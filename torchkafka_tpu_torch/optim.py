"""AdamW and Adam for the train steps, with optax's defaults.

The JAX package trains with ``optax.adamw(lr)``; the port's ``adamw(lr)``
builds on ``torch.optim.AdamW`` with every argument passed explicitly, so
the update is optax's:

    m ← b1·m + (1−b1)·g          v ← b2·v + (1−b2)·g²
    p ← p − lr·( m̂ / (√v̂ + eps) + weight_decay·p )

with bias-corrected m̂, v̂. ``torch.optim.AdamW`` folds the decay in as
``p·(1 − lr·wd)`` before the Adam step, which is the same update.
Its own default weight decay is 1e-2; optax's, and this one's, is 1e-4.

``adam(lr)`` is ``optax.adam``: the same update without the decay term
(the DLRM train step's optimizer, as in the JAX package).

``adamw(...).init(params)`` returns the optimizer state: it holds the
parameter tensors themselves and updates them in place on ``step()``. A
``DTensor`` leaf (a parameter laid out over a mesh) is held as its local
tensor, so the moments are the shape of this rank's chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from torchkafka_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten


def _local_leaves(params: Any) -> list:
    """The tensors the optimizer updates: each leaf, or a DTensor leaf's
    local tensor."""
    from torchkafka_tpu_torch.parallel.mesh import local_part

    return [local_part(t) for t in tree_leaves(params)]


class AdamWState:
    """The optimizer state of one parameter tree: a ``torch.optim.AdamW``
    over exactly that tree's tensors."""

    def __init__(self, optimizer: torch.optim.AdamW, leaves: list) -> None:
        self.optimizer = optimizer
        self._leaves = leaves

    def check_params(self, params: Any) -> None:
        """Raise unless ``params`` is the tree this state was built over
        (the updates land in place, on those very tensors)."""
        leaves = _local_leaves(params)
        if len(leaves) != len(self._leaves) or any(
            a is not b for a, b in zip(leaves, self._leaves)
        ):
            raise ValueError(
                "opt_state was built over other parameter tensors; pass the "
                "params returned by init_fn (or adamw(...).init(params))"
            )

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.optimizer.step()

    def state_tree(self, params: Any) -> dict:
        """The moments as trees shaped like ``params`` (each leaf laid out
        as its parameter is, a ``DTensor`` where the parameter is one) and
        the step count: the state a checkpoint saves."""
        from torch.distributed.tensor import DTensor

        leaves, treedef = tree_flatten(params)

        def moment(name):
            out = []
            for p, t in zip(leaves, self._leaves):
                m = self.optimizer.state.get(t, {}).get(name)
                m = torch.zeros_like(t) if m is None else m
                if isinstance(p, DTensor):
                    m = DTensor.from_local(m, p.device_mesh, p.placements, run_check=False)
                out.append(m)
            return tree_unflatten(treedef, out)

        steps = [self.optimizer.state.get(t, {}).get("step") for t in self._leaves]
        step = next((s for s in steps if s is not None), torch.zeros(()))
        return {"step": torch.as_tensor(step, dtype=torch.float32).detach().cpu().reshape(()),
                "exp_avg": moment("exp_avg"), "exp_avg_sq": moment("exp_avg_sq")}

    def load_state_tree(self, tree: dict) -> None:
        """Set the moments and step count from ``state_tree``'s layout
        (each leaf this rank's local tensor or a full tensor to chunk as
        the parameter is laid out)."""
        from torchkafka_tpu_torch.parallel.mesh import local_part

        step = float(torch.as_tensor(tree["step"]))
        for name in ("exp_avg", "exp_avg_sq"):
            for t, m in zip(self._leaves, tree_leaves(tree[name])):
                st = self.optimizer.state[t]
                st[name] = local_part(m).detach().to(t.device, t.dtype).clone()
                st["step"] = torch.tensor(step, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Any) -> AdamWState:
        """State over every tensor of ``params`` (each made a gradient
        leaf); the moments start at zero, as optax's do."""
        leaves = _local_leaves(params)
        for t in leaves:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                raise TypeError(
                    f"adamw trains floating-point tensors only, got {type(t).__name__}"
                    f"{'' if not isinstance(t, torch.Tensor) else ' ' + str(t.dtype)}"
                )
            t.requires_grad_(True)
        opt = torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
        )
        return AdamWState(opt, leaves)


def adamw(
    learning_rate: float, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 1e-4,
) -> AdamW:
    """``optax.adamw``'s signature and defaults (weight decay 1e-4)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def adam(
    learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> AdamW:
    """``optax.adam``'s signature and defaults: AdamW with no weight
    decay (``eps_root`` 0, as optax's default)."""
    return AdamW(learning_rate, b1, b2, eps, 0.0)
