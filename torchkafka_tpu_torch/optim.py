"""AdamW for the train step, with ``optax.adamw``'s defaults.

The JAX package trains with ``optax.adamw(lr)``; the port's ``adamw(lr)``
builds on ``torch.optim.AdamW`` with every argument passed explicitly, so
the update is optax's:

    m ← b1·m + (1−b1)·g          v ← b2·v + (1−b2)·g²
    p ← p − lr·( m̂ / (√v̂ + eps) + weight_decay·p )

with bias-corrected m̂, v̂. ``torch.optim.AdamW`` folds the decay in as
``p·(1 − lr·wd)`` before the Adam step, which is the same update.
Its own default weight decay is 1e-2; optax's, and this one's, is 1e-4.

``adamw(...).init(params)`` returns the optimizer state: it holds the
parameter tensors themselves and updates them in place on ``step()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from torchkafka_tpu_torch.utils.tree import tree_leaves


class AdamWState:
    """The optimizer state of one parameter tree: a ``torch.optim.AdamW``
    over exactly that tree's tensors."""

    def __init__(self, optimizer: torch.optim.AdamW, leaves: list) -> None:
        self.optimizer = optimizer
        self._leaves = leaves

    def check_params(self, params: Any) -> None:
        """Raise unless ``params`` is the tree this state was built over
        (the updates land in place, on those very tensors)."""
        leaves = tree_leaves(params)
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
        leaves = tree_leaves(params)
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
