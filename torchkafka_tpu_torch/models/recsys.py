"""DLRM-style streaming recommender: port of
``torchkafka_tpu/models/recsys.py``.

Embedding tables, a bottom MLP over the dense features, the pairwise-dot
interaction (the upper triangle of the f32 Gram matrix of the bottom
output and the per-feature embeddings) and a top MLP to one CTR logit.
Parameters keep the JAX package's tree: ``{"tables": {"t0": [V, E], ...},
"bottom": [(w, b), ...], "top": [(w, b), ...]}``, so ``params_from_numpy``
converts a JAX-initialised tree leaf for leaf.

Record layout for the streaming path (``parse_record`` /
``make_processor`` / ``make_chunk_processor``): float32 label,
float32[dense_dim] dense features, int32[n_tables] categorical ids.

``make_dlrm_train_step`` runs on one device (the JAX package's
``make_dlrm_train_step(cfg, mesh, ...)`` on a one-device mesh): the
params and the optimizer state are updated in place, PyTorch's idiom for
the JAX step's donation. A mesh (row-sharded tables over ``tp``) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, load_weight, quantize
from torchkafka_tpu_torch.models.transformer import _not_ported
from torchkafka_tpu_torch.optim import adam
from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    dense_dim: int = 13
    vocab_sizes: tuple[int, ...] = tuple([100_000] * 8)
    embed_dim: int = 64
    bottom_mlp: tuple[int, ...] = (128, 64)  # last entry must equal embed_dim
    top_mlp: tuple[int, ...] = (256, 128, 1)  # last entry must be 1 (logit)
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError(
                f"bottom_mlp must end at embed_dim ({self.embed_dim}) so the "
                f"dense vector joins the interaction block; got {self.bottom_mlp}"
            )
        if self.top_mlp[-1] != 1:
            raise ValueError("top_mlp must end at 1 (the CTR logit)")

    @property
    def n_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def n_interactions(self) -> int:
        n = self.n_tables + 1  # +1: the bottom-MLP dense vector
        return n * (n - 1) // 2


def init_params(generator: torch.Generator, cfg: DLRMConfig, device=None) -> dict:
    """Scaled-normal weights (std 1/√fan_in), zero biases, drawn on
    ``device`` from ``generator`` (which must live there). The numbers
    differ from the JAX package's for the same seed; tests hand both
    packages one numpy tree through ``params_from_numpy``."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pd, device=dev)
        return w.div_(math.sqrt(fan_in))

    def mlp(dims, d_in):
        layers = []
        for d_out in dims:
            layers.append((norm((d_in, d_out), d_in),
                           torch.zeros(d_out, dtype=pd, device=dev)))
            d_in = d_out
        return layers

    return {
        "tables": {f"t{i}": norm((v, cfg.embed_dim), cfg.embed_dim)
                   for i, v in enumerate(cfg.vocab_sizes)},
        "bottom": mlp(cfg.bottom_mlp, cfg.dense_dim),
        "top": mlp(cfg.top_mlp, cfg.n_interactions + cfg.embed_dim),
    }


def params_from_numpy(tree: Any, device=None) -> Any:
    """The JAX package's DLRM tree as numpy arrays (``QTensor`` leaves as
    any NamedTuple with ``q``/``scale``) → the port's tree on ``device``,
    every leaf copied; lists and ``(w, b)`` tuples keep their shape."""
    dev = resolve_device(device)

    def walk(node):
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QTensor(q=walk(node.q), scale=walk(node.scale))
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return torch.from_numpy(np.array(node)).to(dev)

    return walk(tree)


def _tower(x: torch.Tensor, layers, dtype, final_linear: bool) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ load_weight(w, dtype) + b.to(dtype)
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def forward(params: dict, dense: torch.Tensor, cats: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense [B, dense_dim] f32, cats [B, n_tables] int → logits [B] f32.

    Weights may be plain tensors or int8 ``QTensor``s
    (``quantize_dlrm_params``): table lookups gather the int8 rows first
    and scale only the gathered rows."""
    dt = cfg.dtype
    bottom = _tower(dense.to(dt), params["bottom"], dt, final_linear=False)
    embs = [embed_rows(params["tables"][f"t{i}"], cats[:, i], dt)
            for i in range(cfg.n_tables)]
    feats = torch.stack([bottom, *embs], dim=1)  # [B, C+1, E]
    # The Gram matrix in f32 on compute-dtype operands: exact products,
    # an f32 sum (the JAX package's preferred_element_type=float32).
    ff = feats.float()
    gram = ff @ ff.transpose(1, 2)
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
    inter = gram[:, iu, ju].to(dt)  # [B, n_interactions]
    top_in = torch.cat([bottom, inter], dim=-1)
    logits = _tower(top_in, params["top"], dt, final_linear=True)
    return logits[:, 0].float()


def loss_fn(params: dict, dense: torch.Tensor, cats: torch.Tensor,
            labels: torch.Tensor, mask: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """Masked mean sigmoid binary cross-entropy (padded batcher rows
    contribute nothing), a 0-d f32 tensor."""
    logits = forward(params, dense, cats, cfg)
    labels = labels.float()
    per_row = (torch.clamp_min(logits, 0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
    mask = mask.float()
    return (per_row * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_dlrm_train_step(
    cfg: DLRMConfig, mesh=None, optimizer=None, *, device=None,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn), the JAX package's pair on one device.

    init_fn(generator) → (params, opt_state) on ``device`` (CUDA unless
    the caller asks for the CPU). step_fn(params, opt_state, dense, cats,
    labels, mask) → (params, opt_state, loss): value and gradients of
    ``loss_fn``, then one optimizer update, ``params``/``opt_state``
    updated IN PLACE and returned; ``loss`` is a detached 0-d tensor on
    the device, for ``token.commit(wait_for=loss)``.

    ``optimizer``: ``optim.adam(...)`` (or ``adamw``); None means
    ``adam(1e-3)``. ``mesh``: not ported yet (must be None)."""
    if mesh is not None:
        raise _not_ported("mesh=", "Pipeline and expert parallelism")
    opt = adam(1e-3) if optimizer is None else optimizer
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, dev)
        return params, opt.init(params)

    def step_fn(params, opt_state, dense, cats, labels, mask):
        opt_state.check_params(params)
        args = [torch.as_tensor(a, device=dev) for a in (dense, cats, labels, mask)]
        opt_state.zero_grad()
        loss = loss_fn(params, *args, cfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn


# ------------------------------------------------------------- stream glue


def record_nbytes(cfg: DLRMConfig) -> int:
    return 4 * (1 + cfg.dense_dim + cfg.n_tables)


def parse_record(value: bytes, cfg: DLRMConfig) -> dict[str, np.ndarray]:
    """float32 label | float32[dense_dim] | int32[n_tables] → element pytree."""
    d = cfg.dense_dim
    head = np.frombuffer(value, np.float32, count=1 + d)
    cats = np.frombuffer(value, np.int32, count=cfg.n_tables, offset=4 * (1 + d))
    return {"label": head[0], "dense": head[1 : 1 + d], "cats": cats}


def make_processor(cfg: DLRMConfig) -> Callable[[Record], dict | None]:
    """Per-record processor for ``KafkaStream`` (None-drop on records of
    the wrong length)."""
    nbytes = record_nbytes(cfg)

    def processor(record: Record) -> dict | None:
        if len(record.value) != nbytes:
            return None
        return parse_record(record.value, cfg)

    return processor


def make_chunk_processor(cfg: DLRMConfig):
    """Chunked CTR-record decoder: one native ``gather_rows`` call per
    poll chunk into a [K, nbytes] byte matrix, then three columnar views.
    The same columns and drops as ``make_processor``."""
    from torchkafka_tpu_torch import native
    from torchkafka_tpu_torch.transform.processor import chunked

    nbytes = record_nbytes(cfg)
    d = cfg.dense_dim

    @chunked
    def process(records: list[Record]):
        values = [r.value for r in records]
        keep = np.fromiter(
            (len(v) == nbytes for v in values), np.bool_, count=len(values)
        )
        if not keep.any():
            return None, keep
        if not keep.all():
            values = [v for v in values if len(v) == nbytes]
        rows = native.gather_rows(values, nbytes, np.uint8)
        head = np.ascontiguousarray(rows[:, : 4 * (1 + d)]).view(np.float32)
        cats = np.ascontiguousarray(rows[:, 4 * (1 + d):]).view(np.int32)
        out = {
            "label": np.ascontiguousarray(head[:, 0]),
            "dense": np.ascontiguousarray(head[:, 1 : 1 + d]),
            "cats": cats,
        }
        return out, (None if keep.all() else keep)

    return process


def quantize_dlrm_params(params: dict) -> dict:
    """Post-training int8: tables per row (the scale applies to gathered
    rows only), tower weights per output column; biases stay in their
    dtype. The result flows through ``forward``/``loss_fn`` unchanged."""
    return {
        "tables": {name: quantize(w, (1,)) for name, w in params["tables"].items()},
        "bottom": [(quantize(w, (0,)), b) for w, b in params["bottom"]],
        "top": [(quantize(w, (0,)), b) for w, b in params["top"]],
    }


def count_params(params: dict) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))
