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

``make_dlrm_train_step`` updates the params and the optimizer state in
place, PyTorch's idiom for the JAX step's donation. On one device, or on
a ``parallel.make_mesh`` mesh over ``data``, ``fsdp`` and ``tp``
(``param_specs``): the tables are row-sharded over tp and the lookup is
vocab-parallel (each tp rank gathers the ids in its stripe, zeros
elsewhere, and the rows are summed over tp); the towers replicate; the
batch is split over data × fsdp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, load_weight, quantize
from torchkafka_tpu_torch.optim import adam
from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves, tree_map


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


def param_specs(cfg: DLRMConfig) -> dict:
    """The JAX package's partition specs (a tuple per tensor, an axis name
    or None per dim): tables shard their rows over ``tp`` (the capacity
    axis); the towers replicate (they are KBs next to the tables' GBs).
    Axes a mesh lacks are stripped by ``shardings_for_mesh``."""
    return {
        "tables": {f"t{i}": ("tp", None) for i in range(cfg.n_tables)},
        "bottom": [((None, None), (None,)) for _ in cfg.bottom_mlp],
        "top": [((None, None), (None,)) for _ in cfg.top_mlp],
    }


def shardings_for_mesh(mesh, specs: dict) -> dict:
    """``param_specs`` → placements per tensor (the transformer's
    ``shardings_for_mesh`` on each spec; the towers' (w, b) pairs keep
    their shape)."""
    from torchkafka_tpu_torch.models.transformer import shardings_for_mesh as placements

    return {
        "tables": placements(mesh, specs["tables"]),
        **{k: [tuple(placements(mesh, sp) for sp in pair) for pair in specs[k]]
           for k in ("bottom", "top")},
    }


def shard_params(params: dict, cfg: DLRMConfig, mesh) -> dict:
    """A full parameter tree (the same values on every rank) → ``DTensor``s
    laid out per ``param_specs`` on ``mesh``: each tp rank keeps its stripe
    of every table's rows, and a copy of the towers. No communication."""
    from torchkafka_tpu_torch.parallel.mesh import distribute

    pl = shardings_for_mesh(mesh, param_specs(cfg))
    return {
        "tables": {k: distribute(v, mesh, pl["tables"][k]) for k, v in params["tables"].items()},
        **{k: [tuple(distribute(t, mesh, p) for t, p in zip(pair, pls))
               for pair, pls in zip(params[k], pl[k])]
           for k in ("bottom", "top")},
    }


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
            cfg: DLRMConfig, lookup=None) -> torch.Tensor:
    """dense [B, dense_dim] f32, cats [B, n_tables] int → logits [B] f32.

    Weights may be plain tensors or int8 ``QTensor``s
    (``quantize_dlrm_params``): table lookups gather the int8 rows first
    and scale only the gathered rows. ``lookup(table, ids)``: the
    embedding gather (default ``embed_rows``; the mesh step's is
    vocab-parallel)."""
    dt = cfg.dtype
    lookup = (lambda w, ids: embed_rows(w, ids, dt)) if lookup is None else lookup
    bottom = _tower(dense.to(dt), params["bottom"], dt, final_linear=False)
    embs = [lookup(params["tables"][f"t{i}"], cats[:, i]) for i in range(cfg.n_tables)]
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
            labels: torch.Tensor, mask: torch.Tensor, cfg: DLRMConfig, *,
            count=None, lookup=None) -> torch.Tensor:
    """Masked mean sigmoid binary cross-entropy (padded batcher rows
    contribute nothing), a 0-d f32 tensor. ``count``: the mean's
    denominator (the global count of real rows when this call sees one
    rank's rows); None = this call's. ``lookup``: as ``forward``'s."""
    logits = forward(params, dense, cats, cfg, lookup)
    labels = labels.float()
    per_row = (torch.clamp_min(logits, 0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
    mask = mask.float()
    count = torch.clamp_min(mask.sum(), 1.0) if count is None else count
    return (per_row * mask).sum() / count


def make_dlrm_train_step(
    cfg: DLRMConfig, mesh=None, optimizer=None, *, device=None,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn), the JAX package's pair.

    init_fn(generator) → (params, opt_state) on ``device`` (CUDA unless
    the caller asks for the CPU). step_fn(params, opt_state, dense, cats,
    labels, mask) → (params, opt_state, loss): value and gradients of
    ``loss_fn``, then one optimizer update, ``params``/``opt_state``
    updated IN PLACE and returned; ``loss`` is a detached 0-d tensor on
    the device, for ``token.commit(wait_for=loss)``.

    ``optimizer``: ``optim.adam(...)`` (or ``adamw``); None means
    ``adam(1e-3)``. ``mesh``: a ``parallel.make_mesh`` mesh (see
    ``_mesh_dlrm_step``); None is the single-device step."""
    opt = adam(1e-3) if optimizer is None else optimizer
    if mesh is not None:
        return _mesh_dlrm_step(cfg, mesh, opt, device)
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


def _mesh_dlrm_step(cfg: DLRMConfig, mesh, opt, device):
    """The DLRM step over a mesh of data, fsdp and tp axes (the JAX
    package's ``make_dlrm_train_step(cfg, mesh)``): parameters are
    ``DTensor``s per ``param_specs`` — each tp rank holds a stripe of every
    table's rows, the towers whole — and each rank its rows of the batch
    (split over data × fsdp; tp peers hold the same rows). A step:

    1. sums the count of real rows over data and fsdp (the global
       mask-weighted mean, in shares);
    2. runs ``loss_fn`` on the local rows with a vocab-parallel lookup:
       each tp rank gathers the ids that fall in its stripe (zeros for the
       others) and the rows are summed over tp (``reduce_from_tp``: the
       backward hands each rank the whole gradient, which its gather
       scatters into its own rows);
    3. sums every gradient over data and fsdp, never over tp (the towers'
       gradients are equal on tp peers), steps the optimizer on the local
       tensors, and sums the loss shares over data and fsdp into the
       global loss every rank returns.
    ``step_fn.stats``: the last step's collective calls, bytes and host
    seconds."""
    from torchkafka_tpu_torch.models.transformer import _mesh_axes
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.mesh import local_part

    sizes = _mesh_axes(mesh)
    groups = {a: mesh.get_group(a) for a in ("data", "fsdp", "tp") if sizes.get(a, 1) > 1}
    mesh_dev = (torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    dev = resolve_device(device) if device is not None else mesh_dev
    tp = groups.get("tp")
    tp_rank = torch.distributed.get_rank(tp) if tp is not None else 0

    def sum_(t: torch.Tensor) -> torch.Tensor:
        for axis in ("fsdp", "data"):
            if axis in groups:
                collectives.all_reduce_(t, groups[axis])
        return t

    def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if tp is None:
            return embed_rows(table, ids, cfg.dtype)
        n = table.shape[0]
        lo = tp_rank * n
        inside = (ids >= lo) & (ids < lo + n)
        rows = embed_rows(table, torch.where(inside, ids - lo, 0), cfg.dtype)
        return collectives.reduce_from_tp(rows * inside[:, None].to(cfg.dtype), tp)

    def init_fn(generator: torch.Generator):
        params = shard_params(init_params(generator, cfg, dev), cfg, mesh)
        return params, opt.init(params)

    def step_fn(params, opt_state, dense, cats, labels, mask):
        opt_state.check_params(params)
        dense, cats, labels, mask = (torch.as_tensor(local_part(a), device=dev)
                                     for a in (dense, cats, labels, mask))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = collectives.COUNTS.as_dict()
        count = sum_(mask.float().sum().reshape(1)).clamp_min(1.0)[0]
        local = tree_map(local_part, params)
        opt_state.zero_grad()
        share = loss_fn(local, dense, cats, labels, mask, cfg, count=count, lookup=lookup)
        share.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for p in tree_leaves(local):
            sum_(p.grad)
        loss = sum_(share.detach().reshape(1))[0]
        after = collectives.COUNTS.as_dict()
        step_fn.stats = {k: after[k] - before[k] for k in after}
        opt_state.step()
        return params, opt_state, loss

    step_fn.stats = {}
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
