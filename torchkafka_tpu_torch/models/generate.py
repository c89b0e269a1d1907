"""Prefill, the cached decode read, sampling and the lockstep ``generate``
loop: port of ``torchkafka_tpu/models/generate.py``.

``prefill`` reuses the trunk of ``Transformer`` (one implementation of the
layer math, as in the JAX package) and captures each layer's k/v for the
serving cache. ``_attend_cached`` is the decode tail over an M-major
cache ``[B, M, K, Dh]``, in both cache modes: the compute-dtype pool, and
the int8 pool with its scales folded onto the small score/probability
tensors. The server's int8 pool reads through the CUDA kernel instead
(``ops.kvattn``); this read serves the compute-dtype pool.

Sampling draws as the JAX package does: ``jax.random.categorical`` over
the filtered logits, from threefry keys (``utils.prng``), so a key gives
the same tokens in both packages.

Mesh-sharded serving (``ServingShard``): the JAX package lets GSPMD spread
one program over a mesh of chips from the layouts alone; the port's mesh
is processes, one rank per mesh position, and each rank runs the same
program on its share. ``serving_shardings`` gives the training
``param_specs`` layouts (an int8 tree through ``quantize_specs``), so a
tp/fsdp/ep pod's ``shard_params`` output serves in place; ``kv_sharding``
and its siblings are placement records (``Layout``: which dim splits over
which axis) from which a rank builds its local pools. Under ``tp`` a rank
holds its q and kv heads, its ``d_ff`` columns and its rows of the
vocabulary: the lookup is vocab-parallel (summed over tp), the outputs of
``wo`` and ``w_down`` are summed over tp (Megatron's row-parallel pair)
and the logits of its ``lm_head`` columns are all-gathered over tp, so
every rank picks from the same logits. Under ``data`` it holds and
computes its slots; under ``fsdp`` each weight's fan-in dim is split and
gathered at use, layer by layer; under ``ep`` its experts, whose outputs
are summed over ep and tp (``models.transformer.ExpertShard``). sp raises
the JAX package's ``ValueError``; pp (layer-sharded storage) is not
ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from torchkafka_tpu_torch.models.quant import (
    QTensor,
    embed_rows,
    load_weight,
    quantize_specs,
)
from torchkafka_tpu_torch.models.transformer import (
    ExpertShard,
    Transformer,
    TransformerConfig,
    _mesh_axes,
    _mlp,
    _moe_mlp,
    _not_ported,
    _rms_norm,
    _rope,
    layer_at,
    matmul_f32,
    param_specs,
    unstack_layers,
)
from torchkafka_tpu_torch.utils import prng


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, max_len, K, Dh]
    v: torch.Tensor  # [L, B, max_len, K, Dh]


# --------------------------------------------------------------- sampling


def filter_logits(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """Temperature → top-k → top-p over [..., V] logits; masked entries go
    to -inf. Ties at either threshold are kept (>= the boundary value), the
    JAX package's rule. The temperature divides as a tensor on the logits'
    device: CUDA multiplies by the reciprocal of a host scalar instead,
    which can differ in the last bit."""
    temp = torch.full((), float(temperature), dtype=torch.float32,
                      device=logits.device)
    logits = logits.float() / temp
    neg = float("-inf")
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep a token while the cumulative probability BEFORE it is still
        # < p: the minimal prefix whose mass reaches p, never empty.
        keep = (cum - probs) < torch.tensor(top_p, dtype=torch.float32)
        n_keep = keep.int().sum(dim=-1, keepdim=True)
        kth = torch.gather(srt, -1, (n_keep - 1).long())
        logits = torch.where(logits < kth, neg, logits)
    return logits


def sample_logits(
    logits: torch.Tensor,
    key: torch.Tensor | None,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """[..., V] logits → [...] int32 token ids. ``temperature == 0`` is
    greedy argmax (the first maximum, as in JAX; the key is not used);
    otherwise ``prng.categorical(key, filter_logits(...))``: one key [2]
    draws over the whole array, keys [B, 2] draw row b with key b."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = filter_logits(
        logits, temperature=temperature, top_k=top_k, top_p=top_p
    )
    return prng.categorical(key, filtered).to(torch.int32)


def check_sampling_params(top_k: int | None, top_p: float | None) -> None:
    """Eager validation of the sampling knobs."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


# ----------------------------------------------------------------- decode


def _attend_cached(
    x, q, cache_k, cache_v, valid, layer, cfg: TransformerConfig,
    k_scale=None, v_scale=None, shard=None,
):
    """Grouped-query attention over the kv cache, then the output
    projection and the MLP residual. x: [B, S, D]; q: [B, S, H, Dh];
    caches [B, M, K, Dh]; valid: [M], [B, M] or [B, S, M] bool mask of
    readable positions. ``k_scale``/``v_scale`` ([B, M, K] f32): int8 mode,
    the scales folded onto the scores and the probabilities:

        scores[..., m] = (q · k_int8[m]) · k_scale[m]
        out            = (probs · v_scale) @ v_int8

    q·k runs in f32 on the compute-dtype operands (exact products), as the
    JAX package's ``preferred_element_type=float32`` does. ``shard``: the
    rank's ``ServingShard`` on a mesh (q and the caches hold its heads)."""
    b, s, h, dh = q.shape
    kk = cache_k.to(cfg.dtype).float()
    vv = cache_v.to(cfg.dtype).float()
    n_kv = kk.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, dh).float()
    scores = torch.einsum("bskre,bmke->bkrsm", qg, kk)
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / math.sqrt(cfg.head_dim)
    if valid.dim() == 1:
        valid = valid[None, :]
    if valid.dim() == 2:  # [B, M]: one mask for every query position
        vmask = valid[:, None, None, None, :]
    else:  # [B, S, M]: per-query masks
        vmask = valid[:, None, None, :, :]
    scores = torch.where(vmask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    attn = torch.einsum("bkrsm,bmke->bskre", probs.to(cfg.dtype).float(), vv)
    attn = attn.to(cfg.dtype).reshape(b, s, h, dh)
    return _attn_tail(x, attn, layer, cfg, shard)


def _attn_tail(x, attn, layer, cfg: TransformerConfig, shard=None):
    """Post-attention residual: output projection + the MLP block. An MoE
    layer routes exactly (dense dispatch) whatever ``cfg.moe_dispatch``
    says, as the JAX package's decode does: capacity drops are a training
    tradeoff, and every decoded token gets its routed experts. ``shard``
    (a ``ServingShard``): ``attn`` holds this rank's heads and the layer
    its tp shards, so the products of ``wo`` and ``w_down`` are partial
    and summed over tp; an MoE layer's experts are this rank's, summed over
    ep and tp."""
    tp_sum = (lambda y: y) if shard is None else shard.tp_sum
    x = x + tp_sum(torch.einsum(
        "bshe,hed->bsd", attn, load_weight(layer["wo"], cfg.dtype)
    ))
    h = _rms_norm(x, layer["ln2"])
    if cfg.is_moe:
        experts = None if shard is None else shard.experts(layer)
        return x + _moe_mlp(h, layer, cfg, experts)[0]
    return x + tp_sum(_mlp(h, layer, cfg))


def _project_qkv(x, layer, cfg: TransformerConfig):
    """RMSNorm + q/k/v projections for decode queries. x: [B, S, D]."""
    h = _rms_norm(x, layer["ln1"])
    q = torch.einsum("bsd,dhe->bshe", h, load_weight(layer["wq"], cfg.dtype))
    k = torch.einsum("bsd,dke->bske", h, load_weight(layer["wk"], cfg.dtype))
    v = torch.einsum("bsd,dke->bske", h, load_weight(layer["wv"], cfg.dtype))
    return q, k, v


# ---------------------------------------------------------------- prefill


def prefill_model(cfg: TransformerConfig, mesh=None) -> Transformer:
    """The prefill trunk for ``cfg`` (on ``mesh``: its tp all-reduces, ep
    experts and K1 through ``flash_attention_sharded`` on each rank's rows
    and heads). A config that asked for sequence-parallel attention
    ('ring'/'ulysses') serves through 'auto', as in the JAX package."""
    if cfg.attn_impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg, attn_impl="auto")
    return Transformer(cfg, mesh)


def prefill_capture(params, cfg: TransformerConfig, tokens: torch.Tensor,
                    model: Transformer | None = None, shard=None):
    """tokens [B, S] → (last-position logits [B, V] f32, k, v), k/v each
    [L, B, S, K, Dh] in the compute dtype: the prompt's cache rows, for a
    caller that writes them into its own pool. ``shard`` (a
    ``ServingShard``, with ``model`` on its mesh): ``params`` are the
    rank's, k/v hold its kv heads and the logits are whole."""
    model = model or prefill_model(cfg, None if shard is None else shard.mesh)
    if shard is None:
        x, ks, vs = model.trunk_kv(params, tokens)
        return matmul_f32(x[:, -1], params["lm_head"], cfg.dtype), ks, vs
    x, ks, vs = model.trunk_kv(
        params, tokens, x=shard.embed(params["embed"], tokens, cfg.dtype),
        layers=shard.layers(params["layers"]),
    )
    return shard.logits(x[:, -1], params["lm_head"], cfg.dtype), ks, vs


def prefill(params, cfg: TransformerConfig, tokens: torch.Tensor, max_len: int,
            shard=None):
    """tokens [B, S] → (last-position logits [B, V] f32, KVCache with
    positions [0, S) filled and the rest zero, [L, B, max_len, K, Dh];
    this rank's kv heads under ``shard``)."""
    logits, ks, vs = prefill_capture(params, cfg, tokens, shard=shard)
    nl, b, s, kh, dh = ks.shape
    shape = (nl, b, max_len, kh, dh)
    cache_k = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    cache_v = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
    cache_k[:, :, :s] = ks
    cache_v[:, :, :s] = vs
    return logits, KVCache(cache_k, cache_v)


# --------------------------------------------------------------- lockstep


def _layer_step(x, layer, cache_k, cache_v, pos: int, cfg: TransformerConfig,
                shard=None):
    """One token through one layer at the scalar position ``pos``. x:
    [B, 1, D]; caches [B, max_len, K, Dh], one layer's views, written in
    place at ``pos``; the read covers positions [0, pos]."""
    q, k, v = _project_qkv(x, layer, cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
    return _attend_cached(x, q, cache_k, cache_v, valid, layer, cfg, shard=shard)


def _decode_one(params, cfg: TransformerConfig, cache: KVCache,
                token: torch.Tensor, pos: int, shard=None) -> torch.Tensor:
    """token [B] → logits [B, V] f32; the cache is written in place."""
    if shard is None:
        x = embed_rows(params["embed"], token, cfg.dtype)[:, None, :]
        layers = [layer_at(params["layers"], i) for i in range(cfg.n_layers)]
    else:
        x = shard.embed(params["embed"], token, cfg.dtype)[:, None, :]
        layers = shard.layers(params["layers"])
    for i, layer in enumerate(layers):
        x = _layer_step(x, layer, cache.k[i], cache.v[i], pos, cfg, shard)
    x = _rms_norm(x[:, 0], params["ln_f"])
    if shard is None:
        return matmul_f32(x, params["lm_head"], cfg.dtype)
    return shard.logits(x, params["lm_head"], cfg.dtype)


@torch.inference_mode()
def generate(
    params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,
    max_new: int,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    rng: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """prompt [B, S] int32 → generated [B, max_new] int32, every row in
    lockstep (greedy when ``temperature == 0``). ``rng``: a ``prng`` key
    (None = ``prng.key(0)``). Token 0 draws with ``rng`` itself; each later
    step does ``key, sub = split(key)`` and draws with ``sub``, the JAX
    package's schedule, so a key gives the same tokens in both packages.

    ``mesh``: model-sharded decode over a ``parallel.make_mesh`` mesh, run
    by every rank with the same arguments: ``params`` whole on every rank
    or ``shard_params``' ``DTensor``s (``serving_shardings``' layouts), the
    whole ``prompt``. Each rank decodes its data rows on its heads (see
    ``ServingShard``); a sampled step draws over the logits gathered over
    data, since one key draws over the whole batch. Every rank returns the
    whole [B, max_new]; token-exact against the mesh-less call at f32."""
    check_sampling_params(top_k, top_p)
    shard = None
    if mesh is not None:
        shard = ServingShard(cfg, mesh, batch=prompt.shape[0])
        params = shard.local_params(params, prompt.device)
        prompt = shard.local_rows(prompt)
    batch, seq = prompt.shape
    logits, cache = prefill(params, cfg, prompt, seq + max_new, shard=shard)
    key = prng.key(0, prompt.device) if rng is None else rng.to(prompt.device)

    def pick(lg, k):
        if shard is None or temperature == 0.0:
            return sample_logits(lg, k, temperature=temperature, top_k=top_k,
                                 top_p=top_p)
        whole = sample_logits(shard.gather_rows(lg), k, temperature=temperature,
                              top_k=top_k, top_p=top_p)
        return shard.local_rows(whole)

    tokens = [pick(logits, key)]
    for i in range(max_new - 1):
        key, sub = prng.split(key)
        logits = _decode_one(params, cfg, cache, tokens[-1], seq + i, shard)
        tokens.append(pick(logits, sub))
    out = torch.stack(tokens, dim=1)
    return out if shard is None else shard.gather_rows(out)


# ------------------------------------------------------------ mesh-sharded


def check_serving_mesh(cfg: TransformerConfig, mesh, *, batch: int | None = None) -> None:
    """The JAX package's divisibility guards for model-sharded decode, with
    its errors word for word: every dim the ``serving_shardings`` layouts
    split must divide its axis. tp splits heads (wq's H, the cache's K),
    the vocab (embed rows / lm_head columns) and d_ff (w_gate/w_down);
    fsdp splits d_model; ep splits experts; data splits the slots."""
    sizes = _mesh_axes(mesh)
    tp = sizes.get("tp", 1)
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} and "
            f"n_kv_heads={cfg.n_kv_heads} for sharded decode"
        )
    if tp > 1 and (cfg.vocab_size % tp or cfg.d_ff % tp):
        raise ValueError(
            f"tp={tp} must divide vocab_size={cfg.vocab_size} and "
            f"d_ff={cfg.d_ff} (embed/lm_head/MLP shard those dims over tp)"
        )
    fsdp = sizes.get("fsdp", 1)
    if fsdp > 1 and cfg.d_model % fsdp:
        raise ValueError(
            f"fsdp={fsdp} must divide d_model={cfg.d_model} "
            "(weight fan-in dims shard over fsdp)"
        )
    ep = sizes.get("ep", 1)
    if ep > 1 and cfg.is_moe and cfg.n_experts % ep:
        raise ValueError(
            f"ep={ep} must divide n_experts={cfg.n_experts}"
        )
    pp = sizes.get("pp", 1)
    if pp > 1 and cfg.n_layers % pp:
        raise ValueError(
            f"pp={pp} must divide n_layers={cfg.n_layers} (layer-stacked "
            "weights shard over pp; decode is layer-sharded storage, not a "
            "pipelined schedule)"
        )
    if sizes.get("sp", 1) > 1:
        raise ValueError(
            "serving meshes must not carry an sp axis: decode is one token "
            "per step (nothing to sequence-shard) and prefill under sp "
            "would engage ring attention against an unsharded prompt — "
            "shard kv heads over tp and slots over data instead"
        )
    dp = sizes.get("data", 1)
    if batch is not None and dp > 1 and batch % dp:
        raise ValueError(
            f"batch/slots={batch} must divide by the data axis ({dp})"
        )


def serving_specs(cfg: TransformerConfig, params) -> dict:
    """The partition specs of a serving tree: the training ``param_specs``
    (one axis name or None a dim), through ``quantize_specs`` for an int8
    tree, so a checkpoint trained tp/fsdp/ep-sharded serves in place."""
    specs = param_specs(cfg)
    if isinstance(params["lm_head"], QTensor):
        specs = quantize_specs(specs, cfg)
    return specs


def _spec_map(fn, specs):
    if isinstance(specs, Mapping):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, QTensor):
        return QTensor(fn(specs.q), fn(specs.scale))
    return fn(specs)


def serving_shardings(cfg: TransformerConfig, mesh, params) -> dict:
    """Placements (one per mesh axis, ``Shard(dim)`` or ``Replicate()``)
    for a serving tree, plain or int8 (a ``QTensor`` leaf gets a pair):
    exactly the training layouts, the JAX package's ``NamedSharding``s."""
    from torchkafka_tpu_torch.models.transformer import shardings_for_mesh

    return _spec_map(lambda spec: shardings_for_mesh(mesh, spec),
                     serving_specs(cfg, params))


@dataclasses.dataclass(frozen=True)
class Layout:
    """A placement record: ``spec`` names, per dim of a tensor, the mesh
    axis that dim splits over (None: whole on every rank), the JAX
    package's ``PartitionSpec`` entries; ``sizes`` are the mesh's (axis,
    size) pairs (an axis the mesh lacks splits nothing). A rank builds its
    local tensor at ``local_shape`` of the global one."""

    spec: tuple
    sizes: tuple

    def local_shape(self, shape) -> tuple:
        sizes = dict(self.sizes)
        out = []
        for d, n in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            k = sizes.get(axis, 1) if axis is not None else 1
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split over "
                                 f"{axis}={k}")
            out.append(n // k)
        return tuple(out)


def _layout(mesh, *spec) -> Layout:
    return Layout(tuple(spec), tuple(_mesh_axes(mesh).items()))


def kv_sharding(mesh) -> Layout:
    """Dense pool [L, B, M, K, Dh]: slots over data, kv heads over tp."""
    return _layout(mesh, None, "data", None, "tp", None)


def kv_scale_sharding(mesh) -> Layout:
    """int8-pool scales [L, B, M, K]: slots over data, kv heads over tp."""
    return _layout(mesh, None, "data", None, "tp")


def slot_sharding(mesh, ndim: int = 1) -> Layout:
    """Per-slot state [B, ...] (tokens, positions, outputs): over data."""
    return _layout(mesh, "data", *([None] * (ndim - 1)))


def kv_kmajor_sharding(mesh) -> Layout:
    """K-major dense int8 pool [L, B, K, M, Dh] (K4's layout): slots over
    data, kv heads over tp."""
    return _layout(mesh, None, "data", "tp", None, None)


def kv_kmajor_scale_sharding(mesh) -> Layout:
    """K-major int8 scales [L, B, K, M]."""
    return _layout(mesh, None, "data", "tp", None)


def paged_pool_sharding(mesh) -> Layout:
    """Paged block pool [L, NB, bs, K, Dh]: kv heads over tp, blocks
    REPLICATED over data: any slot's table may reference any block and
    radix prefix blocks are read by every slot, so each data rank holds
    the whole pool for its heads and the paged program runs replicated
    over data (the same tables, positions and tokens on every data rank)."""
    return _layout(mesh, None, None, None, "tp", None)


def paged_pool_kmajor_sharding(mesh) -> Layout:
    """K-major-per-block int8 paged payloads [L, NB, K, bs, Dh] (K5's
    layout): kv heads over tp, blocks replicated over data."""
    return _layout(mesh, None, None, "tp", None, None)


def paged_scale_kmajor_sharding(mesh) -> Layout:
    """K-major-per-block int8 paged scales [L, NB, K, bs]."""
    return _layout(mesh, None, None, "tp", None)


def _axis_dim(spec: tuple, axis: str) -> int | None:
    return spec.index(axis) if axis in spec else None


class _GatheredLayers:
    """A sequence of layer views whose fsdp-split weights are gathered over
    fsdp when a layer is taken (at use, layer by layer)."""

    def __init__(self, views: list, specs: dict, shard: "ServingShard") -> None:
        self._views = views
        self._specs = specs
        self._shard = shard

    def __len__(self) -> int:
        return len(self._views)

    def __getitem__(self, i: int):
        return {n: self._shard.gather_fsdp(w, self._specs[n])
                for n, w in self._views[i].items()}

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class ServingShard:
    """One rank's share of a serving mesh (``parallel.make_mesh`` over the
    axes data, fsdp, tp and ep), and the collectives that make its share
    of the program the whole one's (``parallel.collectives``, by written
    rule: gloo stages CUDA tensors through host memory).

    Built by every rank of ``mesh`` with the same arguments;
    ``check_serving_mesh`` first, then a pp axis raises
    ``NotImplementedError`` (layer-sharded serving is not ported)."""

    def __init__(self, cfg: TransformerConfig, mesh, *, batch: int | None = None) -> None:
        check_serving_mesh(cfg, mesh, batch=batch)
        sizes = _mesh_axes(mesh)
        if sizes.get("pp", 1) > 1:
            raise _not_ported("mesh= with a pp axis (layer-sharded serving)",
                              "Sharded serving")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the serving mesh")
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = sizes
        self.coords = dict(zip(mesh.mesh_dim_names, (int(c) for c in coord)))
        self._groups = {a: mesh.get_group(a) for a, n in sizes.items() if n > 1}
        self.tp, self.data = sizes.get("tp", 1), sizes.get("data", 1)
        self.fsdp, self.ep = sizes.get("fsdp", 1), sizes.get("ep", 1)

    def rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The mesh's process group of ``axis`` (None for an axis of 1)."""
        return self._groups.get(axis)

    @property
    def tick_collectives(self) -> bool:
        """Does a decode tick run collectives (tp sums, fsdp gathers, ep
        sums)? A data-only mesh's tick runs none."""
        return self.tp > 1 or self.fsdp > 1 or self.ep > 1

    # ------------------------------------------------------------ params

    def local_params(self, params, device) -> dict:
        """This rank's tree on ``device``: the local tensors of
        ``shard_params``' ``DTensor``s, or, from a whole tree (the same on
        every rank), its chunk of each dim ``serving_specs`` splits over an
        axis of the mesh (a copy, so the whole tree can be freed)."""
        from torch.distributed.tensor import DTensor

        from torchkafka_tpu_torch.parallel.mesh import local_part

        def leaf(x, spec):
            if isinstance(x, QTensor):
                return QTensor(leaf(x.q, spec.q), leaf(x.scale, spec.scale))
            if isinstance(x, DTensor):
                return local_part(x).to(device)
            t, split = x, False
            for d, axis in enumerate(spec):
                n = self.sizes.get(axis, 1) if axis is not None else 1
                if n > 1:
                    t = t.chunk(n, dim=d)[self.coords[axis]]
                    split = True
            return (t.contiguous().clone() if split else t).to(device)

        def walk(tree, spec):
            if isinstance(tree, Mapping):
                return {k: walk(v, spec[k]) for k, v in tree.items()}
            return leaf(tree, spec)

        return walk(params, serving_specs(self.cfg, params))

    def gather_fsdp(self, w, spec):
        """``w`` (a tensor or ``QTensor`` of this rank's tree, ``spec`` its
        ``serving_specs`` entry, the layer dim dropped for a layer view)
        whole over fsdp."""
        if isinstance(w, QTensor):
            return QTensor(self.gather_fsdp(w.q, spec.q), self.gather_fsdp(w.scale, spec.scale))
        d = _axis_dim(spec, "fsdp")
        if d is None or self.fsdp == 1:
            return w
        from torchkafka_tpu_torch.parallel.collectives import all_gather

        return all_gather(w, d, self.group("fsdp"))

    def _specs(self, params_like, name: str):
        specs = param_specs(self.cfg)
        if isinstance(params_like, QTensor):
            specs = quantize_specs(specs, self.cfg)
        return specs[name]

    def layers(self, layers_tree: Mapping):
        """The layer views of this rank's stacked layers: ``unstack_layers``'
        views, each fsdp-split weight gathered when its layer is taken."""
        views = unstack_layers(layers_tree)
        if self.fsdp == 1:
            return views
        specs = param_specs(self.cfg)["layers"]
        quant = quantize_specs(param_specs(self.cfg), self.cfg)["layers"]

        def drop_l(spec):
            if isinstance(spec, QTensor):
                return QTensor(spec.q[1:], spec.scale[1:])
            return spec[1:]

        plan = {n: drop_l(quant[n] if isinstance(w, QTensor) else specs[n])
                for n, w in layers_tree.items()}
        return _GatheredLayers(views, plan, self)

    # ---------------------------------------------------- vocab, heads

    def embed(self, w, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The vocab-parallel lookup: each tp rank looks up the tokens its
        rows of ``embed`` hold (zeros elsewhere), summed over tp (one
        non-zero term a token, so the sum is exact)."""
        w = self.gather_fsdp(w, self._specs(w, "embed"))
        if self.tp == 1:
            return embed_rows(w, tokens, dtype)
        from torchkafka_tpu_torch.parallel.collectives import all_reduce_

        n = (w.q if isinstance(w, QTensor) else w).shape[0]
        lo = self.rank("tp") * n
        inside = (tokens >= lo) & (tokens < lo + n)
        rows = embed_rows(w, torch.where(inside, tokens - lo, 0), dtype)
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))
        return all_reduce_(rows, self.group("tp"))

    def logits(self, x: torch.Tensor, w, dtype) -> torch.Tensor:
        """f32 logits of ``x`` through this rank's ``lm_head`` columns,
        all-gathered over tp: every rank holds the whole [..., V]."""
        w = self.gather_fsdp(w, self._specs(w, "lm_head"))
        out = matmul_f32(x, w, dtype)
        if self.tp == 1:
            return out
        from torchkafka_tpu_torch.parallel.collectives import all_gather

        return all_gather(out, out.dim() - 1, self.group("tp"))

    def tp_sum(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial result summed over tp."""
        if self.tp == 1:
            return y
        from torchkafka_tpu_torch.parallel.collectives import all_reduce_

        return all_reduce_(y, self.group("tp"))

    def experts(self, layer: Mapping) -> ExpertShard | None:
        """This rank's experts of an MoE layer (E/ep of them, each one's
        d_ff columns over tp), summed over ep and tp; None when neither
        splits."""
        groups = tuple(g for g in (self.group("ep"), self.group("tp")) if g is not None)
        if not groups:
            return None
        w = layer["w_gate"]
        n_local = (w.q if isinstance(w, QTensor) else w).shape[0]
        return ExpertShard(first=self.rank("ep") * n_local, groups=groups)

    # ---------------------------------------------------- rows and host

    def row_range(self, n: int) -> tuple[int, int]:
        """(first, count) of this data rank's rows of ``n``."""
        per = n // self.data
        return self.rank("data") * per, per

    def local_rows(self, t):
        """This data rank's rows of ``t`` (a tensor or an array)."""
        lo, per = self.row_range(t.shape[0])
        return t[lo:lo + per]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in rank order (all-gather over
        data)."""
        if self.data == 1:
            return t
        from torchkafka_tpu_torch.parallel.collectives import all_gather

        return all_gather(t.contiguous(), 0, self.group("data"))
