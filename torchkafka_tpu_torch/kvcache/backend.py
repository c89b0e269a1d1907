"""The KV-backend resolver for the serving pool: port of
``torchkafka_tpu/kvcache/backend.py``, single device.

``resolve_kv_backend`` validates one (layout × dtype × read) combination
and returns a ``KVBackend`` saying what actually serves.

- Dense int8 pool: with the kernel, stored K-major and read through
  ``ops.kvattn.int8_decode_attention_dynlen`` (its CUDA kernel on the
  card, its plain version on the CPU); without it, stored M-major and
  read by the scale-folded ``models.generate._attend_cached`` under a
  [B, M] valid mask, the JAX package's XLA read in plain code.
  ``kv_kernel=True`` requires the kernel (raising ``ValueError`` when the
  CUDA kernel does not take the shape), "auto" engages it whenever
  ``kernel_applicable`` holds and otherwise records why not, and
  ``False`` keeps the plain read — a supported configuration, not a
  fallback.
- Paged pool (``kv_pages``): compute-dtype or int8 blocks, read through
  the gathered per-slot view (``ops.kvattn.block_table_attention``/
  ``_q8``). With int8, decode-only ticks may instead read through the
  block-table kernel ``ops.kvattn.int8_paged_decode_attention``:
  ``kv_kernel=True`` requires it (raising ``ValueError`` with the reason
  when the CUDA kernel does not take the shape; on a CPU device the
  wrapper runs its plain version), "auto" engages it on CUDA whenever
  ``paged_kernel_applicable`` holds and otherwise records why not, and
  ``False`` keeps the gathered read — a supported configuration, not a
  fallback.

The TPU package's block-size gate and 1,024-token "auto" threshold are
measurements of the TPU kernels and are not carried over.

Genuine exclusions (each raises ``ValueError``): ``kv_pages`` with an MoE
config, legacy per-record paged admission (``prefill_chunk=0``) with the
int8 pool, and an un-honorable ``kv_kernel=True``.

Under a serving mesh (``mesh``) the same pools serve on each rank's share:
dense pools split slots over data and kv heads over tp, paged pools kv
heads over tp with the blocks replicated over data
(``models.generate.kv_sharding`` and its siblings), and under pp each
stage's pools hold its layers only; the kernels read each rank's local
pool (``ops.kvattn.*_sharded``). ``data``/``tp``/``pp`` record the mesh's
extents.
"""

from __future__ import annotations

import dataclasses

__all__ = ["KVBackend", "resolve_kv_backend"]

@dataclasses.dataclass(frozen=True)
class KVBackend:
    """The resolved serving-cache configuration.

    ``layout``: "dense" (per-slot pool) or "paged" (block pool + per-slot
    tables). ``int8``: quantized payloads + group-wise scales.
    ``kernel``: the int8 pool's decode read goes through a kernel's
    wrapper (on a CPU device that wrapper runs its plain version).
    ``kernel_disabled_reason``: why it does not, when int8 was asked for
    with ``kv_kernel`` True or "auto". ``chunked``: paged admission
    prefills through the fused chunk tick (``prefill_chunk`` != 0).
    ``device``: "cuda" or "cpu". ``data``/``tp``/``pp``: the serving
    mesh's extents (1 = no mesh)."""

    layout: str
    int8: bool
    kernel: bool
    kernel_disabled_reason: str | None
    chunked: bool
    device: str
    data: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def paged(self) -> bool:
        return self.layout == "paged"

    @property
    def sharded(self) -> bool:
        return self.data > 1 or self.tp > 1 or self.pp > 1

    def describe(self) -> dict:
        """The ``ServeMetrics`` ``kv_backend`` info payload."""
        return {
            "layout": self.layout,
            "kv_dtype": "int8" if self.int8 else "compute",
            "kernel": self.kernel,
            "kernel_disabled_reason": self.kernel_disabled_reason,
            "chunked": self.chunked,
            "device": self.device,
            "data": self.data,
            "tp": self.tp,
            "pp": self.pp,
        }


def _check_pages(cfg, kv_pages, int8: bool) -> None:
    if kv_pages.prefill_chunk == 0 and int8:
        raise ValueError(
            "legacy per-record paged admission (prefill_chunk=0) is the "
            "compute-dtype baseline; the int8 paged pool requires the "
            "chunked tick (prefill_chunk None or >= 1)"
        )
    if cfg.is_moe:
        raise ValueError(
            "kv_pages does not serve MoE configs: the paged suffix prefill "
            "routes experts densely (decode's rule) while the dense prefill "
            "uses the training dispatch, which would break the cache-on/off "
            "exactness contract"
        )


def _paged_int8_read(cfg, kv_pages, kv_kernel, dev: str):
    """(kernel, reason) for the int8 paged pool's decode read."""
    from torchkafka_tpu_torch.ops.kvattn import paged_kernel_applicable

    if kv_kernel is False:
        return False, None
    rep = cfg.n_heads // cfg.n_kv_heads
    bs = kv_pages.block_size
    if dev == "cuda" and not paged_kernel_applicable(cfg.head_dim, bs, rep):
        reason = (
            f"tiling: head_dim={cfg.head_dim}, block_size={bs}, H/K={rep} "
            "(see ops.kvattn.paged_kernel_applicable)"
        )
        if kv_kernel is True:
            raise ValueError(f"kv_kernel=True cannot be honored here ({reason})")
        return False, reason
    if kv_kernel == "auto" and dev != "cuda":
        return False, f"auto: device={dev!r} is not cuda"
    return True, None


def resolve_kv_backend(
    cfg,
    *,
    kv_dtype: str | None = None,
    kv_kernel: bool | str = "auto",
    kv_pages=None,
    max_len: int,
    device,
    mesh=None,
) -> KVBackend:
    """Validate one pool combination and decide the int8 read; ``mesh``
    (a serving mesh) fills the extents."""
    backend = _resolve(cfg, kv_dtype, kv_kernel, kv_pages, max_len, device)
    if mesh is None:
        return backend
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dataclasses.replace(backend, data=int(sizes.get("data", 1)),
                               tp=int(sizes.get("tp", 1)), pp=int(sizes.get("pp", 1)))


def _resolve(cfg, kv_dtype, kv_kernel, kv_pages, max_len: int, device) -> KVBackend:
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    if not (kv_kernel is True or kv_kernel is False or kv_kernel == "auto"):
        raise ValueError(
            f"kv_kernel must be True, False or 'auto', got {kv_kernel!r}"
        )
    int8 = kv_dtype == "int8"
    if kv_kernel is True and not int8:
        raise ValueError("kv_kernel requires kv_dtype='int8'")
    dev = getattr(device, "type", str(device))
    paged = kv_pages is not None
    layout = "paged" if paged else "dense"
    chunked = paged and kv_pages.prefill_chunk != 0
    if paged:
        _check_pages(cfg, kv_pages, int8)
    if not int8:
        reason = "auto: kv_dtype is not 'int8'" if kv_kernel else None
        return KVBackend(layout, False, False, reason, chunked, dev)
    if paged:
        kernel, reason = _paged_int8_read(cfg, kv_pages, kv_kernel, dev)
        return KVBackend(layout, True, kernel, reason, chunked, dev)
    if kv_kernel is False:
        return KVBackend("dense", True, False, None, False, dev)
    from torchkafka_tpu_torch.ops.kvattn import kernel_applicable

    rep = cfg.n_heads // cfg.n_kv_heads
    if dev == "cuda" and not kernel_applicable(cfg.head_dim, max_len, rep):
        reason = (
            f"tiling: head_dim={cfg.head_dim}, pool_len={max_len}, "
            f"H/K={rep} (see ops.kvattn.kernel_applicable)"
        )
        if kv_kernel is True:
            raise ValueError(f"kv_kernel=True cannot be honored here ({reason})")
        return KVBackend("dense", True, False, reason, False, dev)
    return KVBackend("dense", True, True, None, False, dev)
