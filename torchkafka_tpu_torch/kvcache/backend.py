"""The KV-backend resolver for the serving pool: port of
``torchkafka_tpu/kvcache/backend.py``, dense layout only.

``resolve_kv_backend`` validates one (dtype × kernel) combination and
returns a ``KVBackend`` saying what actually serves. The int8 pool always
reads through ``ops.kvattn.int8_decode_attention_dynlen`` (its CUDA kernel
on the card, its plain version on the CPU), stored K-major so the CPU
and the card share one layout. ``kv_kernel`` True or "auto" with int8
engages that read whenever ``kernel_applicable`` holds; the TPU package's
1,024-token "auto" threshold is a TPU measurement and is not carried over
(PERF.md). The other read of the int8 pool (``kv_kernel=False``), the
paged pool and mesh-sharded pools are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses

__all__ = ["KVBackend", "resolve_kv_backend"]

_INT8_XLA_READ_TODO = (
    "the int8 pool's non-kernel read (kv_kernel=False) is not ported yet "
    "(ROADMAP Queue A, serving follow-up 8)"
)


@dataclasses.dataclass(frozen=True)
class KVBackend:
    """The resolved serving-cache configuration.

    ``int8``: quantized payloads + group-wise scales. ``kernel``: the
    int8 pool reads through the fill-bounded kernel's wrapper (on a CPU
    device that wrapper runs its plain version). ``device``: "cuda" or
    "cpu"."""

    layout: str
    int8: bool
    kernel: bool
    kernel_disabled_reason: str | None
    device: str

    def describe(self) -> dict:
        """The ``ServeMetrics`` ``kv_backend`` info payload."""
        return {
            "layout": self.layout,
            "kv_dtype": "int8" if self.int8 else "compute",
            "kernel": self.kernel,
            "kernel_disabled_reason": self.kernel_disabled_reason,
            "device": self.device,
        }


def resolve_kv_backend(
    cfg,
    *,
    kv_dtype: str | None = None,
    kv_kernel: bool | str = "auto",
    max_len: int,
    device,
) -> KVBackend:
    """Validate a dense-pool combination and decide the int8 read."""
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
    if not int8:
        reason = "auto: kv_dtype is not 'int8'" if kv_kernel else None
        return KVBackend("dense", False, False, reason, dev)
    if kv_kernel is False:
        raise NotImplementedError(_INT8_XLA_READ_TODO)
    from torchkafka_tpu_torch.ops.kvattn import kernel_applicable

    rep = cfg.n_heads // cfg.n_kv_heads
    if dev == "cuda" and not kernel_applicable(cfg.head_dim, max_len, rep):
        reason = (
            f"tiling: head_dim={cfg.head_dim}, pool_len={max_len}, "
            f"H/K={rep} (see ops.kvattn.kernel_applicable)"
        )
        if kv_kernel is True:
            raise ValueError(f"kv_kernel=True cannot be honored here ({reason})")
        raise NotImplementedError(f"{reason}; {_INT8_XLA_READ_TODO}")
    return KVBackend("dense", True, True, None, dev)
