"""Paged KV-cache pool with radix-tree prefix reuse for the serving path.

Host-side machinery: ``BlockAllocator`` — refcounted free-list blocks,
block 0 reserved as the sink for idle-slot writes; ``RadixCache`` —
prompt-prefix tree mapping whole block runs, LRU-evicting unreferenced
leaves; ``PagedKVConfig`` — the ``StreamingGenerator(kv_pages=...)``
knob; ``resolve_kv_backend`` — the capability probe deciding how the
pool layout, payload dtype and read compose for one server;
``HostTier``/``TierConfig`` — the host-RAM tier (optional disk spill)
that cold radix blocks demote to instead of being freed
(``StreamingGenerator(kv_tier=...)``).
"""

from torchkafka_tpu_torch.kvcache.backend import KVBackend, resolve_kv_backend
from torchkafka_tpu_torch.kvcache.blocks import (
    SINK_BLOCK,
    BlockAllocator,
    PagedKVConfig,
)
from torchkafka_tpu_torch.kvcache.radix import RadixCache
from torchkafka_tpu_torch.kvcache.tier import HostTier, TierConfig

__all__ = [
    "BlockAllocator",
    "HostTier",
    "KVBackend",
    "PagedKVConfig",
    "RadixCache",
    "SINK_BLOCK",
    "TierConfig",
    "resolve_kv_backend",
]
