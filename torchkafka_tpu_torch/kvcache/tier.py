"""Host-memory tier for cold radix-cache blocks (+ optional disk spill).

Copy of ``torchkafka_tpu/kvcache/tier.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The HBM block pool holds the HOT prefix state; this module is where cold
prefixes go to survive eviction. Without it, ``radix.evict`` FREES an
unreferenced leaf — the prefix re-prefills from scratch on its next hit,
and at production tenant counts (far more distinct prefixes than pool
blocks) the tree thrashes: TRAFFIC_BENCH.json's hit-by-Zipf-rank cliff
(0.89 → 0.60) is the small-scale preview. With a tier, eviction DEMOTES
the block's KV payload to a bounded pinned-host-RAM store instead
(SGLang's RadixAttention hierarchy shape), and a radix match that walks
off the in-HBM tree PROMOTES matching tier entries back into fresh pool
blocks — so the effective prefix-cache capacity is host memory (plus an
optional disk tier behind it), not pool blocks.

Contracts, each property-tested against a brute-force reference
(tests/test_tier.py):

- **byte exactness** — a demoted payload promotes back bitwise
  identical (the tier stores copies, never views; disk round-trips
  through ``numpy`` save/load). Token-exactness of tiered serving never
  *depends* on this (a tier miss just re-prefills, the same advisory
  contract as eviction), but it is what makes a promotion and a
  re-prefill indistinguishable.
- **bounded** — RAM occupancy never exceeds ``capacity_bytes``; LRU
  victims spill to ``spill_dir`` when configured, else drop.
- **deterministic** — LRU ticks on a monotone op counter (no clocks),
  so the same put/take sequence always evicts/spills the same entries:
  the property chaos-replay differentials rest on.

Keyed by the PREFIX TOKEN BYTES (the root→node token path), not by
physical block id: a tier entry is a statement about a token prefix, and
physical ids are meaningless across demote/promote cycles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Host-tier policy (``StreamingGenerator``'s ``kv_tier=``).

    ``capacity_bytes``: RAM bound for demoted block payloads (KV bytes
    only; index overhead is not counted). ``spill_dir``: when set, RAM-
    LRU victims spill to one ``.npy``-concatenated file each under this
    directory instead of being dropped — the (unbounded) cold tier
    behind the warm one. A ``capacity_bytes`` of 0 with a ``spill_dir``
    is a pure disk tier."""

    capacity_bytes: int
    spill_dir: str | None = None

    def __post_init__(self) -> None:
        if self.capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {self.capacity_bytes}"
            )


class _Entry:
    __slots__ = ("arrays", "nbytes", "stamp", "path")

    def __init__(self, arrays, nbytes: int, stamp: int, path=None):
        self.arrays = arrays  # tuple[np.ndarray, ...] | None (spilled)
        self.nbytes = nbytes
        self.stamp = stamp
        self.path = path  # spill file when arrays is None


class HostTier:
    """Bounded host-RAM store of demoted block payloads, LRU within,
    optional disk spill behind. One payload is the tuple of per-pool
    arrays for one block (2 arrays on compute-dtype pools, 4 on int8
    payload+scale pools) — the tier is layout-blind: it stores and
    returns exactly the bytes it was handed.

    ``put`` copies (the caller's buffers may be device-backed views);
    ``take`` POPS — a promoted prefix lives in the pool again and
    re-demotes on its next eviction, so a block's bytes are accounted
    in exactly one tier at a time."""

    def __init__(self, config: TierConfig) -> None:
        self.config = config
        self._entries: dict[bytes, _Entry] = {}
        self._clock = 0
        self.occupancy_bytes = 0  # RAM tier only (spilled bytes excluded)
        self.spilled_bytes = 0
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0  # dropped entirely (no spill dir)
        self.spills = 0
        self.spill_loads = 0
        self.rejected = 0  # single payload larger than the whole RAM bound
        if config.spill_dir is not None:
            os.makedirs(config.spill_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._entries)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def contains(self, key: bytes) -> bool:
        return key in self._entries

    # ----------------------------------------------------------- spill io

    def _spill_path(self, key: bytes) -> str:
        name = hashlib.sha1(key).hexdigest() + ".npy"
        return os.path.join(self.config.spill_dir, name)

    @staticmethod
    def _write_arrays(path: str, arrays) -> None:
        with open(path, "wb") as f:
            np.save(f, np.int64(len(arrays)), allow_pickle=False)
            for a in arrays:
                np.save(f, a, allow_pickle=False)

    @staticmethod
    def _read_arrays(path: str):
        with open(path, "rb") as f:
            n = int(np.load(f, allow_pickle=False))
            return tuple(np.load(f, allow_pickle=False) for _ in range(n))

    # ---------------------------------------------------------------- api

    def put(self, key: bytes, arrays) -> None:
        """Demote one block's payload. Overwrites an existing entry for
        the same prefix (idempotent re-demotion); LRU-spills/drops until
        the RAM bound holds again."""
        arrays = tuple(np.array(a, copy=True) for a in arrays)
        nbytes = sum(a.nbytes for a in arrays)
        self.puts += 1
        old = self._entries.pop(key, None)
        if old is not None:
            self._forget(old)
        if nbytes > self.config.capacity_bytes:
            if self.config.spill_dir is not None:
                path = self._spill_path(key)
                self._write_arrays(path, arrays)
                self._entries[key] = _Entry(None, nbytes, self._tick(), path)
                self.spilled_bytes += nbytes
                self.spills += 1
            else:
                self.rejected += 1
            return
        self._entries[key] = _Entry(arrays, nbytes, self._tick())
        self.occupancy_bytes += nbytes
        self._enforce_bound()

    def take(self, key: bytes):
        """Pop and return the payload for ``key`` (promotion), or None.
        Disk-spilled entries load back transparently."""
        e = self._entries.pop(key, None)
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        if e.arrays is None:
            arrays = self._read_arrays(e.path)
            self.spill_loads += 1
            self._forget(e)
            return arrays
        self.occupancy_bytes -= e.nbytes
        return e.arrays

    def _forget(self, e: _Entry) -> None:
        if e.arrays is None:
            self.spilled_bytes -= e.nbytes
            try:
                os.unlink(e.path)
            except OSError:
                pass
        else:
            self.occupancy_bytes -= e.nbytes

    def _enforce_bound(self) -> None:
        while self.occupancy_bytes > self.config.capacity_bytes:
            victim_key = min(
                (k for k, e in self._entries.items() if e.arrays is not None),
                key=lambda k: self._entries[k].stamp,
            )
            e = self._entries[victim_key]
            self.occupancy_bytes -= e.nbytes
            if self.config.spill_dir is not None:
                path = self._spill_path(victim_key)
                self._write_arrays(path, e.arrays)
                e.arrays = None
                e.path = path
                self.spilled_bytes += e.nbytes
                self.spills += 1
            else:
                del self._entries[victim_key]
                self.evictions += 1

    def summary(self) -> dict:
        return {
            "entries": len(self._entries),
            "occupancy_bytes": self.occupancy_bytes,
            "spilled_bytes": self.spilled_bytes,
            "capacity_bytes": self.config.capacity_bytes,
            "puts": self.puts,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "spills": self.spills,
            "spill_loads": self.spill_loads,
            "rejected": self.rejected,
        }
