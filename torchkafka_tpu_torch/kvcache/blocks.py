"""Paged KV-cache block pool: allocator, refcounts, block tables.

Copy of ``torchkafka_tpu/kvcache/blocks.py`` (jax-free; the port keeps
its own copy). The serving path's answer to "device memory scales as
pool × max_context": instead of a dense per-slot cache
``[B, max_len, K, Dh]``, the pool is a fixed set of fixed-size BLOCKS
``[num_blocks, block_size, K, Dh]`` and each decode slot maps logical
positions to physical blocks through a block table ``[B, max_blocks]``
— the static-shape version of vLLM's PagedAttention. Every shape the
device sees is static: the pool, the tables, the gathered per-slot
view; only the HOST-side mapping (this module) is dynamic.

Blocks are REFCOUNTED so several slots can map the same physical
prefix blocks (RadixCache hands them out, kvcache/radix.py): a cached
prefix block carries one reference from the radix tree plus one per
slot currently mapping it. A block returns to the free list exactly
when its count reaches zero — never while anything can still read it.

Physical block 0 is the SINK: it backs the table rows of idle slots,
so the decode tick's unconditional scatter write (an inactive slot
still writes its frozen position — masking the write would cost a
pool-sized select per layer, serve.py's lesson) lands in a block no
live table ever references, instead of corrupting a block that was
freed and re-allocated to another slot. The allocator never hands out
block 0.

Host-side and deterministic: LIFO free list, explicit refcounts, no
clocks — the same admission sequence always produces the same physical
layout, which is what makes the cache-on/cache-off differential (and
chaos replay) exactly comparable.
"""

from __future__ import annotations

import dataclasses

SINK_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Configuration for a paged slot pool (``StreamingGenerator``'s
    ``kv_pages=``).

    ``block_size``: tokens per physical block — sharing granularity
    (only whole blocks are shared; a finer size shares more of a
    prefix but makes the table longer). ``num_blocks``: physical
    blocks in the pool INCLUDING the sink; usable capacity is
    ``num_blocks - 1``. A pool smaller than one slot's worst case
    (``ceil(max_len / block_size)`` blocks) cannot serve at all —
    the server then falls back to the dense cache-off path
    (gracefully, with a warning) rather than deadlocking admission.

    ``prefill_chunk``: admission mode. ``None`` (default) = CHUNKED
    prefill fused into the decode tick — admission enqueues each
    prompt's uncached suffix host-side and every tick processes a
    bounded, statically-shaped chunk of those tokens ALONGSIDE all
    decode slots in ONE layer sweep (Sarathi-style: prefill rides
    the weight stream decode already pays for), with the chunk width
    auto-sized to ``slots * prompt_len`` (every admission a single
    serving quantum can offer completes in one tick, preserving the
    per-record completion timing of the per-record path shifted by
    exactly one tick). An explicit int >= 1 fixes the chunk width —
    smaller widths bound how much prefill work any one tick carries
    (the decode-latency lever under prompt storms; a prompt storm
    then drains FIFO at ``prefill_chunk`` tokens per tick while
    in-flight decode keeps emitting one token per slot per tick).
    ``0`` = the LEGACY per-record admission (one suffix-prefill
    pass per record) — kept as the baseline and differential
    reference, compute-dtype pools only.
    """

    block_size: int
    num_blocks: int
    prefill_chunk: int | None = None

    def __post_init__(self) -> None:
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the sink), "
                f"got {self.num_blocks}"
            )
        if self.prefill_chunk is not None and self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be None (auto), 0 (legacy per-record "
                f"admission) or >= 1, got {self.prefill_chunk}"
            )

    def blocks_per_slot(self, max_len: int) -> int:
        """Blocks one slot needs to hold ``max_len`` positions."""
        return -(-max_len // self.block_size)


class BlockAllocator:
    """Free-list block allocator with refcounts.

    ``alloc(n)`` hands out ``n`` blocks at refcount 1 (the caller's
    slot reference) or ``None`` if the free list is short — the caller
    decides whether to evict (RadixCache) or defer the admission.
    ``incref``/``decref`` move cache/slot references; a decref to zero
    frees the block. Counts can never go negative: ``decref`` on a
    free block raises, which is how the property tests pin the
    invariant.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the sink), "
                f"got {num_blocks}"
            )
        self.num_blocks = num_blocks
        # LIFO free list over [1, num_blocks): low ids first out, so
        # identical admission sequences produce identical layouts.
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks

    @property
    def usable(self) -> int:
        """Allocatable blocks (the pool minus the sink)."""
        return self.num_blocks - 1

    def available(self) -> int:
        return len(self._free)

    def allocated(self) -> int:
        return self.usable - len(self._free)

    def occupancy(self) -> float:
        return self.allocated() / self.usable if self.usable else 0.0

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh blocks at refcount 1, or None (nothing allocated)
        if the free list holds fewer than ``n`` — allocation is
        all-or-nothing so a half-admitted slot never exists."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == SINK_BLOCK:
                raise ValueError("the sink block is never referenced")
            if self._ref[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self._ref[b] += 1

    def decref(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; blocks reaching zero return to
        the free list. Returns the freed blocks (for metrics/tests)."""
        freed = []
        for b in blocks:
            if b == SINK_BLOCK:
                raise ValueError("the sink block is never referenced")
            if self._ref[b] <= 0:
                raise ValueError(f"decref on free block {b} (refcount bug)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed
