"""Host-side radix tree over prompt token prefixes → physical block runs.

Copy of ``torchkafka_tpu/kvcache/radix.py`` (jax-free), its import
re-rooted. The port's server passes ``tier``/``read_block``/``write_block``
when it is given ``kv_tier=``.

Cross-request prefix reuse for the paged serving pool (SGLang's
RadixAttention shape, block-granular): prompts streamed from a Kafka
topic that share a tenant/system-prompt prefix map the SAME physical
blocks for the shared part and prefill only the uncached suffix.

Granularity is one BLOCK of ``block_size`` tokens per tree edge — only
whole blocks are shared, so a shared block is always entirely inside
the matched prefix and is never written again after it is cached
(decode writes land strictly beyond the prompt; the straddling partial
block stays private). That is what makes copy-on-write unnecessary.

The match is capped at ``prompt_len - 1`` tokens: admission always
prefills at least the prompt's final token, because sampling token 0
needs the last position's logits (the standard full-hit rule).

EVICTION IS ADVISORY: the tree only ever holds blocks alive (one cache
reference each); evicting an unreferenced leaf frees its block, and the
only consequence is that a future prompt re-prefills — token-exactness
NEVER depends on what the cache holds. LRU over leaves, cascading
upward while parents become unreferenced leaves themselves.

Determinism: no wall clock — the LRU ticks on a monotone counter
advanced per operation, so the same admission sequence evicts the same
blocks (the property the chaos-replay differential rests on).
"""

from __future__ import annotations

from torchkafka_tpu_torch.kvcache.blocks import BlockAllocator


class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "stamp")

    def __init__(self, chunk: tuple, block: int, parent: "_Node | None"):
        self.chunk = chunk          # the block_size tokens this edge spells
        self.block = block          # physical block holding their k/v
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.stamp = 0              # LRU tick of the last match/insert touch


class RadixCache:
    """Prefix cache over an allocator's blocks.

    The tree owns ONE reference on every block it maps (taken at
    ``insert``, dropped at eviction); ``match`` adds a slot reference
    per returned block, which the server drops via
    ``allocator.decref`` when the slot retires. ``evict`` frees LRU
    leaves whose blocks carry no reference beyond the tree's own.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int, *,
                 tier=None, read_block=None, write_block=None) -> None:
        """``tier``/``read_block``/``write_block``: the host-RAM tier
        (kvcache/tier.py ``HostTier``) plus the pool I/O the server
        supplies — ``read_block(block_id) -> payload`` fetches a block's
        KV bytes to host (demotion source), ``write_block(block_id,
        payload)`` scatters them back (promotion sink). With a tier,
        ``evict`` DEMOTES unreferenced leaves instead of just freeing
        them, and ``match`` PROMOTES tier entries that extend a prefix
        walk into freshly allocated blocks — so a "miss" against the
        in-HBM tree can still be a hit against host memory. Both sides
        stay advisory: a tier miss (or a promotion that finds no free
        block) simply re-prefills, exactly like eviction always did."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if tier is not None and (read_block is None or write_block is None):
            raise ValueError(
                "a tier needs read_block and write_block (the pool I/O "
                "that moves payloads between HBM and the tier)"
            )
        self._alloc = allocator
        self._bs = block_size
        self._tier = tier
        self._read_block = read_block
        self._write_block = write_block
        self._root = _Node((), -1, None)
        self._clock = 0
        self.cached_blocks = 0
        # Tier traffic counters (the server mirrors them onto
        # ServeMetrics after each admission/eviction sweep).
        self.demotions = 0
        self.promotions = 0
        self.tier_hits = 0

    # ------------------------------------------------------------- helpers

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens, limit_blocks: int):
        bs = self._bs
        n = min(limit_blocks, len(tokens) // bs)
        for j in range(n):
            yield tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])

    @staticmethod
    def matchable_blocks(prompt_len: int, block_size: int) -> int:
        """Whole blocks of a prompt that can ever be shared: the final
        token is always prefilled (its logits sample token 0), so the
        shareable prefix is at most ``prompt_len - 1`` tokens."""
        return max(0, (prompt_len - 1) // block_size)

    # ----------------------------------------------------------------- api

    @staticmethod
    def _prefix_key(chunks: list[tuple]) -> bytes:
        """Tier key for the prefix spelled by ``chunks`` (root→node token
        path as int32 bytes) — physical ids are meaningless across
        demote/promote cycles, token prefixes are not."""
        import numpy as np

        return np.asarray(
            [t for c in chunks for t in c], np.int32
        ).tobytes()

    def _node_key(self, node: _Node) -> bytes:
        chunks = []
        while node is not self._root:
            chunks.append(node.chunk)
            node = node.parent
        return self._prefix_key(chunks[::-1])

    def match(self, tokens) -> list[int]:
        """Longest cached whole-block prefix of ``tokens`` (capped at
        ``matchable_blocks``) → physical block ids in logical order.
        Takes one SLOT reference per returned block (caller decrefs when
        the slot retires) and refreshes the path's LRU stamps.

        With a tier attached, a walk that falls off the in-HBM tree
        keeps going against the tier: each matching tier entry is
        PROMOTED — a fresh block allocated (never evicting: promotion
        under pool pressure just stops, the prefix re-prefills), the
        payload scattered back via ``write_block``, and a node inserted
        holding the tree's reference — before the walk continues. The
        promoted bytes are exactly the demoted bytes, which are exactly
        what a re-prefill would compute, so serving stays token-exact
        whether this returns a block or not."""
        stamp = self._tick()
        cap = self.matchable_blocks(len(tokens), self._bs)
        node = self._root
        out: list[int] = []
        path: list[tuple] = []
        for chunk in self._chunks(tokens, cap):
            child = node.children.get(chunk)
            if child is None and self._tier is not None:
                key = self._prefix_key(path + [chunk])
                if self._tier.contains(key):
                    blk = self._alloc.alloc(1)
                    if blk is None:
                        break  # pool pressure: stop promoting, re-prefill
                    payload = self._tier.take(key)
                    self._write_block(blk[0], payload)
                    child = _Node(chunk, blk[0], node)
                    node.children[chunk] = child
                    self.cached_blocks += 1
                    self.promotions += 1
                    self.tier_hits += 1
            if child is None:
                break
            child.stamp = stamp
            out.append(child.block)
            node = child
            path.append(chunk)
        if out:
            self._alloc.incref(out)
        return out

    def insert(self, tokens, blocks: list[int]) -> int:
        """Register ``blocks`` (the slot's table entries for the first
        ``len(blocks)`` whole blocks of ``tokens``) as cached prefix
        blocks. Existing nodes are left in place (the slot got those
        blocks FROM the tree, so the ids must agree); new nodes adopt
        the slot's private blocks with one cache reference each.
        Returns the number of blocks newly cached."""
        stamp = self._tick()
        node = self._root
        added = 0
        for j, chunk in enumerate(self._chunks(tokens, len(blocks))):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, blocks[j], node)
                node.children[chunk] = child
                self._alloc.incref([blocks[j]])
                self.cached_blocks += 1
                added += 1
            elif child.block != blocks[j]:
                raise AssertionError(
                    f"radix divergence at depth {j}: cached block "
                    f"{child.block} vs slot block {blocks[j]} — a slot's "
                    "table must reuse the tree's block wherever a node "
                    "exists (match-before-insert contract)"
                )
            child.stamp = stamp
            node = child
        return added

    # ------------------------------------------------------------ eviction

    def _evictable_leaves(self) -> list[_Node]:
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif self._alloc.refcount(child.block) == 1:
                    out.append(child)  # only the tree's own reference
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` via LRU leaf eviction (cascading: a
        parent that becomes an unreferenced leaf is immediately
        eligible). Returns blocks actually freed — fewer than asked is
        normal when the rest of the tree is pinned by live slots."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.stamp)
            while victim is not None and freed < n_blocks:
                parent = victim.parent
                assert parent is not None
                if self._tier is not None:
                    # DEMOTE before freeing: the block's bytes are valid
                    # until a later alloc rewrites them, so the host copy
                    # taken here is exact. The tier's own LRU/spill
                    # policy decides how long the prefix survives.
                    self._tier.put(
                        self._node_key(victim),
                        self._read_block(victim.block),
                    )
                    self.demotions += 1
                del parent.children[victim.chunk]
                self._alloc.decref([victim.block])
                self.cached_blocks -= 1
                freed += 1
                # Cascade upward while the parent is itself an
                # unreferenced leaf (saves a full re-scan per block).
                victim = (
                    parent
                    if (
                        parent is not self._root
                        and not parent.children
                        and self._alloc.refcount(parent.block) == 1
                    )
                    else None
                )
        return freed
