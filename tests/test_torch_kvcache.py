"""The paged pool's host machinery in the port against the JAX package's:
one seeded sequence of allocator and radix-tree operations must give
identical returns, refcounts and free lists through both packages; the
config validation and the KV-backend resolver with ``kv_pages``."""

import dataclasses

import numpy as np
import pytest
import torch

from torchkafka_tpu.kvcache import BlockAllocator as JaxAllocator
from torchkafka_tpu.kvcache import PagedKVConfig as JaxConfig
from torchkafka_tpu.kvcache import RadixCache as JaxRadix
from torchkafka_tpu_torch.kvcache import (
    SINK_BLOCK,
    BlockAllocator,
    PagedKVConfig,
    RadixCache,
    resolve_kv_backend,
)
from torchkafka_tpu_torch.models.transformer import TransformerConfig

BS, P = 4, 16


def _sequence(Allocator, Radix, seed: int) -> list:
    """A seeded admit/retire/evict schedule over prompts drawn from a few
    tenant families; every return value and the allocator's whole state
    after each operation, as plain Python values."""
    rng = np.random.default_rng(seed)
    alloc = Allocator(24)
    radix = Radix(alloc, BS)
    families = rng.integers(0, 50, (4, P), dtype=np.int32)
    live: list[list[int]] = []
    trace = []
    nblk = P // BS
    for _ in range(120):
        op = rng.random()
        if live and op < 0.3:
            trace.append(("decref", alloc.decref(live.pop(int(rng.integers(len(live)))))))
        elif op < 0.4:
            trace.append(("evict", radix.evict(int(rng.integers(1, 4)))))
        else:
            toks = families[rng.integers(len(families))].copy()
            if rng.random() < 0.5:  # another tail: partial-prefix hits
                toks[int(rng.integers(BS, P)):] = rng.integers(0, 50)
            matched = radix.match(toks)
            short = nblk - len(matched) - alloc.available()
            evicted = radix.evict(short) if short > 0 else 0
            priv = alloc.alloc(nblk - len(matched))
            if priv is None:
                if matched:
                    alloc.decref(matched)
                trace.append(("defer", matched, evicted))
            else:
                row = matched + priv
                cap = Radix.matchable_blocks(len(toks), BS)
                added = radix.insert(toks, row[:cap])
                live.append(row)
                trace.append(("admit", matched, evicted, priv, added))
        trace.append((
            alloc.available(), alloc.allocated(), list(alloc._free),
            [alloc.refcount(b) for b in range(alloc.num_blocks)],
            radix.cached_blocks,
        ))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_radix_sequence_matches_jax(seed):
    port = _sequence(BlockAllocator, RadixCache, seed)
    ref = _sequence(JaxAllocator, JaxRadix, seed)
    assert port == ref
    kinds = {t[0] for t in ref if isinstance(t[0], str)}
    assert {"admit", "decref", "evict", "defer"} <= kinds


def test_allocator_invariants_match_jax():
    for Alloc in (BlockAllocator, JaxAllocator):
        a = Alloc(9)
        assert a.usable == 8 and SINK_BLOCK not in a.alloc(8)
        assert a.alloc(1) is None
        with pytest.raises(ValueError, match="sink"):
            a.incref([SINK_BLOCK])
        small = Alloc(4)
        (b,) = small.alloc(1)
        small.decref([b])
        with pytest.raises(ValueError, match="decref on free block"):
            small.decref([b])


@pytest.mark.parametrize("kw,match", [
    ({"block_size": 0, "num_blocks": 8}, "block_size"),
    ({"block_size": 4, "num_blocks": 1}, "num_blocks"),
    ({"block_size": 4, "num_blocks": 8, "prefill_chunk": -1}, "prefill_chunk"),
])
def test_paged_config_validation(kw, match):
    for Config in (PagedKVConfig, JaxConfig):
        with pytest.raises(ValueError, match=match):
            Config(**kw)


def test_paged_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(PagedKVConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig)]
    for bs, m in ((4, 10), (16, 192), (16, 193)):
        assert PagedKVConfig(bs, 8).blocks_per_slot(m) == JaxConfig(bs, 8).blocks_per_slot(m)


def _cfg(**kw):
    base = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=64, max_seq_len=32, dtype=torch.float32)
    return TransformerConfig(**{**base, **kw})


def _resolve(cfg=None, device="cpu", **kw):
    return resolve_kv_backend(cfg or _cfg(), max_len=24, device=device, **kw)


def test_resolve_exclusions_raise():
    with pytest.raises(ValueError, match="prefill_chunk"):
        _resolve(kv_dtype="int8", kv_pages=PagedKVConfig(BS, 16, prefill_chunk=0))
    moe = _cfg(n_experts=4, expert_top_k=2)
    with pytest.raises(ValueError, match="MoE"):
        _resolve(moe, kv_pages=PagedKVConfig(BS, 16))


@pytest.mark.parametrize("kv_kernel,device,kernel,reason", [
    (True, "cpu", True, None),  # the wrapper runs its plain version on the CPU
    ("auto", "cpu", False, "auto"),  # auto engages on CUDA only
    (False, "cpu", False, None),  # the gathered read, a supported configuration
    ("auto", "cuda", True, None),
    (False, "cuda", False, None),
])
def test_resolve_paged_int8_read(kv_kernel, device, kernel, reason):
    bk = _resolve(kv_dtype="int8", kv_kernel=kv_kernel, device=device,
                  kv_pages=PagedKVConfig(BS, 16, prefill_chunk=BS))
    d = bk.describe()
    assert bk.paged and bk.int8 and bk.kernel == kernel
    assert d["layout"] == "paged" and d["chunked"] and d["device"] == device
    if reason is None:
        assert d["kernel_disabled_reason"] is None
    else:
        assert reason in d["kernel_disabled_reason"]


def test_resolve_unhonorable_kernel_names_reason():
    """On CUDA the kernel's own shape terms decide (head_dim 8 is below its
    16-wide row loads): True raises with the reason, auto records it."""
    small = _cfg(d_model=32)  # head_dim 8
    pages = PagedKVConfig(BS, 16)
    with pytest.raises(ValueError, match="cannot be honored.*tiling"):
        _resolve(small, device="cuda", kv_dtype="int8", kv_kernel=True, kv_pages=pages)
    bk = _resolve(small, device="cuda", kv_dtype="int8", kv_pages=pages)
    assert not bk.kernel and "tiling" in bk.kernel_disabled_reason


def test_resolve_compute_and_dense_layouts():
    bk = _resolve(kv_pages=PagedKVConfig(BS, 16, prefill_chunk=0))
    assert bk.describe() == {
        "layout": "paged", "kv_dtype": "compute", "kernel": False,
        "kernel_disabled_reason": "auto: kv_dtype is not 'int8'",
        "chunked": False, "device": "cpu", "data": 1, "tp": 1,
    }
    dense = _resolve(kv_dtype="int8")
    assert dense.layout == "dense" and dense.kernel and not dense.chunked
