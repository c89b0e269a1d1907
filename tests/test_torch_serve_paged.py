"""The paged slice whole: the port's paged server (radix prefix reuse,
chunked or per-record prefill, block-table reads) against the JAX
package's paged server on the same broker content, from the same
parameters, at f32. Greedy tokens per record, committed offsets and the
prefix-cache and chunked-prefill counts must be identical. The JAX side
reads its int8 pool through the gathered view (``kv_kernel=False``); the
port's int8 decode-only ticks read through the block-table kernel's
wrapper, whose plain version runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.generate import generate as jax_generate
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch import serve as port_serve
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.records import TopicPartition

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)
N, PARTS, SLOTS, P, MAX_NEW, TICKS, BS = 12, 2, 4, 16, 8, 3, 4
TENANTS, SYS_LEN = 3, 8  # two whole blocks of tenant system prompt


def _pages(chunk=None, num_blocks=40):
    return {"block_size": BS, "num_blocks": num_blocks, "prefill_chunk": chunk}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(11), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    rng = np.random.default_rng(4)
    system = rng.integers(0, SHAPE["vocab_size"], (TENANTS, SYS_LEN), dtype=np.int32)
    prompts = rng.integers(0, SHAPE["vocab_size"], (N, P), dtype=np.int32)
    prompts[:, :SYS_LEN] = system[np.arange(N) % TENANTS]
    # EOS = the modal generated token of a lockstep probe, so some
    # generations stop early and slots (and their blocks) recycle.
    probe = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompts[:8]), MAX_NEW))
    toks, counts = np.unique(probe[:, 1:], return_counts=True)
    return jcfg, jparams, pcfg, params, prompts, int(toks[counts.argmax()])


def _serve(which, model, *, max_records=None, **kw):
    jcfg, jparams, pcfg, params, prompts, eos = model
    if which == "jax":
        broker = tk.InMemoryBroker()
        Consumer, TP = tk.MemoryConsumer, tk.TopicPartition
    else:
        broker, Consumer, TP = InMemoryBroker(), MemoryConsumer, TopicPartition
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), key=b"tenant-%d" % (i % TENANTS),
                       partition=i % PARTS)
    consumer = Consumer(broker, "t", group_id="g")
    base = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, eos_id=eos,
                commit_every=SLOTS, ticks_per_sync=TICKS)
    if which == "jax":
        kw["kv_kernel"] = False
        server = JaxServer(consumer, jparams, jcfg, **base, **kw)
    else:
        server = StreamingGenerator(consumer, params, pcfg, device="cpu", **base, **kw)
    server.warmup()
    got = {
        (r.topic, r.partition, r.offset): out.tolist()
        for r, out in server.run(max_records=max_records, idle_timeout_ms=0)
    }
    consumer.close()
    committed = [broker.committed("g", TP("t", p)) for p in range(PARTS)]
    return got, committed, server


def _counts(server):
    cache = {k: v for k, v in server.metrics.cache_summary().items() if k != "tier"}
    return cache, server.metrics.chunk_summary()


@pytest.mark.parametrize("kv_dtype,chunk,kernel", [
    (None, None, "auto"), (None, BS, "auto"), (None, 0, "auto"),
    ("int8", None, True), ("int8", BS, True),
    ("int8", None, False), ("int8", BS, False),
], ids=["compute-auto", "compute-bs", "compute-legacy", "int8-auto-k5",
        "int8-bs-k5", "int8-auto-gathered", "int8-bs-gathered"])
def test_tokens_commits_and_counts_match(model, kv_dtype, chunk, kernel):
    kw = dict(kv_dtype=kv_dtype, kv_pages=_pages(chunk))
    ref, ref_committed, js = _serve("jax", model, **kw)
    got, committed, ps = _serve("port", model, kv_kernel=kernel, **kw)
    assert len(ref) == N
    assert got == ref
    assert committed == ref_committed == [N // PARTS] * PARTS
    assert _counts(ps) == _counts(js)
    cache, chunks = _counts(ps)
    assert cache["hits"] > 0 and cache["prefill_tokens"] < N * P
    assert (chunks["chunk_ticks"] > 0) == (chunk != 0)
    assert ps.metrics.truncated.count > 0  # EOS recycled slots mid-stream
    assert ps.pending_admissions == 0 and not ps._prefill_queue
    kb = ps.metrics.summary()["kv_backend"]
    assert kb["layout"] == "paged" and kb["chunked"] == (chunk != 0)
    assert kb["kernel"] == (kernel is True)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pressure_defers_and_evicts_identically(model, kv_dtype):
    """A pool holding one and a half slots' worth of blocks: admissions
    defer under pressure, cached prefixes are evicted, and the port still
    serves the JAX package's tokens, offsets and counts."""
    kw = dict(kv_dtype=kv_dtype, kv_pages=_pages(num_blocks=10))
    ref, ref_committed, js = _serve("jax", model, **kw)
    got, committed, ps = _serve("port", model, **kw)
    assert got == ref and committed == ref_committed
    assert _counts(ps) == _counts(js)
    cache, _ = _counts(ps)
    assert cache["deferrals"] > 0 and cache["evictions"] > 0
    assert ps.pending_admissions == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_max_records_cut_matches(model, kv_dtype):
    """``run(max_records=)`` under deferrals: the admission budget
    neither starves the deferred backlog nor over-offers."""
    kw = dict(kv_dtype=kv_dtype, kv_pages=_pages(num_blocks=10), max_records=7)
    ref, ref_committed, _ = _serve("jax", model, **kw)
    got, committed, ps = _serve("port", model, **kw)
    assert len(got) == len(ref) == 7
    assert got == ref and committed == ref_committed


def test_pool_too_small_falls_back_to_dense(model, caplog):
    """A pool that cannot hold one slot serves the dense pool instead of
    deadlocking, counted and logged, with the dense run's output."""
    import logging

    caplog.set_level(logging.WARNING, logger="torchkafka_tpu_torch.serve")
    dense, dense_committed, _ = _serve("port", model)
    got, committed, ps = _serve("port", model, kv_pages=_pages(num_blocks=3))
    assert got == dense and committed == dense_committed
    assert ps.metrics.cache_fallbacks.count == 1
    assert ps._kv_pages is None
    assert ps.metrics.summary()["kv_backend"]["layout"] == "dense"
    assert any("falling back" in r.message for r in caplog.records)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_matches_port_dense(model, kv_dtype):
    """The JAX package's own differential, on the port: cache on (paged,
    radix hits) against cache off (dense pool), identical tokens."""
    dense, dense_committed, _ = _serve("port", model, kv_dtype=kv_dtype)
    got, committed, ps = _serve("port", model, kv_dtype=kv_dtype,
                                kv_pages=_pages())
    assert got == dense and committed == dense_committed
    assert ps.metrics.prefix_hits.count > 0


def test_kernel_reads_every_decode_only_tick(model, monkeypatch):
    """With the int8 pool and ``kv_kernel=True`` each layer of every decode
    tick but the first of a chunk-carrying tick block reads through the
    block-table kernel's wrapper: n_layers × (decode_ticks − chunk_ticks)
    calls (the count ``chip_smoke.py`` requires of the launches)."""
    calls = []
    real = port_serve.int8_paged_decode_attention

    def counted(*args):
        calls.append(1)
        return real(*args)

    jcfg, jparams, pcfg, params, prompts, eos = model
    broker = InMemoryBroker()
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS)
    consumer = MemoryConsumer(broker, "t", group_id="g")
    server = StreamingGenerator(
        consumer, params, pcfg, slots=SLOTS, prompt_len=P, max_new=MAX_NEW,
        ticks_per_sync=TICKS, kv_dtype="int8", kv_kernel=True,
        kv_pages=_pages(), device="cpu",
    )
    server.warmup()
    monkeypatch.setattr(port_serve, "int8_paged_decode_attention", counted)
    assert len(list(server.run(idle_timeout_ms=0))) == N
    m = server.metrics.summary()
    chunk_ticks = m["chunked_prefill"]["chunk_ticks"]
    assert chunk_ticks > 0
    assert len(calls) == SHAPE["n_layers"] * (m["decode_ticks"] - chunk_ticks) > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_recycled_blocks_ignore_stale_tail(model, kv_dtype):
    """The sink invariant as an asserted property: after every admission,
    poison EVERY pool position except the live slots' readable prefix —
    freed blocks re-allocated later, the sink block, each slot's
    not-yet-written tail. Outputs must equal an unpoisoned run's, because
    every position is written before it first becomes readable. (No
    prefix sharing here: a poisoned cached block would change outputs.)"""
    _, _, pcfg, params, _, _ = model
    prompts = np.random.default_rng(9).integers(0, SHAPE["vocab_size"], (6, P),
                                                dtype=np.int32)

    def drive(poison):
        broker = InMemoryBroker()
        broker.create_topic("p", partitions=2)
        for i in range(len(prompts)):
            broker.produce("p", prompts[i].tobytes(), partition=i % 2)
        consumer = MemoryConsumer(broker, "p", group_id="gs")
        server = StreamingGenerator(
            consumer, params, pcfg, slots=2, prompt_len=P, max_new=MAX_NEW,
            ticks_per_sync=TICKS, kv_dtype=kv_dtype,
            kv_pages={"block_size": BS, "num_blocks": 14}, device="cpu",
        )
        out = {}
        while len(out) < len(prompts):
            recs = consumer.poll(max_records=server.free_slots(), timeout_ms=0)
            if recs:
                server.note_fetched(recs)
                server.admit_records(recs)
                if poison:
                    _poison(server)
            for rec, toks in server.step():
                out[(rec.partition, rec.offset)] = toks.tolist()
        server.flush_commits()
        consumer.close()
        return out

    got, ref = drive(True), drive(False)
    assert len(ref) == len(prompts) and got == ref


def _poison(s):
    keep = np.zeros((s._kv_pages.num_blocks, BS), bool)
    pos = s._pos.numpy()
    for i in range(s._slots):
        if s._active[i]:
            for p in range(int(pos[i])):  # readable: [0, pos)
                keep[s._table_np[i, p // BS], p % BS] = True
    stale = torch.from_numpy(~keep)
    if len(s._pools) == 2:  # compute dtype: [L, NB, bs, K, Dh]
        for pool in s._pools:
            pool[:, stale] = 1e9
    else:  # int8, K-major per block: [L, NB, K, bs, (Dh)]
        st = stale[:, None, :].expand(-1, s._pools[0].shape[2], -1)
        for pool in s._pools:
            pool[:, st] = 127 if pool.dtype == torch.int8 else 1e9
