"""Sampled serving: the port's server against the JAX package's at f32, on
the same broker content, from the same parameters and base key
(``temperature=0.9, top_k=16, rng=key(11)``). Tokens per record and
committed offsets must be identical on the dense pool, the paged pool and
the chunked paged pool, at two slot counts: a record's tokens depend on
its key and token index only, never on the slot it lands in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.records import TopicPartition
from torchkafka_tpu_torch.utils import prng

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)
N, PARTS, P, MAX_NEW, TICKS, BS = 10, 2, 16, 8, 3, 4
TENANTS, SYS_LEN = 3, 8
SAMPLED = dict(temperature=0.9, top_k=16)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(2), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    rng = np.random.default_rng(8)
    system = rng.integers(0, SHAPE["vocab_size"], (TENANTS, SYS_LEN), dtype=np.int32)
    prompts = rng.integers(0, SHAPE["vocab_size"], (N, P), dtype=np.int32)
    prompts[:, :SYS_LEN] = system[np.arange(N) % TENANTS]
    # EOS = the modal sampled token of a run without one, so some
    # generations stop early and slots refill mid-stream.
    probe, _, _ = _serve("port", (jcfg, jparams, pcfg, params, prompts, None),
                         slots=4)
    toks, counts = np.unique([t for out in probe.values() for t in out[1:]],
                             return_counts=True)
    return jcfg, jparams, pcfg, params, prompts, int(toks[counts.argmax()])


def _serve(which, model, *, slots, **kw):
    jcfg, jparams, pcfg, params, prompts, eos = model
    if which == "jax":
        broker = tk.InMemoryBroker()
        Consumer, TP = tk.MemoryConsumer, tk.TopicPartition
    else:
        broker, Consumer, TP = InMemoryBroker(), MemoryConsumer, TopicPartition
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS)
    consumer = Consumer(broker, "t", group_id="g")
    base = dict(slots=slots, prompt_len=P, max_new=MAX_NEW, eos_id=eos,
                commit_every=slots, ticks_per_sync=TICKS, **{**SAMPLED, **kw})
    if which == "jax":
        server = JaxServer(consumer, jparams, jcfg, kv_kernel=False,
                           rng=jax.random.key(11), **base)
    else:
        server = StreamingGenerator(consumer, params, pcfg, device="cpu",
                                    rng=prng.key(11), **base)
    server.warmup()
    got = {
        (r.topic, r.partition, r.offset): out.tolist()
        for r, out in server.run(idle_timeout_ms=0)
    }
    consumer.close()
    committed = [broker.committed("g", TP("t", p)) for p in range(PARTS)]
    return got, committed, server.metrics


def _pages(chunk):
    return {"block_size": BS, "num_blocks": 48, "prefill_chunk": chunk}


POOLS = {
    "dense": {},
    "dense-int8": {"kv_dtype": "int8"},
    "paged": {"kv_pages": _pages(0)},
    "paged-chunked": {"kv_pages": _pages(BS)},
    "paged-int8-chunked": {"kv_pages": _pages(None), "kv_dtype": "int8"},
}


@pytest.mark.parametrize("slots", [4, 3])
@pytest.mark.parametrize("pool", list(POOLS))
def test_sampled_tokens_and_commits_match_jax(model, pool, slots):
    ref, ref_committed, _ = _serve("jax", model, slots=slots, **POOLS[pool])
    got, committed, metrics = _serve("port", model, slots=slots, **POOLS[pool])
    assert len(ref) == N
    assert got == ref
    assert committed == ref_committed == [N // PARTS] * PARTS
    assert metrics.truncated.count > 0  # EOS freed slots early


def test_tokens_do_not_depend_on_slots_or_pool(model):
    """The same records through two slot counts and two pools: identical
    tokens, since each draw is keyed by (record, index) alone."""
    runs = [_serve("port", model, slots=s, **POOLS[pool])[0]
            for s, pool in ((4, "dense"), (2, "dense"), (3, "paged-chunked"))]
    assert runs[0] == runs[1] == runs[2]


def test_sampling_is_not_greedy_and_repeats(model):
    """The sampled run differs from greedy, and a second run repeats it."""
    a, ca, _ = _serve("port", model, slots=4)
    b, cb, _ = _serve("port", model, slots=4)
    assert a == b and ca == cb
    greedy, _, _ = _serve("port", model, slots=4, temperature=0.0)
    assert greedy != a
