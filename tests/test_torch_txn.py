"""The port's broker transactions and exactly-once serving against the JAX
package's.

- ``test_txn.py`` (the ``TransactionalProducer`` unit contracts and the
  20-seed fuzz of transactional interleavings against a brute-force
  model) runs over the port: its source is loaded with the package name
  re-rooted onto ``torchkafka_tpu_torch`` and its cases collected here.
- The exactly-once server in one process, the JAX server and the port's
  on the same broker content (eight prompts and a poison record, two
  partitions) from the same parameters at f32: equal read_committed
  outputs, DLQ copies, watermarks and transaction counters; each
  completion and the poison's DLQ copy exactly once.
- The argument checks raise ``ValueError`` where the JAX server does.
- The keyed outbox: a record served twice (an eager-rebalance double
  delivery, before and after its covering commit) publishes one copy.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.utils import prng

_REF = pathlib.Path(__file__).with_name("test_txn.py")
_mod = types.ModuleType("_port_txn")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk

TestTransactionalProducer = _mod.TestTransactionalProducer
test_fuzz_txn_interleavings = _mod.test_fuzz_txn_interleavings

P, MAX_NEW, VOCAB, SLOTS, PARTS, N = 8, 8, 64, 2, 2, 8
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
POISON = b"POISON"
PKG = {"jax": (tk, JaxServer), "port": (ptk, StreamingGenerator)}


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jcfg, jparams), "port": (pcfg, params)}


def _decode(record):
    if record.value == POISON:
        raise ValueError("poison prompt")
    return np.frombuffer(record.value, dtype=np.int32)[:P]


def _prime(broker):
    """Prompt i on partition i % PARTS keyed by i; the poison after them
    on partition 0 (``_crash_worker.prime_topics``'s layout)."""
    broker.create_topic("t", partitions=PARTS)
    broker.create_topic("out", partitions=1)
    broker.create_topic("dlq", partitions=1)
    prompts = np.random.default_rng(7).integers(0, VOCAB, (N, P), dtype=np.int32)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS,
                       key=str(i).encode())
    broker.produce("t", POISON, partition=0, key=b"poison")


def _server(pkg, model, broker, consumer, producer, **kw):
    mod, Server = PKG[pkg]
    cfg, params = model[pkg]
    if "rng" in kw:
        kw["rng"] = (jax.random.key if pkg == "jax" else prng.key)(kw["rng"])
    if pkg == "port":
        kw["device"] = "cpu"
    return Server(
        consumer, params, cfg, slots=SLOTS, prompt_len=P, max_new=MAX_NEW,
        ticks_per_sync=1, max_poll_records=SLOTS, decode_prompt=_decode,
        output_producer=producer, output_topic="out", exactly_once=True,
        quarantine=mod.PoisonQuarantine(producer, "dlq", budget=1, timeout_s=5.0),
        **kw,
    )


def _committed_view(pkg, broker, topic):
    """The read_committed records of ``topic``: (key, value, headers)."""
    tp = PKG[pkg][0].TopicPartition(topic, 0)
    recs, _ = broker.fetch_stable(tp, 0, 100000)
    return [(r.key, r.value, tuple(r.headers)) for r in recs]


def _serve_txn(pkg, model, **kw):
    mod, _ = PKG[pkg]
    broker = mod.InMemoryBroker()
    _prime(broker)
    consumer = mod.MemoryConsumer(broker, "t", group_id="g")
    producer = mod.TransactionalProducer(broker, "txn-0")
    server = _server(pkg, model, broker, consumer, producer, commit_every=2, **kw)
    got = {r.key: t.tolist() for r, t in server.run(idle_timeout_ms=200)}
    server.close()
    tp = mod.TopicPartition
    return {
        "completions": got,
        "out": _committed_view(pkg, broker, "out"),
        "dlq": _committed_view(pkg, broker, "dlq"),
        "committed": [broker.committed("g", tp("t", p)) for p in range(PARTS)],
        "ends": [broker.end_offset(tp("t", p)) for p in range(PARTS)],
        "txn": server.metrics.summary()["txn"],
        "quarantined": server.metrics.quarantined.count,
    }


@pytest.mark.parametrize("kw", [{}, {"temperature": 0.9, "top_k": 16, "rng": 11}],
                         ids=["greedy", "sampled"])
def test_exactly_once_serving_matches_jax(model, kw):
    ref = _serve_txn("jax", model, **dict(kw))
    got = _serve_txn("port", model, **dict(kw))
    assert got == ref
    keys = [k for k, _, _ in got["out"]]
    assert sorted(keys) == sorted(str(i).encode() for i in range(N))  # once each
    for key, value, headers in got["out"]:
        assert np.frombuffer(value, np.int32).tolist() == got["completions"][key]
        assert headers == (("mv", b"0"),)
    assert [(k, v) for k, v, _ in got["dlq"]] == [(b"poison", POISON)]
    assert got["committed"] == got["ends"]
    assert got["txn"]["commits"] > 0 and got["txn"]["held_outputs"] == 0
    assert got["quarantined"] == 1


def _check_args(pkg, model, case):
    mod, _ = PKG[pkg]
    broker = mod.InMemoryBroker()
    _prime(broker)
    consumer = mod.MemoryConsumer(broker, "t", group_id="g")
    txn = mod.TransactionalProducer(broker, "txn-args")
    producer, quarantine = {
        "no_producer": (None, None),
        "not_transactional": (mod.MemoryProducer(broker), None),
        "quarantine_elsewhere": (txn, mod.PoisonQuarantine(mod.MemoryProducer(broker), "dlq")),
    }[case]
    cfg, params = model[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    if producer is not None:
        kw.update(output_producer=producer, output_topic="out")
    with pytest.raises(ValueError) as info:
        PKG[pkg][1](consumer, params, cfg, slots=SLOTS, prompt_len=P, max_new=MAX_NEW,
                    exactly_once=True, quarantine=quarantine, **kw)
    return str(info.value)


@pytest.mark.parametrize("case", ["no_producer", "not_transactional",
                                  "quarantine_elsewhere"])
def test_exactly_once_argument_checks_match_jax(model, case):
    assert _check_args("port", model, case) == _check_args("jax", model, case)


def _double_serve(pkg, model, commit_between: bool):
    """Serve record (0, 0) twice, as an eager rebalance delivers it twice:
    both copies before one commit, or the second after the commit that
    covered the first. Returns the committed output view and watermarks."""
    mod, _ = PKG[pkg]
    broker = mod.InMemoryBroker()
    _prime(broker)
    consumer = mod.MemoryConsumer(broker, "t", group_id="g")
    producer = mod.TransactionalProducer(broker, "txn-dup")
    server = _server(pkg, model, broker, consumer, producer, commit_every=2**31 - 1)
    recs = [r for r in consumer.poll(max_records=N + 1, timeout_ms=100)
            if r.partition == 0][:2]
    server.note_fetched(recs)

    def serve(records):
        server.admit_records(records)
        while server.has_active():
            server.step()

    serve(recs)
    if commit_between:
        assert server.flush_commits()
    server.note_fetched(recs[:1])  # the redelivered copy
    serve(recs[:1])
    assert server.flush_commits()
    server.close()
    tp = mod.TopicPartition
    return (_committed_view(pkg, broker, "out"),
            [broker.committed("g", tp("t", p)) for p in range(PARTS)])


@pytest.mark.parametrize("commit_between", [False, True],
                         ids=["same_window", "after_commit"])
def test_outbox_dedups_a_double_serve(model, commit_between):
    got = _double_serve("port", model, commit_between)
    assert got == _double_serve("jax", model, commit_between)
    keys = [k for k, _, _ in got[0]]
    assert keys.count(b"0") == 1  # the record served twice published once
    # The redelivered copy reopens the ledger below offset 1, so in one
    # window offset 1's output stays held (it re-delivers), as in JAX.
    assert keys == ([b"0", b"2"] if commit_between else [b"0"])
