"""The port's resilience layer, chaos injectors, WAL replication and
checkpoint wire against the JAX package's.

- The host cases of ``test_resilience.py`` (retry policy, circuit
  breaker, resilient consumer, chaos outages/corruption/producer faults,
  the quarantine and ``KafkaStream``'s quarantine policy) run over the
  port: the module's source is loaded with the package name re-rooted
  onto ``torchkafka_tpu_torch`` and its classes are collected here, over a
  port broker. Its serving-fleet soak runs over the port's fleet in
  ``test_torch_fleet.py``.
- Differentials, one seeded sequence through both packages: chaos
  schedules, records and commits; retry backoffs and breaker states; DLQ
  records byte for byte (headers included) from ``KafkaStream`` and from
  the server; WAL segments of a replicated cell; checkpoint frames.
"""

import io
import pathlib
import pickle
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

_REF = pathlib.Path(__file__).with_name("test_resilience.py")
_mod = types.ModuleType("_port_resilience")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk

TestRetryPolicy = _mod.TestRetryPolicy
TestCircuitBreaker = _mod.TestCircuitBreaker
TestResilientConsumer = _mod.TestResilientConsumer
TestChaosOutage = _mod.TestChaosOutage
TestChaosCorruption = _mod.TestChaosCorruption
TestChaosProducer = _mod.TestChaosProducer
TestPoisonQuarantine = _mod.TestPoisonQuarantine
TestStreamQuarantine = _mod.TestStreamQuarantine


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


def _errors(pkg):
    return (pkg.CommitFailedError, pkg.BrokerUnavailableError)


# ------------------------------------------------------------------ chaos


def _chaos_run(pkg, seed):
    rng = np.random.default_rng(seed)
    broker = pkg.InMemoryBroker()
    broker.create_topic("t", partitions=3)
    for i in range(60):
        broker.produce("t", rng.bytes(8), key=b"k%d" % (i % 4),
                       timestamp_ms=1_000 + i)
    chaos = pkg.ChaosConsumer(
        pkg.MemoryConsumer(broker, "t", group_id="g"), seed=seed,
        commit_failure_rate=0.3, poll_empty_rate=0.2, outage_rate=0.05,
        outage_ops=(1, 3), corrupt_rate=0.1,
    )
    events = []
    for _ in range(60):
        try:
            batch = chaos.poll(max_records=5)
            events.append([(r.partition, r.offset, r.key, r.value) for r in batch])
            if batch:
                offs = {}
                for r in batch:
                    offs[r.tp] = max(offs.get(r.tp, 0), r.offset + 1)
                chaos.commit(offs)
                events.append(sorted((tp.partition, o) for tp, o in offs.items()))
        except _errors(pkg) as exc:
            events.append(type(exc).__name__)
    final = [broker.committed("g", pkg.TopicPartition("t", p)) for p in range(3)]
    counts = (chaos.injected_commit_failures, chaos.injected_empty_polls,
              chaos.injected_outage_faults, chaos.injected_corruptions)
    return events, chaos.outage_log, sorted(chaos.corrupted), counts, final


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seeded_chaos_matches_jax(seed):
    port, ref = _chaos_run(ptk, seed), _chaos_run(tk, seed)
    assert port == ref
    assert all(n > 0 for n in ref[3][:2])  # faults really fired


# ------------------------------------------------------- retry and breaker


def _policy_run(pkg):
    from importlib import import_module

    res = import_module(pkg.__name__ + ".resilience")
    clock = res.ManualClock()
    policy = res.RetryPolicy(max_attempts=4, base_delay_s=0.05, max_delay_s=0.4,
                             deadline_s=30.0, seed=3, clock=clock.now,
                             sleep=clock.sleep)
    backoffs = [policy.backoff_s(a) for a in range(1, 9)]
    calls = []

    def flaky():
        calls.append(clock.now())
        if len(calls) < 3:
            raise pkg.BrokerUnavailableError("blip")
        return "ok"

    result = policy.run(flaky)
    breaker = res.CircuitBreaker(failure_threshold=2, reset_timeout_s=1.0,
                                 clock=clock.now)
    states = []
    for ok in (False, True, False, False, None, None, True, False, False):
        if ok is None:
            clock.sleep(0.6)
        elif breaker.allow():
            (breaker.record_success if ok else breaker.record_failure)()
        states.append(breaker.state)
    return backoffs, calls, result, states


def test_retry_policy_and_breaker_match_jax():
    port, ref = _policy_run(ptk), _policy_run(tk)
    assert port == ref
    assert "open" in ref[3]


# ------------------------------------------------------------- quarantine


def _dlq_records(pkg, broker):
    tp = pkg.TopicPartition("dlq", 0)
    return [(r.key, r.value, tuple(r.headers), r.offset)
            for r in broker.fetch(tp, 0, 100)]


def _stream_quarantine_run(pkg):
    broker = pkg.InMemoryBroker()
    broker.create_topic("t", partitions=2)
    broker.create_topic("dlq", partitions=1)
    for i in range(24):
        broker.produce("t", np.full(2, i, np.int32).tobytes(), key=b"r%d" % i)
    poison = {5, 17}

    def processor(rec):
        row = np.frombuffer(rec.value, np.int32)
        if int(row[0]) in poison:
            raise ValueError(f"poison {int(row[0])}")
        return row

    q = pkg.PoisonQuarantine(pkg.MemoryProducer(broker), "dlq", budget=2)
    kw = dict(to_device=False) if pkg is tk else dict(device="cpu")
    stream = pkg.KafkaStream(
        pkg.MemoryConsumer(broker, "t", group_id="g"), processor, batch_size=4,
        idle_timeout_ms=200, owns_consumer=True, pad_policy="pad", prefetch=0,
        on_processor_error="quarantine", quarantine=q, **kw,
    )
    seen = []
    with stream:
        for batch, token in stream:
            seen.extend(int(v) for v in np.asarray(batch.data)[: batch.valid_count, 0])
            assert token.commit()
    committed = [broker.committed("g", pkg.TopicPartition("t", p)) for p in range(2)]
    return sorted(seen), _dlq_records(pkg, broker), committed, stream.metrics.summary()["quarantined"]


def test_stream_quarantine_matches_jax():
    port, ref = _stream_quarantine_run(ptk), _stream_quarantine_run(tk)
    assert port == ref
    assert len(ref[1]) == 2 and ref[3] == 2
    headers = dict(ref[1][0][2])
    assert headers["dlq.attempts"] == b"2" and headers["dlq.topic"] == b"t"


SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)
P, MAX_NEW = 8, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(6), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return jcfg, jparams, pcfg, params


def _decode(rec):
    if rec.value.startswith(b"POISON"):
        raise ValueError("undecodable prompt")
    return np.frombuffer(rec.value, np.int32)


def _server_quarantine_run(pkg, model, **sampling):
    jcfg, jparams, pcfg, params = model
    prompts = np.random.default_rng(2).integers(0, 64, (7, P), dtype=np.int32)
    broker = pkg.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    broker.create_topic("dlq", partitions=1)
    for i, row in enumerate(prompts):
        broker.produce("p", row.tobytes(), key=b"k%d" % i, partition=i % 2)
        if i == 3:
            broker.produce("p", b"POISON-payload", key=b"bad", partition=1)
    consumer = pkg.MemoryConsumer(broker, "p", group_id="g")
    q = pkg.PoisonQuarantine(pkg.MemoryProducer(broker), "dlq", budget=2)
    kw = dict(slots=3, prompt_len=P, max_new=MAX_NEW, decode_prompt=_decode,
              quarantine=q, **sampling)
    if pkg is tk:
        if "temperature" in sampling:
            kw["rng"] = jax.random.key(11)
        server = JaxServer(consumer, jparams, jcfg, **kw)
    else:
        if "temperature" in sampling:
            kw["rng"] = prng.key(11)
        server = StreamingGenerator(consumer, params, pcfg, device="cpu", **kw)
    out = {(r.partition, r.offset): toks.tolist() for r, toks in server.run(idle_timeout_ms=0)}
    consumer.close()
    committed = [broker.committed("g", pkg.TopicPartition("p", p)) for p in range(2)]
    ends = [broker.end_offset(pkg.TopicPartition("p", p)) for p in range(2)]
    s = server.metrics.summary()
    return out, _dlq_records(pkg, broker), committed, ends, (s["quarantined"], s["dropped"])


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.9, "top_k": 16}],
                         ids=["greedy", "sampled"])
def test_server_quarantine_matches_jax(model, sampling):
    """A poison prompt spends its budget in place, is dead-lettered with
    the JAX package's exact DLQ record, and its offset retires: committed
    == end offsets, the poison's included."""
    port = _server_quarantine_run(ptk, model, **sampling)
    ref = _server_quarantine_run(tk, model, **sampling)
    assert port == ref
    out, dlq, committed, ends, (quarantined, dropped) = ref
    assert len(out) == 7 and committed == ends
    assert len(dlq) == 1 and quarantined == dropped == 1
    key, value, headers, _ = dlq[0]
    assert key == b"bad" and value == b"POISON-payload"
    assert dict(headers)["dlq.offset"] == b"2" and dict(headers)["dlq.partition"] == b"1"


def test_server_dlq_failure_fail_stops():
    """A failed DLQ produce counts in ``dlq_delivery_failures`` and raises
    ``OutputDeliveryError`` before any commit covers the record."""
    cfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    params = pt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    broker.create_topic("dlq", partitions=1)
    broker.produce("p", b"POISON")
    doomed = ptk.ChaosProducer(ptk.MemoryProducer(broker), delivery_failure_rate=1.0)
    q = ptk.PoisonQuarantine(doomed, "dlq", budget=1, timeout_s=0.1)
    consumer = ptk.MemoryConsumer(broker, "p", group_id="g")
    server = StreamingGenerator(consumer, params, cfg, slots=2, prompt_len=P,
                                max_new=MAX_NEW, decode_prompt=_decode,
                                quarantine=q, device="cpu")
    with pytest.raises(ptk.OutputDeliveryError):
        list(server.run(idle_timeout_ms=0))
    assert server.metrics.summary()["dlq_delivery_failures"] == 1
    assert broker.committed("g", ptk.TopicPartition("p", 0)) is None


# ---------------------------------------------------- WAL and checkpoints


def _cell_run(pkg, workdir):
    cell = pkg.BrokerCell(
        workdir, config=pkg.ReplicationConfig(replicas=3, durability="batch")
    )
    try:
        client = cell.client()
        client.create_topic("t", partitions=2)
        producer = pkg.MemoryProducer(client)
        for i in range(12):
            producer.send("t", b"v%d" % i, key=b"k%d" % (i % 3),
                          timestamp_ms=10_000 + i).get(5.0)
        consumer = pkg.MemoryConsumer(client, "t", group_id="g", member_id="m0")
        got = []
        while len(got) < 12:
            batch = consumer.poll(max_records=5, timeout_ms=200)
            got.extend(batch)
            if batch:
                consumer.commit({r.tp: r.offset + 1 for r in batch})
        consumer.close()
        client.close()
    finally:
        cell.close()
    return {
        str(f.relative_to(workdir)): f.read_bytes()
        for f in sorted(pathlib.Path(workdir).rglob("*")) if f.is_file()
    }


class _ReRoot(pickle.Unpickler):
    """Unpickles JAX-package classes as their port counterparts."""

    def find_class(self, module, name):
        if module.split(".")[0] == "torchkafka_tpu":
            module = "torchkafka_tpu_torch" + module[len("torchkafka_tpu"):]
        return super().find_class(module, name)


def _reencoded_segment(jax_segment: bytes, out_dir) -> bytes:
    """A JAX WAL segment's frames, re-rooted and written by the port's
    ``WriteAheadLog``: the bytes the port must have written for the same
    events (each package pickles its own classes into its frames)."""
    from torchkafka_tpu.source.wal import _HEADER
    from torchkafka_tpu_torch.source.wal import WriteAheadLog

    log = WriteAheadLog(out_dir)
    pos = 0
    while pos < len(jax_segment):
        n, _crc = _HEADER.unpack_from(jax_segment, pos)
        pos += _HEADER.size
        kind, event = _ReRoot(io.BytesIO(jax_segment[pos:pos + n])).load()
        pos += n
        log.append(kind, event)
    log.close()
    (seg,) = sorted(pathlib.Path(out_dir).iterdir())
    return seg.read_bytes()


def test_replicated_wal_segments_match_jax(tmp_path):
    """Every member's WAL of a 3-replica cell: the same files, and each
    port segment byte for byte the JAX segment's frames re-encoded by the
    port (the events agree exactly, class for class)."""
    port = _cell_run(ptk, tmp_path / "port")
    ref = _cell_run(tk, tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(ref) == 3
    for i, name in enumerate(sorted(ref)):
        assert port[name] == _reencoded_segment(ref[name], tmp_path / f"re{i}"), name


def test_checkpoint_published_by_jax_fetches_into_the_port():
    from torchkafka_tpu.source import checkpoint_wire as jw
    from torchkafka_tpu_torch.source import checkpoint_wire as pw

    rng = np.random.default_rng(0)
    params = {
        "embed": rng.normal(size=(16, 8)).astype(np.float32),
        "layers": {"wq": rng.normal(size=(2, 8, 4)).astype(np.float32),
                   "ln": np.ones((2, 8), np.float32)},
        "step": np.array([7], np.int32),
    }
    assert pw.checkpoint_frames(3, params, chunk_bytes=100) == \
        jw.checkpoint_frames(3, params, chunk_bytes=100)
    jb = tk.InMemoryBroker()
    jb.create_topic("ckpt", partitions=1)
    jw.publish_checkpoint(jb, "ckpt", 3, params, chunk_bytes=100)
    pb = ptk.InMemoryBroker()
    pb.create_topic("ckpt", partitions=1)
    for r in jb.fetch(tk.TopicPartition("ckpt", 0), 0, 1000):
        pb.produce("ckpt", r.value, key=r.key)
    flat, manifest = pw.fetch_checkpoint(pb, "ckpt", 3)
    assert manifest["version"] == 3
    want = dict(jw.flatten_params(params))
    assert sorted(flat) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(flat[name], arr)
