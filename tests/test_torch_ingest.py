"""The port's ingest stack against the JAX package: each side's own broker
filled with identical records must give identical decoded rows, batches,
ledger state and committed offsets."""

import shutil
import signal

import jax
import numpy as np
import pytest
import torch

import torchkafka_tpu as jtk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu import native as jax_native
from torchkafka_tpu.transform import BucketBatcher as JaxBucketBatcher
from torchkafka_tpu_torch import native as port_native
from torchkafka_tpu_torch.transform import BucketBatcher as PortBucketBatcher

PKGS = {"jax": jtk, "port": ptk}
SEQ = 12


def _records(pkg, seed, n=40, parts=3, ragged=False):
    """n records of SEQ int32 tokens (ragged: 1..SEQ+4 tokens) produced to
    a fresh broker of ``pkg``; returns (broker, values)."""
    tk = PKGS[pkg]
    rng = np.random.default_rng(seed)
    broker = tk.InMemoryBroker()
    broker.create_topic("t", partitions=parts)
    values = []
    for i in range(n):
        width = int(rng.integers(1, SEQ + 5)) if ragged else SEQ
        v = rng.integers(0, 1000, width, dtype=np.int32).tobytes()
        if ragged and i % 7 == 3:
            v += b"\x01"  # a trailing partial item
        values.append(v)
        broker.produce("t", v, partition=i % parts, timestamp_ms=1_000 + i)
    return broker, values


def _consumer(pkg, broker, parts=3):
    tk = PKGS[pkg]
    return tk.MemoryConsumer(
        broker, "t", group_id="g",
        assignment=tk.partitions_for_process("t", parts, 0, 1),
    )


# -------------------------------------------------------------- decoding


def test_native_builds_where_gxx_exists():
    if shutil.which("g++"):
        assert port_native.available()


def test_native_build_is_race_free(tmp_path):
    """Six processes that build the decoder into one empty directory at
    once (the test workers' situation) all load it, and leave exactly one
    library and no temporary file behind."""
    import pathlib
    import subprocess
    import sys

    code = (
        "import importlib.util, pathlib, sys\n"
        "spec = importlib.util.spec_from_file_location('tkn', sys.argv[2])\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "m._BUILD = pathlib.Path(sys.argv[1])\n"
        "print(m.available())\n"
    )
    init = pathlib.Path(port_native.__file__)
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp_path), str(init)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    want = str(shutil.which("g++") is not None)
    assert [o[0].strip() for o in outs] == [want] * 6
    names = sorted(f.name for f in tmp_path.iterdir())
    assert not any(n.endswith(".tmp") for n in names), names
    assert len(names) == (1 if want == "True" else 0), names


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("ragged", [False, True])
def test_gather_rows_identical(monkeypatch, path, ragged):
    _, values = _records("port", 1, ragged=ragged)
    ref = jax_native.gather_rows(values, SEQ, np.int32, 7)
    if path == "numpy":
        monkeypatch.setattr(port_native, "_lib", lambda: None)
    got = port_native.gather_rows(values, SEQ, np.int32, 7)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.shape == (len(values), SEQ)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_json_tokens_scan_identical(monkeypatch, path):
    values = [b'{"text": "hello"}', b'{"t": 1}', b'{"text":"a\\"b"}', b"not json",
              b'{"text": "' + b"x" * 40 + b'"}']
    ref = jax_native.json_tokens_scan(values, "text", 16, 0)
    if path == "numpy":
        monkeypatch.setattr(port_native, "_lib", lambda: None)
    got = port_native.json_tokens_scan(values, "text", 16, 0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_fixed_width_processor_identical():
    _, values = _records("port", 2, n=10)
    recs = {
        pkg: [PKGS[pkg].Record("t", 0, i, v) for i, v in enumerate(values)]
        for pkg in PKGS
    }
    ref, _ = jtk.fixed_width(SEQ, np.int32)(recs["jax"])
    got, keep = ptk.fixed_width(SEQ, np.int32, wire_dtype=np.uint16)(recs["port"])
    assert keep is None and got.dtype == np.uint16
    np.testing.assert_array_equal(got, ref.astype(np.uint16))
    with pytest.raises(NotImplementedError, match="bitpack"):
        ptk.fixed_width(SEQ, np.int32, wire_bits=10)


def test_tree_flatten_order_matches_jax():
    from torchkafka_tpu_torch.utils import tree

    t = {"b": (np.zeros(1), [np.ones(2), None]), "a": {"z": 1, "y": np.arange(3)}}
    leaves, treedef = tree.tree_flatten(t)
    jleaves = jax.tree_util.tree_leaves(t)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tree.tree_unflatten(treedef, leaves)
    assert list(back) == ["a", "b"] and back["b"][1][1] is None


# --------------------------------------------------------------- batching


def _batch_run(pkg, seed, batcher_kind):
    tk = PKGS[pkg]
    broker, _ = _records(pkg, seed, n=23, ragged=batcher_kind == "bucket")
    consumer = _consumer(pkg, broker)
    records = consumer.poll(max_records=100)
    ledger = tk.OffsetLedger()
    ledger.fetched_many(records)
    if batcher_kind == "bucket":
        cls = JaxBucketBatcher if pkg == "jax" else PortBucketBatcher
        batcher = cls(4, (4, 8, 16), ledger, pad_policy="pad", pad_value=-1)
    else:
        batcher = tk.Batcher(5, ledger, pad_policy="pad")
    out = []
    for i, r in enumerate(records):
        row = np.frombuffer(r.value[: len(r.value) // 4 * 4], np.int32)
        if batcher_kind == "bucket":
            el = None if i % 5 == 4 else row
        else:
            el = None if i % 5 == 4 else {"tok": row, "n": np.int32(i)}
        b = batcher.add(el, r)
        if b is not None:
            out.append(b)
    out.extend(batcher.flush_tails())
    return [
        (jax.tree_util.tree_map(np.asarray, b.data), b.valid_count,
         sorted((tp.partition, o) for tp, o in b.offsets.items()))
        for b in out
    ], sorted((tp.partition, o) for tp, o in ledger.snapshot().items())


@pytest.mark.parametrize("kind", ["batcher", "bucket"])
def test_batchers_identical(kind):
    jb, jl = _batch_run("jax", 4, kind)
    pb, pl = _batch_run("port", 4, kind)
    assert pl == jl and len(pb) == len(jb) > 2
    for (pd, pv, po), (jd, jv, jo) in zip(pb, jb):
        assert (pv, po) == (jv, jo)
        p_leaves = jax.tree_util.tree_leaves(pd)
        j_leaves = jax.tree_util.tree_leaves(jd)
        for a, b in zip(p_leaves, j_leaves):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ----------------------------------------------------------------- stream


def _stream_run(pkg, mode, commit):
    tk = PKGS[pkg]
    ragged = mode == "buckets"
    broker, _ = _records(pkg, 9, n=31, ragged=ragged)
    consumer = _consumer(pkg, broker)
    kw = dict(idle_timeout_ms=300, owns_consumer=True, max_poll_records=7)
    if pkg == "port":
        kw["device"] = "cpu"
    if mode == "drop":
        calls = []

        def processor(r):
            if r.offset % 4 == 1:
                raise ValueError("poison")
            return {"tok": np.frombuffer(r.value, np.int32)}

        kw.update(on_processor_error="drop",
                  dead_letter=lambda r, e: calls.append((r.partition, r.offset)))
    elif mode == "buckets":
        def processor(r):
            return np.frombuffer(r.value[: len(r.value) // 4 * 4], np.int32)

        kw.update(buckets=(4, 8, 16), pad_policy="pad")
    else:
        processor = tk.fixed_width(SEQ, np.int32)
    kw["prefetch"] = 0 if mode == "sync" else 2
    batches, futures = [], []
    with tk.KafkaStream(consumer, processor, batch_size=4, **kw) as stream:
        for batch, token in stream:
            batches.append((
                jax.tree_util.tree_map(
                    lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                    batch.data),
                batch.valid_count,
            ))
            if commit == "sync":
                assert token.commit(wait_for=batch.data)
            else:
                futures.append(token.commit_async(wait_for=batch.data))
        done = [f.result(timeout=30) for f in futures]
        assert all(done)
        metrics = stream.metrics.summary()
    committed = [broker.committed("g", tk.TopicPartition("t", p)) for p in range(3)]
    extra = sorted(calls) if mode == "drop" else None
    return batches, committed, metrics["dropped"], extra


@pytest.mark.parametrize("commit", ["sync", "async"])
@pytest.mark.parametrize("mode", ["sync", "threaded", "drop", "buckets"])
def test_stream_identical_batches_and_commits(mode, commit):
    jb, jc, jd, jx = _stream_run("jax", mode, commit)
    pb, pc, pd, px = _stream_run("port", mode, commit)
    assert (pc, pd, px) == (jc, jd, jx)
    assert len(pb) == len(jb) > 2
    for (p_data, p_valid), (j_data, j_valid) in zip(pb, jb):
        assert p_valid == j_valid
        for a, b in zip(jax.tree_util.tree_leaves(p_data), jax.tree_util.tree_leaves(j_data)):
            np.testing.assert_array_equal(a, b)
    assert all(c is not None and c > 0 for c in pc)


def test_stream_batches_are_tensors_on_the_device():
    broker, _ = _records("port", 5, n=8)
    with ptk.KafkaStream(_consumer("port", broker), ptk.fixed_width(SEQ, np.int32),
                         batch_size=4, prefetch=0, idle_timeout_ms=100,
                         device="cpu") as stream:
        batch, _ = next(iter(stream))
    assert isinstance(batch.data, torch.Tensor) and batch.data.dtype == torch.int32
    assert batch.data.shape == (4, SEQ) and batch.data.device.type == "cpu"


def test_stream_unported_arguments_raise():
    broker, _ = _records("port", 5, n=4)
    proc = ptk.fixed_width(SEQ, np.int32)
    for kw, match in (
        ({"mesh": object()}, "mesh"),
        ({"quarantine": object(), "on_processor_error": "quarantine"}, "quarantine"),
        ({"barrier_timeout_s": 10.0}, "multihost"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            ptk.KafkaStream(_consumer("port", broker), proc, 4, device="cpu", **kw)


# ---------------------------------------------------------- commit barrier


def test_barrier_fails_closed_when_retirement_fails():
    """A step result whose retirement cannot be proven (here a meta tensor:
    no value exists to read back) raises BarrierError and commits nothing."""
    broker, _ = _records("port", 6, n=8)
    with ptk.KafkaStream(_consumer("port", broker), ptk.fixed_width(SEQ, np.int32),
                         batch_size=4, prefetch=0, idle_timeout_ms=100,
                         device="cpu") as stream:
        _, token = next(iter(stream))
        with pytest.raises(ptk.BarrierError):
            token.commit(wait_for=torch.empty(3, device="meta"))
        with pytest.raises(ptk.BarrierError):
            token.commit_async(wait_for={"loss": torch.empty(1, device="meta")}).result(30)
        assert not token.committed
    assert all(broker.committed("g", ptk.TopicPartition("t", p)) is None for p in range(3))
    with pytest.raises(ptk.BarrierError):
        ptk.LocalBarrier()(torch.empty(2, device="meta"))
    ptk.CommitBarrier(strict=False)(torch.empty(2, device="meta"))  # no host read


def test_fence_records_nothing_for_host_tensors():
    from torchkafka_tpu_torch.commit import StepFence

    fence = ptk.CommitBarrier.fence({"a": torch.ones(2), "b": torch.empty(0)})
    assert isinstance(fence, StepFence) and fence.events == []
    assert fence.first is not None and fence.first.numel() == 2
    ptk.CommitBarrier()(fence)


# ---------------------------------------------------------- small copies


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_partitions_for_process_identical(count):
    for idx in range(count):
        got = ptk.partitions_for_process("t", 7, idx, count)
        ref = jtk.partitions_for_process("t", 7, idx, count)
        assert [(tp.topic, tp.partition) for tp in got] == [
            (tp.topic, tp.partition) for tp in ref
        ]
    with pytest.raises(ValueError):
        ptk.partitions_for_process("t", 7, count, count)


def test_tracing_and_timing_helpers_match():
    from torchkafka_tpu.utils import timing as jtiming
    from torchkafka_tpu.utils import tracing as jtracing
    from torchkafka_tpu_torch.utils import timing, tracing

    for args in ((1_000, None, lambda: 3.5), (0, 99.0, None), (5_000, 4_000.0, None)):
        assert tracing.ingest_lag_ms(*args) == jtracing.ingest_lag_ms(*args)
    for args in ((0.2, 0.8, 2, 8), (0.5, 0.4, 2, 8)):
        assert timing.two_point_slope(*args) == jtiming.two_point_slope(*args)
    with tracing.span("x"), tracing.step_span(3):
        pass
    with pytest.raises(ValueError, match="CUDA"):
        timing.device_step_seconds(lambda p, o, t: (p, o, t), {}, None, torch.zeros(2))


def test_shutdown_signal_sets_the_flag():
    with ptk.ShutdownSignal(signals=(signal.SIGUSR1,)) as stop:
        assert not stop.requested
        signal.raise_signal(signal.SIGUSR1)
        assert stop.requested
