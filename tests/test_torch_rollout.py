"""The port's rolling hot-swap (``fleet/rollout.py``, ``swap_params``,
``spawn_shadow``/``shadow_decode``) against the JAX package's.

- ``test_rollout.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` and its
  classes are collected here (the checkpoint wire and its fuzz, the
  controller's state machine, the broker rollout over the control topic,
  the in-process clean, divergent and resumed rollouts, the swap
  protocol's refusals and journal order, the journal's version meta),
  the fleets and servers on the CPU.
- Differentials at f32, one seeded broker content through both packages'
  fleets, each writing an output topic and traced under a manual clock:
  a clean rollout (the incumbent's weights as version 1) and a divergent
  one (other weights) give equal completions, equal output records with
  their ``mv`` headers, equal trace events (``swapped``,
  ``canary_started``, ``rollout_phase``, ``rolled_back``), equal canary
  diffs, phases and member versions; the clean rollout's output equals
  the never-rolled-out fleet's, and no ``mv`` 1 record of the divergent
  one ever reaches the output topic.
- The broker path: version 1 published with ``publish_checkpoint``, a
  ``BrokerRolloutDriver`` and one ``RolloutWorker`` per replica fetch it
  CRC-checked and rebuild it onto the incumbent's device; the rebuilt
  tree is bitwise the published one, and the run equals JAX's.
- Kills at ``rollout_pre_swap`` and ``swap_mid_apply`` leave the journal
  at the old and the new version, and the weights unswapped.
"""

import functools

import numpy as np
import pytest
import torch

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import (
    MOD,
    StepClock,
    committed,
    fleet,
    jax_and_port,
    load_rerooted,
    produce,
    record,
    sub,
)
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu_torch.resilience import crashpoint
from torchkafka_tpu_torch.serve import StreamingGenerator

_mod = load_rerooted("test_rollout", replace=[
    ("        from torchkafka_tpu.serve import StreamingGenerator\n", ""),
])
_mod.StreamingGenerator = functools.partial(StreamingGenerator, device="cpu")

model = _mod.model
divergent_params = _mod.divergent_params
TestCheckpointWire = _mod.TestCheckpointWire
TestCheckpointFuzz = _mod.TestCheckpointFuzz
TestRolloutController = _mod.TestRolloutController
TestBrokerDriver = _mod.TestBrokerDriver
TestInProcessRollout = _mod.TestInProcessRollout
TestSwapProtocol = _mod.TestSwapProtocol
TestJournalVersionMeta = _mod.TestJournalVersionMeta


@pytest.fixture(scope="module")
def pkgs():
    return {"v0": jax_and_port(seed=0), "v1": jax_and_port(seed=1)}


def _outputs(pkg, broker) -> list:
    """Every record on the output topic: (key, tokens, mv header)."""
    mod = MOD[pkg]
    tp = mod.TopicPartition("out", 0)
    return [(r.key, np.frombuffer(r.value, np.int32).tolist(), dict(r.headers)["mv"])
            for r in broker.fetch(tp, 0, broker.end_offset(tp))]


def _rollout(pkg, pkgs, candidate, *, n=24, canary_slice=3):
    """One traced fleet serve with an output topic; ``candidate``: None (no
    rollout), "same" (v1 = the incumbent's weights) or "divergent"."""
    mod = MOD[pkg]
    broker = mod.InMemoryBroker()
    produce(broker, n, key_of=lambda i: b"k%d" % i)
    broker.create_topic("out", partitions=1)
    f = fleet(pkg, pkgs["v0"][pkg], broker, commit_every=4,
              obs=mod.ObsConfig(clock=StepClock()),
              gen_kwargs={"output_producer": mod.MemoryProducer(broker),
                          "output_topic": "out"})
    params = pkgs["v0"][pkg][1]
    drv = None
    if candidate is not None:
        v1 = params if candidate == "same" else pkgs["v1"][pkg][1]
        drv = f.start_rollout(1, {0: params, 1: v1}, canary_slice=canary_slice)
    got = []
    for rid, rec, toks in f.serve(max_records=n, idle_timeout_ms=500,
                                  on_round=drv.on_round if drv else None):
        if drv is not None:
            drv.observe(rid, rec, toks)
        got.append(record(rid, rec, toks))
    for _ in range(10):
        if drv is None or drv.done:
            break
        drv.on_round(f, n)
    f.close()
    ctl = drv.controller if drv else None
    return {
        "records": got,
        "outputs": _outputs(pkg, broker),
        "committed": committed(pkg, broker, "fleet", 4),
        "events": [e.to_json() for e in f.tracer.events],
        "versions": [r.gen.model_version for r in f.replicas],
        "phase": ctl.phase if ctl else None,
        "member_versions": dict(ctl.member_versions) if ctl else None,
        "diffs": f.metrics.canary_token_diffs.count,
        "rollout": f.metrics.summary()["rollout"],
    }


@pytest.fixture(scope="module")
def runs(pkgs):
    cache = {}

    def get(pkg, candidate):
        if (pkg, candidate) not in cache:
            cache[(pkg, candidate)] = _rollout(pkg, pkgs, candidate)
        return cache[(pkg, candidate)]

    return get


@pytest.mark.parametrize("candidate", ["same", "divergent"])
def test_in_process_rollout_matches_jax(runs, candidate):
    got, ref = runs("port", candidate), runs("jax", candidate)
    assert got == ref


def test_clean_rollout_promotes_and_serves_as_no_rollout(runs):
    got, base = runs("port", "same"), runs("port", None)
    assert got["phase"] == "complete" and got["versions"] == [1, 1]
    assert got["diffs"] == 0
    key = lambda r: (r[2], r[3])  # noqa: E731
    assert sorted((key(r), r[4]) for r in got["records"]) == \
        sorted((key(r), r[4]) for r in base["records"])
    assert sorted(o[:2] for o in got["outputs"]) == \
        sorted(o[:2] for o in base["outputs"])
    assert {o[2] for o in got["outputs"]} <= {b"0", b"1"}
    assert got["committed"] == base["committed"] == [6] * 4
    assert sum(e["stage"] == "swapped" for e in got["events"]) == 2


def test_divergent_rollout_rolls_back_and_never_publishes(runs):
    got = runs("port", "divergent")
    assert got["phase"] == "rolled_back" and got["versions"] == [0, 0]
    assert got["diffs"] >= 1
    assert all(o[2] == b"0" for o in got["outputs"])
    assert not any(e["stage"] == "swapped" for e in got["events"])


def _broker_rollout(pkg, pkgs, *, n=16):
    """Version 1 (other weights) over the checkpoint topic, applied to a
    live fleet by a BrokerRolloutDriver and one RolloutWorker per replica
    (no canary gate: the diff budget is large)."""
    mod = MOD[pkg]
    ro, cw = sub(pkg, "fleet.rollout"), sub(pkg, "source.checkpoint_wire")
    broker = mod.InMemoryBroker()
    produce(broker, n, key_of=lambda i: b"k%d" % i)
    for topic in ("out", "ctl", "ckpt"):
        broker.create_topic(topic, partitions=1)
    f = fleet(pkg, pkgs["v0"][pkg], broker, commit_every=4,
              gen_kwargs={"output_producer": mod.MemoryProducer(broker),
                          "output_topic": "out"})
    v1 = pkgs["v1"][pkg][1]
    cw.publish_checkpoint(broker, "ckpt", 1, v1, chunk_bytes=4096)
    ctl = ro.RolloutController([f"r{r.id}" for r in f.replicas], 1,
                               canary_slice=2, max_canary_diffs=10**6,
                               metrics=f.metrics)
    drv = ro.BrokerRolloutDriver(broker, "ctl", ctl)
    workers = {
        r.id: ro.RolloutWorker(broker, "ctl", "ckpt", f"r{r.id}", r,
                               boot_params=pkgs["v0"][pkg][1], metrics=f.metrics)
        for r in f.replicas
    }
    drv.start()
    got = []
    for rid, rec, toks in f.serve(max_records=n, idle_timeout_ms=500):
        got.append(record(rid, rec, toks))
        drv.pump()
        workers[rid].pump([(rec, toks)])
    for _ in range(40):
        if drv.done:
            break
        drv.pump()
        for w in workers.values():
            w.pump([])
    # Traffic after the rollout is served by version 1.
    for i in range(8):
        broker.produce("p", np.full(8, i, np.int32).tobytes(), partition=i % 4,
                       key=b"late%d" % i)
    got += [record(*c) for c in f.serve(max_records=8, idle_timeout_ms=500)]
    f.close()
    trees = [w._params_by_version.get(1) for w in workers.values()]
    return {
        "records": got,
        "outputs": _outputs(pkg, broker),
        "phase": ctl.phase,
        "versions": [r.gen.model_version for r in f.replicas],
        "committed": committed(pkg, broker, "fleet", 4),
    }, trees, v1


def test_broker_rollout_rebuilds_bitwise_and_matches_jax(pkgs):
    got, trees, v1 = _broker_rollout("port", pkgs)
    ref, _, _ = _broker_rollout("jax", pkgs)
    assert got == ref
    assert got["phase"] == "complete" and got["versions"] == [1, 1]
    assert {o[2] for o in got["outputs"]} == {b"0", b"1"}
    flat_v1 = dict(ptk.source.checkpoint_wire.flatten_params(v1))
    for tree in trees:
        assert tree is not None
        flat = dict(ptk.source.checkpoint_wire.flatten_params(tree))
        assert sorted(flat) == sorted(flat_v1)
        for name, arr in flat.items():
            assert isinstance(arr, np.ndarray)
            np.testing.assert_array_equal(arr, flat_v1[name])


@pytest.mark.parametrize("point,durable", [("rollout_pre_swap", 0),
                                           ("swap_mid_apply", 5)])
def test_kill_at_swap_points_leaves_one_version(pkgs, tmp_path, point, durable):
    """A death at either swap crash point: the journal names one version
    (the old before the journal write, the new after it) and the weights
    are the incumbent's."""
    from torchkafka_tpu_torch.journal import DecodeJournal

    cfg, params = pkgs["v0"]["port"]
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    path = tmp_path / "j.journal"
    gen = StreamingGenerator(ptk.MemoryConsumer(broker, "p", group_id="g"),
                             params, cfg, slots=2, prompt_len=8, max_new=8,
                             journal=DecodeJournal(path, cadence=1), device="cpu")
    gen.sync_journal()
    crashpoint.arm(point, mode="raise")
    try:
        with pytest.raises(crashpoint.CrashPointInjected):
            gen.swap_params(pkgs["v1"]["port"][1], 5)
    finally:
        crashpoint.disarm()
    assert DecodeJournal.load_meta(path).get("model_version", 0) == durable
    assert gen.model_version == 0
    assert gen._params["embed"].data_ptr() == params["embed"].data_ptr()


def test_swap_rebinds_every_layer_view(pkgs):
    """After ``swap_params`` no per-layer view reads the old weights."""
    cfg, params = pkgs["v0"]["port"]
    new = pkgs["v1"]["port"][1]
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=1)
    gen = StreamingGenerator(ptk.MemoryConsumer(broker, "p", group_id="g"),
                             params, cfg, slots=2, prompt_len=8, max_new=8,
                             device="cpu")
    gen.swap_params(new, 3)
    for i, layer in enumerate(gen._layers):
        for name, w in layer.items():
            assert torch.equal(w, new["layers"][name][i])
            assert w.data_ptr() == new["layers"][name][i].data_ptr()
    assert gen.model_version == 3


def test_shadow_mirrors_the_incumbent(pkgs):
    """The canary's shadow: the incumbent's slot count, KV dtype and
    device, no producer, journal or partitions; its tokens equal the
    incumbent's for the same record (an int8 pool against an int8 pool)."""
    cfg, params = pkgs["v0"]["port"]
    broker = ptk.InMemoryBroker()
    prompts = produce(broker, 2, parts=1)
    gen = StreamingGenerator(ptk.MemoryConsumer(broker, "p", group_id="g"),
                             params, cfg, slots=2, prompt_len=8, max_new=8,
                             kv_dtype="int8", device="cpu")
    served = dict(((r.offset, np.asarray(t).tolist()) for r, t in gen.run(2)))
    shadow = gen.spawn_shadow(params, 4)
    assert shadow.slots == gen.slots and shadow.model_version == 4
    assert shadow._kv_int8 and shadow._consumer.assignment() == frozenset()
    assert shadow._output_producer is None and shadow._journal is None
    for off in range(2):
        rec = ptk.Record(topic="p", partition=0, offset=off, key=None,
                         value=prompts[off].tobytes(), timestamp_ms=0)
        assert np.asarray(shadow.shadow_decode(rec)).tolist() == served[off]
