"""The port's in-process serving fleet (``fleet/``) against the JAX
package's.

- ``test_fleet.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` and its
  classes are collected here (token buckets, serving and splitting,
  token exactness against ``generate``, the netbroker and speculative
  fleets, the seeded kill under the in-commit audit, QoS buckets and
  lanes, backpressure, SIGTERM and programmatic drains, the drain flush
  retry), the fleets' replicas serving on the CPU.
- Differentials at f32, one seeded broker content through both
  packages' fleets: the completion sequence (replica, topic, partition,
  offset, tokens), the committed and merged watermarks, the replica
  states and the fleet counters (completions, duplicates, drains,
  deaths, journal handoffs, drain-timeout kills, joins) are equal for a
  plain fleet, the netbroker fleet, the seeded kill with a journal under
  the in-commit audit (the survivor warm-resumes), a drain and restart
  with zero replays, a drain timeout's journal-synced kill, QoS under a
  manual clock (equal lane waits and tenant counters), ``scale_to`` up
  and down, a speculative fleet (``spec_stats`` equal) and a traced
  paged chaos fleet (events and JSONL export equal). The resilience
  soak of ``test_resilience.py`` (outage plus poison over a fleet) runs
  over the port.
- ``note_partitions_revoked``: a scale-down that hands a partition back
  never regresses its committed watermark.
- ``handoff_consumer_factory``: a paged fleet adopting from a
  ``PrefillPool`` equals the JAX fleet in completions, state, disagg
  counters and commits, with no prompt pass on a replica.
"""

import numpy as np
import pytest

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import (
    MAX_NEW,
    MOD,
    P,
    PKGS,
    StepClock,
    audited_consumer,
    committed,
    fleet,
    jax_and_port,
    load_rerooted,
    produce,
    record,
    sub,
    summary,
)
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture

_mod = load_rerooted("test_fleet")

model = _mod.model
TestTokenBucket = _mod.TestTokenBucket
TestFleetServing = _mod.TestFleetServing
TestChaosReplicaKill = _mod.TestChaosReplicaKill
TestQoS = _mod.TestQoS
TestGracefulDrain = _mod.TestGracefulDrain

_res = load_rerooted("test_resilience", replace=[
    ("    from torchkafka_tpu.fleet import ServingFleet\n", ""),
])
TestChaosSoak = _res.TestChaosSoak


@pytest.fixture(scope="module")
def pkgs():
    return jax_and_port()


def _serve(pkg, pkgs, *, n=16, parts=4, produce_kw=None, serve_kw=None,
           on_record=None, broker=None, **kw):
    """One fleet serve of ``n`` seeded prompts → (records, summary,
    committed, fleet)."""
    mod = MOD[pkg]
    broker = broker or mod.InMemoryBroker()
    produce(broker, n, parts=parts, **(produce_kw or {}))
    f = fleet(pkg, pkgs[pkg], broker, **kw)
    out = []
    for rid, rec, toks in f.serve(**{"idle_timeout_ms": 500, **(serve_kw or {})}):
        out.append(record(rid, rec, toks))
        if on_record is not None:
            on_record(f, len(out))
    state = summary(f)
    f.close()
    return out, state, committed(pkg, broker, kw.get("group", "fleet"), parts), f


def _both(pkgs, **kw):
    return {pkg: _serve(pkg, pkgs, **kw) for pkg in PKGS}


def _same(runs):
    ref, got = runs["jax"], runs["port"]
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]


def test_plain_fleet_matches_jax(pkgs):
    runs = _both(pkgs, commit_every=4, serve_kw={"max_records": 16})
    _same(runs)
    assert runs["port"][2] == [4] * 4
    assert {r[0] for r in runs["port"][0]} == {0, 1}


def test_netbroker_fleet_matches_jax(pkgs):
    runs = {}
    for pkg in PKGS:
        mod = MOD[pkg]
        broker = mod.InMemoryBroker()
        clients = []
        with mod.BrokerServer(broker) as host:
            def factory(rid, mod=mod, host=host):
                c = mod.BrokerClient(host.host, host.port)
                clients.append(c)
                return mod.MemoryConsumer(c, "p", group_id="net",
                                          member_id=f"m{rid}")

            runs[pkg] = _serve(pkg, pkgs, n=8, parts=2, broker=broker,
                               consumer=factory, group="net")
            for c in clients:
                c.close()
    _same(runs)
    assert runs["port"][2] == [4, 4]


def test_seeded_kill_with_journal_matches_jax(pkgs, tmp_path):
    """The headline differential: a seeded mid-generation kill over
    journaled replicas; every commit audited; the survivor takes the
    victim's journal and warm-resumes."""
    runs, resumes = {}, {}
    for pkg in PKGS:
        audit = {"completed": None}
        cls = audited_consumer(pkg, audit)
        broker = MOD[pkg].InMemoryBroker()

        def factory(rid, cls=cls, broker=broker):
            return cls(broker, "p", group_id="chaos", member_id=f"chaos-r{rid:03d}")

        chaos = sub(pkg, "fleet").ReplicaChaos(seed=3, min_completions=2,
                                               max_completions=6)
        produce(broker, 24, parts=4)
        f = fleet(pkg, pkgs[pkg], broker, consumer=factory, group="chaos",
                  commit_every=100, journal_dir=tmp_path / pkg,
                  journal_cadence=2)
        audit["completed"] = f.completed
        out = [record(*c) for c in f.serve(idle_timeout_ms=500, chaos=chaos)]
        state = summary(f)
        resumes[pkg] = [r.gen.metrics.journal_summary() for r in f.replicas]
        f.close()
        runs[pkg] = (out, state, committed(pkg, broker, "chaos", 4), chaos.killed)
    assert runs["port"] == runs["jax"]
    out, state, wm, killed = runs["port"]
    assert len(killed) == 1 and state["counters"]["duplicates"] >= 1
    assert state["counters"]["journal_handoffs"] >= 1
    assert wm == [6] * 4
    assert {(r[2], r[3]) for r in out} == {(i % 4, i // 4) for i in range(24)}
    assert resumes["port"] == resumes["jax"]
    survivor = resumes["port"][1 - killed[0]]
    assert survivor["warm_resumes"] + survivor["served_from_journal"] >= 1


def test_drain_and_restart_replays_nothing_as_jax(pkgs):
    """Drain at the sixth completion (the SIGTERM path's ``requested``
    flag), then a second fleet on the same group serves the rest with no
    prompt served by both."""
    runs = {}
    for pkg in PKGS:
        mod = MOD[pkg]
        broker = mod.InMemoryBroker()
        produce(broker, 20, parts=2)
        stop = type("Stop", (), {"requested": False})()
        f1 = fleet(pkg, pkgs[pkg], broker, group="drain", commit_every=100)
        got1 = []
        for c in f1.serve(idle_timeout_ms=500, shutdown=stop):
            got1.append(record(*c))
            if len(got1) == 6:
                stop.requested = True
        s1 = summary(f1)
        wm1 = committed(pkg, broker, "drain", 2)
        f2 = fleet(pkg, pkgs[pkg], broker, group="drain", commit_every=4)
        got2 = [record(*c) for c in f2.serve(idle_timeout_ms=500)]
        s2 = summary(f2)
        f2.close()
        runs[pkg] = (got1, s1, wm1, got2, s2, committed(pkg, broker, "drain", 2))
    assert runs["port"] == runs["jax"]
    got1, s1, wm1, got2, _s2, final = runs["port"]
    assert s1["states"] == ["done", "done"] and s1["counters"]["drains"] == 2
    assert sum(wm1) == len(got1) and final == [10, 10]
    assert not {(r[2], r[3]) for r in got1} & {(r[2], r[3]) for r in got2}


def test_drain_timeout_kill_matches_jax(pkgs, tmp_path):
    """A drain that overruns ``drain_timeout_s`` syncs each draining
    replica's journal and kills it; the next incarnation warm-starts from
    the journals left on disk."""
    runs = {}
    for pkg in PKGS:
        mod = MOD[pkg]
        broker = mod.InMemoryBroker()
        produce(broker, 12, parts=2)
        clock = StepClock(dt=0.5)
        f1 = fleet(pkg, pkgs[pkg], broker, group="dt", commit_every=100,
                   journal_dir=tmp_path / pkg, journal_cadence=1,
                   drain_timeout_s=0.1, clock=clock)
        got1 = []
        for c in f1.serve(idle_timeout_ms=500):
            got1.append(record(*c))
            if len(got1) == 2:
                f1.drain()
        s1 = summary(f1)
        f2 = fleet(pkg, pkgs[pkg], broker, group="dt", commit_every=4,
                   journal_dir=tmp_path / pkg)
        got2 = [record(*c) for c in f2.serve(idle_timeout_ms=500)]
        s2 = summary(f2)
        warm = [r.gen.metrics.journal_summary() for r in f2.replicas]
        f2.close()
        runs[pkg] = (got1, s1, got2, s2, warm, committed(pkg, broker, "dt", 2))
    assert runs["port"] == runs["jax"]
    assert runs["port"][1]["counters"]["drain_timeout_kills"] >= 1
    assert runs["port"][5] == [6, 6]


def test_qos_under_manual_clock_matches_jax(pkgs):
    """Keyed tenants (one throttled) and mixed lanes, a manual clock
    stepping 50 ms at every reading (so a throttled queue refills): equal
    order, lane waits and tenant counters."""
    runs = {}
    for pkg in PKGS:
        qos = sub(pkg, "fleet").QoSConfig(tenant_rates={"slow": 0.25}, burst=1.0,
                                          max_queue_depth=8, resume_queue_depth=2)
        out, state, wm, f = _serve(
            pkg, pkgs, n=24, parts=2, group="qos", qos=qos,
            clock=StepClock(dt=0.05), commit_every=4, max_poll_records=4,
            produce_kw={"key_of": lambda i: b"slow" if i % 2 == 0 else b"fast",
                        "lane_of": lambda i: (b"interactive" if i % 3 == 0
                                              else b"batch")},
        )
        s = f.metrics.summary(f.replicas)
        tenants = {t: {k: v for k, v in c.items() if not k.endswith("_per_s")}
                   for t, c in s["tenants"].items()}  # wall-clock rates
        runs[pkg] = (out, state, wm, tenants, s["lanes"],
                     f.metrics.backpressure_pauses.count)
    assert runs["port"] == runs["jax"]
    tenants, lanes = runs["port"][3], runs["port"][4]
    assert tenants["slow"]["throttled"] > 0 and tenants["fast"]["throttled"] == 0
    assert set(lanes) == {"interactive", "batch"}


def test_scale_to_up_and_down_matches_jax(pkgs):
    """One replica, scaled to three at the fourth completion and back to
    one at the twelfth: the joiners take partitions, the leavers drain
    warm, and the watermark ends at the log end."""
    def scale(f, n):
        if n == 4:
            f.scale_to(3)
        elif n == 12:
            f.scale_to(1)

    runs = _both(pkgs, n=24, parts=4, replicas=1, commit_every=2,
                 group="scale", on_record=scale)
    _same(runs)
    out, state, wm, _f = runs["port"]
    assert state["counters"]["replica_joins"] == 3
    assert state["states"] == ["serving", "done", "done"]
    assert wm == [6] * 4
    assert {r[0] for r in out} == {0, 1, 2}


def test_scale_down_returning_a_partition_never_regresses(pkgs):
    """A partition that leaves a replica (scale-up) and comes back
    (scale-down) carries no stale ledger entry back: every commit of
    every partition is monotone (the commit log), as in JAX."""
    logs = {}
    for pkg in PKGS:
        mod = MOD[pkg]
        broker = mod.InMemoryBroker()
        seen = []

        class Logged(mod.MemoryConsumer):
            def commit(self, offsets=None):
                super().commit(offsets)
                seen.append(sorted((tp.partition, o) for tp, o in offsets.items()))

        def scale(f, n):
            if n == 2:
                f.scale_to(2)
            elif n == 8:
                f.scale_to(1)

        _serve(pkg, pkgs, n=16, parts=2, broker=broker, replicas=1,
               commit_every=1, group="ret", on_record=scale,
               consumer=lambda rid, broker=broker, cls=Logged: cls(
                   broker, "p", group_id="ret", member_id=f"ret-r{rid:03d}"))
        logs[pkg] = seen
    assert logs["port"] == logs["jax"]
    high: dict = {}
    for commit in logs["port"]:
        for p, off in commit:
            assert off >= high.get(p, 0), (p, off, high)
            high[p] = off
    assert high == {0: 8, 1: 8}


def test_note_partitions_revoked_drops_ledger_state(pkgs):
    """Records fetched on a partition that is then revoked leave the
    ledger: the snapshot no longer holds the partition back."""
    broker = ptk.InMemoryBroker()
    produce(broker, 4, parts=2)
    f = fleet("port", pkgs["port"], broker, replicas=1, group="rv")
    gen = f.replicas[0].gen
    recs = f.replicas[0].consumer.poll(max_records=4)
    gen.note_fetched(recs)
    tp0 = ptk.TopicPartition("p", 0)
    assert tp0 in gen._ledger.pending_by_partition()
    gen.note_partitions_revoked({tp0})
    assert tp0 not in gen._ledger.pending_by_partition()
    gen.note_partitions_revoked(set())
    f.close()


def test_spec_fleet_matches_jax(pkgs):
    from torchkafka_tpu.serve_spec import SpecStreamingGenerator as JaxSpec
    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

    cls = {"jax": JaxSpec, "port": SpecStreamingGenerator}
    runs, stats = {}, {}
    for pkg in PKGS:
        runs[pkg] = _serve(pkg, pkgs, n=8, parts=2, generator_cls=cls[pkg],
                           gen_kwargs={"k": 2}, commit_every=2)
        stats[pkg] = [r.gen.spec_stats() for r in runs[pkg][3].replicas]
    _same(runs)
    assert stats["port"] == stats["jax"]
    assert sum(s["proposed"] for s in stats["port"]) > 0


def test_traced_paged_chaos_fleet_matches_jax(pkgs, tmp_path):
    """``test_obs.py``'s traced chaos fleet (paged replicas, a seeded
    kill) under a manual clock: the event lists and the JSONL exports
    are equal, as are the completions and watermarks."""
    runs, exports = {}, {}
    for pkg in PKGS:
        mod = MOD[pkg]
        obs = mod.ObsConfig(clock=StepClock())
        chaos = sub(pkg, "fleet").ReplicaChaos(seed=5, min_completions=2,
                                               max_completions=6)
        out, state, wm, f = _serve(
            pkg, pkgs, n=16, parts=4, group="gc", commit_every=2, obs=obs,
            gen_kwargs={"kv_pages": {"block_size": 4, "num_blocks": 24}},
            serve_kw={"chaos": chaos},
            produce_kw={"key_of": lambda i: b"tenant-%d" % (i % 2)},
        )
        path = tmp_path / f"{pkg}.jsonl"
        f.tracer.export_jsonl(str(path))
        exports[pkg] = path.read_text()
        runs[pkg] = (out, state, wm, chaos.killed,
                     [e.to_json() for e in f.tracer.events],
                     f.metrics.summary(f.replicas)["membership"])
    assert runs["port"] == runs["jax"]
    assert exports["port"] == exports["jax"]
    assert len(runs["port"][3]) == 1


def _adopting_fleet(pkg, model):
    """A 2-replica paged fleet adopting from one in-process prefill
    worker (``PrefillPool``) pumped every round: (record, fleet summary,
    disagg counters, committed offsets)."""
    mod, pre = MOD[pkg], sub(pkg, "fleet.prefill")
    cfg, params = model
    broker = mod.InMemoryBroker()
    produce(broker, 12, parts=2)
    broker.create_topic("ho", partitions=1)
    pages = {"block_size": 4, "num_blocks": 24}
    gen_kw = {"kv_pages": pages}
    pool_kw = {"gen_kwargs": {"device": "cpu"}} if pkg == "port" else {}
    pool = pre.PrefillPool(broker, "p", "fleet-prefill", "ho", params, cfg,
                           workers=1, slots=2, prompt_len=P, max_new=MAX_NEW,
                           kv_pages=pages, commit_every=2, **pool_kw)
    f = fleet(pkg, model, broker, gen_kwargs=gen_kw, route_patience=64,
              handoff_consumer_factory=lambda rid: mod.MemoryConsumer(
                  broker, "ho", group_id=f"ho-{rid}", member_id=f"ho-{rid}"))
    got = [record(*c) for c in f.serve(idle_timeout_ms=300,
                                       on_round=lambda _f, _s: pool.pump_once())]
    disagg = f.metrics.summary(f.replicas)["disagg"]
    prefill_tokens = [r.gen.metrics.prefill_tokens.count for r in f.replicas]
    state = summary(f)
    f.close()
    pool.close()
    return got, state, disagg, prefill_tokens, committed(pkg, broker, "fleet", 2)


def test_handoff_consumer_factory_adopts_like_jax(pkgs):
    """``ServingFleet(handoff_consumer_factory=)``: each replica tails the
    handoff topic in its own group and adopts the prefill worker's KV; the
    completions, fleet state, disagg counters and commits equal the JAX
    fleet's, and no replica runs a prompt pass."""
    got = _adopting_fleet("port", pkgs["port"])
    assert got == _adopting_fleet("jax", pkgs["jax"])
    records, _state, disagg, prefill_tokens, done = got
    assert len({(r[2], r[3]) for r in records}) == 12
    assert disagg["adopted_slots"] == 12 and prefill_tokens == [0, 0]
    assert done == [6, 6]


def test_replicas_share_the_params_tree(pkgs):
    """Every replica serves the caller's tensors, not copies of them."""
    broker = ptk.InMemoryBroker()
    produce(broker, 2, parts=2)
    _cfg, params = pkgs["port"]
    f = fleet("port", pkgs["port"], broker, group="share")
    ptrs = {r.gen._params["embed"].data_ptr() for r in f.replicas}
    assert ptrs == {params["embed"].data_ptr()}
    f.close()


def test_fleet_exports_match_jax_names():
    from torchkafka_tpu import fleet as jf
    from torchkafka_tpu_torch import fleet as pf

    assert set(pf.__all__) == set(jf.__all__)
    assert np.all([hasattr(pf, n) for n in pf.__all__])


_TP = ptk.TopicPartition("p", 0)


@pytest.mark.parametrize("outputs, fault", [
    ([(0, 0, 0), (0, 3, 0), (0, 4, 1), (0, 5, 1)], None),
    ([(0, 0, 0), (0, 3, 1), (0, 4, 1)], "closed under version 0"),
    ([(0, 0, 0), (0, 4, 0), (0, 5, 1)], "closed under version 1"),
    ([(0, 6, 1)], "lies in no commit window"),
], ids=["swap_between_windows", "v1_in_a_v0_window", "v0_in_a_v1_window",
        "uncommitted"])
def test_window_versions_holds_each_output_to_its_commit(outputs, fault):
    """A swap inside an open window leaves both versions' outputs in
    order along the partition; only the commit's version catches it."""
    from torchkafka_tpu_torch.fleet.drill import window_versions

    commits = [("m", {_TP: 2}, 0), ("m", {_TP: 4}, 0), ("m", {_TP: 6}, 1)]
    if fault is None:
        assert window_versions(commits, outputs) == {"windows": 3,
                                                     "by_version": {0: 2, 1: 2}}
    else:
        with pytest.raises(AssertionError, match=fault):
            window_versions(commits, outputs)


def test_audited_commits_carry_the_live_version(pkgs):
    """The audit records each commit with its replica's live version: an
    in-process rollout to version 1 leaves every output in a window of
    its own ``mv``."""
    from torchkafka_tpu_torch.fleet.drill import window_versions

    broker = ptk.InMemoryBroker()
    audit = {"completed": None}
    cls = audited_consumer("port", audit)
    prompts = produce(broker, 8, parts=2)
    broker.create_topic("out", partitions=1)
    f = fleet("port", pkgs["port"], broker, group="v", commit_every=2,
              consumer=lambda rid: cls(broker, "p", group_id="v", member_id=f"v-r{rid}"),
              gen_kwargs={"output_producer": ptk.MemoryProducer(broker),
                          "output_topic": "out"})
    audit["completed"] = f.completed
    audit["version_of"] = lambda m: f.replicas[int(m[3:])].gen.model_version
    drv = f.start_rollout(1, {0: pkgs["port"][1], 1: pkgs["port"][1]}, canary_slice=2)
    late = []

    def on_round(fl, served):
        drv.on_round(fl, served)
        if drv.done and not late:  # traffic after the swap: version 1's
            late.extend(broker.produce("p", x[::-1].tobytes(), partition=i % 2)
                        for i, x in enumerate(prompts))

    out = []
    for c in f.serve(idle_timeout_ms=500, on_round=on_round):
        drv.observe(*c)
        out.append(record(*c))
    f.close()
    by_value = {np.asarray(r[4], np.int32).tobytes(): (r[2], r[3]) for r in out}
    tp = ptk.TopicPartition("out", 0)
    outputs = [(*by_value[r.value], int(dict(r.headers)["mv"]))
               for r in broker.fetch(tp, 0, broker.end_offset(tp))]
    got = window_versions(audit["commits"], outputs)
    assert drv.controller.phase == "complete" and len(out) == 16
    assert {v for _m, _o, v in audit["commits"]} == {0, 1}
    assert got["by_version"][0] and got["by_version"][1]


@pytest.mark.parametrize("start", [0, 7, 9, 97, 999])
def test_member_order_follows_creation_past_a_power_of_ten(start, monkeypatch):
    """Auto-generated member ids sort in creation order whatever the
    process-wide counter reached, so a group's range assignment (members
    sorted by id) is replayable: ``member-9`` and ``member-10`` sorted as
    strings would hand partition 0 to the later consumer."""
    import itertools

    from torchkafka_tpu_torch.source import memory

    monkeypatch.setattr(memory, "_member_counter", itertools.count(start))
    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    first = ptk.MemoryConsumer(broker, "p", group_id="g")
    second = ptk.MemoryConsumer(broker, "p", group_id="g")
    first.poll(timeout_ms=0)
    second.poll(timeout_ms=0)
    first.poll(timeout_ms=0)
    assert first.assignment() == [ptk.TopicPartition("p", 0)]
    assert second.assignment() == [ptk.TopicPartition("p", 1)]


@pytest.mark.parametrize("start", [7, 9, 97])
def test_same_seed_same_schedule_across_the_member_counter(start, model, monkeypatch):
    """``TestChaosReplicaKill.test_same_seed_same_schedule`` with the
    member counter set so that its two runs straddle a power of ten (the
    reference's ids reorder there and its replay differs)."""
    import itertools

    from torchkafka_tpu_torch.source import memory

    monkeypatch.setattr(memory, "_member_counter", itertools.count(start))
    TestChaosReplicaKill().test_same_seed_same_schedule(model)
