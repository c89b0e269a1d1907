"""Reproducible fleet drills shared by the on-card check (``chip_smoke.py``)
and the CPU differentials (``tests/test_torch_fleet.py``,
``tests/test_torch_autoscale.py``).

- ``audited_consumer``: a group consumer class whose every commit asserts
  that each committed offset is covered by a completion the fleet already
  registered (``tests/test_fleet.py``'s ``_AuditedConsumer``), and records
  the commit with the model version live on the committing replica, so a
  caller can hold every output record to its commit window's version.
- ``autoscaled_run``: ``tests/test_autoscale.py``'s per-role loop with the
  decode role only: a ``FleetAutoscaler`` over a one-replica paged fleet,
  driven by a ``WorkloadGenerator`` step load under one manual clock.

Both take the package they drive as arguments (a consumer base class;
the top-level, workload and fleet modules; the port's by default), so the
differentials run one copy over the JAX package and the port.
"""

from __future__ import annotations

from typing import Any


def audited_consumer(base: type, audit: dict) -> type:
    """A subclass of the consumer class ``base`` (a ``MemoryConsumer``)
    auditing its commits against ``audit``:

    - ``audit["completed"]``: the fleet's ``completed`` set of
      ``(topic, partition, offset)``, bound once the fleet exists; every
      offset a commit covers must be in it, from
      ``audit.get("floor", {})[partition]`` on (commits an earlier fleet
      left on the group are exempt). A violation raises
      ``AssertionError`` INSIDE the commit, before it reaches the broker.
    - ``audit.get("version_of")``: if given, ``version_of(member_id)`` is
      the model version live on the committing member's replica; each
      successful commit appends ``(member_id, {tp: offset}, version)`` to
      ``audit["commits"]`` (version ``None`` without ``version_of``).
    """

    class Audited(base):
        def __init__(self, *args: Any, member_id: str | None = None, **kw: Any) -> None:
            super().__init__(*args, member_id=member_id, **kw)
            self.audited_member = member_id

        def commit(self, offsets=None) -> None:
            done = audit["completed"]
            if offsets is None or done is None:
                raise AssertionError("an audited commit names its offsets, "
                                     "after the fleet registered its set")
            floor = audit.get("floor", {})
            for tp, off in offsets.items():
                for o in range(floor.get(tp.partition, 0), off):
                    if (tp.topic, tp.partition, o) not in done:
                        raise AssertionError(
                            f"commit {tp}:{off} covers offset {o} with no completion")
            super().commit(offsets)
            version_of = audit.get("version_of")
            version = None if version_of is None else version_of(self.audited_member)
            audit.setdefault("commits", []).append(
                (self.audited_member, dict(offsets), version))

    return Audited


def window_versions(commits: list, outputs: list) -> dict:
    """Hold each output record to its commit window. ``commits``: an
    audited consumer's ``(member, {tp: offset}, version)`` in commit
    order; ``outputs``: ``(partition, offset, mv)``, one per output
    record, naming the prompt it answers. The window of a prompt at
    offset ``o`` is closed by the first commit on its partition past
    ``o``; the record's ``mv`` must be the version live at that commit,
    so every window carries one version. Raises ``AssertionError`` for a
    prompt no commit covers or a version that differs. → {"windows":
    windows holding outputs, "by_version": {mv: outputs}}."""
    closes: dict = {}
    for _member, offsets, version in commits:
        for tp, off in offsets.items():
            closes.setdefault(tp.partition, []).append((off, version))
    windows, by_version = set(), {}
    for p, o, mv in outputs:
        seen = [(i, off, v) for i, (off, v) in enumerate(closes.get(p, ())) if off > o]
        if not seen:
            raise AssertionError(f"output of {p}:{o} (mv {mv}) lies in no commit window")
        i, off, version = seen[0]
        if version != mv:
            raise AssertionError(f"output of {p}:{o} carries mv {mv}, but its window "
                                 f"(committed to {off}) closed under version {version}")
        windows.add((p, i))
        by_version[mv] = by_version.get(mv, 0) + 1
    return {"windows": len(windows), "by_version": by_version}


def _port_modules() -> tuple:
    import torchkafka_tpu_torch as top
    from torchkafka_tpu_torch import fleet, workload

    return top, workload, fleet


def autoscaled_run(cfg, params, *, prompt_len: int, max_new: int,
                   gen_kwargs: dict | None = None, modules: tuple | None = None) -> dict:
    """One autoscaled serve: a ``FleetAutoscaler`` (decode role, 1-4
    replicas) over a one-replica paged fleet of 2 slots, driven by a
    ``WorkloadGenerator`` step load of 36 records (seed 5, 3 tenants,
    300/s, 6x from 0.04 s to 0.14 s) under one ``ManualClock`` stepping
    2 ms a round. ``modules``: the (top-level, ``workload``, ``fleet``)
    modules of the package to drive, the port's by default;
    ``gen_kwargs`` are added to the replicas' (e.g. ``device``).
    → the completion order, trace events, committed and end offsets, the
    controller's summary and decision digest, and the replica joins."""
    top, wl, fl = modules or _port_modules()
    tick = 0.002
    gen = wl.WorkloadGenerator(
        wl.WorkloadConfig(tenants=3, total_records=36, arrival_rate=300.0, seed=5,
                          rate_schedule=wl.step_load(0.04, 6.0, 0.14)),
        prompt_len=prompt_len, max_new=max_new, vocab_size=cfg.vocab_size)
    mc = top.ManualClock()
    broker = top.InMemoryBroker()
    broker.create_topic("t", partitions=4)
    pages = {"block_size": 4, "num_blocks": 2 * -(-(prompt_len + max_new) // 4) + 16}
    fleet = fl.ServingFleet(
        gen.consumer_factory(broker, "t", "g", clock=mc), params, cfg, replicas=1,
        prompt_len=prompt_len, max_new=max_new, slots=2, commit_every=4, clock=mc.now,
        qos=fl.QoSConfig(), obs=True,
        gen_kwargs={"kv_pages": pages, "max_new_of": wl.header_max_new,
                    **(gen_kwargs or {})},
        slo_targets=[top.SLOTarget(metric="ttft", threshold_s=tick * 12, objective=0.75,
                                   fast_window_s=tick * 32, slow_window_s=tick * 128,
                                   min_samples=4)])
    ctrl = fl.AutoscaleController({"decode": fl.RolePolicy(
        min_replicas=1, max_replicas=4, queue_high=4, queue_low=1,
        up_cooldown_s=tick * 8, down_cooldown_s=tick * 24, down_confirm=6,
    )}, clock=mc.now, tracer=fleet.tracer, metrics=fleet.metrics)
    scaler = fl.FleetAutoscaler(fleet, ctrl)
    fleet.warmup()
    report = gen.drive(fleet, broker, "t", clock=mc, tick_dt=tick, settle_rounds=200,
                       on_round=lambda _f, _s: scaler.step())
    tps = [top.TopicPartition("t", p) for p in range(4)]
    out = {"order": [(rid, r.partition, r.offset, [int(x) for x in t])
                     for rid, r, t in report["completions"]],
           "events": [e.to_json() for e in fleet.tracer.events],
           "committed": [broker.committed("g", tp) or 0 for tp in tps],
           "ends": [broker.end_offset(tp) for tp in tps],
           "ctrl": ctrl.summary(), "digest": ctrl.decision_digest(),
           "joins": fleet.metrics.replica_joins.count}
    fleet.close()
    return out
