"""Partitioned multi-replica serving, the fleet orchestrator: port of
``torchkafka_tpu/fleet/fleet.py``.

``ServingFleet`` runs N serving replicas as members of ONE consumer group
over the prompt topic, so partitions range-assign across replicas and the
at-least-once contract holds *per prompt across replica failure* — the
consumer-group machinery that is battle-tested for training ingest
(source/memory.py range assignment + generations; tests/test_pod.py
elastic leave/join with exact re-delivery) generalized to the serving
path, the way vLLM-class production stacks put a router with admission
control in front of continuous-batching engines.

The scheduler is COOPERATIVE: ``serve()`` round-robins one ``pump()``
(poll → QoS admit → one tick block) across live replicas on the calling
thread, which keeps every chaos/drain interleaving deterministic under a
seeded schedule — the property the differential tests are built on. Each
replica is still a real, independent group member with its own consumer,
ledger, and commits; point the ``consumer_factory`` at a
``BrokerClient`` (source/netbroker.py) and the same fleet spans OS
processes, one replica each, exactly like the elastic pod tests.

Failure model:

- ``kill_replica`` / ``ReplicaChaos``: the victim leaves the group with
  nothing committed past its last cadence commit. The rebalance hands its
  partitions to survivors, whose polls resume from the committed offset —
  its uncommitted prompts re-deliver and regenerate. Completions the
  victim emitted but never committed are served AGAIN by a survivor
  (duplicates, counted in ``FleetMetrics.duplicates``); completions it
  committed never re-deliver. No prompt is lost, and no commit ever
  covers unfinished work (each replica's interval ledger guarantees it
  locally; the fleet's commit-follows-completion pump ordering makes it
  observable globally).
- ``ShutdownSignal`` / ``drain()``: stop admitting fleet-wide, finish
  every in-flight generation, commit, leave the group — a restart resumes
  with zero replayed completions (drain is the replay-free shutdown; kill
  is the loss-free crash).

Replay-free drain requires per-partition FIFO admission: the ledger
watermark can only cover a completion once every EARLIER offset of its
partition is retired, so a QoS policy that admits offset 10 ahead of a
still-queued offset 3 of the SAME partition (cross-tenant throttling or
cross-lane priority inside one partition) leaves 10 uncommittable at
drain — it re-serves after restart (at-least-once still holds; the
duplicate is the cost). Keep tenants/lanes partition-aligned (keyed
production — Kafka's own multi-tenant idiom) and drain replay-freedom
holds alongside QoS.

Port notes: every replica builds its own pools on the one device and
shares the caller's ``params`` tree (the servers keep the leaves that
already sit on their device, so N replicas hold one copy of the
weights); replicas run in turn on the calling thread, so their kernel
launches interleave on one CUDA stream.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterator

import numpy as np

from torchkafka_tpu_torch.parallel.lockstep import agree
from torchkafka_tpu_torch.commit.ledger import merged_watermarks
from torchkafka_tpu_torch.fleet.metrics import FleetMetrics
from torchkafka_tpu_torch.fleet.prefill import PrefillRouter, drain_handoffs
from torchkafka_tpu_torch.fleet.qos import AdmissionQueue, QoSConfig, TenantBuckets
from torchkafka_tpu_torch.fleet.replica import (
    DEAD,
    DRAINING,
    SERVING,
    Replica,
)
from torchkafka_tpu_torch.journal import DecodeJournal
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.records import Record

_logger = logging.getLogger(__name__)


class ReplicaChaos:
    """Seeded replica-death schedule for chaos runs.

    Picks (victim, kill point) from ``seed`` once the fleet is known;
    fires when the fleet has served ``>= kill point`` completions AND the
    victim is mid-generation with at least one completion already emitted
    — the conditions under which a death provably exercises redelivery
    (something uncommitted exists) rather than dying idle. Deterministic:
    the same seed against the same fleet kills the same replica at the
    same completion count."""

    def __init__(
        self, seed: int = 0, *, min_completions: int = 1,
        max_completions: int = 8, kills: int = 1,
    ) -> None:
        if min_completions < 1 or max_completions < min_completions:
            raise ValueError(
                "need 1 <= min_completions <= max_completions for a kill "
                "point that can exercise redelivery"
            )
        self._rng = np.random.default_rng(seed)
        self._lo, self._hi = min_completions, max_completions
        self._kills_left = kills
        self._victim: int | None = None
        self._at: int | None = None
        self.killed: list[int] = []

    def maybe_kill(self, fleet: "ServingFleet", served: int) -> None:
        if self._kills_left <= 0:
            return
        if self._victim is None:
            self._victim = int(self._rng.integers(len(fleet.replicas)))
            self._at = int(self._rng.integers(self._lo, self._hi + 1))
        if served < (self._at or 0):
            return

        def eligible(r) -> bool:
            return (
                r.runnable
                and r.gen.has_active()
                and fleet.metrics.replica_completions(r.id).count >= 1
            )

        victim = fleet.replicas[self._victim]
        if not eligible(victim):
            # The drawn victim cannot exercise redelivery — it drained,
            # died on its own, or simply owns no active work (a keyed
            # topic can concentrate every partition's traffic on one
            # replica). Re-draw among replicas that CAN die
            # mid-generation; if none can right now, wait (still
            # deterministic: re-draws consume the seeded stream only when
            # an eligible replica exists).
            live = [r.id for r in fleet.replicas if eligible(r)]
            if not live:
                return
            self._victim = int(live[self._rng.integers(len(live))])
            victim = fleet.replicas[self._victim]
        fleet.kill_replica(victim.id)
        self.killed.append(victim.id)
        self._kills_left -= 1
        self._victim = None
        self._at = None


class ServingFleet:
    """N replicas, one consumer group, QoS admission in front.

    ``consumer_factory(rid) -> Consumer`` must return a GROUP-MANAGED
    consumer over the prompt topic (same group_id for every replica —
    that sharing is the whole mechanism). ``generator_cls`` defaults to
    ``StreamingGenerator``; pass ``SpecStreamingGenerator`` for a
    speculative fleet. ``gen_kwargs`` forward to the generator
    constructor (kv_dtype, ticks_per_sync, output_producer, ...).

    ``commit_every`` is the per-replica commit cadence in COMPLETIONS,
    owned by the fleet loop (the generators' internal cadence is
    disabled) so commits happen only at points where the fleet has
    already registered every completion they cover.

    ``journal_dir``/``journal_cadence``: WARM failover
    (torchkafka_tpu_torch/journal). Each replica writes a decode journal
    (``<journal_dir>/replica_<rid>.json``) of its in-flight generations.
    When a replica dies — ``kill_replica``, ``ReplicaChaos``, or a
    SIGTERM drain that overruns ``drain_timeout_s`` — the fleet loads
    the victim's journal FROM DISK (exactly what a survivor of a real
    process death would see) and installs its entries as resume hints on
    every surviving replica, so the rebalance-redelivered prompts
    warm-resume instead of re-decoding from token 0. On construction,
    journals left by a PREVIOUS incarnation are consulted the same way —
    a whole-fleet crash restarts warm too.

    ``gen_kwargs={"mesh": mesh}`` (sharded replicas): every rank of the
    mesh builds the fleet with the same arguments; the factory returns the
    root's consumers and None on the other ranks, each is read through a
    ``parallel.lockstep.MeshConsumer``, and the idle timeout is the
    root's (the loops stay in step on the root's records).
    """

    def __init__(
        self,
        consumer_factory: Callable[[int], object],
        params,
        cfg,
        *,
        replicas: int = 2,
        prompt_len: int,
        max_new: int,
        slots: int = 4,
        eos_id: int | None = None,
        qos: QoSConfig | None = None,
        commit_every: int = 8,
        generator_cls: type = StreamingGenerator,
        max_poll_records: int = 256,
        clock: Callable[[], float] = time.monotonic,
        gen_kwargs: dict | None = None,
        journal_dir: str | os.PathLike | None = None,
        journal_cadence: int = 8,
        drain_timeout_s: float | None = None,
        obs=None,
        slo_targets=None,
        handoff_consumer_factory: Callable[[int], object] | None = None,
        route_patience: int = 256,
    ) -> None:
        """``obs``: record-lifecycle tracing + SLO histograms for the
        whole fleet (torchkafka_tpu_torch/obs). ``True`` builds a tracer on
        the fleet's own injectable ``clock`` (so ManualClock fleets get
        deterministic timestamps for free); an ``obs.ObsConfig`` sets
        policy (ring capacity, JSONL sink, token events); an existing
        ``obs.RecordTracer`` is shared as-is. The ONE tracer spans every
        replica — events tag the replica id, the SLO histograms label by
        lane/tenant/replica, and ``metrics.summary()`` gains an ``slo``
        section. None (default): zero tracing, guard-only cost.

        ``handoff_consumer_factory``: disaggregated-prefill adoption for
        an in-process fleet — ``(rid) -> Consumer`` tailing the handoff
        topic (one PRIVATE group per replica: handoffs broadcast).
        Each replica then routes admission through a ``PrefillRouter``
        (``route_patience`` hold decisions before the local-prefill
        fallback) and the serve loop drains arrived handoffs onto the
        generator's shelf every round. Requires paged generators
        (``gen_kwargs={"kv_pages": ...}``).

        ``slo_targets``: a list of ``obs.SLOTarget`` — builds a
        ``BurnRateMonitor`` over the tracer's windowed SLO view
        (requires ``obs``; with ``obs=True`` the window width defaults
        to a quarter of the fastest target's fast window), evaluated
        once per scheduling round. Its state transitions ride the trace
        stream as typed ``burn_state`` events, its per-tenant goodput
        ledger rides ``metrics.summary()``, and its shedding state
        becomes the AdmissionQueue overload hook: batch-lane admission
        DEFERS while the SLO burns, instead of the whole fleet
        collapsing together. ``fleet.monitor`` exposes it."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._qos = qos or QoSConfig()
        self._clock = clock
        self.metrics = FleetMetrics()
        self.tracer = None
        self.monitor = None
        if slo_targets and not obs:
            raise ValueError(
                "slo_targets need the tracer: pass obs=True (or an "
                "ObsConfig with window_s set)"
            )
        if obs is not None and obs is not False:
            from torchkafka_tpu_torch.obs import ObsConfig, RecordTracer

            if isinstance(obs, RecordTracer):
                self.tracer = obs
            elif isinstance(obs, ObsConfig):
                self.tracer = RecordTracer(obs)
            elif obs is True:
                kw = {}
                if slo_targets:
                    kw["window_s"] = min(
                        t.fast_window_s for t in slo_targets
                    ) / 4.0
                self.tracer = RecordTracer(ObsConfig(clock=clock, **kw))
            else:
                raise TypeError(
                    "obs must be True, an ObsConfig, or a RecordTracer, "
                    f"got {type(obs).__name__}"
                )
            self.metrics.attach_slo(self.tracer.slo)
        if slo_targets:
            from torchkafka_tpu_torch.obs import BurnRateMonitor

            self.monitor = BurnRateMonitor(
                self.tracer.slo, slo_targets, tracer=self.tracer,
            )
            self.tracer.attach_monitor(self.monitor)
            self.metrics.attach_burn(self.monitor)
        self._buckets = TenantBuckets(self._qos, clock)
        # Everything _build_replica needs, kept so ``scale_to`` can join
        # fresh group members MID-SERVE with the exact construction the
        # initial replicas got (same shared params, same QoS plumbing).
        self._factory = consumer_factory
        self._params = params
        self._cfg = cfg
        self._slots = slots
        self._prompt_len = prompt_len
        self._max_new = max_new
        self._eos_id = eos_id
        self._commit_every = commit_every
        self._generator_cls = generator_cls
        self._max_poll_records = max_poll_records
        self._gen_kwargs = dict(gen_kwargs or {})
        self._handoff_factory = handoff_consumer_factory
        self._route_patience = route_patience
        self._handoff_tails: dict[int, object] = {}
        self._journal_cadence = journal_cadence
        self._warmed = False
        self._journal_paths: dict[int, str] = {}
        self._journal_dir = (
            None if journal_dir is None else os.fspath(journal_dir)
        )
        carried_hints: dict = {}
        if self._journal_dir is not None:
            os.makedirs(self._journal_dir, exist_ok=True)
            for rid in range(replicas):
                path = os.path.join(
                    self._journal_dir, f"replica_{rid}.json"
                )
                # A journal left by a previous incarnation = that
                # replica's in-flight state at the whole-fleet crash;
                # its prompts redeliver to THIS incarnation's members.
                carried_hints.update(DecodeJournal.load(path))
            if carried_hints:
                _logger.info(
                    "fleet restart: %d journal entries carried over for "
                    "warm resume", len(carried_hints),
                )
        self.replicas: list[Replica] = []
        for _ in range(replicas):
            gen = self._build_replica().gen
            if carried_hints:
                gen.add_resume_hints(carried_hints)
        self._draining = False
        self._drain_timeout_s = drain_timeout_s
        self._drain_started: float | None = None
        # Every (topic, partition, offset) a completion has been emitted
        # for, fleet-wide — updated BEFORE any commit that could cover it
        # (the pump/maybe_flush ordering), so an external observer can
        # assert "committed ⊆ completed" at every commit point.
        self.completed: set[tuple[str, int, int]] = set()

    # ---------------------------------------------------------- elasticity

    def _build_replica(self) -> Replica:
        """Construct and register one replica (the next free id): its
        group-managed consumer, generator, admission queue — and, for a
        disaggregated fleet, its private handoff tail + PrefillRouter.
        Used by the constructor AND by ``scale_to`` mid-serve (the new
        consumer's join triggers the rebalance that hands it
        partitions)."""
        rid = len(self.replicas)
        consumer = self._factory(rid)
        kw = dict(self._gen_kwargs)
        if kw.get("mesh") is not None:
            # A fleet of mesh-sharded replicas runs on every rank of the
            # mesh; the factory gives the root a consumer and the other
            # ranks None, and every rank reads the root's answers.
            from torchkafka_tpu_torch.parallel.lockstep import MeshConsumer

            consumer = MeshConsumer(consumer, kw["mesh"])
        if self._journal_dir is not None:
            path = os.path.join(self._journal_dir, f"replica_{rid}.json")
            self._journal_paths[rid] = path
            kw["journal"] = DecodeJournal(
                path, cadence=self._journal_cadence
            )
        if self.tracer is not None:
            kw.setdefault("tracer", self.tracer)
            kw.setdefault("trace_replica", rid)
        gen = self._generator_cls(
            consumer, self._params, self._cfg,
            slots=self._slots, prompt_len=self._prompt_len,
            max_new=self._max_new, eos_id=self._eos_id,
            # The fleet loop owns the cadence (commit-follows-
            # completion ordering); the generator must never
            # self-commit mid-step.
            commit_every=2**31 - 1,
            **kw,
        )
        prefill_router = None
        if self._handoff_factory is not None:
            self._handoff_tails[rid] = self._handoff_factory(rid)
            prefill_router = PrefillRouter(
                gen, patience=self._route_patience
            ).should_hold
        queue = AdmissionQueue(
            self._qos, self._buckets, self.metrics, self._clock,
            tracer=self.tracer, replica=rid,
            overload=(
                self.monitor.should_defer
                if self.monitor is not None else None
            ),
            on_overload_defer=(
                self.monitor.note_deferred
                if self.monitor is not None else None
            ),
            prefill_router=prefill_router,
        )
        rep = Replica(
            rid, gen, consumer, queue, self._qos, self.metrics,
            commit_every=self._commit_every,
            max_poll_records=self._max_poll_records, clock=self._clock,
        )
        self.replicas.append(rep)
        self.metrics.replica_joins.add(1)
        if self.tracer is not None:
            self.tracer.replica_joined(f"replica-{rid}", replica=rid)
        if self._warmed:
            gen.warmup()  # a joiner after fleet.warmup() is warmed too
        return rep

    def live_count(self) -> int:
        """Replicas currently SERVING (draining members are winding down
        and no longer count as capacity — the autoscaler's view)."""
        return sum(1 for r in self.replicas if r.state == SERVING)

    def scale_to(self, n: int) -> None:
        """Elastic membership mid-serve, in-process: the ServingFleet
        twin of ``ProcessFleet.scale``. Scale-UP builds fresh replicas
        (their consumers join the group — the rebalance hands them
        partitions; a joiner after ``warmup`` is warmed at once).
        Scale-DOWN drains the NEWEST serving replicas
        WARM (stop admitting, finish in-flight generations, commit,
        leave — zero lost, zero replay at quiesced transitions); the
        serve loop completes the drain."""
        if n < 1:
            raise ValueError(f"scale target must be >= 1, got {n}")
        serving = [r for r in self.replicas if r.state == SERVING]
        if n > len(serving):
            for _ in range(n - len(serving)):
                self._build_replica()
        elif n < len(serving):
            # LIFO: the longest-lived replicas keep their partition and
            # radix-cache locality.
            for rep in serving[n:]:
                rep.start_drain()

    # ------------------------------------------------------------- control

    def warmup(self) -> None:
        """Warm every replica (``StreamingGenerator.warmup``: the kernels
        load on replica 0, every replica's pools and library handles
        warm)."""
        for rep in self.replicas:
            rep.gen.warmup()
        self._warmed = True

    def drain(self) -> None:
        """Fleet-wide graceful drain: stop admitting everywhere; serve()
        finishes in-flight generations, commits, and leaves the group.
        With ``drain_timeout_s`` set, a replica whose in-flight work
        outlives the timeout is escalated: its journal is synced (the
        one cooperative act a SIGTERM grace window still allows) and the
        replica is killed — its uncommitted prompts re-deliver to the
        NEXT incarnation, which warm-resumes them from the synced
        journal instead of re-decoding from token 0."""
        self._draining = True
        self._drain_started = self._clock()
        for rep in self.replicas:
            rep.start_drain()

    def _enforce_drain_timeout(self) -> None:
        if (
            self._drain_timeout_s is None
            or self._drain_started is None
            or self._clock() - self._drain_started < self._drain_timeout_s
        ):
            return
        for rep in self.replicas:
            if rep.state == DRAINING:
                # Last cooperative act before the axe: the journal's
                # disk state becomes exactly current, so the overrun
                # in-flight work resumes warm (and token-exact) later.
                rep.gen.sync_journal()
                _logger.warning(
                    "replica %d overran drain timeout (%.1fs); killing "
                    "with journal synced for warm resume", rep.id,
                    self._drain_timeout_s,
                )
                self.kill_replica(rep.id)
                self.metrics.drain_timeout_kills.add(1)

    def start_rollout(
        self,
        version: int,
        params_by_version: dict,
        *,
        canary_replica: int = 0,
        canary_slice: int = 8,
        max_canary_diffs: int = 0,
        incumbent_version: int = 0,
    ):
        """Begin a rolling hot-swap to ``version`` on this in-process
        fleet (fleet/rollout.py). ``params_by_version`` maps version
        ints to params trees — the in-process twin of the checkpoint
        topic; it must hold the target AND the incumbent (rollback swaps
        back to it). Returns an ``InProcessRolloutDriver``: plug its
        ``on_round`` into ``serve(on_round=...)`` and feed every yielded
        completion to ``observe(rid, rec, tokens)`` — the canary's
        token-diff stream. ``trace_acks`` is off because each
        generator's own ``swap_params`` already types the ``swapped``
        event with its replica id."""
        from torchkafka_tpu_torch.fleet.rollout import (
            InProcessRolloutDriver,
            RolloutController,
        )

        ctl = RolloutController(
            [r.id for r in self.replicas if r.state == SERVING],
            int(version),
            canary_member=canary_replica,
            canary_slice=canary_slice,
            max_canary_diffs=max_canary_diffs,
            incumbent_version=incumbent_version,
            tracer=self.tracer, metrics=self.metrics,
            trace_acks=False,
        )
        return InProcessRolloutDriver(self, ctl, params_by_version)

    def start_distill(
        self,
        *,
        policy=None,
        broker=None,
        ckpt_topic: str | None = None,
        versions: dict | None = None,
        applied_version: int = 0,
    ):
        """Close the online-distillation loop on this in-process fleet
        (torchkafka_tpu_torch/distill): a ``DistillController`` tracking the
        windowed live-α from every replica's ``spec_stats`` (requires
        ``generator_cls=SpecStreamingGenerator``) and an
        ``InProcessDistillDriver`` applying refresh directives via
        ``swap_draft_params`` — between ticks, no quiesce, committed
        tokens invariant. Plug the returned driver's ``on_round`` into
        ``serve(on_round=...)`` (compose with a workload driver's hook
        by calling both) and push published draft versions with
        ``driver.note_version``. Delivery is ``broker``+``ckpt_topic``
        (wire fetch, CRC-validated) or a ``versions`` dict (in-process
        twin). The controller shares the fleet clock, so ManualClock
        fleets replay the whole control loop byte-identically."""
        from torchkafka_tpu_torch.distill.controller import (
            DistillController,
            InProcessDistillDriver,
        )

        ctl = DistillController(
            policy,
            applied_version=applied_version,
            clock=self._clock,
            tracer=self.tracer,
            metrics=self.metrics,
        )
        return InProcessDistillDriver(
            self, ctl, broker=broker, ckpt_topic=ckpt_topic,
            versions=versions,
        )

    def kill_replica(self, rid: int) -> None:
        """Simulate a replica crash (see Replica.kill), then consult the
        victim's decode journal for warm failover: its entries — read
        FROM DISK, exactly the state a real process death leaves behind,
        never the dead generator's fresher in-memory view — become resume
        hints on every survivor. The rebalance re-delivers the victim's
        uncommitted prompts to whichever survivor inherits the
        partitions; the hint is consumed there (CRC-checked), and stale
        copies on the other survivors sit harmlessly."""
        self.replicas[rid].kill()
        self._close_handoff_tail(rid)
        self.metrics.replica_deaths.add(1)
        self.metrics.replica_fences.add(1)
        if self.tracer is not None:
            self.tracer.replica_fenced(
                f"replica-{rid}", reason="kill", replica=rid,
            )
        self._install_journal_hints(rid)

    def _install_journal_hints(self, rid: int) -> None:
        path = self._journal_paths.get(rid)
        if path is None:
            return
        hints = DecodeJournal.load(path)
        if not hints:
            return
        survivors = [r for r in self.replicas if r.runnable]
        for rep in survivors:
            rep.gen.add_resume_hints(hints)
        self.metrics.journal_handoffs.add(len(hints))
        if self.tracer is not None:
            self.tracer.journal_handoff(
                f"replica-{rid}", len(hints), replica=rid,
            )
        _logger.info(
            "replica %d death: %d journal entries handed to %d "
            "survivor(s) for warm resume", rid, len(hints), len(survivors),
        )

    def _close_handoff_tail(self, rid: int) -> None:
        tail = self._handoff_tails.pop(rid, None)
        if tail is None:
            return
        try:
            tail.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            _logger.exception("handoff tail close failed for replica %d", rid)

    def close(self) -> None:
        """Graceful stop outside serve(): commit completed work, leave."""
        for rep in self.replicas:
            rep.close()
        for rid in list(self._handoff_tails):
            self._close_handoff_tail(rid)

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- observability

    def watermarks(self) -> dict:
        """Fleet-level committable view: per-replica ledger snapshots
        merged fail-low (commit.ledger.merged_watermarks)."""
        return merged_watermarks([
            rep.gen.committable_offsets()
            for rep in self.replicas if rep.state != DEAD
        ])

    def pending_by_replica(self) -> dict[int, int]:
        """In-flight (fetched-but-unretired) records per replica."""
        return {
            rep.id: sum(rep.gen._ledger.pending_by_partition().values())
            for rep in self.replicas
        }

    # --------------------------------------------------------------- serve

    def serve(
        self,
        max_records: int | None = None,
        idle_timeout_ms: int = 2000,
        shutdown=None,
        chaos: ReplicaChaos | None = None,
        on_round: Callable[["ServingFleet", int], None] | None = None,
    ) -> Iterator[tuple[int, Record, np.ndarray]]:
        """Yield ``(replica_id, record, tokens)`` in fleet completion
        order until ``max_records`` completions, an idle timeout, or a
        completed drain.

        ``shutdown``: a ``ShutdownSignal`` (or anything with a
        ``requested`` bool) — when it fires, the fleet drains gracefully
        and serve() returns after the last in-flight generation commits.
        ``chaos``: a ``ReplicaChaos`` schedule, evaluated once per
        scheduling round. ``on_round(fleet, served)``: called once at
        the top of every scheduling round — the workload driver's
        injection point (advance a synthetic clock, produce due
        arrivals, fire scheduled chaos) so open-loop load generation
        stays deterministic against the cooperative scheduler."""
        served = 0
        exhausted_at: float | None = None
        while True:
            if on_round is not None:
                on_round(self, served)
            if (
                shutdown is not None
                and getattr(shutdown, "requested", False)
                and not self._draining
            ):
                self.drain()
            if self._draining:
                self._enforce_drain_timeout()
            progressed = False
            for rep in self.replicas:
                if not rep.runnable:
                    continue
                tail = self._handoff_tails.get(rep.id)
                if tail is not None:
                    # Disaggregated adoption: arrived handoffs land on
                    # the generator's shelf BEFORE this round's
                    # admission sweep, so the router releases their
                    # records the same round.
                    drain_handoffs(tail, rep.gen)
                completions = rep.pump()
                # Register BEFORE the flush below: every commit must only
                # ever cover completions already in self.completed.
                for rec, _toks in completions:
                    key = (rec.topic, rec.partition, rec.offset)
                    if key in self.completed:
                        self.metrics.duplicates.add(1)
                    self.completed.add(key)
                self.metrics.completions.add(len(completions))
                rep.maybe_flush()
                if rep.drain_idle:
                    rep.finish_drain()
                    self._close_handoff_tail(rep.id)
                    self.metrics.drains.add(1)
                if completions:
                    progressed = True
                for rec, toks in completions:
                    served += 1
                    yield rep.id, rec, toks
            if self.monitor is not None:
                # One burn-rate sweep per scheduling round: cheap (no
                # new samples → no transitions), deterministic, and the
                # NEXT round's admission sweeps see the fresh state.
                self.monitor.evaluate()
            if chaos is not None:
                chaos.maybe_kill(self, served)
            live = [r for r in self.replicas if r.runnable]
            if not live:
                break  # drained (or every replica died)
            if max_records is not None and served >= max_records and not any(
                r.gen.has_active() for r in live
            ):
                break
            idle = not progressed and not any(
                r.gen.has_active() for r in live
            )
            if idle:
                if not any(r.queue.depth() for r in live):
                    # Truly exhausted (no work anywhere): start the idle
                    # clock. A non-empty queue with nothing admissible is
                    # the THROTTLED case — wait for token refill without
                    # burning a core, but never time out on it.
                    if exhausted_at is None:
                        exhausted_at = time.monotonic()
                    elif agree(self._gen_kwargs.get("mesh"), (
                        time.monotonic() - exhausted_at
                    ) * 1e3 >= idle_timeout_ms):
                        # On a mesh the root's clock decides for every rank.
                        break
                time.sleep(0.001)
            else:
                exhausted_at = None
        for rep in self.replicas:
            if rep.runnable:
                rep.maybe_flush(force=True)

    # Convenience for scripts/tests that just want everything served.
    def serve_all(
        self, max_records: int | None = None, idle_timeout_ms: int = 2000,
        shutdown=None, chaos: ReplicaChaos | None = None, on_round=None,
    ) -> list[tuple[int, Record, np.ndarray]]:
        return list(self.serve(
            max_records, idle_timeout_ms, shutdown=shutdown, chaos=chaos,
            on_round=on_round,
        ))
