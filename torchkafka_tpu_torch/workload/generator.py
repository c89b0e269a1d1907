"""Deterministic production-traffic generation for the serving stack.

Copy of ``torchkafka_tpu/workload/generator.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

What "millions of users" looks like, distilled to the properties that
stress a serving system, each mapped to a seeded, replayable draw:

- **Zipf-distributed tenants** — a few tenants dominate, a long tail
  trickles (popularity exponent ``zipf_s``). The tenant name is the
  record KEY, so the broker's key-hash partitioner pins each tenant to a
  partition — Kafka's own multi-tenant idiom, and what makes per-tenant
  radix-cache locality real (a tenant's traffic lands on the replica
  that owns its partition).
- **Poisson burst arrivals** — bursts arrive as a Poisson process
  (exponential gaps at ``arrival_rate / burst_mean`` bursts/sec), each
  carrying ``1 + Poisson(burst_mean - 1)`` records at the same instant:
  open-loop offered load with the burstiness that defeats average-rate
  provisioning.
- **Heavy-tailed lengths** (lognormal or Pareto) — per record, the
  *uncached prompt suffix* length (the prefill work left after the
  tenant's shared context prefix radix-hits) and the *output budget*
  (enforced by ``StreamingGenerator(max_new_of=...)`` via the
  ``max_new`` record header). Means are configured; tails do the damage.
- **Mixed QoS lanes** — each record draws interactive vs batch
  (``interactive_fraction``), carried on the ``lane`` header the fleet's
  admission queue already classifies by.
- **Scheduled mid-run chaos** — replica kills at synthetic times (fired
  through ``ServingFleet.kill_replica``, i.e. the journal warm-failover
  path) and broker-outage windows (op-counted ``ChaosConsumer`` windows
  behind a ``ResilientConsumer``, the resilience layer's own machinery).

Everything is a pure function of ``WorkloadConfig.seed``: independent
``SeedSequence``-spawned streams per draw (tenants / arrivals / lengths /
lanes / payload) so tuning one knob never reshuffles another's schedule,
and ``schedule_digest()`` hashes the schedule bytes for byte-identity
assertions. Driven through ``drive()`` — which advances a ManualClock,
produces due arrivals, and fires due chaos once per fleet scheduling
round (``ServingFleet.serve(on_round=...)``) — a same-seed run replays
byte-identically: same arrival schedule, same tracer event stream, same
commit ledger. The repo's differential discipline, applied to traffic.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, NamedTuple

import numpy as np

from torchkafka_tpu_torch.source.records import Record

INTERACTIVE = "interactive"
BATCH = "batch"


def step_load(t_on: float, factor: float,
              t_off: float | None = None) -> tuple:
    """A step load schedule for ``WorkloadConfig.rate_schedule``: 1× base
    rate until ``t_on``, ``factor``× from then on (back to 1× at
    ``t_off`` when given) — the storm-arrives/storm-ends shape an
    autoscale controller must ride without flapping."""
    if t_on < 0 or factor <= 0:
        raise ValueError(f"need t_on >= 0, factor > 0, got {(t_on, factor)}")
    sched = [(0.0, 1.0), (float(t_on), float(factor))]
    if t_off is not None:
        if t_off <= t_on:
            raise ValueError(f"need t_off > t_on, got {(t_on, t_off)}")
        sched.append((float(t_off), 1.0))
    return tuple(sched)


def diurnal_load(period_s: float, peak: float, trough: float = 1.0,
                 phases: int = 8, cycles: int = 2) -> tuple:
    """A piecewise-constant diurnal curve: ``phases`` segments per
    period tracing trough → peak → trough (half-cosine), repeated for
    ``cycles`` periods — the day/night swell that rewards scale-down as
    much as scale-up."""
    if period_s <= 0 or peak < trough or trough <= 0:
        raise ValueError(
            f"need period_s > 0, peak >= trough > 0, got "
            f"{(period_s, peak, trough)}"
        )
    if phases < 2 or cycles < 1:
        raise ValueError(f"need phases >= 2, cycles >= 1, got "
                         f"{(phases, cycles)}")
    sched = []
    for c in range(cycles):
        for i in range(phases):
            frac = i / phases
            mult = trough + (peak - trough) * 0.5 * (
                1.0 - np.cos(2.0 * np.pi * frac)
            )
            sched.append((
                round((c + frac) * period_s, 9), round(float(mult), 6),
            ))
    return tuple(sched)


def rate_multiplier_at(schedule: tuple, t: float) -> float:
    """The offered-load multiplier at synthetic time ``t`` under a
    piecewise-constant ``rate_schedule`` (1.0 before the first entry or
    with no schedule at all)."""
    mult = 1.0
    for t0, m in schedule:
        if t0 > t:
            break
        mult = m
    return mult


def hot_set_shift_at(rotation: tuple, t: float) -> int:
    """The tenant-rank shift in force at synthetic time ``t`` under a
    piecewise-constant ``hot_set_rotation`` (0 before the first entry or
    with no rotation at all)."""
    shift = 0
    for t0, s in rotation:
        if t0 > t:
            break
        shift = int(s)
    return shift


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Mid-run chaos, on the workload's synthetic timeline.

    ``replica_kills``: (t_s, replica_id) pairs — at synthetic time t the
    replica is killed through the fleet's journal warm-failover path
    (skipped, and recorded as skipped, if it would kill the last
    runnable replica). ``broker_outages``: op-counted (start_op, n_ops)
    windows applied to EVERY consumer built by ``consumer_factory`` —
    polls and commits inside the window raise retryably and the
    resilience layer rides it out."""

    replica_kills: tuple = ()
    broker_outages: tuple = ()

    def __post_init__(self) -> None:
        for t_s, rid in self.replica_kills:
            if t_s < 0 or rid < 0:
                raise ValueError(
                    f"replica_kills need t_s >= 0, rid >= 0, got {(t_s, rid)}"
                )
        for start, n in self.broker_outages:
            if start < 0 or n < 1:
                raise ValueError(
                    "broker_outages need start_op >= 0, n_ops >= 1, got "
                    f"{(start, n)}"
                )


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Knobs for one synthetic traffic mix (see the module docstring for
    what each distribution models). ``arrival_rate`` is the OFFERED load
    in records/sec of synthetic time — overload sweeps multiply it and
    nothing else, so 1×/2×/4× slices share every other draw stream."""

    tenants: int = 8
    zipf_s: float = 1.1
    total_records: int = 128
    arrival_rate: float = 200.0
    burst_mean: float = 3.0
    interactive_fraction: float = 0.5
    length_dist: str = "lognormal"  # or "pareto"
    mean_suffix: float = 8.0    # mean uncached prompt-suffix tokens
    mean_output: float = 8.0    # mean output-budget tokens
    sigma: float = 0.8          # lognormal shape (log-space std)
    pareto_alpha: float = 1.5   # pareto shape (tail exponent)
    seed: int = 0
    chaos: ChaosSchedule = dataclasses.field(default_factory=ChaosSchedule)
    # Piecewise-constant offered-load multipliers ((t_s, factor), ...),
    # sorted by t_s: the effective rate at synthetic time t is
    # arrival_rate × the last factor whose t_s <= t. Build with
    # ``step_load`` / ``diurnal_load``. Only arrival INSTANTS change —
    # tenants, lanes, lengths, and payloads ride their own independent
    # draw streams, so scheduled and unscheduled runs stay comparable.
    rate_schedule: tuple = ()
    # Scheduled Zipf hot-set rotation ((t_s, shift), ...), strictly
    # increasing t_s: from synthetic time t_s on, popularity rank r maps
    # to tenant (r + shift) % tenants — the head of the Zipf curve
    # MOVES. The rank draw stream is consumed identically whatever the
    # rotation (the remap is pure arithmetic on the drawn rank), so a
    # rotated run shares every arrival instant, lane, and length with
    # its unrotated twin; only WHICH tenant (and hence which shared
    # context prefix — real prompt-content drift, the thing that decays
    # a distilled draft's α) changes at the configured instants.
    hot_set_rotation: tuple = ()

    def __post_init__(self) -> None:
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {self.tenants}")
        if self.zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0, got {self.zipf_s}")
        if self.total_records < 1:
            raise ValueError(
                f"total_records must be >= 1, got {self.total_records}"
            )
        if self.arrival_rate <= 0:
            raise ValueError(
                f"arrival_rate must be > 0 rec/s, got {self.arrival_rate}"
            )
        if self.burst_mean < 1:
            raise ValueError(f"burst_mean must be >= 1, got {self.burst_mean}")
        if not 0 <= self.interactive_fraction <= 1:
            raise ValueError(
                "interactive_fraction must sit in [0, 1], got "
                f"{self.interactive_fraction}"
            )
        if self.length_dist not in ("lognormal", "pareto"):
            raise ValueError(
                "length_dist must be 'lognormal' or 'pareto', got "
                f"{self.length_dist!r}"
            )
        if self.mean_suffix < 1 or self.mean_output < 1:
            raise ValueError("mean_suffix / mean_output must be >= 1")
        if self.length_dist == "pareto" and self.pareto_alpha <= 1:
            raise ValueError(
                f"pareto_alpha must be > 1 (finite mean), got "
                f"{self.pareto_alpha}"
            )
        last_t = -1.0
        for entry in self.rate_schedule:
            if len(entry) != 2:
                raise ValueError(
                    f"rate_schedule entries are (t_s, factor), got {entry!r}"
                )
            t_s, factor = entry
            if t_s < 0 or t_s <= last_t or factor <= 0:
                raise ValueError(
                    "rate_schedule needs strictly increasing t_s >= 0 and "
                    f"factors > 0, got {self.rate_schedule!r}"
                )
            last_t = t_s
        last_t = -1.0
        for entry in self.hot_set_rotation:
            if len(entry) != 2:
                raise ValueError(
                    "hot_set_rotation entries are (t_s, shift), got "
                    f"{entry!r}"
                )
            t_s, shift = entry
            if t_s < 0 or t_s <= last_t or int(shift) != shift:
                raise ValueError(
                    "hot_set_rotation needs strictly increasing t_s >= 0 "
                    f"and integer shifts, got {self.hot_set_rotation!r}"
                )
            last_t = t_s


class ArrivalEvent(NamedTuple):
    """One scheduled record: arrival instant (synthetic seconds), draw
    sequence number, tenant/lane, the heavy-tailed lengths, and the full
    prompt (tenant context prefix + fresh suffix, ``prompt_len`` total)."""

    t_s: float
    seq: int
    tenant: str
    lane: str
    suffix_len: int
    out_len: int
    prompt: np.ndarray

    @property
    def key(self) -> bytes:
        return self.tenant.encode("utf-8")

    @property
    def headers(self) -> tuple:
        return (
            ("lane", self.lane.encode("utf-8")),
            ("max_new", str(self.out_len).encode("utf-8")),
        )


def header_max_new(record: Record) -> int | None:
    """The generator's per-record output budget, read back from the
    ``max_new`` header — pass as ``StreamingGenerator(max_new_of=...)``
    (via ``gen_kwargs`` on a fleet) to enforce heavy-tailed output
    lengths."""
    for k, v in record.headers:
        if k == "max_new":
            try:
                return int(v)
            except ValueError:
                return None
    return None


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf popularity over ranks 1..n: p(rank) ∝ rank^-s."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


class WorkloadGenerator:
    """Synthesizes and drives one ``WorkloadConfig`` against a serving
    fleet. Construction binds the serving frame (``prompt_len`` /
    ``max_new`` / ``vocab_size``) the draws are clamped to; everything
    else is derived from the config's seed."""

    def __init__(
        self, config: WorkloadConfig, *, prompt_len: int, max_new: int,
        vocab_size: int,
    ) -> None:
        if prompt_len < 2:
            raise ValueError(f"prompt_len must be >= 2, got {prompt_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.config = config
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.vocab_size = vocab_size
        # One independent stream per draw: new knobs / different rates
        # never reshuffle another stream's schedule (the resilience
        # layer's per-fault-type spawn-key discipline).
        ss = np.random.SeedSequence(config.seed).spawn(5)
        self._rng_tenant = np.random.default_rng(ss[0])
        self._rng_arrival = np.random.default_rng(ss[1])
        self._rng_length = np.random.default_rng(ss[2])
        self._rng_lane = np.random.default_rng(ss[3])
        self._rng_payload = np.random.default_rng(ss[4])
        self.tenant_names = tuple(
            f"tenant-{i:02d}" for i in range(config.tenants)
        )
        self._weights = zipf_weights(config.tenants, config.zipf_s)
        # Per-tenant shared context stream: records reuse its prefix to
        # depth (prompt_len - suffix_len), so radix-cache hits follow
        # tenant locality. Drawn from the payload stream FIRST so record
        # suffix draws line up identically across configs.
        self._context = {
            t: self._rng_payload.integers(
                0, vocab_size, prompt_len, dtype=np.int32
            )
            for t in self.tenant_names
        }
        self._schedule: list[ArrivalEvent] | None = None

    # ---------------------------------------------------------- synthesis

    def _draw_len(self, mean: float, hi: int) -> int:
        cfg = self.config
        if cfg.length_dist == "lognormal":
            mu = np.log(mean) - cfg.sigma**2 / 2.0  # E[X] = mean
            x = self._rng_length.lognormal(mu, cfg.sigma)
        else:
            a = cfg.pareto_alpha
            xm = mean * (a - 1.0) / a  # Pareto(xm, a) mean = xm*a/(a-1)
            x = xm * (1.0 + self._rng_length.pareto(a))
        return int(np.clip(round(x), 1, hi))

    def schedule(self) -> list[ArrivalEvent]:
        """The full arrival schedule, synthesized once and cached — a
        pure function of (config, prompt_len, max_new, vocab_size)."""
        if self._schedule is not None:
            return self._schedule
        cfg = self.config
        events: list[ArrivalEvent] = []
        burst_rate = cfg.arrival_rate / cfg.burst_mean
        t = 0.0
        while len(events) < cfg.total_records:
            # Inhomogeneous arrivals by gap scaling: the unit draw stream
            # is consumed identically whatever the schedule, so a step or
            # diurnal curve changes arrival INSTANTS only (the same
            # stream-independence contract as scaling arrival_rate).
            gap = float(self._rng_arrival.exponential(1.0 / burst_rate))
            t += gap / rate_multiplier_at(cfg.rate_schedule, t)
            size = 1 + int(self._rng_arrival.poisson(cfg.burst_mean - 1.0))
            for _ in range(min(size, cfg.total_records - len(events))):
                seq = len(events)
                # The Zipf draw picks a popularity RANK; the rotation in
                # force at this instant maps rank → tenant. Pure
                # arithmetic after the draw: zero extra RNG consumption,
                # so rotated and unrotated runs share every stream.
                rank = int(
                    self._rng_tenant.choice(cfg.tenants, p=self._weights)
                )
                shift = hot_set_shift_at(cfg.hot_set_rotation, t)
                tenant = self.tenant_names[(rank + shift) % cfg.tenants]
                lane = (
                    INTERACTIVE
                    if self._rng_lane.random() < cfg.interactive_fraction
                    else BATCH
                )
                suffix = self._draw_len(
                    cfg.mean_suffix, self.prompt_len - 1
                )
                out_len = self._draw_len(cfg.mean_output, self.max_new)
                prompt = np.concatenate([
                    self._context[tenant][: self.prompt_len - suffix],
                    self._rng_payload.integers(
                        0, self.vocab_size, suffix, dtype=np.int32
                    ),
                ])
                events.append(ArrivalEvent(
                    round(t, 9), seq, tenant, lane, suffix, out_len, prompt,
                ))
        self._schedule = events
        return events

    def schedule_digest(self) -> str:
        """SHA-256 over the schedule's canonical bytes — the byte-
        identity handle for same-seed replay assertions."""
        h = hashlib.sha256()
        for ev in self.schedule():
            h.update(repr((
                ev.t_s, ev.seq, ev.tenant, ev.lane, ev.suffix_len,
                ev.out_len,
            )).encode())
            h.update(ev.prompt.tobytes())
        return h.hexdigest()

    def tenant_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {t: 0 for t in self.tenant_names}
        for ev in self.schedule():
            counts[ev.tenant] += 1
        return counts

    # ------------------------------------------------------------ serving

    def consumer_factory(
        self, broker, topic: str, group_id: str, *, resilient=None,
        clock=None,
    ) -> Callable[[int], object]:
        """A ``ServingFleet`` consumer factory over ``broker`` with the
        chaos schedule's broker-outage windows applied: MemoryConsumer →
        ChaosConsumer(outage windows) → ResilientConsumer (skip the last
        wrap with ``resilient=False``; without outage windows the chaos
        wrap is elided entirely). Deterministic per replica id.

        ``clock``: the drive's ManualClock — when given, the retry
        policy and circuit breaker run on the SAME synthetic timeline as
        everything else (backoff sleeps advance it, breaker cooldowns
        count rounds), which is what makes outage recovery — and with
        it the whole trace — byte-identical across same-seed replays.
        Leaving the resilience stack on the real clock makes breaker
        half-open probe timing wall-clock-dependent."""
        from torchkafka_tpu_torch.source.chaos import ChaosConsumer
        from torchkafka_tpu_torch.source.memory import MemoryConsumer

        outages = tuple(self.config.chaos.broker_outages)
        if resilient is None:
            resilient = bool(outages)

        def factory(rid: int):
            # Explicit zero-padded member ids: the broker range-assigns
            # over SORTED member ids, and the auto-generated fallback
            # ("member-<global counter>") sorts by digit count — two
            # same-seed runs in one process would draw different counter
            # values and could land different partition splits. A pure
            # function of (group, rid) keeps placement replayable, scale
            # events included.
            consumer = MemoryConsumer(
                broker, topic, group_id=group_id,
                member_id=f"{group_id}-r{rid:03d}",
            )
            if outages:
                consumer = ChaosConsumer(
                    consumer, seed=self.config.seed * 1009 + rid,
                    outages=list(outages),
                )
            if resilient:
                from torchkafka_tpu_torch.resilience import (
                    CircuitBreaker, ResilientConsumer, RetryPolicy,
                )

                kw = {}
                bkw = {}
                if clock is not None:
                    kw = {"clock": clock.now, "sleep": clock.sleep}
                    bkw = {"clock": clock.now}
                consumer = ResilientConsumer(
                    consumer,
                    policy=RetryPolicy(
                        max_attempts=2, base_delay_s=0.001,
                        max_delay_s=0.002, deadline_s=5.0,
                        seed=self.config.seed * 1013 + rid, **kw,
                    ),
                    breaker=CircuitBreaker(
                        failure_threshold=2, reset_timeout_s=0.02, **bkw,
                    ),
                )
            return consumer

        return factory

    def produce_due(self, broker, topic: str, now_s: float,
                    cursor: int) -> int:
        """Produce every scheduled arrival with ``t_s <= now_s`` starting
        at ``cursor``; returns the new cursor. Records carry the tenant
        key (partition pinning), lane + max_new headers, and the
        synthetic arrival time as their timestamp."""
        sched = self.schedule()
        while cursor < len(sched) and sched[cursor].t_s <= now_s:
            ev = sched[cursor]
            broker.produce(
                topic, ev.prompt.tobytes(), key=ev.key,
                headers=ev.headers,
                timestamp_ms=int(round(ev.t_s * 1e3)),
            )
            cursor += 1
        return cursor

    def drive(
        self,
        fleet,
        broker,
        topic: str,
        *,
        clock,
        tick_dt: float = 0.002,
        idle_timeout_ms: int = 4000,
        settle_s: float = 10.0,
        on_round: "Callable | None" = None,
        settle_rounds: int | None = None,
    ) -> dict:
        """Run the schedule through ``fleet`` on the synthetic timeline.

        Once per fleet scheduling round (``serve(on_round=...)``): the
        ManualClock advances ``tick_dt`` (the synthetic cost of one
        round — what turns offered-load excess into real queueing in the
        SLO numbers), due arrivals are produced, and due replica kills
        fire through the journal warm-failover path. After serving,
        survivable commit failures left by outage windows are retried
        until the ledger settles (bounded by ``settle_s`` wall seconds).

        ``on_round(fleet, served)``: an extra per-round callback run
        AFTER the driver's own work (arrivals produced, chaos fired) —
        the autoscale controller's injection point: it samples the round
        the load change already hit and actuates before the next round
        serves. Anything it does rides the same synthetic timeline, so
        the whole control loop replays with the rest.

        ``settle_rounds``: DETERMINISTIC termination for control-loop
        replays. Without it, serve() ends on a wall-clock idle timeout —
        the number of trailing idle rounds (each advancing the synthetic
        clock) varies run to run, which is invisible when nothing
        happens in them but breaks byte-identity the moment a controller
        acts there. With it, once the schedule has fully arrived and the
        fleet has quiesced (nothing active, queued, or commit-pending),
        exactly ``settle_rounds`` more rounds run — room for the
        controller's post-storm scale-downs to fire on the synthetic
        clock — and then the fleet DRAINS (warm: finish, commit, leave),
        so the run ends at the same round on every replay.

        Returns completions (fleet order, duplicates included), the
        kills that fired/skipped, rounds driven, and whether the
        schedule fully arrived and served."""
        import time as _time

        sched = self.schedule()
        cursor = 0
        rounds = 0
        settled = 0
        kills = sorted(self.config.chaos.replica_kills)
        fired: list[tuple[float, int]] = []
        skipped: list[tuple[float, int]] = []

        class _Stop:
            requested = False

        stop = _Stop()

        def _on_round(f, _served):
            nonlocal cursor, rounds, settled
            rounds += 1
            clock.advance(tick_dt)
            now = clock.now()
            cursor = self.produce_due(broker, topic, now, cursor)
            while kills and kills[0][0] <= now:
                t_s, rid = kills.pop(0)
                runnable = [r for r in f.replicas if r.runnable]
                victim = f.replicas[rid] if rid < len(f.replicas) else None
                if (
                    victim is not None and victim.runnable
                    and len(runnable) > 1
                ):
                    f.kill_replica(rid)
                    fired.append((t_s, rid))
                else:
                    skipped.append((t_s, rid))
            if cursor == len(sched):
                # Schedule exhausted and the fleet idle: flush the
                # cadence stragglers NOW, at the synthetic instant the
                # work actually finished — otherwise their commit (and
                # the trace's e2e) is stamped thousands of empty rounds
                # later, when the real-time idle timeout finally trips.
                live = [r for r in f.replicas if r.runnable]
                if live and not any(
                    r.gen.has_active() or r.queue.depth() for r in live
                ):
                    for r in live:
                        r.maybe_flush(force=True)
            if on_round is not None:
                on_round(f, _served)
            if settle_rounds is not None and not stop.requested:
                live = [r for r in f.replicas if r.runnable]
                quiesced = cursor == len(sched) and live and not any(
                    r.gen.has_active() or r.queue.depth()
                    or r.gen.pending_commit
                    for r in live
                )
                settled = settled + 1 if quiesced else 0
                if settled >= settle_rounds:
                    stop.requested = True

        completions = fleet.serve_all(
            idle_timeout_ms=idle_timeout_ms, on_round=_on_round,
            shutdown=stop,
        )
        # Outage-window commit failures are survivable: completions stay
        # commit-pending; retry against the healed broker.
        deadline = _time.monotonic() + settle_s
        while any(rep.gen.pending_commit for rep in fleet.replicas):
            for rep in fleet.replicas:
                if rep.runnable and rep.gen.pending_commit:
                    rep.gen.flush_commits()
            if _time.monotonic() > deadline:
                break
            _time.sleep(0.002)
        served_keys = [
            (rec.partition, rec.offset) for _rid, rec, _t in completions
        ]
        return {
            "completions": completions,
            "served_keys": served_keys,
            "unique_served": len(set(served_keys)),
            "duplicates": len(served_keys) - len(set(served_keys)),
            "arrived": cursor,
            "all_arrived": cursor == len(sched),
            "kills_fired": fired,
            "kills_skipped": skipped,
            "rounds": rounds,
            "end_time_s": clock.now(),
        }
