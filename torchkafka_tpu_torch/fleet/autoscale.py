"""The autoscaling loop: burn-rate + queue-depth signals driving
per-role fleet scaling, with hysteresis and warm drain.

Copy of ``torchkafka_tpu/fleet/autoscale.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

Every mechanism this controller composes already exists as a measured
part — ``BurnRateMonitor`` emits typed ok→warning→burning→shedding
transitions (obs/burn.py), the admission queue exposes its depth
(fleet/qos.py), replicas join and drain mid-serve with zero loss
(``ServingFleet.scale_to`` in-process, ``ProcessFleet.scale`` across OS
processes), and disaggregated prefill workers are their own scalable
role (fleet/prefill.py). What was missing is the thing production
actually runs: a CONTROLLER that closes the loop from those signals to
replica counts, per role, without flapping under the Poisson burst
noise the workload generator emits.

Three layers, deliberately split:

- ``AutoscaleController`` is the pure decision core: clock-injectable,
  transport-free, deterministic. Per role it walks signals →
  ``ScaleDecision`` through classic control hysteresis: a DEAD-BAND
  between ``queue_low`` and ``queue_high`` per-replica backlog where it
  holds; per-direction COOLDOWNS (scale-down additionally dwells out the
  up-cooldown, so a burst can never trigger up-then-down thrash); STEP
  LIMITS clamping how far one decision moves; and a ``down_confirm``
  streak — the idle condition must hold for K consecutive evaluations
  before capacity is returned, so one quiet gap between bursts never
  drains a replica the next burst needs. Decisions are a pure function
  of (policy, signal sequence, clock readings): under a ManualClock a
  same-seed run replays its decisions byte-identically
  (``decision_digest``), the repo's differential discipline applied to
  the control plane itself.
- ``FleetAutoscaler`` binds the core to the in-process ``ServingFleet``
  (+ an optional ``PrefillPool``): sample admission-queue depth, the
  burn monitor's worst state, slot occupancy, and the prefill backlog;
  evaluate; apply via ``scale_to`` — scale-up joins fresh group members
  mid-serve, scale-down drains WARM (finish in-flight, commit, leave:
  zero lost, zero replay at quiesced transitions).
- ``SupervisorAutoscaler`` binds the same core to a ``ProcessFleet``:
  signals come from the broker (group lag — exactly what a supervisor
  of real processes can know), actuation is ``ProcessFleet.scale(n,
  role=...)`` whose scale-up deliberately reuses a fenced victim's
  replica index so the replacement sorts into the victim's member-id
  range and inherits its journal + radix locality.

Observability rides the existing planes: every decision is a typed
``scale_decision`` event on the tracer's "fleet" topic (ordered against
the joins/fences it causes) and counts on FleetMetrics
(``autoscale_decisions_total{role,direction,reason}``,
``autoscale_target_replicas{role}``, phase + time-in-phase gauges).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Mapping, NamedTuple

from torchkafka_tpu_torch.obs.burn import BURNING, OK, SHEDDING, STATE_LEVEL

DECODE = "decode"
PREFILL = "prefill"

UP = "up"
DOWN = "down"

# Controller phases (the time-in-state gauges' domain).
STEADY = "steady"
SCALING_UP = "scaling_up"
SCALING_DOWN = "scaling_down"
PHASES = (STEADY, SCALING_UP, SCALING_DOWN)
PHASE_LEVEL = {p: i for i, p in enumerate(PHASES)}

# Decision reasons (the {reason} label's closed set).
REASON_BURN = "burn"
REASON_QUEUE = "queue"
REASON_IDLE = "idle"


@dataclasses.dataclass(frozen=True)
class RolePolicy:
    """One role's scaling policy.

    ``queue_high``/``queue_low``: per-replica backlog thresholds — above
    high demands capacity, below low (with burn OK and occupancy at most
    ``occupancy_low``) offers it back; between them is the dead-band
    where the controller holds. ``up_step``/``down_step`` clamp how many
    replicas one decision adds/removes. ``up_cooldown_s`` /
    ``down_cooldown_s``: minimum spacing between same-direction
    decisions; a down additionally waits out the up-cooldown since the
    last up (no up→down thrash inside one burst). ``down_confirm``: the
    idle condition must hold for this many CONSECUTIVE evaluations
    before a scale-down fires — the Poisson-burst-noise filter.
    ``burn_up``: burning/shedding burn states force scale-up pressure
    regardless of queue depth (decode's SLO-protection path)."""

    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 8.0
    queue_low: float = 2.0
    up_step: int = 1
    down_step: int = 1
    up_cooldown_s: float = 0.0
    down_cooldown_s: float = 0.0
    down_confirm: int = 3
    burn_up: bool = True
    occupancy_low: float = 0.75

    def __post_init__(self) -> None:
        if not 0 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        if not 0 <= self.queue_low <= self.queue_high:
            raise ValueError(
                "need 0 <= queue_low <= queue_high, got "
                f"{self.queue_low}/{self.queue_high}"
            )
        if self.up_step < 1 or self.down_step < 1:
            raise ValueError("up_step / down_step must be >= 1")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if self.down_confirm < 1:
            raise ValueError(
                f"down_confirm must be >= 1, got {self.down_confirm}"
            )
        if not 0 <= self.occupancy_low <= 1:
            raise ValueError(
                f"occupancy_low must sit in [0, 1], got {self.occupancy_low}"
            )


@dataclasses.dataclass(frozen=True)
class RoleSignals:
    """One role's observed inputs for one evaluation sweep.

    ``live``: replicas currently serving (what the controller adopts as
    its initial target). ``queue_depth``: the role's backlog — admission
    queue depth for decode, handoff-plane lag for prefill.
    ``burn_state``: the worst burn-rate state over every monitored scope
    (``BurnRateMonitor.worst_state()``); prefill roles usually leave it
    "ok". ``occupancy``: mean slot occupancy in [0, 1] — a scale-down
    guard (never drain replicas that are still busy)."""

    live: int
    queue_depth: int = 0
    burn_state: str = OK
    occupancy: float = 0.0

    def __post_init__(self) -> None:
        if self.live < 0:
            raise ValueError(f"live must be >= 0, got {self.live}")
        if self.queue_depth < 0:
            raise ValueError(
                f"queue_depth must be >= 0, got {self.queue_depth}"
            )
        if self.burn_state not in STATE_LEVEL:
            raise ValueError(f"unknown burn state {self.burn_state!r}")


class ScaleDecision(NamedTuple):
    """One actuation order: move ``role`` from ``frm`` to ``to`` replicas
    (``direction`` up/down) because ``reason``, decided at ``t_s``."""

    t_s: float
    role: str
    direction: str
    reason: str
    frm: int
    to: int


class _RoleState:
    __slots__ = (
        "target", "last_up_t", "last_down_t", "idle_streak", "phase",
        "phase_since",
    )

    def __init__(self) -> None:
        self.target: int | None = None
        self.last_up_t = -float("inf")
        self.last_down_t = -float("inf")
        self.idle_streak = 0
        self.phase = STEADY
        self.phase_since: float | None = None


class AutoscaleController:
    """The deterministic decision core: signals in, ScaleDecisions out.

    ``policies``: role name → ``RolePolicy``. ``clock``: injectable —
    under a ManualClock every cooldown comparison is exact and the
    decision stream replays byte-identically. ``tracer``/``metrics``:
    optional obs.RecordTracer / FleetMetrics for typed ``scale_decision``
    events and the autoscale metric families. The controller never
    touches a fleet; a binding (``FleetAutoscaler`` /
    ``SupervisorAutoscaler``) applies its decisions."""

    def __init__(
        self,
        policies: Mapping[str, RolePolicy],
        *,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        metrics=None,
    ) -> None:
        if not policies:
            raise ValueError("AutoscaleController needs at least one role")
        self.policies = dict(policies)
        self._clock = clock
        self.tracer = tracer
        self.metrics = metrics
        self._state = {role: _RoleState() for role in self.policies}
        self.decisions: list[ScaleDecision] = []
        self.evaluations = 0

    # --------------------------------------------------------- evaluation

    def target(self, role: str) -> int | None:
        """The controller's current target for ``role`` (None before the
        first evaluation adopted the observed live count)."""
        return self._state[role].target

    def _clamp(self, pol: RolePolicy, n: int) -> int:
        return max(pol.min_replicas, min(pol.max_replicas, n))

    def evaluate(
        self, signals: Mapping[str, RoleSignals]
    ) -> list[ScaleDecision]:
        """One control sweep over every role with a signal this round
        (sorted iteration — determinism). Returns the decisions made;
        also appends them to ``self.decisions`` and narrates them on the
        tracer/metrics."""
        t = self._clock()
        self.evaluations += 1
        out: list[ScaleDecision] = []
        for role in sorted(self.policies):
            if role not in signals:
                continue
            pol = self.policies[role]
            sig = signals[role]
            st = self._state[role]
            if st.target is None:
                st.target = self._clamp(pol, sig.live)
                st.phase_since = t
            basis = max(1, st.target)
            burn_hot = pol.burn_up and STATE_LEVEL[sig.burn_state] >= \
                STATE_LEVEL[BURNING]
            hot = burn_hot or sig.queue_depth > pol.queue_high * basis
            cold = (
                not hot
                and sig.queue_depth <= pol.queue_low * basis
                and sig.burn_state == OK
                and sig.occupancy <= pol.occupancy_low
            )
            decision: ScaleDecision | None = None
            if hot:
                st.idle_streak = 0
                if (
                    st.target < pol.max_replicas
                    and t - st.last_up_t >= pol.up_cooldown_s
                ):
                    to = min(pol.max_replicas, st.target + pol.up_step)
                    decision = ScaleDecision(
                        t, role, UP,
                        REASON_BURN if burn_hot else REASON_QUEUE,
                        st.target, to,
                    )
                    st.target = to
                    st.last_up_t = t
                    self._set_phase(st, SCALING_UP, t)
            elif cold:
                st.idle_streak += 1
                if (
                    st.target > pol.min_replicas
                    and st.idle_streak >= pol.down_confirm
                    and t - st.last_down_t >= pol.down_cooldown_s
                    and t - st.last_up_t >= pol.up_cooldown_s
                ):
                    to = max(pol.min_replicas, st.target - pol.down_step)
                    decision = ScaleDecision(
                        t, role, DOWN, REASON_IDLE, st.target, to,
                    )
                    st.target = to
                    st.last_down_t = t
                    st.idle_streak = 0
                    self._set_phase(st, SCALING_DOWN, t)
            else:
                # Dead-band: hold, and reset the idle streak — the
                # confirm counter measures CONSECUTIVE idle sweeps.
                st.idle_streak = 0
                self._set_phase(st, STEADY, t)
            if decision is not None:
                out.append(decision)
                self.decisions.append(decision)
                self._narrate(decision)
            self._gauge(role, st, t)
        return out

    def _set_phase(self, st: _RoleState, phase: str, t: float) -> None:
        if st.phase != phase:
            st.phase = phase
            st.phase_since = t

    def _narrate(self, d: ScaleDecision) -> None:
        if self.metrics is not None:
            self.metrics.autoscale_decision(d.role, d.direction, d.reason) \
                .add(1)
        if self.tracer is not None:
            self.tracer.scale_decision(
                d.role, d.direction, d.reason, d.frm, d.to,
            )

    def _gauge(self, role: str, st: _RoleState, t: float) -> None:
        if self.metrics is None:
            return
        self.metrics.autoscale_target(role).set(st.target or 0)
        self.metrics.autoscale_phase(role).set(PHASE_LEVEL[st.phase])
        since = st.phase_since if st.phase_since is not None else t
        self.metrics.autoscale_time_in_phase(role).set(max(0.0, t - since))

    # ---------------------------------------------------------- reporting

    def decision_digest(self) -> str:
        """SHA-256 over the decision stream's canonical bytes (timestamps
        included — a ManualClock makes them replayable): the byte-
        identity handle for same-seed control-loop replay assertions."""
        h = hashlib.sha256()
        for d in self.decisions:
            h.update(repr(tuple(d)).encode())
        return h.hexdigest()

    def summary(self) -> dict:
        by_reason: dict[str, int] = {}
        for d in self.decisions:
            key = f"{d.role}/{d.direction}/{d.reason}"
            by_reason[key] = by_reason.get(key, 0) + 1
        return {
            "targets": {
                role: st.target for role, st in sorted(self._state.items())
            },
            "phases": {
                role: st.phase for role, st in sorted(self._state.items())
            },
            "decisions": len(self.decisions),
            "by_reason": dict(sorted(by_reason.items())),
            "evaluations": self.evaluations,
            "digest": self.decision_digest(),
        }


# --------------------------------------------------------------- bindings


class FleetAutoscaler:
    """Close the loop for an in-process ``ServingFleet`` (+ optional
    ``PrefillPool``). Call ``step()`` once per scheduling round — e.g.
    from ``WorkloadGenerator.drive(on_round=...)``: it samples signals,
    evaluates the controller, and applies decisions via the fleet's
    warm ``scale_to`` (and the pool's, for the prefill role). Fully
    deterministic under a ManualClock."""

    def __init__(self, fleet, controller: AutoscaleController, *,
                 prefill=None) -> None:
        self.fleet = fleet
        self.controller = controller
        self.prefill = prefill
        if PREFILL in controller.policies and prefill is None:
            raise ValueError(
                "controller has a prefill policy but no PrefillPool was "
                "given"
            )

    def sample(self) -> dict[str, RoleSignals]:
        fleet = self.fleet
        serving = [r for r in fleet.replicas if r.state == "serving"]
        runnable = [r for r in fleet.replicas if r.runnable]
        depth = sum(r.queue.depth() for r in runnable)
        burn = (
            fleet.monitor.worst_state()
            if fleet.monitor is not None else OK
        )
        occ = [
            fleet.metrics.replica_occupancy(r.id).value for r in serving
        ]
        signals = {
            DECODE: RoleSignals(
                live=len(serving),
                queue_depth=depth,
                burn_state=burn,
                occupancy=sum(occ) / len(occ) if occ else 0.0,
            ),
        }
        if self.prefill is not None and PREFILL in self.controller.policies:
            signals[PREFILL] = RoleSignals(
                live=self.prefill.live_count(),
                queue_depth=self.prefill.backlog(),
                occupancy=self.prefill.occupancy(),
            )
        return signals

    def step(self) -> list[ScaleDecision]:
        if getattr(self.fleet, "_draining", False):
            # A fleet-wide drain outranks the controller: never spawn
            # into (or drain under) a shutdown in progress.
            return []
        decisions = self.controller.evaluate(self.sample())
        for d in decisions:
            if d.role == DECODE:
                self.fleet.scale_to(d.to)
            elif d.role == PREFILL and self.prefill is not None:
                self.prefill.scale_to(d.to)
        return decisions


class SupervisorAutoscaler:
    """Close the loop for a real-process ``ProcessFleet``: signals come
    from the broker the supervisor already watches (per-role consumer-
    group lag — offered work not yet committed), actuation is
    ``ProcessFleet.scale(n, role=...)``. Scale-up inherits fenced
    victims' member-id ranges (journal + radix locality); scale-down is
    the SIGTERM warm drain. Real processes live on the wall clock, so
    the controller here narrates rather than replays — the deterministic
    contract lives in the ManualClock bindings above."""

    def __init__(self, fleet, controller: AutoscaleController, *,
                 monitor=None) -> None:
        self.fleet = fleet
        self.controller = controller
        self.monitor = monitor

    def _lag(self, group: str) -> int:
        from torchkafka_tpu_torch.source.records import TopicPartition

        broker = self.fleet.broker
        total = 0
        for p in range(broker.partitions_for(self.fleet.topic)):
            tp = TopicPartition(self.fleet.topic, p)
            total += broker.end_offset(tp) - (
                broker.committed(group, tp) or 0
            )
        return total

    def sample(self) -> dict[str, RoleSignals]:
        fleet = self.fleet
        burn = self.monitor.worst_state() if self.monitor is not None else OK
        signals = {
            DECODE: RoleSignals(
                live=len([
                    i for i in fleet.live() if i.state == "live"
                ]),
                queue_depth=self._lag(fleet.group),
                burn_state=burn,
            ),
        }
        if PREFILL in self.controller.policies:
            if fleet.handoff_topic is None:
                raise ValueError(
                    "prefill policy needs a disaggregated fleet "
                    "(ProcessFleet(prefill_replicas=..., kv_pages=...))"
                )
            signals[PREFILL] = RoleSignals(
                live=len([
                    i for i in fleet.live("prefill") if i.state == "live"
                ]),
                queue_depth=self._lag(f"{fleet.group}-prefill"),
            )
        return signals

    def step(self) -> list[ScaleDecision]:
        """One supervision round with the controller in the loop: sweep
        leases (poll_once), sample, evaluate, apply."""
        self.fleet.poll_once()
        decisions = self.controller.evaluate(self.sample())
        for d in decisions:
            self.fleet.scale(d.to, role=d.role)
        return decisions
