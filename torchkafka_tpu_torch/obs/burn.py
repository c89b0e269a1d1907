"""Burn-rate overload detection over the windowed SLO histograms.

Copy of ``torchkafka_tpu/obs/burn.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The question cumulative histograms cannot answer — "is the SLO
burning RIGHT NOW, and should we shed load?" — answered the way SRE
practice does: an **error budget** (1 - objective: the fraction of
requests allowed to miss the latency threshold) and a **burn rate** (the
observed violation fraction divided by that budget) evaluated over a
FAST and a SLOW trailing window. Fast-window burn reacts in seconds;
requiring the slow window to agree before escalating keeps a one-burst
blip from flapping the state machine — the classic multiwindow
multi-burn-rate alerting shape, run in-process so admission can consume
it instead of a human pager.

Per ``SLOTarget`` the monitor tracks one state machine per scope — the
global stream plus every lane and tenant label the SLO histograms have
seen — through four typed states::

    ok → warning → burning → shedding   (and back down as windows drain)

Every transition is emitted as a typed ``burn_state`` event through the
record tracer's stream (same ring, same JSONL, same determinism contract:
under a ManualClock a same-seed replay produces byte-identical
transitions), and the current state is consumed by the fleet's
``AdmissionQueue`` as an overload hook: in ``shedding``, batch-lane
admission is DEFERRED (records stay queued, watermark stalled — the
at-least-once contract untouched) so interactive traffic keeps its SLO
instead of the whole fleet collapsing together.

The monitor also owns **goodput accounting**: a completion is *goodput*
only if it met every configured latency target — the per-tenant
completed / completed-within-SLO / deferred / quarantined ledger that
turns "throughput" into the number production actually buys.
"""

from __future__ import annotations

import dataclasses
import threading

from torchkafka_tpu_torch.obs.slo import SLOHistograms

OK = "ok"
WARNING = "warning"
BURNING = "burning"
SHEDDING = "shedding"

STATES = (OK, WARNING, BURNING, SHEDDING)
STATE_LEVEL = {s: i for i, s in enumerate(STATES)}


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One latency objective to monitor.

    ``metric``: which SLO quantity (obs.slo.METRICS). ``threshold_s``:
    the latency bound a sample must meet. ``objective``: the fraction of
    samples that must meet it (error budget = 1 - objective).
    ``fast_window_s``/``slow_window_s``: the two trailing evaluation
    horizons. ``warn_burn``/``burning_burn``/``shed_burn``: burn-rate
    ladder — warn on fast alone, escalate only when the slow window
    agrees. ``lane``: restrict this target to one lane's label scope
    (None = monitor every scope the histograms have seen).
    ``min_samples``: a window with fewer samples reads burn 0 (no
    evidence is not an emergency)."""

    metric: str = "ttft"
    threshold_s: float = 0.1
    objective: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    warn_burn: float = 1.0
    burning_burn: float = 2.0
    shed_burn: float = 4.0
    lane: str | None = None
    min_samples: int = 4

    def __post_init__(self) -> None:
        from torchkafka_tpu_torch.obs.slo import METRICS

        if self.metric not in METRICS:
            raise ValueError(
                f"metric must be one of {METRICS}, got {self.metric!r}"
            )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must sit in (0, 1), got {self.objective}"
            )
        if self.threshold_s <= 0:
            raise ValueError(f"threshold_s must be > 0, got {self.threshold_s}")
        if not 0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )
        if not 0 < self.warn_burn <= self.burning_burn <= self.shed_burn:
            raise ValueError(
                "need 0 < warn_burn <= burning_burn <= shed_burn, got "
                f"{self.warn_burn}/{self.burning_burn}/{self.shed_burn}"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


class _Goodput:
    """One tenant's goodput ledger (counts; rates live on FleetMetrics)."""

    __slots__ = ("completed", "within_slo", "quarantined")

    def __init__(self) -> None:
        self.completed = 0
        self.within_slo = 0
        self.quarantined = 0


class BurnRateMonitor:
    """Evaluates ``SLOTarget``s against windowed ``SLOHistograms``.

    ``evaluate()`` is cheap and idempotent between new samples; a traced
    fleet calls it once per scheduling round. ``tracer`` (optional)
    receives typed ``burn_state`` transition events; ``should_defer`` is
    the AdmissionQueue's overload hook. Thread-safe; deterministic under
    a ManualClock (sorted scope iteration, transition-only emission)."""

    def __init__(
        self,
        slo: SLOHistograms,
        targets: "list[SLOTarget] | tuple[SLOTarget, ...]",
        *,
        tracer=None,
        shed_lanes: tuple = ("batch",),
    ) -> None:
        if not targets:
            raise ValueError("BurnRateMonitor needs at least one SLOTarget")
        if not slo.windowed:
            raise ValueError(
                "BurnRateMonitor needs time-windowed SLO histograms — "
                "build the tracer with ObsConfig(window_s=...)"
            )
        self.slo = slo
        self.targets = tuple(targets)
        self.tracer = tracer
        self._shed_lanes = frozenset(shed_lanes)
        self._lock = threading.Lock()
        # (metric, dim, label) -> state string.
        self._state: dict[tuple[str, str, str], str] = {}
        # (metric, dim, label) -> (fast_burn, slow_burn), last evaluate().
        self._burn: dict[tuple[str, str, str], tuple[float, float]] = {}
        self._seq = 0  # transition sequence — the typed event's offset
        self.transitions = 0
        self.evaluations = 0
        self._goodput: dict[str, _Goodput] = {}
        self._deferred: dict[str, int] = {}
        # metric -> threshold_s for goodput classification (first target
        # per metric wins; lane-scoped targets classify their lane only).
        self._thresholds: dict[str, list[SLOTarget]] = {}
        for t in self.targets:
            self._thresholds.setdefault(t.metric, []).append(t)

    # --------------------------------------------------------- evaluation

    def _burn_rate(self, target: SLOTarget, hist, horizon: float) -> float:
        samples = hist.windowed_snapshot(horizon)
        if len(samples) < target.min_samples:
            return 0.0
        violating = sum(1 for s in samples if s > target.threshold_s)
        return (violating / len(samples)) / target.budget

    @staticmethod
    def _classify(target: SLOTarget, fast: float, slow: float) -> str:
        if fast >= target.shed_burn and slow >= target.burning_burn:
            return SHEDDING
        if fast >= target.burning_burn and slow >= target.warn_burn:
            return BURNING
        if fast >= target.warn_burn:
            return WARNING
        return OK

    def _scopes(self, target: SLOTarget) -> list[tuple[str, str]]:
        if target.lane is not None:
            return [("lane", target.lane)]
        scopes = [("", "")]
        for dim in ("lane", "tenant"):
            scopes.extend(
                (dim, label) for label in self.slo.labels(target.metric, dim)
            )
        return scopes

    def evaluate(self) -> dict:
        """One evaluation sweep: recompute every (target, scope) burn
        pair, walk the state machines, emit typed transition events.
        Returns ``{(metric, dim, label): state}``. Transition events are
        emitted AFTER the monitor lock is released — the tracer calls
        back into this class under its own lock (note_commit →
        note_completed), so holding ours while calling it would invert
        the lock order."""
        transitions: list[tuple] = []
        with self._lock:
            self.evaluations += 1
            for target in self.targets:
                for dim, label in self._scopes(target):
                    hist = self.slo.hist(target.metric, dim, label)
                    fast = self._burn_rate(target, hist, target.fast_window_s)
                    slow = self._burn_rate(target, hist, target.slow_window_s)
                    key = (target.metric, dim, label)
                    new = self._classify(target, fast, slow)
                    old = self._state.get(key, OK)
                    self._burn[key] = (fast, slow)
                    self._state[key] = new
                    if new != old:
                        self.transitions += 1
                        transitions.append((
                            self._seq, target.metric, dim, label,
                            old, new, fast, slow,
                        ))
                        self._seq += 1
            states = dict(self._state)
        if self.tracer is not None:
            for t in transitions:
                self.tracer.burn_state(*t)
        return states

    def state(self, metric: str, dim: str = "", label: str = "") -> str:
        with self._lock:
            return self._state.get((metric, dim, label), OK)

    def worst_state(self) -> str:
        """The highest-severity state over every monitored scope — the
        single-signal view an autoscale controller consumes (OK when no
        scope has been evaluated yet)."""
        with self._lock:
            if not self._state:
                return OK
            return max(self._state.values(), key=STATE_LEVEL.__getitem__)

    def should_defer(self, lane: str, tenant: str) -> bool:
        """The AdmissionQueue overload hook: defer this (lane, tenant)
        pop? True only for sheddable lanes (batch by default — the
        interactive lane is the SLO being protected), when the global
        scope, the lane's scope, or the tenant's scope of ANY monitored
        metric is in ``shedding``."""
        if lane not in self._shed_lanes:
            return False
        with self._lock:
            for (m, dim, label), state in self._state.items():
                if state != SHEDDING:
                    continue
                if dim == "" or (dim, label) in (
                    ("lane", lane), ("tenant", tenant),
                ):
                    return True
        return False

    # ------------------------------------------------------------ goodput

    def _classify_within(self, lane, values: dict) -> bool:
        """Did this completion meet every applicable latency target?
        ``values``: {metric: seconds-or-None}; a metric with no sample
        (e.g. TTFT on a warm resume) doesn't count against it."""
        for metric, targets in self._thresholds.items():
            v = values.get(metric)
            if v is None:
                continue
            for t in targets:
                if t.lane is not None and t.lane != lane:
                    continue
                if v > t.threshold_s:
                    return False
        return True

    def note_completed(self, lane, tenant, *, ttft_s=None, e2e_s=None,
                       itl_s=None, queue_wait_s=None) -> None:
        """One record reached COMMITTED (called by the tracer): count it
        and classify goodput against the configured thresholds."""
        within = self._classify_within(lane, {
            "ttft": ttft_s, "e2e": e2e_s, "itl": itl_s,
            "queue_wait": queue_wait_s,
        })
        with self._lock:
            g = self._goodput.setdefault(str(tenant), _Goodput())
            g.completed += 1
            if within:
                g.within_slo += 1

    def note_quarantined(self, tenant) -> None:
        with self._lock:
            g = self._goodput.setdefault(str(tenant), _Goodput())
            g.quarantined += 1

    def note_deferred(self, tenant, n: int = 1) -> None:
        """An overload deferral decision (the AdmissionQueue left this
        tenant's records queued because of the burn state)."""
        with self._lock:
            t = str(tenant)
            self._deferred[t] = self._deferred.get(t, 0) + n

    def goodput_summary(self) -> dict:
        """Per-tenant completed / within-SLO / deferred / quarantined,
        plus fleet totals — goodput is ``within_slo`` (completed work
        that met its SLO; deferred work is neither lost nor goodput)."""
        with self._lock:
            tenants = sorted(set(self._goodput) | set(self._deferred))
            per = {}
            tot_c = tot_w = tot_d = tot_q = 0
            for t in tenants:
                g = self._goodput.get(t, _Goodput())
                d = self._deferred.get(t, 0)
                per[t] = {
                    "completed": g.completed,
                    "within_slo": g.within_slo,
                    "deferred": d,
                    "quarantined": g.quarantined,
                    "goodput_ratio": (
                        round(g.within_slo / g.completed, 4)
                        if g.completed else None
                    ),
                }
                tot_c += g.completed
                tot_w += g.within_slo
                tot_d += d
                tot_q += g.quarantined
            return {
                "tenants": per,
                "completed": tot_c,
                "within_slo": tot_w,
                "deferred": tot_d,
                "quarantined": tot_q,
                "goodput_ratio": round(tot_w / tot_c, 4) if tot_c else None,
            }

    # ---------------------------------------------------------- reporting

    def summary(self) -> dict:
        with self._lock:
            states = {
                "/".join(k).strip("/"): v
                for k, v in sorted(self._state.items())
            }
            burn = {
                "/".join(k).strip("/"): {
                    "fast": round(f, 4), "slow": round(s, 4),
                }
                for k, (f, s) in sorted(self._burn.items())
            }
        out = {
            "states": states,
            "burn": burn,
            "transitions": self.transitions,
            "evaluations": self.evaluations,
            "targets": [dataclasses.asdict(t) for t in self.targets],
        }
        out["goodput"] = self.goodput_summary()
        return out

    def series(self) -> list[tuple]:
        """Exposition series for the shared renderer: numeric state +
        fast/slow burn gauges per scope, transition/evaluation counters,
        and the per-tenant goodput ledger."""
        from torchkafka_tpu_torch.utils.metrics import format_labels

        def scope_labels(key, **extra):
            metric, dim, label = key
            lab = {"slo_metric": metric}
            if dim:
                lab[dim] = label
            lab.update(extra)
            return format_labels(**lab)

        with self._lock:
            state_entries = [
                (scope_labels(k), STATE_LEVEL[v])
                for k, v in sorted(self._state.items())
            ]
            burn_entries = []
            for k, (fast, slow) in sorted(self._burn.items()):
                burn_entries.append((scope_labels(k, window="fast"), fast))
                burn_entries.append((scope_labels(k, window="slow"), slow))
            transitions = self.transitions
            evaluations = self.evaluations
        g = self.goodput_summary()
        series: list[tuple] = [
            ("state", "gauge", state_entries or 0,
             "burn-rate state per SLO scope (0 ok / 1 warning / "
             "2 burning / 3 shedding)"),
            ("rate", "gauge", burn_entries or 0,
             "error-budget burn rate per SLO scope and window"),
            ("transitions_total", "counter", transitions,
             "burn-rate state transitions"),
            ("evaluations_total", "counter", evaluations,
             "burn-rate evaluation sweeps"),
            ("completed_total", "counter", [
                (format_labels(tenant=t), v["completed"])
                for t, v in g["tenants"].items()
            ] or 0, "completions per tenant"),
            ("completed_within_slo_total", "counter", [
                (format_labels(tenant=t), v["within_slo"])
                for t, v in g["tenants"].items()
            ] or 0, "completions that met every latency target (goodput)"),
            ("overload_deferrals_total", "counter", [
                (format_labels(tenant=t), v["deferred"])
                for t, v in g["tenants"].items()
            ] or 0, "admissions deferred by the overload hook"),
            ("quarantined_total", "counter", [
                (format_labels(tenant=t), v["quarantined"])
                for t, v in g["tenants"].items()
            ] or 0, "records dead-lettered per tenant"),
            ("goodput_ratio", "gauge", g["goodput_ratio"] or 0.0,
             "within-SLO completions / completions, fleet-wide"),
        ]
        return series

    def render_prometheus(self, prefix: str = "torchkafka_burn") -> str:
        from torchkafka_tpu_torch.utils.metrics import render_exposition

        return render_exposition(prefix, self.series())
