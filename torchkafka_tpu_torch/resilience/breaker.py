"""Circuit breaker: stop hammering a broker that is provably down.

Retries handle the *blip*; the breaker handles the *outage*. Once N
consecutive operations have failed with retryable faults, the broker is
evidently unavailable and every further attempt is pure cost — latency
added to the serving hot loop, connection churn added to a broker trying
to recover. The breaker converts that into a fast local decision:

- **closed** (healthy): every operation is allowed; consecutive failures
  are counted, successes reset the count.
- **open** (outage declared): operations are refused locally (``allow()``
  is False) for ``reset_timeout_s`` — callers degrade (empty polls,
  fast-failed commits) instead of blocking on a dead socket.
- **half-open** (probing): after the cooldown, exactly
  ``half_open_probes`` operations are let through as probes. One success
  closes the circuit; one failure re-opens it and restarts the cooldown.

The state machine is deliberately the textbook one (Nygard's *Release
It!* shape, the same three states Polly/resilience4j implement) because
its value here is *observability*: ``opens``/``closes``/``probes``
counters and a numeric ``state_code`` export through the resilience
metrics, so "circuit opened at 12:03, closed at 12:07" is a dashboard
fact, not a log archaeology project. Time is injectable for the same
reason as everywhere else in this layer: chaos tests drive the cooldown
with a ManualClock and stay deterministic.

Thread-safe; shared by the poll path (stream producer thread) and the
commit path (stream owner's thread) of one consumer.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: Gauge encoding for dashboards: healthy=0, probing=0.5, outage=1.
_STATE_CODES = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


class CircuitBreaker:
    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if reset_timeout_s <= 0:
            raise ValueError(f"reset_timeout_s must be > 0, got {reset_timeout_s}")
        if half_open_probes < 1:
            raise ValueError(f"half_open_probes must be >= 1, got {half_open_probes}")
        self._threshold = failure_threshold
        self._reset_timeout_s = reset_timeout_s
        self._half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.opens = 0  # transitions into OPEN (first open + every re-open)
        self.closes = 0  # transitions into CLOSED from HALF_OPEN
        self.probes = 0  # operations admitted while HALF_OPEN

    # ----------------------------------------------------------- inspection

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek()

    @property
    def state_code(self) -> float:
        with self._lock:
            return _STATE_CODES[self._peek()]

    def _peek(self) -> str:
        """State with the cooldown applied (an expired OPEN reads as
        HALF_OPEN even before the next allow() formalizes it)."""
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self._reset_timeout_s
        ):
            return HALF_OPEN
        return self._state

    # ------------------------------------------------------------ decisions

    def allow(self) -> bool:
        """May the caller attempt an operation right now? OPEN refuses
        until the cooldown elapses; HALF_OPEN admits up to
        ``half_open_probes`` concurrent probes."""
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at < self._reset_timeout_s:
                    return False
                self._state = HALF_OPEN
                self._probes_in_flight = 0
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= self._half_open_probes:
                    return False
                self._probes_in_flight += 1
                self.probes += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes_in_flight = 0
                self.closes += 1

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # The probe failed: the outage is not over. Re-open and
                # restart the cooldown from now.
                self._open()
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and (
                self._consecutive_failures >= self._threshold
            ):
                self._open()

    def _open(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._probes_in_flight = 0
        self.opens += 1
