"""RetryPolicy: classified retries with exponential backoff and full jitter.

The reference's entire failure story is "commit failures are survivable"
(the reference's src/kafka_dataset.py:131-135). That is the right call for
a *protocol* rejection — but a *transport* fault (broker unreachable,
request timeout) is a different animal: the operation is idempotent and
repeating it after a backoff is both safe and the only useful response.
This module is the one place that decision lives:

- **classification** — an exception is retryable iff it declares itself
  (``TpuKafkaError.retryable``, see errors.py) or its type is listed in
  ``retryable_errors``. Everything else propagates untouched on the first
  throw: a terminal error retried is a bug amplifier.
- **exponential backoff with full jitter** — attempt k sleeps
  ``uniform(0, min(max_delay, base * 2**k))``. Full jitter (not equal
  jitter, not decorrelated) because the failure mode that matters at
  fleet scale is the *thundering herd*: every consumer of a recovering
  broker retrying on the same schedule re-kills it. Uniform-from-zero
  spreads the retry storm across the whole window.
- **per-operation deadline** — ``deadline_s`` bounds the total time one
  operation may spend retrying, independent of ``max_attempts``; the
  budget check happens BEFORE sleeping, so the policy never burns a sleep
  it cannot follow with an attempt.
- **injectable time and randomness** — ``clock``/``sleep`` default to the
  real ones; tests inject ``ManualClock`` so every retry schedule is
  deterministic and instantaneous, and the jitter RNG is seeded so a
  failing schedule replays exactly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from torchkafka_tpu_torch.errors import BrokerUnavailableError


class ManualClock:
    """A clock/sleep pair for deterministic tests and benches: ``sleep``
    advances ``now`` instead of waiting, so a 30-second retry schedule
    runs in microseconds while every deadline comparison stays exact.
    Pass ``clock=mc.now, sleep=mc.sleep`` to a RetryPolicy (and
    ``clock=mc.now`` to a CircuitBreaker) and the whole resilience stack
    shares one synthetic timeline."""

    def __init__(self, start: float = 0.0) -> None:
        self._lock = threading.Lock()
        self._now = float(start)

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += max(0.0, float(seconds))

    # Explicit spelling for tests that advance time without "sleeping".
    advance = sleep


@dataclasses.dataclass
class RetryPolicy:
    """How one operation retries. Frozen decisions, injectable mechanics.

    ``max_attempts`` counts the total tries (first call included), so
    ``max_attempts=1`` means "never retry". ``deadline_s=None`` removes
    the wall-clock budget (attempts alone bound the loop)."""

    max_attempts: int = 6
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: float | None = 30.0
    retryable_errors: tuple[type[BaseException], ...] = (BrokerUnavailableError,)
    seed: int = 0
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 or None, got {self.deadline_s}")
        # Seeded jitter + a lock: poll retries (stream producer thread) and
        # commit retries (the stream owner's thread) share this policy.
        self._rng = np.random.default_rng(self.seed)
        self._rng_lock = threading.Lock()

    # -------------------------------------------------------------- pieces

    def classify(self, exc: BaseException) -> bool:
        """True iff ``exc`` is retryable: listed in ``retryable_errors``
        or self-declared via the ``retryable`` attribute (errors.py's
        transport-independent classification)."""
        return isinstance(exc, self.retryable_errors) or bool(
            getattr(exc, "retryable", False)
        )

    def backoff_s(self, attempt: int) -> float:
        """Jittered delay AFTER failed attempt ``attempt`` (0-based):
        uniform over [0, min(max_delay, base * 2**attempt)]."""
        cap = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        if cap <= 0:
            return 0.0
        with self._rng_lock:
            return float(self._rng.uniform(0.0, cap))

    # --------------------------------------------------------------- runner

    def run(self, fn: Callable[[], object], *, on_retry=None):
        """Call ``fn`` under this policy. Terminal errors propagate from
        the first throw; retryable errors sleep-and-retry until attempts
        or deadline run out, then the LAST error propagates. ``on_retry``
        (attempt_index, exc, delay_s) observes each scheduled retry —
        metrics hooks, log lines, chaos bookkeeping."""
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as exc:  # noqa: BLE001 - classified below
                if not self.classify(exc):
                    raise
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(attempt - 1)
                if (
                    self.deadline_s is not None
                    and (self.clock() - start) + delay >= self.deadline_s
                ):
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                self.sleep(delay)
