"""Transport-level resilience: retry/backoff, circuit breaking, poison
quarantine — the layer that turns injectable faults (source/chaos.py)
into survivable ones.

Composition order, outermost first::

    consumer = ResilientConsumer(          # retries + circuit breaker
        ChaosConsumer(                     # (tests) seeded fault injection
            MemoryConsumer(broker, ...),   # any Consumer transport
            seed=7, outage_rate=0.01,
        ),
        policy=RetryPolicy(...), breaker=CircuitBreaker(...),
    )

and ``PoisonQuarantine`` rides the processing layer above it
(``KafkaStream(on_processor_error="quarantine", quarantine=...)`` or
``StreamingGenerator(quarantine=...)``). Every piece takes injectable
clocks/seeds so chaos tests are deterministic and sleep-free
(``ManualClock``).
"""

from torchkafka_tpu_torch.resilience.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
)
from torchkafka_tpu_torch.resilience.consumer import ResilientConsumer
from torchkafka_tpu_torch.resilience.crashpoint import (
    REGISTERED_CRASH_POINTS,
    CrashPointInjected,
    arm,
    arm_from_env,
    crash_hook,
    disarm,
)
from torchkafka_tpu_torch.resilience.policy import ManualClock, RetryPolicy
from torchkafka_tpu_torch.resilience.quarantine import PoisonQuarantine
from torchkafka_tpu_torch.utils.metrics import ResilienceMetrics

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "REGISTERED_CRASH_POINTS",
    "CircuitBreaker",
    "CrashPointInjected",
    "ManualClock",
    "PoisonQuarantine",
    "ResilienceMetrics",
    "ResilientConsumer",
    "RetryPolicy",
    "arm",
    "arm_from_env",
    "crash_hook",
    "disarm",
]
