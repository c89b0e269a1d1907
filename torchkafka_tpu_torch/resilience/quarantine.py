"""PoisonQuarantine: a retry budget and a dead-letter exit per record.

Under at-least-once delivery a record whose *payload* crashes processing
is re-delivered forever — the infinite crash loop the reference has no
escape hatch for. The quarantine gives each ``(topic, partition, offset)``
a bounded processing-retry budget and, once it is spent, routes the
record to a dead-letter topic and declares it RESOLVED so the commit
watermark may advance past it.

The core invariant it preserves: **the committed watermark never covers
an unresolved record.** A record is resolved by exactly one of
(a) processing succeeded, (b) it was dropped by explicit policy, or
(c) its quarantine copy is DURABLE on the dead-letter topic. (c) is
enforced the same way serve.py enforces output durability: the DLQ
produce is sent AND acknowledged (``SendHandle.get``) before
``note_failure`` returns True — and a DLQ failure raises
``OutputDeliveryError``, the fail-stop = crash-before-commit discipline
from errors.py: better to re-deliver the poison record on restart than to
commit past a record that exists nowhere.

Callers (pipeline/stream.py's ``on_processor_error="quarantine"``,
serve.py's ``quarantine=``) hold the ledger; the quarantine only answers
"is this record resolved yet?":

    if quarantine.note_failure(record, exc):   # True => DLQ'd, durable
        ledger.dropped(record)                 # safe to retire the offset
    else:
        ...retry the record (budget remains)...

Budget semantics: ``budget`` counts FAILURES before dead-lettering, so
``budget=1`` dead-letters on the first failure and ``budget=3`` allows
two in-place retries (transient processing faults — a flaky external
tokenizer, an allocator hiccup) before declaring the record poison.
A processor that KNOWS the payload is bad raises ``PoisonRecordError``
(errors.py: terminal per record) and skips the remaining budget — the
retries exist for failures that might be transient, and that one, by
declaration, is not.
"""

from __future__ import annotations

import logging
import threading

from torchkafka_tpu_torch.errors import OutputDeliveryError, PoisonRecordError
from torchkafka_tpu_torch.source.producer import Producer
from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.utils.metrics import RateMeter

_logger = logging.getLogger(__name__)


class PoisonQuarantine:
    """Per-record failure budget + acknowledged dead-letter routing.

    ``producer``/``topic``: where quarantined records go (provenance,
    error, and attempt count ride in headers; the key is preserved so
    compacted/keyed DLQ topics keep working — same header convention as
    ``source.producer.dead_letter_to_topic``).
    ``budget``: failures per (topic, partition, offset) before the record
    is dead-lettered. ``timeout_s``: the DLQ durability wait.
    """

    def __init__(
        self,
        producer: Producer,
        topic: str,
        *,
        budget: int = 3,
        timeout_s: float | None = 30.0,
    ) -> None:
        if budget < 1:
            raise ValueError(f"budget must be >= 1 failure, got {budget}")
        self._producer = producer
        self._topic = topic
        self._budget = budget
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        # Failure counts for records still under budget. Entries are
        # removed on quarantine; successes never enter. Poison is rare by
        # definition, so this stays tiny — a pipeline where it does not is
        # already fail-stopping on the DLQ volume.
        self._counts: dict[tuple[str, int, int], int] = {}
        self.failures = RateMeter()  # every note_failure call
        self.quarantined = RateMeter()  # records dead-lettered (resolved)
        self.dlq_failures = RateMeter()  # DLQ produces that FAILED (each
        # one raised OutputDeliveryError — fail-stop — but the count
        # survives for the /metrics view of a broken DLQ)
        # The exact send kwargs of the most recent SUCCESSFUL dead-letter
        # produce — forensic/observability handle (what exactly went to
        # the DLQ, provenance headers included).
        self.last_dead_letter: dict | None = None

    @property
    def topic(self) -> str:
        return self._topic

    @property
    def producer(self):
        """The DLQ producer (read-only). serve.py's exactly_once mode
        validates the quarantine shares its transactional producer —
        the atomicity argument needs one transaction, not two brokers."""
        return self._producer

    def rebind_producer(self, producer) -> None:
        """Swap the DLQ delivery path. serve.py's exactly_once mode
        rebinds the quarantine onto its transactional outbox so the
        dead-letter copy is produced INSIDE the commit window's
        transaction — atomic with the offset that retires the poison
        record — rather than acknowledged ahead of it."""
        self._producer = producer

    def attempts(self, record: Record) -> int:
        """Failures recorded so far for this record (0 if unseen/resolved)."""
        with self._lock:
            return self._counts.get(
                (record.topic, record.partition, record.offset), 0
            )

    def note_failure(self, record: Record, exc: BaseException) -> bool:
        """Record one processing failure. Returns False while budget
        remains (the record is UNRESOLVED: retry it, or leave it pending
        so it re-delivers — never retire its offset). Returns True once
        the record has been dead-lettered AND the DLQ copy acknowledged
        durable — only then may the caller retire the offset. Raises
        ``OutputDeliveryError`` if the DLQ produce fails: fail-stop,
        because resolving the record without a durable copy would let the
        watermark commit past a record that then exists nowhere."""
        key = (record.topic, record.partition, record.offset)
        self.failures.add(1)
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            # A self-declared PoisonRecordError spends the whole budget:
            # terminal-per-record means a retry cannot end differently.
            if n < self._budget and not isinstance(exc, PoisonRecordError):
                return False
        self._dead_letter(record, exc, n)
        with self._lock:
            self._counts.pop(key, None)
        self.quarantined.add(1)
        _logger.warning(
            "poison record %s@%d:%d dead-lettered to %r after %d "
            "failure(s): %s",
            record.topic, record.partition, record.offset,
            self._topic, n, exc,
        )
        return True

    def _dead_letter(self, record: Record, exc: BaseException, attempts: int) -> None:
        kwargs = dict(
            topic=self._topic,
            value=record.value,
            key=record.key,
            headers=(
                ("dlq.error", str(exc).encode()),
                ("dlq.topic", record.topic.encode()),
                ("dlq.partition", str(record.partition).encode()),
                ("dlq.offset", str(record.offset).encode()),
                ("dlq.attempts", str(attempts).encode()),
            ),
        )
        try:
            self._producer.send(
                kwargs["topic"], kwargs["value"], key=kwargs["key"],
                headers=kwargs["headers"],
            ).get(self._timeout_s)
        except Exception as e:  # noqa: BLE001 - any DLQ failure fails stop
            self.dlq_failures.add(1)
            raise OutputDeliveryError(
                f"dead-letter produce to {self._topic!r} failed for "
                f"{record.topic}@{record.partition}:{record.offset}; "
                "refusing to resolve the record without a durable "
                "quarantine copy (crash-before-commit: it re-delivers)"
            ) from e
        self.last_dead_letter = kwargs
