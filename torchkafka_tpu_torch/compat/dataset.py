"""Drop-in KafkaDataset: the reference's user API on the TPU-native core.

Re-implements the full public surface of the reference's ``KafkaDataset``
(the reference's src/kafka_dataset.py:31-247) — ``_process``, ``new_consumer``,
``placeholder``, ``init_worker``, ``commit``, ``commit_worker``, ``close``,
the platform signal selection, and the dual-mode commit flag protocol — so a
torch-kafka user's subclass and training loop port with an import change.
Built fresh on this framework's Consumer protocol: any transport works
(kafka-python adapter, in-memory broker), and the same dataset class can feed
either a torch DataLoader (this module) or a KafkaStream (the TPU path).

Behavioral contract mirrored, with citations:

- one extension point ``_process(record) -> data | None``; None drops the
  record (:159-162, :173-186)
- auto-commit force-disabled in the consumer factory (:201); never commit on
  close (:89)
- main process: ``commit()`` commits immediately (:103-105); worker process:
  the commit signal only sets a flag (:107-114) and the commit itself runs at
  a known-safe point inside the iteration loop (:164-167 — the 1.1.0
  deadlock fix, CHANGELOG.md:17)
- CommitFailedError is swallowed and logged: records re-deliver (:131-135)
- ``_COMMIT_SIGNAL``: SIGUSR1 on linux, SIGINT on darwin/win (:47-55)

Known reference defects intentionally NOT replicated (SURVEY.md §2):
the broken ``src.`` absolute import (installed-wheel breakage), and the
silent assumption that committing "whatever was polled" equals committing
the yielded batch — documented here loudly instead (see auto_commit).
"""

from __future__ import annotations

import logging
import os
import signal
import sys
from typing import Any

from torch.utils.data import IterableDataset, get_worker_info

from torchkafka_tpu_torch.errors import CommitFailedError
from torchkafka_tpu_torch.source.consumer import Consumer
from torchkafka_tpu_torch.source.kafka import KafkaConsumer

logger = logging.getLogger(__name__)


def _platform_commit_signal() -> signal.Signals:
    # Same mapping as the reference (the reference's src/kafka_dataset.py:47-55);
    # raises at class-definition time on unsupported platforms, as it does.
    if sys.platform in ("linux", "linux2"):
        return signal.SIGUSR1
    if sys.platform in ("darwin", "win32", "win64"):
        return signal.SIGINT
    raise RuntimeError(f"Unsupported platform {sys.platform!r}.")


class KafkaDataset(IterableDataset):
    """Streaming dataset over a Kafka-like consumer with manual commits.

    Subclass and implement ``_process``. All constructor arguments flow to
    ``new_consumer`` (the reference's kwargs-passthrough config philosophy,
    SURVEY.md §5); override ``new_consumer`` to change transports or inject
    deserializers (the reference's README.md:46-57).
    """

    _COMMIT_SIGNAL = _platform_commit_signal()

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self._worker_id: int | None = None
        self._commit_required = False
        if kwargs.get("_is_placeholder", False):
            # Placeholder protocol (the reference's src/kafka_dataset.py:67-71):
            # consumers are not fork/pickle-safe, so the dataset handed to a
            # multiprocessing DataLoader carries no consumer; each worker
            # builds its own post-fork via init_worker.
            self._consumer: Consumer | None = None
        else:
            if len(args) == 0:
                raise ValueError(
                    "No topic was provided. Use placeholder() to create a "
                    "dataset without a consumer."
                )
            self._consumer = self.new_consumer(*args, **kwargs)

    # ------------------------------------------------------------- teardown

    def __del__(self) -> None:
        self.close()

    def close(self) -> None:
        """Close the consumer WITHOUT committing: uncommitted work must be
        re-delivered (the reference's src/kafka_dataset.py:85-91)."""
        # getattr guard: partially-constructed instances lack _consumer.
        if getattr(self, "_consumer", None) is not None:
            self._consumer.close()
        self._commit_required = False

    # --------------------------------------------------------------- commit

    def commit(self, signum: int | None = None, stack: Any = None) -> None:
        """Dual-mode commit (the reference's src/kafka_dataset.py:93-118).

        Main process: commit now. Worker process: this is the signal handler —
        it only sets the deferred flag; the commit happens at the next safe
        point in the iteration loop (committing from inside an interrupted
        poll deadlocks — the reference's 1.1.0 fix).
        """
        if self._consumer is None:
            raise RuntimeError("Consumer is not initialized.")
        if self._worker_id is None:
            self._commit_if_required(force=True)
        elif signum is not None:
            if signum != self._COMMIT_SIGNAL:
                raise ValueError(
                    f"Worker {self._worker_id} received a bad signal ({signum})."
                )
            self._commit_required = True
        else:
            raise RuntimeError("Direct commit should not be used with multiprocessing.")

    def _commit_if_required(self, force: bool = False) -> None:
        """Flag-guarded commit; CommitFailedError is non-fatal by contract
        (the reference's src/kafka_dataset.py:120-145)."""
        if not force and not self._commit_required:
            return
        who = "" if self._worker_id is None else f" on worker {self._worker_id}"
        try:
            self._consumer.commit()
        except CommitFailedError:
            logger.error("Commit failed%s.", who)
        else:
            logger.debug("Committed offsets%s.", who)
        finally:
            self._commit_required = False

    # ------------------------------------------------------------ iteration

    def __iter__(self):
        """The hot loop (the reference's src/kafka_dataset.py:147-171):
        iterate records, transform, drop Nones, honor deferred commits at the
        loop's safe point, restore the signal handler when exhausted."""
        if self._consumer is None:
            raise RuntimeError("Consumer is not initialized.")
        in_worker = self._worker_id is not None
        if in_worker:
            signal.signal(self._COMMIT_SIGNAL, self.commit)
        try:
            for record in self._consumer:
                data = self._process(record)
                if data is not None:
                    yield data
                if in_worker:
                    self._commit_if_required()
        finally:
            if in_worker:
                signal.signal(self._COMMIT_SIGNAL, signal.SIG_DFL)

    def _process(self, record: Any) -> Any:
        """The user extension point: record -> batch element, or None to drop
        (the reference's src/kafka_dataset.py:173-186)."""
        raise NotImplementedError()

    # ------------------------------------------------------------ factories

    @classmethod
    def new_consumer(cls, *args: Any, **kwargs: Any) -> Consumer:
        """Consumer factory; force-disables auto-commit — the invariant the
        library exists for (the reference's src/kafka_dataset.py:188-206).

        Default transport is the kafka-python adapter (which hard-codes
        ``enable_auto_commit=False``); override in subclasses to use any
        Consumer-protocol transport (e.g. MemoryConsumer for tests).
        """
        if len(args) == 0:
            raise ValueError("Cannot create a consumer without topic.")
        kwargs.pop("_is_placeholder", None)
        # The reference forwards all positional args as topics
        # (the reference's src/kafka_dataset.py:206) — multi-topic consumers
        # are valid usage and must keep working.
        return KafkaConsumer(list(args), **kwargs)

    @classmethod
    def init_worker(cls, *args: Any, **kwargs: Any):
        """Build a DataLoader ``worker_init_fn`` that gives each spawned
        worker its own consumer (the reference's src/kafka_dataset.py:208-233).

        One consumer per worker process in one consumer group => the broker
        assigns disjoint partitions per worker — the reference's
        data-parallel sharding mechanism.
        """

        def func(worker_id: int) -> None:
            info = get_worker_info()
            if info is None:
                raise RuntimeError(
                    "Custom initialization should be used for multiprocessing only."
                )
            dataset = info.dataset  # the per-worker COPY of the placeholder
            dataset._worker_id = worker_id
            dataset._consumer = cls.new_consumer(*args, **kwargs)

        return func

    @classmethod
    def commit_worker(cls, worker: Any) -> None:
        """Tell a worker process to commit: the cross-process 'commit now'
        RPC, implemented as a POSIX signal
        (the reference's src/kafka_dataset.py:235-239)."""
        os.kill(worker.pid, cls._COMMIT_SIGNAL)

    @classmethod
    def placeholder(cls, **kwargs: Any) -> "KafkaDataset":
        """Consumer-less instance for the multiprocessing path
        (the reference's src/kafka_dataset.py:241-247). Subclasses with extra
        constructor arguments must override (README.md:62-70)."""
        return cls(_is_placeholder=True, **kwargs)
