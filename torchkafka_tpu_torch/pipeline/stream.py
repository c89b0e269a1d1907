"""KafkaStream: the end-to-end ingest pipeline.

Port of ``torchkafka_tpu/pipeline/stream.py``. Batches leave as torch
tensors on the device: each leaf is copied into pinned host memory, then
sent with a ``non_blocking`` copy on a side CUDA stream, on the producer
thread, so the transfer overlaps the consumer's step. The batch carries the
copy's completion event; before handing a batch out, ``next()`` makes the
caller's current stream wait on that event and marks every tensor as used
on that stream (``record_stream``), so the step never reads a half-copied
batch and the allocator never hands the batch's memory back to the copy
stream while the step may still read it. Run the step on the stream that
is current when ``next()`` returns.

With ``mesh=`` each batch leaf leaves as a ``DTensor`` sharded over the
data axes (``parallel.global_batch``): the rank's own rows, wrapped after
the copy's event, so a reduction over it spans every process. Inside a
process group of more than one rank the default barrier is a
``BarrierWatchdog`` (exit 42 when one barrier hangs past
``barrier_timeout_s``), as in the JAX package.

What follows is the JAX package's design note, which holds for the port.

This is the TPU-native replacement for the reference's entire hot path —
`KafkaDataset.__iter__` + DataLoader collation + `auto_commit`
(/root/reference/src/kafka_dataset.py:147-171, /root/reference/src/auto_commit.py:22-72)
— re-architected for an accelerator consumer:

    stream = KafkaStream(consumer, processor, batch_size=256, mesh=mesh)
    for batch, token in stream:
        loss = train_step(batch.data)       # pjit'd, async dispatch
        token.commit(wait_for=loss)         # barrier, then commit THIS batch

Architecture (one background thread per stream):

    poll -> ledger.fetched -> processor (thread pool) -> batcher
         -> device transfer (side stream, overlaps with user's step)
         -> bounded queue (depth = prefetch, provides backpressure)
    main thread: dequeue -> mint CommitToken -> yield

The reference's multiprocessing design exists because CPython + torch force
process-level parallelism, which in turn forces the signal-based commit RPC
(SURVEY.md §1 "signature architectural fact"). Here the poll loop is I/O-bound
(releases the GIL), transforms run in a thread pool, and the heavy compute is
on the TPU — so one process per host suffices, commits run synchronously on
the stream owner's thread, and the entire signal/worker-correspondence hack
disappears.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from time import monotonic, time
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from torchkafka_tpu_torch.commit import CommitBarrier, CommitSequencer, CommitToken, OffsetLedger
from torchkafka_tpu_torch.errors import ConsumerClosedError
from torchkafka_tpu_torch.parallel.lockstep import MeshConsumer, agree
from torchkafka_tpu_torch.source.consumer import Consumer
from torchkafka_tpu_torch.transform.batcher import Batch, Batcher
from torchkafka_tpu_torch.transform.bucket import BucketBatcher
from torchkafka_tpu_torch.transform.processor import Processor
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.metrics import StreamMetrics
from torchkafka_tpu_torch.utils.tracing import ingest_lag_ms
from torchkafka_tpu_torch.utils.tree import tree_leaves, tree_map

_logger = logging.getLogger(__name__)

_END = object()


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class KafkaStream:
    """Iterator of (Batch, CommitToken) over a Kafka-like consumer.

    Parameters
    ----------
    consumer: any Consumer-protocol transport.
    processor: record -> pytree of fixed-shape np arrays, or None to drop
        (the reference's `_process` contract,
        /root/reference/src/kafka_dataset.py:173-186).
    batch_size: host-local rows per batch.
    device: where batches go: None = the current CUDA device (raises
        without one), or e.g. "cpu". ``to_device=False`` leaves them NumPy.
    mesh / data_axis: global sharded batches: each leaf becomes a
        ``DTensor`` over ``mesh`` (a ``parallel.make_mesh`` mesh) with
        ``Shard(0)`` over ``data_axis`` (a name or a tuple, e.g.
        ``("data", "fsdp")``). The batch lands on the mesh's device unless
        ``device`` names one.
    pad_policy: 'block' (only full batches) or 'pad' (flush emits a padded
        tail with valid_count).
    prefetch: max batches in flight ahead of the consumer (double buffering
        at the default of 2). ``prefetch=0`` selects synchronous mode: no
        producer thread at all — poll/decode run inline in ``__next__`` on
        the caller's thread. Loses compute/ingest overlap, but also loses
        all queue/GIL handoff cost; fastest when the step is cheap relative
        to decode (pure-ingest workloads), and the mode to use when the
        caller forks (threads don't survive fork).
    idle_timeout_ms: if set, the stream ends after this long with no new
        records (flushing the tail under 'pad'); if None, it streams forever.
        Over a ``parallel.lockstep.MeshConsumer`` (every rank of a mesh
        reading the root's polls) the root's clock decides, for every rank;
        such a stream runs with ``prefetch=0``.
    transform_threads: >0 runs the processor in a thread pool (order
        preserved); numpy-heavy processors release the GIL and scale.
    on_processor_error: what a RAISING processor does to the stream.
        'raise' (default): the error surfaces on the consuming thread and
        ends the stream — malformed data is a bug until declared otherwise.
        'drop': the record is dropped exactly like a ``None`` return (its
        offset retires so the commit watermark keeps advancing), the error
        is counted in ``metrics.processor_errors`` and logged, and the
        stream continues — the poison-pill policy. For a CHUNKED processor
        the whole failing chunk drops (the chunk call is all-or-nothing).
        'quarantine': requires ``quarantine=``; each failure spends the
        record's retry budget (in-place re-attempts for transient
        processing faults), and once the budget is gone the record is
        dead-lettered with an ACKNOWLEDGED produce before its offset
        retires (counted in ``metrics.quarantined``) — so the committed
        watermark never covers a record that is neither processed nor
        durably quarantined. A failed DLQ produce fail-stops the stream
        (``OutputDeliveryError``, crash-before-commit) — the discipline
        'drop'+``dead_letter`` deliberately does NOT give you (there, a
        broken DLQ loses the copy but keeps ingest alive). Per-record
        processors only: a chunked processor's all-or-nothing call has no
        per-record failure to budget.
    dead_letter: optional ``(record, exception) -> None`` callback invoked
        for each record dropped by the 'drop' policy — wire it to a DLQ
        producer, a file, or a metrics sink. Exceptions it raises are
        logged and swallowed (a broken DLQ must not take down ingest).
    quarantine: a ``resilience.PoisonQuarantine`` (producer + DLQ topic +
        retry budget), required by ``on_processor_error='quarantine'``.
    buckets: length-bucket widths (e.g. ``(64, 128, 512)``) for RAGGED
        record streams: the (per-record) processor returns variable-length
        1-D rows; each lands in the smallest bucket that fits (longer than
        the largest truncates, like ``fixed_width``) and batches emit as
        ``{"tokens": [B, W], "length": [B]}`` per width — one static
        shape per bucket instead of padding everything to the maximum.
        All buckets share the stream's ledger, so commits stay exact under
        out-of-order emission across buckets (transform/bucket.py).
    bucket_pad_value: fill value for intra-bucket padding.
    barrier: override the commit barrier. Default: a plain CommitBarrier
        single-process; inside a ``torch.distributed`` group of more than
        one process a ``BarrierWatchdog`` around it that exits the process
        (code 42) when one barrier call hangs: a dead peer otherwise
        wedges the commit collective. Timing out is fail-closed: nothing
        was committed, so the restart re-delivers the uncommitted tail.
    barrier_timeout_s / on_barrier_timeout: the default watchdog's
        timeout and callback (multi-process only).
    clock: seconds-since-epoch clock for the ``ingest_lag_ms`` gauge
        (record append time -> poll time); default ``time.time``. Inject a
        ``resilience.ManualClock.now`` (with records produced at explicit
        ``timestamp_ms``) and consumer lag becomes exactly testable
        instead of wall-clock-dependent (utils.tracing.ingest_lag_ms).
    """

    def __init__(
        self,
        consumer: Consumer,
        processor: Processor,
        batch_size: int,
        *,
        mesh: Any | None = None,
        data_axis: str | Sequence[str] = "data",
        pad_policy: str = "block",
        prefetch: int = 2,
        max_poll_records: int = 1024,
        poll_timeout_ms: int = 100,
        idle_timeout_ms: int | None = None,
        transform_threads: int = 0,
        to_device: bool = True,
        barrier: CommitBarrier | None = None,
        barrier_timeout_s: float = 300.0,
        on_barrier_timeout: Any | None = None,
        owns_consumer: bool = False,
        on_processor_error: str = "raise",
        dead_letter: Any | None = None,
        quarantine: Any | None = None,
        buckets: Any | None = None,
        bucket_pad_value: int = 0,
        clock: Any | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        if mesh is not None:
            from torchkafka_tpu_torch.parallel.mesh import batch_sharding

            batch_sharding(mesh, data_axis)  # raises on an axis the mesh lacks
        if on_processor_error not in ("raise", "drop", "quarantine"):
            raise ValueError(
                "on_processor_error must be 'raise'|'drop'|'quarantine', "
                f"got {on_processor_error!r}"
            )
        if (on_processor_error == "quarantine") != (quarantine is not None):
            raise ValueError(
                "quarantine= and on_processor_error='quarantine' go "
                "together (the policy needs a DLQ route; a route needs "
                "the policy)"
            )
        self._consumer = consumer
        self._processor = processor
        self._chunked = bool(getattr(processor, "chunked", False))
        if quarantine is not None and self._chunked:
            raise ValueError(
                "on_processor_error='quarantine' needs a per-record "
                "processor: a chunked processor's all-or-nothing call has "
                "no per-record failure to budget (use 'drop' or 'raise')"
            )
        self._mesh = mesh
        self._data_axis = data_axis
        self._to_device = to_device
        self._max_poll = max_poll_records
        self._poll_timeout_ms = poll_timeout_ms
        self._idle_timeout_ms = idle_timeout_ms
        # A consumer shared by the ranks of a serving mesh
        # (``parallel.lockstep.MeshConsumer``): the idle decision is the
        # root's, and only the synchronous path takes it.
        self._lockstep = consumer.mesh if isinstance(consumer, MeshConsumer) else None
        if self._lockstep is not None and prefetch != 0:
            raise ValueError("a MeshConsumer stream runs synchronously (prefetch=0): "
                             "every rank polls at the same point of its loop")
        self._owns_consumer = owns_consumer
        self._clock = clock or time
        self._on_processor_error = on_processor_error
        self._dead_letter = dead_letter
        self._quarantine = quarantine
        if barrier is not None:
            self._barrier = barrier
        elif _world_size() > 1:
            from torchkafka_tpu_torch.parallel.multihost import BarrierWatchdog

            self._barrier = BarrierWatchdog(
                CommitBarrier(), timeout_s=barrier_timeout_s,
                on_timeout=on_barrier_timeout, exit_on_timeout=True,
            )
        else:
            self._barrier = CommitBarrier()
        self.metrics = StreamMetrics()
        self._ledger = OffsetLedger()
        if buckets is not None:
            if self._chunked:
                raise ValueError(
                    "buckets= requires a per-record processor returning "
                    "variable-length 1-D rows; chunked processors emit "
                    "fixed shapes already"
                )
            self._batcher = BucketBatcher(
                batch_size, buckets, self._ledger, pad_policy=pad_policy,
                pad_value=bucket_pad_value,
            )
        else:
            self._batcher = Batcher(
                batch_size, self._ledger, pad_policy=pad_policy
            )
        # Resolved once every argument is checked, so a bad argument
        # raises its ValueError on a machine without the card too.
        if to_device and device is None and mesh is not None:
            device = "cpu" if mesh.device_type == "cpu" else None
        self._device = resolve_device(device) if to_device else None
        # The H2D copies' own stream (created on first use, on the card).
        self._copy_stream: torch.cuda.Stream | None = None
        self._sequencer = CommitSequencer()
        self._sync = prefetch == 0
        self._ready: list[Batch] = []  # sync mode: decoded-but-unyielded batches
        self._idle_since: float | None = None
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._pool = (
            ThreadPoolExecutor(max_workers=transform_threads, thread_name_prefix="tk-transform")
            if transform_threads > 0
            else None
        )
        self._thread = threading.Thread(
            target=self._produce_loop, name="tk-stream", daemon=True
        )
        self._started = False
        self._exhausted = False
        self._commit_pool: ThreadPoolExecutor | None = None

    def _commit_executor(self) -> ThreadPoolExecutor:
        """Single FIFO thread for token.commit_async (order-preserving)."""
        if self._commit_pool is None:
            self._commit_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tk-commit"
            )
        return self._commit_pool

    # ------------------------------------------------------------ producer

    def _put(self, item: Any) -> None:
        """Enqueue with backpressure, aborting if the stream is stopping."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _to_dev(self, batch: Batch) -> tuple[Batch, torch.cuda.Event | None]:
        """Move a host batch toward the device. On the card: each leaf is
        copied into pinned memory (so the transfer never reads a buffer
        anyone may still write), then sent ``non_blocking`` on the side
        copy stream. → (batch, the copy's completion event or None)."""
        ready = None
        if self._to_device:
            if self._device.type == "cuda":
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self._device)
                with torch.cuda.stream(self._copy_stream):
                    data = tree_map(
                        lambda a: torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory()
                        .to(self._device, non_blocking=True),
                        batch.data,
                    )
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
            else:
                data = tree_map(lambda a: torch.as_tensor(a, device=self._device), batch.data)
            batch = Batch(data=data, valid_count=batch.valid_count, offsets=batch.offsets)
        self.metrics.batches.add(1)
        return batch, ready

    def _ship(self, batch: Batch) -> None:
        """Device transfer + enqueue. Runs on the producer thread so
        transfers overlap the consumer's step."""
        self._put(self._to_dev(batch))

    def _drop_errored(self, record, exc: Exception, quiet: bool = False) -> None:
        """The 'drop' policy for one failing record: count, log, DLQ.
        ``quiet`` skips the per-record log (chunk drops log once)."""
        self.metrics.processor_errors.add(1)
        if not quiet:
            _logger.warning(
                "processor raised on %s offset %d; dropping (%s)",
                record.tp, record.offset, exc,
            )
        if self._dead_letter is not None:
            try:
                self._dead_letter(record, exc)
            except Exception:  # noqa: BLE001 - a broken DLQ must not kill ingest
                # Swallowed by contract, but never SILENTLY: the counter
                # puts a broken DLQ on the /metrics endpoint (the record
                # really is lost to the DLQ — that must page someone, not
                # scroll past in stderr).
                self.metrics.dlq_delivery_failures.add(1)
                _logger.exception("dead_letter callback raised; record lost to DLQ")

    def _apply(self, record):
        """Processor with the error policy applied; an error under 'drop'
        becomes the None-drop contract (offset retires, stream continues).
        Under 'quarantine' the record is re-attempted in place while its
        budget lasts, then dead-lettered (acknowledged) and retired; a
        failed DLQ produce raises OutputDeliveryError through the normal
        sticky-death path — fail-stop, crash-before-commit."""
        while True:
            try:
                return self._processor(record)
            except Exception as e:  # noqa: BLE001 - policy decides
                if self._on_processor_error == "raise":
                    raise
                if self._on_processor_error == "quarantine":
                    self.metrics.processor_errors.add(1)
                    if not self._quarantine.note_failure(record, e):
                        continue  # budget left: transient until proven poison
                    self.metrics.quarantined.add(1)
                    _logger.warning(
                        "poison record %s offset %d dead-lettered to %r; "
                        "offset retires (%s)",
                        record.tp, record.offset,
                        self._quarantine.topic, e,
                    )
                    return None  # resolved: retires like a drop
                self._drop_errored(record, e)
                return None

    def _process_chunk(self, records) -> list[Batch]:
        """One poll chunk through ledger + transform + batcher. Shared by the
        threaded producer loop and the synchronous path."""
        self.metrics.records.add(len(records))
        newest = records[-1].timestamp_ms
        if newest:
            # Through the shared helper + the injectable clock, never a
            # bare wall-clock read: ManualClock tests pin lag exactly.
            self.metrics.ingest_lag_ms.set(
                ingest_lag_ms(newest, clock=self._clock)
            )
        self._ledger.fetched_many(records)
        if self._chunked:
            # Vectorized path: one processor call per poll chunk, one
            # slice-copy per emitted batch — the throughput hot path.
            try:
                stacked, keep = self._processor(records)
            except Exception as e:  # noqa: BLE001 - policy decides
                if self._on_processor_error == "raise":
                    raise
                # The chunk call is all-or-nothing: the whole chunk drops.
                # ONE log line for the chunk (a 1024-record poll would
                # otherwise emit 1024 identical warnings per bad record);
                # DLQ + metrics still run per record.
                _logger.warning(
                    "chunk processor raised; dropping %d records "
                    "(%s offsets %d-%d) (%s)",
                    len(records), records[0].tp, records[0].offset,
                    records[-1].offset, e,
                )
                for r in records:
                    self._drop_errored(r, e, quiet=True)
                stacked, keep = None, None
            if keep is not None:
                self.metrics.dropped.add(int(len(keep) - keep.sum()))
            elif stacked is None:
                self.metrics.dropped.add(len(records))
            # stacked=None (whole chunk dropped) is handled by the batcher:
            # it retires every offset so the commit watermark can't freeze.
            return self._batcher.add_many(stacked, records, keep)
        if self._pool is not None:
            # Lazy: results stream out in order as workers finish, so a
            # batch ships as soon as it fills instead of waiting for the
            # whole poll chunk to transform.
            elements = self._pool.map(self._apply, records)
        else:
            elements = (self._apply(r) for r in records)
        outs = []
        for r, el in zip(records, elements):
            if el is None:
                self.metrics.dropped.add(1)
            out = self._batcher.add(el, r)
            if out is not None:
                outs.append(out)
        return outs

    def _produce_loop(self) -> None:
        last_data = monotonic()
        try:
            while not self._stop.is_set():
                try:
                    records = self._consumer.poll(
                        max_records=self._max_poll, timeout_ms=self._poll_timeout_ms
                    )
                except ConsumerClosedError:
                    break  # clean end: consumer closed under us
                if not records:
                    if (
                        self._idle_timeout_ms is not None
                        and (monotonic() - last_data) * 1000 >= self._idle_timeout_ms
                    ):
                        break
                    continue
                last_data = monotonic()
                for out in self._process_chunk(records):
                    self._ship(out)
            for tail in self._batcher.flush_tails():
                self._ship(tail)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            self._error = e
        finally:
            self._put(_END)

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> Iterator[tuple[Batch, CommitToken]]:
        return self

    def _next_sync(self) -> tuple[Batch, CommitToken]:
        """prefetch=0: poll/decode inline on the caller's thread."""
        while not self._ready:
            if self._stop.is_set():
                raise StopIteration
            try:
                records = self._consumer.poll(
                    max_records=self._max_poll, timeout_ms=self._poll_timeout_ms
                )
            except ConsumerClosedError:
                records = []
                self._stop.set()
            if records:
                self._idle_since = None
                try:
                    self._ready.extend(self._process_chunk(records))
                except BaseException as e:  # noqa: BLE001 - sticky, then re-raised
                    # Same sticky-death contract as the threaded path: a
                    # processor error ENDS the stream. Without this, a
                    # caller that catches the error and keeps iterating
                    # would silently resume past a poisoned chunk whose
                    # offsets are half-resolved — completed batches lost,
                    # commit watermark frozen at the poison offset.
                    self._error = e
                    self._exhausted = True
                    self._stop.set()
                    raise
                continue
            now = monotonic()
            if self._idle_since is None:
                self._idle_since = now
            idle = (self._idle_timeout_ms is not None
                    and (now - self._idle_since) * 1000 >= self._idle_timeout_ms)
            if self._lockstep is not None:
                # Ranks of a serving mesh poll the root's consumer: the
                # root's clock ends the stream for every rank.
                idle = agree(self._lockstep, idle)
            if self._stop.is_set() or idle:
                tails = self._batcher.flush_tails()
                self._exhausted = True
                if not tails:
                    raise StopIteration
                self._ready.extend(tails)
        return self._mint(*self._to_dev(self._ready.pop(0)))

    def __next__(self) -> tuple[Batch, CommitToken]:
        if self._exhausted and not self._ready:
            # Sticky: the _END sentinel is consumed only once; without this a
            # second iteration attempt would block forever on an empty queue.
            if self._error is not None:
                raise self._error
            raise StopIteration
        if self._sync:
            return self._next_sync()
        if not self._started:
            self._started = True
            self._thread.start()
        while True:
            try:
                item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if self._error is not None:
                    self._exhausted = True
                    raise self._error
                if self._stop.is_set():
                    self._exhausted = True
                    raise StopIteration
        if item is _END:
            self._exhausted = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return self._mint(*item)

    def _mint(
        self, batch: Batch, ready: torch.cuda.Event | None = None
    ) -> tuple[Batch, CommitToken]:
        if ready is not None:
            # The caller's stream waits for the H2D copy, and the allocator
            # learns the tensors are in use there (they were allocated on
            # the copy stream).
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in tree_leaves(batch.data):
                t.record_stream(stream)
        if self._mesh is not None and self._to_device:
            from torchkafka_tpu_torch.parallel.mesh import global_batch

            batch = Batch(data=global_batch(batch.data, self._mesh, self._data_axis),
                          valid_count=batch.valid_count, offsets=batch.offsets)
        token = CommitToken(
            self._consumer,
            batch.offsets,
            self._sequencer,
            barrier=self._barrier,
            on_commit=self._record_commit,
            executor=self._commit_executor,
        )
        return batch, token

    def _record_commit(self, latency_s: float, ok: bool) -> None:
        if ok:
            self.metrics.commit_latency.observe(latency_s)
        else:
            self.metrics.commit_failures.add(1)

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the stream. Never commits on its own — in-flight batches
        re-deliver (the reference's close contract,
        /root/reference/src/kafka_dataset.py:89) — but commits the USER
        already requested via commit_async are drained, not dropped."""
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                _logger.warning(
                    "KafkaStream producer thread still alive after 5s join; "
                    "a wedged consumer poll is leaking a daemon thread that "
                    "holds the consumer"
                )
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._commit_pool is not None:
            self._commit_pool.shutdown(wait=True)
        if self._owns_consumer:
            self._consumer.close()

    def __enter__(self) -> "KafkaStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream(consumer: Consumer, processor: Processor, batch_size: int, **kw) -> KafkaStream:
    """Functional spelling of KafkaStream(...)."""
    return KafkaStream(consumer, processor, batch_size, **kw)
