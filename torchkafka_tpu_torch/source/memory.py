"""In-memory Kafka-semantics broker and consumer.

The reference has no test double at all (SURVEY.md §4: no tests anywhere in
the tree); every commit-ordering behavior it implements is only exercisable
against a live broker. This module is the seam SURVEY.md §4 calls for: a
faithful in-process implementation of the consumer surface the framework uses
— partitioned logs, consumer groups with generation-checked commits,
rebalance-on-membership-change, at-least-once re-delivery — so the entire
commit path is testable and benchmarkable hermetically (the environment has
no network egress and no broker).

Semantics mirrored from the Kafka group protocol (behavior the reference
depends on implicitly via kafka-python):

- Partitions of subscribed topics are range-assigned across the group's
  members; any join/leave bumps the group *generation* and reassigns.
  This is the mechanism behind the reference's data-parallel sharding
  (the reference's src/kafka_dataset.py:208-233 — one consumer per DataLoader
  worker, disjoint partitions each).
- A commit carrying a stale generation (i.e. issued after a rebalance took
  the partitions away) raises CommitFailedError — exactly the error the
  reference swallows as non-fatal (the reference's src/kafka_dataset.py:131-135).
- Committed offsets are the group's durable resume state: a new consumer in
  the same group starts at the committed offset (the reference's
  checkpoint/resume story, SURVEY.md §5).

``commit_log_path`` additionally appends every successful commit as a JSON
line; this makes commits observable across forked processes, which is how the
torch-DataLoader compat path is tested.
"""

from __future__ import annotations

import itertools
import json
import logging
import re
import threading
import time
import zlib
from typing import Any, Iterable, Mapping, Sequence

from torchkafka_tpu_torch.errors import (
    CommitFailedError,
    ConsumerClosedError,
    FencedMemberError,
    NotAssignedError,
    ProducerFencedError,
    TransactionStateError,
    UnknownTopicError,
)
from torchkafka_tpu_torch.source.consumer import ConsumerIterMixin
from torchkafka_tpu_torch.source.records import Record, TopicPartition
from torchkafka_tpu_torch.source import wal as _wal

_member_counter = itertools.count()


class _Group:
    """One consumer group: membership, generation, assignment, offsets."""

    def __init__(self, gid: str = "") -> None:
        self.gid = gid
        self.generation = 0
        # member_id -> subscription: a frozenset of topic names, or a
        # compiled regex (pattern subscription) resolved at rebalance time
        self.members: dict[str, "frozenset[str] | re.Pattern"] = {}
        self.assignment: dict[str, list[TopicPartition]] = {}
        self.committed: dict[TopicPartition, int] = {}
        # member_id -> lease expiry deadline (broker clock). Populated only
        # when the broker has a session timeout; renewed by heartbeat().
        self.leases: dict[str, float] = {}
        # Members evicted by lease expiry or an explicit fence() — kept so
        # a zombie's later heartbeat gets FencedMemberError (Kafka's
        # UNKNOWN_MEMBER_ID) rather than a confusing KeyError.
        self.fenced: set[str] = set()
        self.fence_count = 0


class _Txn:
    """One in-flight transaction: the records appended under it (by log
    position) and the offset commits buffered to land atomically with
    them."""

    __slots__ = ("seq", "records", "offsets")

    def __init__(self, seq: int) -> None:
        self.seq = seq
        self.records: list[tuple[TopicPartition, int]] = []
        # group_id -> (offsets, member_id, generation); last write per
        # group wins (Kafka's sendOffsetsToTransaction semantics).
        self.offsets: dict[str, tuple[dict, str | None, int | None]] = {}


class _TxnProducer:
    """Broker-side state for one ``transactional.id``: the current
    producer id + epoch, the open transaction (if any), and the last
    completed outcome (for idempotent commit retries)."""

    __slots__ = ("txn_id", "pid", "epoch", "open", "last")

    def __init__(self, txn_id: str, pid: int) -> None:
        self.txn_id = txn_id
        self.pid = pid
        self.epoch = 0
        self.open: _Txn | None = None
        self.last: tuple[int, str] | None = None  # (epoch, outcome)


class InMemoryBroker:
    """Thread-safe partitioned log store with consumer-group semantics."""

    def __init__(
        self,
        commit_log_path: str | None = None,
        *,
        session_timeout_s: float | None = None,
        clock=None,
        wal_dir: str | None = None,
        wal_durability: str | None = "batch",
        wal_segment_bytes: int = 4 * 1024 * 1024,
    ) -> None:
        """``session_timeout_s``: opt-in heartbeat leases for group
        members (None, the default, preserves lease-free semantics —
        membership changes only via join/leave). With a timeout set,
        ``join`` grants each member a lease that only ``heartbeat``
        renews; a member whose lease expires is FENCED — evicted with a
        rebalance — the next time any group-mutating traffic arrives
        (another member's heartbeat or join, its own commit, or an
        explicit ``fence``). Fencing on the zombie's own COMMIT is the
        integrity half: a merely-slow member that missed heartbeats gets
        its commit rejected (records re-deliver), never merged.
        ``clock``: the lease clock (default ``time.monotonic``);
        injectable so lease tests run on a ``ManualClock``.

        ``wal_dir``: opt-in DURABILITY (None, the default, keeps the
        broker fully in-memory — nothing on disk, nothing recovered).
        With a directory set, every state change that the broker ever
        acknowledges — produced records, committed offset snapshots,
        group membership/generation mutations, transaction begin/commit/
        abort markers, producer-id inits — is appended to a segmented
        CRC-framed write-ahead log (source/wal.py) BEFORE the ack, and
        construction over a non-empty ``wal_dir`` RECOVERS: the log
        replays into identical topics/records/offsets/generations, a
        transaction with a begin but no commit marker is ABORTED (its
        producer's next ``init_producer_id`` already expects that — the
        epoch fence from the process fleet), the LSO recomputes so
        ``read_committed`` consumers never see a half-recovered
        transaction, and restored group members get FRESH leases (a
        member that is really dead just expires one session timeout
        later, exactly like any other silent peer). ``wal_durability``:
        the fsync discipline (``"commit"``/``"batch"``/None — see
        source/wal.py; process death never loses acknowledged events
        under any of them, only machine death reaches the knob)."""
        if session_timeout_s is not None and session_timeout_s <= 0:
            raise ValueError(
                f"session_timeout_s must be > 0 or None, got {session_timeout_s}"
            )
        from torchkafka_tpu_torch.utils.metrics import BrokerMetrics

        self._lock = threading.RLock()
        self._data_arrived = threading.Condition(self._lock)
        self._logs: dict[TopicPartition, list[Record]] = {}
        self._topics: dict[str, int] = {}  # topic -> partition count
        self._groups: dict[str, _Group] = {}
        self._rr: dict[str, int] = {}  # per-topic round-robin produce cursor
        self._commit_log_path = commit_log_path
        self._session_timeout_s = session_timeout_s
        self._clock = clock if clock is not None else time.monotonic
        # Transactions (KIP-98 shape): producers keyed by transactional
        # id; per-partition side table mapping offset -> txn sequence for
        # TRANSACTIONAL records only (non-transactional records have no
        # entry and are stable the moment they append); txn sequence ->
        # lifecycle status. Records append to the real log immediately
        # (read_uncommitted sees them, like Kafka); the committed view is
        # computed by ``fetch_stable``.
        self._txn_producers: dict[str, _TxnProducer] = {}
        self._txn_by_pid: dict[int, _TxnProducer] = {}
        self._txn_pid_counter = itertools.count(1000)
        self._txn_seq_counter = itertools.count(1)
        self._txn_status: dict[int, str] = {}  # seq -> open|committed|aborted
        self._rec_txn: dict[TopicPartition, dict[int, int]] = {}
        self.metrics = BrokerMetrics()
        self.recovery_info: dict | None = None
        self._wal: _wal.WriteAheadLog | None = None
        # "quorum" is a CELL-level ack discipline, not a new fsync mode:
        # each replica keeps the default batch fsync locally and the ack
        # gate moves to the replicator (a mutation returns only once a
        # majority of replicas appended its frame). A bare broker with
        # no replicator attached just runs the local half — the cell
        # (source/cluster.py) attaches the quorum gate after recovery.
        self.wal_durability = wal_durability
        if wal_durability == "quorum":
            wal_durability = "batch"
        self.replicator = None
        if wal_dir is not None:
            self._recover_from_wal(
                wal_dir, wal_durability, wal_segment_bytes
            )

    # ------------------------------------------------------ WAL + recovery

    @property
    def wal(self) -> "_wal.WriteAheadLog | None":
        return self._wal

    def _wal_append(self, kind: str, event: dict) -> None:
        # The closed-WAL guard covers teardown stragglers (a drain-path
        # mutation landing after close()): in-memory semantics proceed,
        # durability is over — the broker is already being discarded.
        if self._wal is not None and not self._wal.closed:
            self._wal.append(kind, event)
        # Quorum gate: with a replicator attached, the local append is
        # only half the ack — ship() returns on majority and RAISES
        # otherwise, aborting the in-memory apply before the caller could
        # observe a mutation the cell cannot durably prove.
        rep = self.replicator
        if rep is not None:
            rep.ship(kind, event)

    def repl_ping(self) -> dict:
        """Leader-liveness probe for the cell's heartbeat loop: answers
        iff this broker's server is reachable, and reports the epoch it
        is serving under (0 for a bare, cell-less broker)."""
        rep = self.replicator
        return {
            "epoch": rep.epoch if rep is not None else 0,
            "frames": len(rep.log) if rep is not None else 0,
        }

    def close(self) -> None:
        """Flush + close the write-ahead log (clean shutdown; a crash
        skips this by definition and recovery covers it). No-op for the
        pure in-memory broker."""
        if self._wal is not None and not self._wal.closed:
            self._wal.close()

    def _recover_from_wal(
        self, wal_dir: str, durability: str | None, segment_bytes: int
    ) -> None:
        """Rebuild broker state from the log: replay the clean frame
        prefix (a torn tail is truncated, never replayed), settle every
        transaction the log left unsettled (begin without commit/abort →
        ABORT — its records drop out of the committed view and its
        buffered offsets vanish), advance the id counters past everything
        replayed, grant restored members fresh leases, then open the log
        for append and write the recovery abort markers so the on-disk
        log states what recovery decided."""
        from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

        t0 = time.perf_counter()
        events, truncated = _wal.replay(wal_dir, repair=True)
        replayed_records = 0
        for kind, event in events:
            # Recovery is read-only until the replay completes: a death
            # here leaves the log byte-identical, so the next recovery
            # reproduces the identical state (the crash matrix kills a
            # recovering broker exactly here to prove it).
            crash_hook("recovery_mid_replay")
            self._apply_wal_event(kind, event)
            if kind == "produce":
                replayed_records += 1
        aborted: list[tuple[str, int, int]] = []
        for st in self._txn_producers.values():
            if st.open is not None:
                self._txn_status[st.open.seq] = "aborted"
                st.last = (st.epoch, "aborted")
                aborted.append((st.txn_id, st.epoch, st.open.seq))
                st.open = None
        if self._txn_by_pid:
            self._txn_pid_counter = itertools.count(
                max(self._txn_by_pid) + 1
            )
        if self._txn_status:
            self._txn_seq_counter = itertools.count(
                max(self._txn_status) + 1
            )
        if self._session_timeout_s is not None:
            # Restored members get fresh leases dated from recovery: a
            # live worker's reconnecting heartbeat renews in time, a dead
            # one silently expires one session timeout later — the normal
            # fencing path, no special casing. This is what lets a
            # process fleet ride a broker restart without re-joining.
            now = self._clock()
            for g in self._groups.values():
                for m in g.members:
                    g.leases[m] = now + self._session_timeout_s
        else:
            # A lease-less broker has NO liveness protocol that could
            # ever reap a dead member: restored memberships would be
            # immortal ghosts squatting on their partitions. Kafka's own
            # coordinator failover makes members REJOIN; mirror that —
            # drop memberships (committed offsets keep, they are the
            # durable resume state) with one final rebalance per group,
            # so a pre-crash zombie's stale-generation commit still
            # bounces off the moved generation.
            for g in self._groups.values():
                if g.members:
                    g.members.clear()
                    g.leases.clear()
                    self._rebalance(g)
        recovery_ms = (time.perf_counter() - t0) * 1e3
        self._wal = _wal.WriteAheadLog(
            wal_dir, durability=durability, segment_bytes=segment_bytes,
            metrics=self.metrics,
        )
        for txn_id, epoch, seq in aborted:
            self._wal_append("txn_abort", {
                "txn_id": txn_id, "epoch": epoch, "seq": seq,
                "recovery": True,
            })
        m = self.metrics
        m.recoveries.add(1)
        m.recovery_replayed_events.add(len(events))
        m.recovery_replayed_records.add(replayed_records)
        m.recovery_aborted_txns.add(len(aborted))
        m.recovery_truncated_bytes.add(truncated)
        m.recovery_ms.set(recovery_ms)
        self.recovery_info = {
            "replayed_events": len(events),
            "replayed_records": replayed_records,
            "aborted_txns": len(aborted),
            "truncated_bytes": truncated,
            "recovery_ms": round(recovery_ms, 3),
        }

    def _apply_wal_event(self, kind: str, d: dict) -> None:
        """One replayed event → the same state mutation the original
        call made, minus re-logging and lease bookkeeping (leases are
        wall-clock state; recovery re-grants them wholesale). Raw-state
        application keeps replay byte-exact: record timestamps, offsets,
        the round-robin produce cursor, and group generations all come
        out identical to the pre-crash broker."""
        if kind == "topic":
            topic, parts = d["topic"], d["partitions"]
            self._topics[topic] = parts
            for p in range(parts):
                self._logs[TopicPartition(topic, p)] = []
            for g in self._groups.values():
                if any(
                    isinstance(sub, re.Pattern) and sub.match(topic)
                    for sub in g.members.values()
                ):
                    self._rebalance(g)
        elif kind == "produce":
            tp = TopicPartition(d["topic"], d["partition"])
            log = self._logs[tp]
            rec = Record(
                topic=d["topic"], partition=d["partition"],
                offset=len(log), value=d["value"], key=d["key"],
                timestamp_ms=d["ts"], headers=tuple(d["headers"]),
            )
            log.append(rec)
            if d.get("rr"):
                self._rr[d["topic"]] = d["partition"] + 1
            if d.get("seq") is not None:
                self._rec_txn.setdefault(tp, {})[rec.offset] = d["seq"]
        elif kind == "group":
            g = self._group(d["group"])
            member = d["member"]
            if d["op"] == "join":
                g.members[member] = (
                    re.compile(d["pattern"])
                    if d.get("pattern") is not None
                    else frozenset(d["topics"])
                )
                g.fenced.discard(member)
                self._rebalance(g)
            elif d["op"] == "leave":
                if member in g.members:
                    del g.members[member]
                    self._rebalance(g)
            elif d["op"] == "fence":
                if member in g.members:
                    del g.members[member]
                    g.fenced.add(member)
                    g.fence_count += 1
                    self._rebalance(g)
        elif kind == "commit":
            self._group(d["group"]).committed.update(d["offsets"])
        elif kind == "init_pid":
            st = self._txn_producers.get(d["txn_id"])
            if st is None:
                st = _TxnProducer(d["txn_id"], d["pid"])
                self._txn_producers[d["txn_id"]] = st
                self._txn_by_pid[st.pid] = st
            st.epoch = d["epoch"]
        elif kind == "txn_begin":
            st = self._txn_producers[d["txn_id"]]
            txn = _Txn(d["seq"])
            self._txn_status[txn.seq] = "open"
            st.open = txn
        elif kind == "txn_commit":
            self._txn_status[d["seq"]] = "committed"
            st = self._txn_producers.get(d["txn_id"])
            if st is not None:
                if st.open is not None and st.open.seq == d["seq"]:
                    st.open = None
                st.last = (d["epoch"], "committed")
            for gid, offsets in d["offsets"].items():
                self._group(gid).committed.update(offsets)
        elif kind == "txn_abort":
            self._txn_status[d["seq"]] = "aborted"
            st = self._txn_producers.get(d["txn_id"])
            if st is not None:
                if st.open is not None and st.open.seq == d["seq"]:
                    st.open = None
                st.last = (d["epoch"], "aborted")
        else:  # pragma: no cover - forward-compat guard
            logging.getLogger(__name__).warning(
                "ignoring unknown WAL event kind %r", kind
            )

    # ------------------------------------------------------------- topics

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        with self._lock:
            if topic in self._topics:
                raise ValueError(f"topic {topic!r} already exists")
            self._wal_append("topic", {
                "topic": topic, "partitions": partitions,
            })
            self._topics[topic] = partitions
            for p in range(partitions):
                self._logs[TopicPartition(topic, p)] = []
            # Pattern subscribers pick up matching NEW topics via a
            # rebalance (Kafka's metadata-refresh path).
            for g in self._groups.values():
                if any(
                    isinstance(sub, re.Pattern) and sub.match(topic)
                    for sub in g.members.values()
                ):
                    self._rebalance(g)

    def partitions_for(self, topic: str) -> int:
        with self._lock:
            if topic not in self._topics:
                raise UnknownTopicError(topic)
            return self._topics[topic]

    def produce(
        self,
        topic: str,
        value: bytes,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
        _txn_seq: int | None = None,
    ) -> Record:
        """Append one record; partition chosen by explicit arg, key hash, or
        round-robin (Kafka's default partitioner behavior). ``_txn_seq``
        is internal (``txn_produce``): the owning transaction's sequence,
        journaled WITH the record so recovery restores the association."""
        with self._lock:
            n = self.partitions_for(topic)
            was_rr = partition is None and key is None
            if partition is None:
                if key is not None:
                    partition = zlib.crc32(key) % n
                else:
                    partition = self._rr.get(topic, 0) % n
                    self._rr[topic] = partition + 1
            if not 0 <= partition < n:
                raise ValueError(f"partition {partition} out of range for {topic!r}")
            tp = TopicPartition(topic, partition)
            log = self._logs[tp]
            ts = int(time.time() * 1000) if timestamp_ms is None else int(timestamp_ms)
            if log:
                # LogAppendTime semantics: timestamps are monotone per
                # partition (clamped, like a broker with its own clock) —
                # the invariant offset_for_time's bisect relies on.
                ts = max(ts, log[-1].timestamp_ms)
            rec = Record(
                topic=topic,
                partition=partition,
                offset=len(log),
                value=value,
                key=key,
                timestamp_ms=ts,
                headers=tuple(headers),
            )
            # Write-ahead: the record is durable before the append is
            # acknowledged (an unlogged append dies with the process and
            # was never acked — the producer's retry is the recovery).
            self._wal_append("produce", {
                "topic": topic, "partition": partition, "value": value,
                "key": key, "ts": ts, "headers": tuple(headers),
                "rr": was_rr, "seq": _txn_seq,
            })
            log.append(rec)
            if _txn_seq is not None:
                self._rec_txn.setdefault(tp, {})[rec.offset] = _txn_seq
            self._data_arrived.notify_all()
            return rec

    def produce_many(self, topic: str, values: Iterable[bytes], **kw) -> list[Record]:
        return [self.produce(topic, v, **kw) for v in values]

    def end_offset(self, tp: TopicPartition) -> int:
        with self._lock:
            if tp not in self._logs:
                raise UnknownTopicError(tp)
            return len(self._logs[tp])

    def fetch(self, tp: TopicPartition, offset: int, max_records: int) -> list[Record]:
        with self._lock:
            if tp not in self._logs:
                raise UnknownTopicError(tp)
            log = self._logs[tp]
            return log[offset : offset + max_records]

    def offset_for_time(self, tp: TopicPartition, timestamp_ms: int) -> int | None:
        """Earliest offset whose record timestamp >= ``timestamp_ms``; None
        if every record is older. Produce order gives monotone timestamps
        per partition (as Kafka's log-append time does), so bisect applies."""
        import bisect

        with self._lock:
            if tp not in self._logs:
                raise UnknownTopicError(tp)
            log = self._logs[tp]
            i = bisect.bisect_left(log, timestamp_ms, key=lambda r: r.timestamp_ms)
            return log[i].offset if i < len(log) else None

    # -------------------------------------------------------- transactions

    def init_producer_id(self, transactional_id: str) -> tuple[int, int]:
        """Register (or re-register) a transactional producer; returns
        ``(producer_id, epoch)``. Re-initializing an EXISTING
        transactional id is the fencing act (KIP-98): the epoch bumps —
        every operation still carrying the old epoch raises
        ``ProducerFencedError`` from here on — and any transaction the
        old epoch left open is ABORTED (its records drop out of the
        committed view, its buffered offsets are discarded). This is how
        a SIGKILLed producer's in-flight transaction dies: its successor
        (same transactional id — the process fleet keys it by replica
        INDEX, not incarnation) initializes, and the corpse's work
        vanishes atomically."""
        if not transactional_id:
            raise ValueError("transactional_id must be a non-empty string")
        with self._lock:
            st = self._txn_producers.get(transactional_id)
            if st is None:
                st = _TxnProducer(transactional_id, next(self._txn_pid_counter))
                self._txn_producers[transactional_id] = st
                self._txn_by_pid[st.pid] = st
            else:
                st.epoch += 1
                if st.open is not None:
                    self._abort_txn_locked(st)
            # Durable BEFORE the ack: the epoch fence must survive broker
            # death, or a recovered broker would let a SIGKILLed zombie's
            # stale epoch write again.
            self._wal_append("init_pid", {
                "txn_id": transactional_id, "pid": st.pid,
                "epoch": st.epoch,
            })
            return st.pid, st.epoch

    def _txn_state(self, producer_id: int, epoch: int) -> _TxnProducer:
        """Resolve + fence-check. Caller holds the lock."""
        st = self._txn_by_pid.get(producer_id)
        if st is None:
            raise ProducerFencedError(
                f"unknown producer id {producer_id} (never initialized, or "
                "forged); init_producer_id first"
            )
        if epoch != st.epoch:
            raise ProducerFencedError(
                f"producer {st.txn_id!r} epoch {epoch} is "
                f"{'stale' if epoch < st.epoch else 'from the future'} "
                f"(current {st.epoch}): another incarnation holds this "
                "transactional id; this handle is a zombie's"
            )
        return st

    def begin_txn(self, producer_id: int, epoch: int) -> None:
        """Open a transaction. If the SAME epoch already holds one open
        (a client that lost track after a transport fault mid-cycle),
        the stale transaction is aborted first and a fresh one opened —
        self-healing over strictness, since nothing of the old one could
        ever have committed without this epoch asking for it."""
        with self._lock:
            st = self._txn_state(producer_id, epoch)
            if st.open is not None:
                self._abort_txn_locked(st)
            txn = _Txn(next(self._txn_seq_counter))
            self._wal_append("txn_begin", {
                "txn_id": st.txn_id, "epoch": epoch, "seq": txn.seq,
            })
            self._txn_status[txn.seq] = "open"
            st.open = txn

    def txn_produce(
        self,
        producer_id: int,
        epoch: int,
        topic: str,
        value: bytes,
        key: bytes | None = None,
        partition: int | None = None,
        timestamp_ms: int | None = None,
        headers: tuple[tuple[str, bytes], ...] = (),
    ) -> Record:
        """Append one record UNDER the open transaction. The record lands
        in the real log immediately (``read_uncommitted`` consumers see
        it, as on Kafka) but stays invisible to ``read_committed``
        consumers until ``commit_txn`` — and vanishes from their view
        forever on abort."""
        with self._lock:
            st = self._txn_state(producer_id, epoch)
            if st.open is None:
                raise TransactionStateError(
                    f"producer {st.txn_id!r} has no open transaction; "
                    "begin_txn first"
                )
            rec = self.produce(
                topic, value, key=key, partition=partition,
                timestamp_ms=timestamp_ms, headers=headers,
                _txn_seq=st.open.seq,
            )
            st.open.records.append(
                (TopicPartition(rec.topic, rec.partition), rec.offset)
            )
            return rec

    def txn_commit_offsets(
        self,
        producer_id: int,
        epoch: int,
        group_id: str,
        offsets: Mapping[TopicPartition, int],
        member_id: str | None = None,
        generation: int | None = None,
    ) -> None:
        """Buffer consumer offsets INTO the open transaction — they
        become durable atomically with the transaction's records at
        ``commit_txn`` (Kafka's sendOffsetsToTransaction). Validated
        eagerly against the group (stale generation / fenced member /
        unowned partition raises ``CommitFailedError`` NOW, so the
        caller can abort instead of discovering it at commit) and
        re-validated atomically at commit time — a rebalance in between
        aborts the whole transaction, records included. Repeated calls
        for the same group replace the earlier buffer (last wins)."""
        with self._lock:
            st = self._txn_state(producer_id, epoch)
            if st.open is None:
                raise TransactionStateError(
                    f"producer {st.txn_id!r} has no open transaction; "
                    "begin_txn first"
                )
            g = self._group(group_id)
            self._validate_group_commit_locked(
                g, group_id, offsets, member_id, generation
            )
            st.open.offsets[group_id] = (dict(offsets), member_id, generation)

    def commit_txn(self, producer_id: int, epoch: int) -> None:
        """Atomically commit the open transaction: its records become
        visible to ``read_committed`` consumers AND its buffered offsets
        merge into the group watermark(s) — one outcome, never half.
        The offset validation re-runs HERE, inside the same lock that
        flips the records' status: if the group rebalanced since
        ``txn_commit_offsets`` (the member was fenced, the generation
        moved), the ENTIRE transaction aborts and ``CommitFailedError``
        raises — the records never reach the committed view, so the new
        partition owner's re-serve is the only copy (this is the
        exactly-once pivot). A retry of an already-committed transaction
        (transport fault ate the ack) is answered with success."""
        with self._lock:
            st = self._txn_state(producer_id, epoch)
            if st.open is None:
                if st.last == (epoch, "committed"):
                    return  # idempotent retry of an un-acked commit
                raise TransactionStateError(
                    f"producer {st.txn_id!r} has no open transaction to "
                    "commit"
                )
            txn = st.open
            try:
                for gid, (offsets, member_id, generation) in txn.offsets.items():
                    self._validate_group_commit_locked(
                        self._group(gid), gid, offsets, member_id, generation
                    )
            except CommitFailedError:
                # Atomicity means failure is total: records out too.
                self._abort_txn_locked(st)
                raise
            from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

            # The WAL marker IS the commit decision (KIP-98's transaction
            # marker): offsets validated, marker not yet durable — broker
            # death here recovers to an ABORTED transaction (begin with
            # no commit marker), nothing surfaces committed.
            crash_hook("txn_marker_pre_append")
            self._wal_append("txn_commit", {
                "txn_id": st.txn_id, "epoch": epoch, "seq": txn.seq,
                "offsets": {
                    gid: dict(offsets)
                    for gid, (offsets, _m, _g) in txn.offsets.items()
                },
            })
            # Marker durable, memory state not yet flipped / ack not yet
            # sent: broker death here recovers to a COMMITTED transaction
            # (records + offsets atomic), and the producer's retry of
            # commit_txn is answered idempotently via the restored
            # ``last`` outcome.
            crash_hook("txn_marker_post_append_pre_ack")
            self._txn_status[txn.seq] = "committed"
            st.open = None
            st.last = (epoch, "committed")
            for gid, (offsets, member_id, generation) in txn.offsets.items():
                self._apply_commit_locked(gid, offsets, member_id, log=False)
            # Committed records became readable below the (possibly
            # advanced) LSO: wake blocked read_committed pollers.
            self._data_arrived.notify_all()

    def abort_txn(self, producer_id: int, epoch: int) -> bool:
        """Abort the open transaction: its records drop out of the
        committed view permanently, its buffered offsets are discarded,
        and the group watermark is untouched. Idempotent — aborting with
        nothing open returns False (a recovery path must be free to
        abort defensively)."""
        with self._lock:
            st = self._txn_state(producer_id, epoch)
            if st.open is None:
                return False
            self._abort_txn_locked(st)
            return True

    def _abort_txn_locked(self, st: _TxnProducer) -> None:
        self._wal_append("txn_abort", {
            "txn_id": st.txn_id, "epoch": st.epoch, "seq": st.open.seq,
        })
        self._txn_status[st.open.seq] = "aborted"
        st.last = (st.epoch, "aborted")
        st.open = None
        # Aborted records stop gating the LSO: readers blocked on them
        # may now advance.
        self._data_arrived.notify_all()

    def last_stable_offset(self, tp: TopicPartition) -> int:
        """The partition's LSO: everything below it has a settled
        transactional fate (committed, aborted, or was never
        transactional). ``fetch_stable`` never reads at or past it —
        Kafka's read_committed ordering guarantee (a later record never
        surfaces before an earlier still-open transaction decides)."""
        with self._lock:
            if tp not in self._logs:
                raise UnknownTopicError(tp)
            return self._lso_locked(tp)

    def _lso_locked(self, tp: TopicPartition) -> int:
        lso = len(self._logs[tp])
        meta = self._rec_txn.get(tp)
        if meta:
            for off, seq in meta.items():
                if off < lso and self._txn_status[seq] == "open":
                    lso = off
        return lso

    def fetch_stable(
        self, tp: TopicPartition, offset: int, max_records: int
    ) -> tuple[list[Record], int]:
        """The read_committed fetch: records from ``offset`` with
        committed-or-non-transactional status, stopping at the LSO;
        aborted records are skipped (they hold their offsets but never
        surface). Returns ``(records, next_offset)`` — the consumer must
        resume from ``next_offset``, which advances over skipped aborted
        records (unlike plain ``fetch``, the record list alone cannot
        carry the position)."""
        with self._lock:
            if tp not in self._logs:
                raise UnknownTopicError(tp)
            log = self._logs[tp]
            meta = self._rec_txn.get(tp, {})
            lso = self._lso_locked(tp)
            out: list[Record] = []
            pos = max(0, offset)
            while pos < lso and len(out) < max_records:
                seq = meta.get(pos)
                if seq is None or self._txn_status[seq] == "committed":
                    out.append(log[pos])
                pos += 1
            return out, pos

    # -------------------------------------------------------------- groups

    def _group(self, group_id: str) -> _Group:
        return self._groups.setdefault(group_id, _Group(group_id))

    def _fence_locked(self, g: _Group, member_id: str) -> bool:
        """Evict one member (lease expiry or explicit fence) and
        rebalance. Returns True if the member was actually present.
        Caller holds the lock."""
        if member_id not in g.members:
            return False
        self._wal_append("group", {
            "op": "fence", "group": g.gid, "member": member_id,
        })
        del g.members[member_id]
        g.leases.pop(member_id, None)
        g.fenced.add(member_id)
        g.fence_count += 1
        self._rebalance(g)
        return True

    def _reap_locked(self, g: _Group) -> list[str]:
        """Fence every member whose lease has expired. Called from the
        group-MUTATING entry points (join/heartbeat/commit/fence) — read
        paths (group_state/membership) stay pure so a supervisor can
        OBSERVE an expired lease before anything acts on it (the
        ``lease_expired_pre_fence`` window). Caller holds the lock."""
        if self._session_timeout_s is None or not g.leases:
            return []
        now = self._clock()
        expired = [m for m, deadline in g.leases.items() if deadline <= now]
        for m in expired:
            self._fence_locked(g, m)
        return expired

    def join(
        self,
        group_id: str,
        member_id: str,
        topics: frozenset[str],
        pattern: str | None = None,
    ) -> int:
        """Add a member and rebalance; returns the new generation.

        ``pattern``: a regex subscribing the member to every topic whose
        name matches — unanchored ``re.match`` (prefix) semantics, the
        same matching kafka-python's ``subscribe(pattern=...)`` applies;
        anchor with ``$`` for exact names. Includes topics created LATER
        (create_topic triggers the rebalance, Kafka's metadata-refresh
        behavior)."""
        with self._lock:
            g = self._group(group_id)
            self._reap_locked(g)
            self._wal_append("group", {
                "op": "join", "group": group_id, "member": member_id,
                "topics": sorted(topics), "pattern": pattern,
            })
            g.members[member_id] = (
                re.compile(pattern) if pattern is not None else topics
            )
            # A re-join after fencing is a FRESH membership (Kafka's
            # rejoin-with-new-epoch): the fenced mark clears, the old
            # generation stays dead.
            g.fenced.discard(member_id)
            if self._session_timeout_s is not None:
                g.leases[member_id] = self._clock() + self._session_timeout_s
            self._rebalance(g)
            return g.generation

    def _member_topics(self, sub) -> set[str]:
        if isinstance(sub, re.Pattern):
            return {t for t in self._topics if sub.match(t)}
        return set(sub)

    def leave(self, group_id: str, member_id: str) -> None:
        with self._lock:
            g = self._group(group_id)
            if member_id in g.members:
                self._wal_append("group", {
                    "op": "leave", "group": group_id, "member": member_id,
                })
                del g.members[member_id]
                g.leases.pop(member_id, None)
                self._rebalance(g)

    def heartbeat(
        self, group_id: str, member_id: str, generation: int | None = None,
    ) -> int:
        """Renew ``member_id``'s lease; returns the CURRENT group
        generation so the caller can cheaply detect a rebalance. Any
        member's heartbeat also reaps peers with expired leases — the
        self-healing sweep that hands a SIGKILLed member's partitions to
        survivors without waiting for a supervisor. Raises
        ``FencedMemberError`` if the member itself was fenced (or never
        joined): the zombie learns it is dead instead of serving into the
        void. ``generation`` is advisory (diagnostics); lease renewal is
        keyed on identity, not generation — a member mid-rebalance-sync
        is alive, just behind."""
        with self._lock:
            g = self._group(group_id)
            self._reap_locked(g)
            if member_id not in g.members:
                raise FencedMemberError(
                    f"member {member_id!r} is not in group {group_id!r} "
                    "(lease expired or fenced); re-join to resume"
                )
            if self._session_timeout_s is not None:
                g.leases[member_id] = self._clock() + self._session_timeout_s
            return g.generation

    def fence(self, group_id: str, member_id: str) -> bool:
        """Explicitly evict a member (the supervisor's response to an
        observed lease expiry): rebalance hands its partitions to
        survivors, and its stale-generation commits are rejected from
        here on. Idempotent — fencing an already-gone member returns
        False. Also reaps any other expired leases while it is here."""
        with self._lock:
            g = self._group(group_id)
            fenced = self._fence_locked(g, member_id)
            self._reap_locked(g)
            return fenced

    def membership(self, group_id: str) -> dict:
        """Read-only membership snapshot for supervisors/observability:
        generation, member ids, per-member lease seconds REMAINING
        (negative = expired but not yet reaped; None when leases are
        off), and the cumulative fence count. Deliberately performs no
        reaping — observing an expired lease must not race the observer's
        own response to it."""
        with self._lock:
            g = self._group(group_id)
            now = self._clock()
            return {
                "generation": g.generation,
                "members": sorted(g.members),
                "leases": {
                    m: (
                        g.leases[m] - now if m in g.leases else None
                    )
                    for m in g.members
                },
                "session_timeout_s": self._session_timeout_s,
                "fenced": sorted(g.fenced),
                "fence_count": g.fence_count,
            }

    def _rebalance(self, g: _Group) -> None:
        """Range-assign every subscribed partition across members, bump generation.

        Deterministic: members sorted by id, partitions sorted by
        (topic, partition). A member that held partitions before the
        rebalance may lose them — its in-flight commit then fails with
        CommitFailedError, which is the re-delivery trigger."""
        g.generation += 1
        g.assignment = {m: [] for m in g.members}
        members = sorted(g.members)
        if not members:
            return
        resolved = {m: self._member_topics(g.members[m]) for m in members}
        topics = sorted({t for ts in resolved.values() for t in ts})
        all_tps = [
            TopicPartition(t, p)
            for t in topics
            for p in range(self._topics.get(t, 0))
        ]
        # Only members subscribed to a topic are eligible for its partitions.
        for t in topics:
            eligible = [m for m in members if t in resolved[m]]
            tps = [tp for tp in all_tps if tp.topic == t]
            for i, tp in enumerate(tps):
                g.assignment[eligible[i % len(eligible)]].append(tp)

    def group_state(self, group_id: str, member_id: str) -> tuple[int, list[TopicPartition]]:
        """Current (generation, assignment) for a member — polled by consumers
        to detect rebalances."""
        with self._lock:
            g = self._group(group_id)
            return g.generation, list(g.assignment.get(member_id, []))

    def commit(
        self,
        group_id: str,
        offsets: Mapping[TopicPartition, int],
        member_id: str | None = None,
        generation: int | None = None,
    ) -> None:
        """Durably record next-read offsets for a group.

        Group-managed members must present the generation they last synced;
        a stale generation or an unowned partition raises CommitFailedError
        (what Kafka raises after a rebalance). Standalone (manually-assigned)
        consumers pass member_id=None and skip the check, matching Kafka's
        ``assign()`` mode."""
        with self._lock:
            g = self._group(group_id)
            self._validate_group_commit_locked(
                g, group_id, offsets, member_id, generation
            )
            self._apply_commit_locked(group_id, offsets, member_id)

    def _validate_group_commit_locked(
        self, g: _Group, group_id: str, offsets, member_id, generation,
    ) -> None:
        """The generation/ownership discipline, shared by plain commits
        and transactional offset commits (validated at buffer time AND
        re-run atomically inside commit_txn). Caller holds the lock."""
        if member_id is None:
            return  # standalone (manual-assignment) mode skips the check
        # Lease discipline first: a member whose own lease lapsed
        # is fenced BY this very commit attempt — the "merely
        # slow" zombie gets a clean CommitFailedError (records
        # re-deliver to whoever owns the partitions now), never a
        # merged watermark.
        self._reap_locked(g)
        if member_id not in g.members:
            raise CommitFailedError(
                f"member {member_id!r} fenced/evicted from group "
                f"{group_id!r} (lease expired or rebalanced away); "
                "offsets not committed"
            )
        if generation != g.generation:
            raise CommitFailedError(
                f"generation {generation} != current {g.generation} "
                f"(group rebalanced); offsets not committed"
            )
        owned = set(g.assignment.get(member_id, []))
        stray = set(offsets) - owned
        if stray:
            raise CommitFailedError(f"partitions not owned: {sorted(stray)}")

    def _apply_commit_locked(
        self, group_id: str, offsets, member_id, log: bool = True,
    ) -> None:
        """``log=False``: the caller (``commit_txn``) already made the
        durability decision with its transaction marker — the offsets
        ride THAT frame, not a second one."""
        if log:
            self._wal_append("commit", {
                "group": group_id, "offsets": dict(offsets),
                "member": member_id,
            })
        self._group(group_id).committed.update(offsets)
        if self._commit_log_path:
            entry = {
                "group": group_id,
                "member": member_id,
                "offsets": {f"{tp.topic}:{tp.partition}": o for tp, o in offsets.items()},
                "ts": time.time(),
            }
            with open(self._commit_log_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry) + "\n")

    def committed(self, group_id: str, tp: TopicPartition) -> int | None:
        with self._lock:
            return self._group(group_id).committed.get(tp)

    # ------------------------------------------------------------- waiting

    def wait_for_data(self, timeout_s: float) -> None:
        """Block until any produce happens (or timeout). Used by polling
        consumers so empty polls don't spin."""
        with self._data_arrived:
            self._data_arrived.wait(timeout=timeout_s)


class MemoryConsumer(ConsumerIterMixin):
    """Consumer over an InMemoryBroker implementing the Consumer protocol.

    Two assignment modes, matching kafka-python's subscribe()/assign() split:

    - ``group-managed`` (default): join the group, receive a range assignment,
      commits are generation-checked. This is what the reference's per-worker
      consumers do (the reference's src/kafka_dataset.py:208-233).
    - ``manual``: pass ``assignment=[...]``; no group membership, commits are
      unchecked. This is the mesh-aligned mode used on TPU pods, where
      partition → jax.process_index() mapping is static (SURVEY.md §2 TPU
      equivalents table).

    Group mode also accepts ``pattern=`` (a regex; unanchored ``re.match``
    prefix semantics like kafka-python's ``subscribe(pattern=...)`` — add
    ``$`` for exact names) instead of explicit topics. The subscription
    covers matching topics created LATER too, via rebalance.

    Never auto-commits, by construction: there is no code path that commits
    except the explicit ``commit()`` — the invariant the reference enforces by
    forcing ``enable_auto_commit=False`` (the reference's src/kafka_dataset.py:201).
    """

    def __init__(
        self,
        broker: InMemoryBroker,
        topics: str | Sequence[str] | None = None,
        group_id: str | None = None,
        *,
        pattern: str | None = None,
        assignment: Sequence[TopicPartition] | None = None,
        auto_offset_reset: str = "earliest",
        member_id: str | None = None,
        consumer_timeout_ms: int | None = None,
        rebalance_listener: Any | None = None,
        isolation_level: str = "read_uncommitted",
    ) -> None:
        if auto_offset_reset not in ("earliest", "latest"):
            raise ValueError(f"auto_offset_reset must be earliest|latest, got {auto_offset_reset!r}")
        if isolation_level not in ("read_uncommitted", "read_committed"):
            raise ValueError(
                "isolation_level must be read_uncommitted|read_committed, "
                f"got {isolation_level!r}"
            )
        if group_id is None:
            # Loud, not a shared "" group: omitting group_id would silently
            # make unrelated consumers rebalance each other and share a
            # committed-offset namespace.
            raise ValueError("group_id is required (commits are per-group)")
        if pattern is not None and (topics is not None or assignment is not None):
            raise ValueError("pattern is exclusive with topics/assignment")
        if pattern is None and topics is None and assignment is None:
            raise ValueError("one of topics, pattern, or assignment is required")
        if rebalance_listener is not None and assignment is not None:
            # Same contract as the kafka adapter: manual assignment never
            # rebalances, so a listener there would silently never fire.
            raise ValueError(
                "rebalance_listener is group-mode only (manual assignment "
                "never rebalances)"
            )
        self._broker = broker
        if topics is not None:
            self._topics = frozenset([topics] if isinstance(topics, str) else topics)
        elif assignment is not None:
            # Assignment-only construction (the kafka adapter allows it too);
            # the topic set exists for the eager existence check below.
            self._topics = frozenset(tp.topic for tp in assignment)
        else:
            self._topics = frozenset()
        self._group_id = group_id
        self._auto_offset_reset = auto_offset_reset
        # "read_committed": polls go through ``fetch_stable`` — only
        # records whose transactional fate is COMMITTED (or that were
        # never transactional) are delivered, never past the LSO, with
        # aborted records silently skipped. The default preserves the
        # pre-transaction behavior byte-for-byte (plain ``fetch``).
        self._isolation = isolation_level
        self._closed = False
        self._positions: dict[TopicPartition, int] = {}
        self._fetch_rr = 0  # round-robin cursor across assigned partitions
        # kafka-python semantics: iteration (not poll) gives up after this
        # long with no records; None = iterate forever.
        self._consumer_timeout_ms = consumer_timeout_ms
        # Positions of records handed out via the iterator (see
        # ConsumerIterMixin): commit(None) prefers these over poll positions.
        self._last_yielded: dict[TopicPartition, int] = {}
        self._paused: set[TopicPartition] = set()
        # Object with optional on_partitions_revoked / on_partitions_assigned
        # methods (kafka-python's ConsumerRebalanceListener shape).
        self._rebalance_listener = rebalance_listener
        self._pending_initial_assign = rebalance_listener is not None

        # Topics must exist either way; surfaces config errors eagerly.
        for t in self._topics:
            broker.partitions_for(t)

        if assignment is not None:
            self._manual = True
            self._member_id = None
            self._generation: int | None = None
            self._assignment = list(assignment)
        else:
            self._manual = False
            # Zero-padded so that sorted ids (the range assignment's
            # member order) follow creation order whatever the counter
            # reached: "member-10" would sort before "member-9".
            self._member_id = member_id or f"member-{next(_member_counter):08d}"
            self._generation, self._assignment = 0, []
            self._generation = broker.join(
                self._group_id, self._member_id, self._topics, pattern=pattern
            )
            _, self._assignment = broker.group_state(self._group_id, self._member_id)

    # ---------------------------------------------------------------- state

    def _check_open(self) -> None:
        if self._closed:
            raise ConsumerClosedError("consumer is closed")

    def _sync_group(self) -> None:
        """Pick up a new assignment if the group rebalanced.

        Models Kafka's eager rebalance: ALL partitions are revoked and
        re-acquired, so every position re-resolves from the committed offset —
        anything fetched but uncommitted is re-delivered (at-least-once).
        A registered rebalance listener sees revoked(old) then
        assigned(new), in that order — the kafka-python
        ConsumerRebalanceListener contract; the revoked callback runs
        BEFORE local state clears, so it may still read positions (but a
        commit there can already fail generation-checked, exactly as a
        real broker mid-rebalance — re-delivery covers it)."""
        if self._manual:
            return
        gen, assign = self._broker.group_state(self._group_id, self._member_id)
        listener = self._rebalance_listener
        if self._pending_initial_assign:
            # The initial join's assigned callback fires on the first sync
            # AFTER construction (kafka-python's timing) — so a listener
            # holding a reference to this consumer can seek() in the hook.
            self._pending_initial_assign = False
            if listener is not None:
                self._call_listener(
                    listener, "on_partitions_assigned", self._assignment
                )
        if gen != self._generation:
            # Adopt the new generation BEFORE the revoked hook: a listener
            # that calls assignment()/lag()/pause() re-enters _sync_group,
            # and a stale generation there would recurse into the hooks
            # unboundedly. The hook still observes the OLD assignment and
            # positions — they are replaced after it returns.
            old, self._generation = list(self._assignment), gen
            if listener is not None:
                self._call_listener(listener, "on_partitions_revoked", old)
            self._assignment = assign
            self._positions.clear()
            self._last_yielded.clear()
            # Kafka clients rebuild partition state on reassignment: a
            # revoked-then-reacquired partition comes back UNpaused, and a
            # paused flag must never outlive the assignment that set it.
            self._paused.clear()
            if listener is not None:
                self._call_listener(listener, "on_partitions_assigned", assign)

    @staticmethod
    def _call_listener(listener, hook: str, tps) -> None:
        """A raising listener must not wedge the consumer mid-rebalance
        (kafka-python logs and continues the same way)."""
        fn = getattr(listener, hook, None)
        if fn is None:
            return
        try:
            fn(list(tps))
        except Exception:  # noqa: BLE001 - listener errors are not ours
            logging.getLogger(__name__).exception(
                "rebalance listener %s raised", hook
            )

    def _resolve_position(self, tp: TopicPartition) -> int:
        if tp not in self._positions:
            committed = self._broker.committed(self._group_id, tp)
            if committed is not None:
                self._positions[tp] = committed
            elif self._auto_offset_reset == "earliest":
                self._positions[tp] = 0
            else:
                self._positions[tp] = self._broker.end_offset(tp)
        return self._positions[tp]

    # ----------------------------------------------------------------- api

    def poll(self, max_records: int = 500, timeout_ms: int = 0) -> list[Record]:
        self._check_open()
        from torchkafka_tpu_torch.errors import BrokerUnavailableError

        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            self._sync_group()
            out: list[Record] = []
            tps = self._assignment
            if tps:
                # Round-robin across partitions for fairness, like the Kafka
                # fetcher; per-partition order is always preserved.
                start = self._fetch_rr % len(tps)
                order = tps[start:] + tps[:start]
                self._fetch_rr += 1
                budget = max_records
                for tp in order:
                    if budget <= 0:
                        break
                    if tp in self._paused:
                        continue
                    try:
                        pos = self._resolve_position(tp)
                        if self._isolation == "read_committed":
                            # fetch_stable returns the resume position
                            # explicitly: it can advance over SKIPPED
                            # aborted records, which the record list
                            # cannot express.
                            recs, nxt = self._broker.fetch_stable(
                                tp, pos, budget
                            )
                            if nxt != pos:
                                self._positions[tp] = nxt
                            out.extend(recs)
                            budget -= len(recs)
                        else:
                            recs = self._broker.fetch(tp, pos, budget)
                            if recs:
                                self._positions[tp] = recs[-1].offset + 1
                                out.extend(recs)
                                budget -= len(recs)
                    except BrokerUnavailableError:
                        # Poll atomicity under transport faults: positions
                        # have already advanced for the records in ``out``
                        # — raising now would DROP them (the caller never
                        # sees records a retried poll will never re-fetch:
                        # silent per-consumer loss, found by the broker
                        # crash-restart drill). Return the partial poll;
                        # the failed partition's fetch retries next poll
                        # from its unmoved position. An empty partial
                        # carries nothing, so the fault surfaces.
                        if out:
                            return out
                        raise
            if out or timeout_ms <= 0:
                return out
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            self._broker.wait_for_data(min(remaining, 0.05))

    def commit(self, offsets: Mapping[TopicPartition, int] | None = None) -> None:
        self._check_open()
        if offsets is None:
            # Iterator mode: commit what the user was handed; poll mode:
            # commit the poll positions (everything returned by poll), both
            # matching kafka-python's notion of "consumed".
            offsets = dict(self._last_yielded) if self._last_yielded else dict(self._positions)
        if self._manual:
            stray = set(offsets) - set(self._assignment)
            if stray:
                raise NotAssignedError(f"not assigned: {sorted(stray)}")
            self._broker.commit(self._group_id, offsets)
        else:
            self._broker.commit(
                self._group_id, offsets,
                member_id=self._member_id, generation=self._generation,
            )

    def heartbeat(self) -> int | None:
        """Renew this member's broker-side lease; returns the group's
        current generation (None in manual-assignment mode, which has no
        membership to keep alive). Raises ``FencedMemberError`` once the
        broker has evicted this member — the caller must re-join (a fresh
        ``MemoryConsumer``) or exit and be respawned; continuing to serve
        would be zombie work whose commits are all doomed. The process
        fleet's replica loop calls this every ``heartbeat_interval_s``;
        the ``heartbeat_pre_send`` crash point pins the window where a
        replica dies between decode progress and the renewal that would
        have proven it alive."""
        if self._manual:
            return None
        self._check_open()
        from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

        crash_hook("heartbeat_pre_send")
        return self._broker.heartbeat(
            self._group_id, self._member_id, self._generation
        )

    def committed(self, tp: TopicPartition) -> int | None:
        self._check_open()
        return self._broker.committed(self._group_id, tp)

    @property
    def group_id(self) -> str:
        return self._group_id

    @property
    def member_id(self) -> str | None:
        """This member's group identity (None in manual-assignment mode,
        which has no membership). With ``generation`` below, this is the
        group metadata a transactional producer presents so its offset
        commit is fenced exactly like a plain commit would be (Kafka's
        ConsumerGroupMetadata handed to sendOffsetsToTransaction)."""
        return self._member_id

    @property
    def generation(self) -> int | None:
        """The generation this consumer last synced (None in manual
        mode). Callers building a transactional offset commit should
        sync first (``assignment()``) so a rebalance is adopted before
        the commit burns a doomed attempt."""
        return self._generation

    def position(self, tp: TopicPartition) -> int:
        self._check_open()
        return self._resolve_position(tp)

    def seek(self, tp: TopicPartition, offset: int) -> None:
        self._check_open()
        if tp not in set(self._assignment):
            raise NotAssignedError(str(tp))
        self._positions[tp] = offset

    def assignment(self) -> list[TopicPartition]:
        self._check_open()
        self._sync_group()
        return list(self._assignment)

    def offsets_for_times(
        self, times: Mapping[TopicPartition, int]
    ) -> dict[TopicPartition, int | None]:
        """Earliest offset with record timestamp >= the given epoch-ms per
        partition (None if every record is older) — kafka-python's
        ``offsets_for_times`` over the in-memory log. Timestamps are
        produce-assigned and monotone per partition here, so bisect applies."""
        self._check_open()
        out: dict[TopicPartition, int | None] = {}
        for tp, ts in times.items():
            out[tp] = self._broker.offset_for_time(tp, int(ts))
        return out

    def end_offsets(self, tps: Sequence[TopicPartition]) -> dict[TopicPartition, int]:
        self._check_open()
        return {tp: self._broker.end_offset(tp) for tp in tps}

    def lag(self) -> dict[TopicPartition, int]:
        """Per-assigned-partition consumer lag: log end minus position —
        the records fetched-side still ahead of this consumer (the
        operator's 'are we keeping up' number)."""
        self._check_open()
        self._sync_group()
        return {
            tp: max(0, self._broker.end_offset(tp) - self._resolve_position(tp))
            for tp in self._assignment
        }

    def pause(self, *tps: TopicPartition) -> None:
        self._check_open()
        self._sync_group()  # validate against the CURRENT assignment
        stray = set(tps) - set(self._assignment)
        if stray:
            raise NotAssignedError(f"not assigned: {sorted(stray)}")
        self._paused.update(tps)

    def resume(self, *tps: TopicPartition) -> None:
        self._check_open()
        self._sync_group()
        stray = set(tps) - set(self._assignment)
        if stray:  # same contract as the kafka adapter's _check_assigned
            raise NotAssignedError(f"not assigned: {sorted(stray)}")
        self._paused.difference_update(tps)

    def paused(self) -> list[TopicPartition]:
        self._check_open()
        return sorted(self._paused)

    def has_paused(self) -> bool:
        return bool(self._paused)

    def close(self) -> None:
        """Release assignment. Never commits (the reference's
        close(autocommit=False), the reference's src/kafka_dataset.py:89)."""
        if self._closed:
            return
        self._closed = True
        if not self._manual:
            self._broker.leave(self._group_id, self._member_id)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter teardown
            pass
