"""Segmented, CRC-framed write-ahead log: broker durability.

Every other process in the tree is already a crash-recoverable
participant — workers SIGKILL mid-decode and resume warm from journals,
transactions abort on epoch fences — but the broker those guarantees
route through was fully volatile: kill the supervisor's
``InMemoryBroker`` and every topic, offset watermark, membership
generation, and open transaction vanished, voiding the exactly-once
contract FAILOVER_BENCH just asserted. This module is the durability
substrate that closes that hole: an append-only event log the broker
writes BEFORE acknowledging state changes and replays at construction
(Kafka's own story — the log IS the broker; KIP-98 commit/abort markers
live in the same log as the records they settle).

Format. A log is a directory of segments ``wal-<n>.log``; each segment
is a sequence of frames::

    [u32 length][u32 crc32(payload)][payload]

with the payload a pickled ``(kind, dict)`` event (trusted local file —
the same payload discipline as the netbroker's trusted socket). A torn
tail — a frame whose length header, body, or CRC is incomplete because
the writer died mid-append — is DETECTED (short read or CRC mismatch)
and TRUNCATED at recovery: the log's authoritative content is the
longest clean frame prefix, and a torn frame is never replayed (its
write was never acknowledged, so dropping it loses nothing that was
promised). Segments roll at ``segment_bytes`` so recovery tooling and
retention can reason about bounded files.

Durability discipline (``durability=``):

- ``"commit"`` — fsync after EVERY append: survives machine power loss
  at per-append cost (Kafka's ``flush.messages=1``).
- ``"batch"`` — fsync only on COMMIT-class appends (offset commits,
  transaction commit/abort markers, producer inits): the produces of a
  window ride their window's commit fsync — the classic group-commit
  amortization.
- ``None`` — never fsync. Appends still hit the kernel page cache via
  unbuffered ``write()``, so a SIGKILLed *process* loses nothing — only
  a machine crash can eat the tail. This is the honest floor the WAL-tax
  bench measures against.

Crash points ``wal_append_mid`` (death between the two halves of a
frame's body — the torn-tail generator) and ``wal_pre_fsync`` (frame
written, fsync pending) pin the windows the recovery contract is sworn
against; the broker-side markers (``txn_marker_*``) live in
source/memory.py where the commit decision is made.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from dataclasses import dataclass, field

from torchkafka_tpu_torch.resilience.crashpoint import crash_hook

_HEADER = struct.Struct(">II")  # (payload length, crc32(payload))

#: Appends of these kinds are the durability points ``durability="batch"``
#: fsyncs on — everything appended since the last one rides the same sync.
COMMIT_KINDS = frozenset({"commit", "txn_commit", "txn_abort", "init_pid"})

DURABILITIES = (None, "batch", "commit")


@dataclass
class WalStats:
    appends: int = 0
    bytes_written: int = 0
    fsyncs: int = 0
    truncated_bytes: int = 0  # torn tail repaired away at recovery
    segments: int = 0
    replayed_events: int = 0


@dataclass
class _Segment:
    path: str
    index: int
    size: int = field(default=0)


def _segment_name(index: int) -> str:
    return f"wal-{index:08d}.log"


def _list_segments(wal_dir: str) -> list[_Segment]:
    try:
        names = sorted(os.listdir(wal_dir))
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        if not (name.startswith("wal-") and name.endswith(".log")):
            continue
        try:
            idx = int(name[4:-4])
        except ValueError:
            continue
        path = os.path.join(wal_dir, name)
        out.append(_Segment(path, idx, os.path.getsize(path)))
    out.sort(key=lambda s: s.index)
    return out


def _scan_segment(path: str) -> tuple[list[tuple[str, dict]], int]:
    """Parse one segment's clean frame prefix. Returns ``(events,
    clean_bytes)`` where ``clean_bytes`` is the offset of the first torn
    or corrupt frame (== file size when the segment is wholly clean).
    Never raises on damage — the clean prefix is the answer."""
    events: list[tuple[str, dict]] = []
    clean = 0
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    pos = 0
    while pos + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(data, pos)
        body_end = pos + _HEADER.size + length
        if body_end > n:
            break  # torn tail: body incomplete
        payload = data[pos + _HEADER.size : body_end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break  # torn or corrupt frame: never replay past it
        try:
            kind, event = pickle.loads(payload)
        except Exception:  # noqa: BLE001 - CRC passed but payload bad:
            break  # treat as damage, stop at the clean prefix
        events.append((kind, event))
        clean = body_end
        pos = body_end
    return events, clean


def replay(wal_dir: str | os.PathLike, *, repair: bool = True):
    """Read a WAL directory's clean event prefix.

    Returns ``(events, truncated_bytes)``. Damage (a torn tail from a
    death inside ``append``, or external corruption) ends the replay at
    the last clean frame; with ``repair=True`` the damaged segment is
    truncated to its clean prefix and any LATER segments are removed, so
    the on-disk log and the replayed state agree and a subsequent
    recovery is idempotent. A missing directory is an empty log."""
    wal_dir = os.fspath(wal_dir)
    segments = _list_segments(wal_dir)
    events: list[tuple[str, dict]] = []
    truncated = 0
    for i, seg in enumerate(segments):
        seg_events, clean = _scan_segment(seg.path)
        events.extend(seg_events)
        if clean < seg.size:
            truncated = (seg.size - clean) + sum(
                s.size for s in segments[i + 1 :]
            )
            if repair:
                with open(seg.path, "ab") as f:
                    f.truncate(clean)
                for later in segments[i + 1 :]:
                    os.unlink(later.path)
            break
    return events, truncated


class WriteAheadLog:
    """Append side of the log. One writer per directory (the broker holds
    it under its own lock); recovery uses :func:`replay` first, then
    constructs this to continue appending after the clean tail."""

    def __init__(
        self,
        wal_dir: str | os.PathLike,
        *,
        durability: str | None = None,
        segment_bytes: int = 4 * 1024 * 1024,
        metrics=None,
    ) -> None:
        if durability not in DURABILITIES:
            raise ValueError(
                f"durability must be one of {DURABILITIES}, got "
                f"{durability!r}"
            )
        if segment_bytes < 1024:
            raise ValueError(
                f"segment_bytes must be >= 1024, got {segment_bytes}"
            )
        self.wal_dir = os.fspath(wal_dir)
        os.makedirs(self.wal_dir, exist_ok=True)
        self.durability = durability
        self.segment_bytes = segment_bytes
        self.stats = WalStats()
        self._metrics = metrics
        self._closed = False
        segments = _list_segments(self.wal_dir)
        if segments:
            tail = segments[-1]
            self._seg_index = tail.index
            self._seg_size = tail.size
        else:
            self._seg_index = 0
            self._seg_size = 0
        self.stats.segments = max(1, len(segments))
        # Unbuffered: every frame write is a kernel write() — a SIGKILL
        # after append() returns can never lose an acknowledged event,
        # fsync or not (only machine crash reaches the durability knob).
        self._fd = os.open(
            self._seg_path(self._seg_index),
            os.O_CREAT | os.O_WRONLY | os.O_APPEND,
            0o644,
        )

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.wal_dir, _segment_name(index))

    @property
    def closed(self) -> bool:
        return self._closed

    def _roll(self) -> None:
        os.close(self._fd)
        self._seg_index += 1
        self._seg_size = 0
        self.stats.segments += 1
        self._fd = os.open(
            self._seg_path(self._seg_index),
            os.O_CREAT | os.O_WRONLY | os.O_APPEND,
            0o644,
        )

    def append(self, kind: str, event: dict) -> None:
        """Durably append one ``(kind, event)`` frame per the configured
        discipline. The two-part body write around ``wal_append_mid``
        pins the torn-frame window (a death there leaves a frame the
        CRC rejects — recovery truncates, never replays); the
        ``wal_pre_fsync`` window pins an appended-but-unsynced frame."""
        if self._closed:
            raise ValueError("write-ahead log is closed")
        payload = pickle.dumps((kind, event), protocol=pickle.HIGHEST_PROTOCOL)
        frame = _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        if self._seg_size and self._seg_size + len(frame) + len(payload) \
                > self.segment_bytes:
            self._roll()
        half = len(payload) // 2
        os.write(self._fd, frame + payload[:half])
        crash_hook("wal_append_mid")
        os.write(self._fd, payload[half:])
        crash_hook("wal_pre_fsync")
        if self.durability == "commit" or (
            self.durability == "batch" and kind in COMMIT_KINDS
        ):
            os.fsync(self._fd)
            self.stats.fsyncs += 1
            if self._metrics is not None:
                self._metrics.wal_fsyncs.add(1)
        nbytes = len(frame) + len(payload)
        self._seg_size += nbytes
        self.stats.appends += 1
        self.stats.bytes_written += nbytes
        if self._metrics is not None:
            self._metrics.wal_appends.add(1)
            self._metrics.wal_bytes_written.add(nbytes)

    def sync(self) -> None:
        """Unconditional fsync (clean-shutdown path)."""
        if not self._closed:
            os.fsync(self._fd)
            self.stats.fsyncs += 1
            if self._metrics is not None:
                self._metrics.wal_fsyncs.add(1)

    def total_bytes(self) -> int:
        """On-disk size of every segment (the recovery-curve x-axis)."""
        return sum(s.size for s in _list_segments(self.wal_dir))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            os.fsync(self._fd)
        except OSError:
            pass
        os.close(self._fd)
