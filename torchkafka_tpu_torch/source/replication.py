"""WAL-frame replication: the leader's ship path and the follower's
apply path of a broker cell.

The write-ahead log made the broker crash-SAFE — every acked mutation is a CRC-framed
WAL event replayed at construction — but a single process still rode
every outage (scenario 19's 2.5 s) and a lost disk lost everything. The
observation this module builds on is that the WAL frames are ALREADY a
replication stream: the broker funnels every acknowledged state change
through one chokepoint (``InMemoryBroker._wal_append``), each event is a
self-contained ``(kind, dict)`` pair, and replaying a prefix of them
reconstructs a broker. So replication is: after the leader's local
append, ship the same frame over the existing netbroker wire to N
followers, each of which appends it to its OWN write-ahead log (same
fsync discipline, same torn-tail repair), and ack the mutation only once
a MAJORITY of replicas hold it — ``wal_durability="quorum"``. Promotion
is then exactly WAL recovery pointed at a follower's directory.

Fencing. Every shipped frame carries the cell EPOCH. An election (see
source/cluster.py) bumps the epoch and stamps it on every reachable
follower before the winner promotes, so a deposed leader's late ships
meet ``StaleEpochError`` from the survivors, fail their quorum, and are
NEVER applied — the cell-level twin of the producer-epoch fence that
already rejects a zombie replica's transaction commits.

Ordering. Frames are shipped under the broker's own lock in append
order, and a follower only appends the frame whose sequence number
matches its applied count — a follower's WAL is always a strict PREFIX
of the leader's frame log. A follower that missed frames (transport
fault mid-ship) reports its applied count back and the leader re-ships
the gap from its in-memory frame log on the next append; election picks
the longest prefix, so majority-acked frames can never be lost (they are
on ≥ quorum replicas, and the winner holds at least every frame any
quorum holds... the SUPERVISED-cell argument: one BrokerCell orchestrates
membership, so two concurrent elections cannot split the brain).

Crash points: ``repl_frame_pre_ship`` (leader WAL has the frame, no
follower does — unacked, must never surface as a committed duplicate),
``repl_frame_post_majority_pre_ack`` (majority holds it, client never saw
the ack — durable cell-wide, the retry is answered idempotently).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from torchkafka_tpu_torch.errors import (
    BrokerUnavailableError,
    QuorumLostError,
    StaleEpochError,
)
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source import wal as _wal


@dataclass
class ReplicationConfig:
    """Cell-wide replication knobs.

    ``replicas`` counts EVERY member, leader included: a cell of 3 is one
    leader plus two followers and commits on 2 acks. ``durability`` is
    the PER-REPLICA local fsync discipline (the ``wal.DURABILITIES``
    values) — quorum mode changes what an ACK means, not how each
    replica syncs its own disk. ``lease_timeout_s`` is the leader lease
    the followers' heartbeats renew; letting it lapse is what triggers an
    epoch-bumped election. ``rpc_timeout_s`` bounds every replication
    RPC so a hung follower reads as unreachable, not as a stalled cell."""

    replicas: int = 3
    durability: str | None = "batch"
    segment_bytes: int = 4 * 1024 * 1024
    lease_timeout_s: float = 2.0
    heartbeat_interval_s: float = 0.2
    rpc_timeout_s: float = 5.0

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.durability not in _wal.DURABILITIES:
            raise ValueError(
                f"durability must be one of {_wal.DURABILITIES}, got "
                f"{self.durability!r}"
            )
        if self.lease_timeout_s <= 0:
            raise ValueError(
                f"lease_timeout_s must be > 0, got {self.lease_timeout_s}"
            )

    @property
    def quorum(self) -> int:
        return self.replicas // 2 + 1


class FollowerReplica:
    """The apply side: owns one WAL directory and appends the frames the
    leader ships. Served over the netbroker wire (``BrokerServer`` wraps
    this object directly; ``repl_append``/``repl_status`` are on the
    server's method allowlist), so replication rides the same
    length-prefixed frames, the same marshalled-exception discipline, and
    the same ``WireFaults`` chaos coverage as every client RPC.

    Construction REPAIRS: the directory's torn tail (a death mid-append,
    or a leader that died mid-ship leaving a half-written frame) is
    truncated away exactly as broker recovery would, so ``applied`` and
    the on-disk log agree before any new frame lands."""

    def __init__(
        self,
        wal_dir: str | os.PathLike,
        *,
        durability: str | None = "batch",
        segment_bytes: int = 4 * 1024 * 1024,
        metrics=None,
    ) -> None:
        self.wal_dir = os.fspath(wal_dir)
        events, truncated = _wal.replay(self.wal_dir, repair=True)
        self.applied = len(events)
        self.truncated_bytes = truncated
        self.epoch = 0
        self._metrics = metrics
        self._lock = threading.Lock()
        self._closed = False
        self._wal = _wal.WriteAheadLog(
            self.wal_dir, durability=durability, segment_bytes=segment_bytes
        )

    # -------------------------------------------------- wire-facing RPCs

    def repl_append(self, epoch: int, base: int, frames) -> int:
        """Append ``frames`` (leader frame-log slice starting at sequence
        ``base``) and return this replica's applied count — the leader's
        ack AND its catch-up cursor. Stale epochs are REJECTED before any
        frame is touched; already-held frames are skipped idempotently; a
        gap (``base`` beyond ``applied``) appends nothing, and the
        returned count tells the leader where to re-ship from."""
        with self._lock:
            if self._closed:
                raise BrokerUnavailableError("follower replica is closed")
            if epoch < self.epoch:
                if self._metrics is not None:
                    self._metrics.repl_stale_rejections.add(1)
                raise StaleEpochError(
                    f"replicated frame carries epoch {epoch} but this "
                    f"replica already accepted epoch {self.epoch}: the "
                    f"sender is a deposed leader"
                )
            self.epoch = max(self.epoch, epoch)
            for i, (kind, event) in enumerate(frames):
                seq = base + i
                if seq < self.applied:
                    continue  # duplicate re-ship: already durable here
                if seq > self.applied:
                    break  # gap: report position, leader re-ships
                self._wal.append(kind, event)
                self.applied += 1
                if self._metrics is not None:
                    self._metrics.repl_frames_applied.add(1)
            return self.applied

    def repl_status(self, epoch: int | None = None) -> dict:
        """Position probe; with ``epoch`` set, also ADOPTS it (the
        election stamps the bumped epoch on every reachable follower
        here, which is the instant the old leader becomes fenceable)."""
        with self._lock:
            if self._closed:
                raise BrokerUnavailableError("follower replica is closed")
            if epoch is not None and epoch > self.epoch:
                self.epoch = epoch
            return {
                "applied": self.applied,
                "epoch": self.epoch,
                "wal_bytes": self._wal.total_bytes(),
            }

    # ----------------------------------------------------------- local

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wal.close()


class _FollowerLink:
    """Leader-side view of one follower: its RPC client plus the acked
    cursor (how much of the frame log the leader knows it holds)."""

    __slots__ = ("idx", "client", "acked")

    def __init__(self, idx: int, client, acked: int = 0):
        self.idx = idx
        self.client = client
        self.acked = acked


class Replicator:
    """The ship side, attached to the leader broker as
    ``broker.replicator``: ``_wal_append`` calls :meth:`ship` after the
    leader-local append, and the mutation is acknowledged only if
    :meth:`ship` returns — i.e. only once ``quorum`` replicas (leader
    included) hold the frame. Raising here aborts the in-memory apply,
    so a quorum-less leader can never diverge its served state from what
    the cell can durably prove."""

    def __init__(
        self,
        *,
        epoch: int,
        quorum: int,
        log: list | None = None,
        metrics=None,
    ) -> None:
        self.epoch = epoch
        self.quorum = quorum
        self.log: list[tuple[str, dict]] = list(log) if log else []
        self.deposed = False
        self._metrics = metrics
        self._followers: list[_FollowerLink] = []

    def add_follower(self, idx: int, client, *, acked: int = 0) -> None:
        self._followers.append(_FollowerLink(idx, client, acked))

    @property
    def follower_count(self) -> int:
        return len(self._followers)

    def _ship_to(self, link: _FollowerLink, target: int) -> bool:
        """Push frames ``[link.acked, target)`` to one follower; True iff
        it holds the full prefix afterwards. Transport faults read as
        no-ack (the quorum decides); a stale-epoch rejection marks this
        leader deposed — its ack can never count again."""
        try:
            ret = link.client.repl_append(
                self.epoch, link.acked, self.log[link.acked : target]
            )
        except StaleEpochError:
            self.deposed = True
            if self._metrics is not None:
                self._metrics.repl_stale_rejections.add(1)
            return False
        except (BrokerUnavailableError, ConnectionError, OSError):
            return False
        link.acked = ret
        return ret >= target

    def ship(self, kind: str, event: dict) -> None:
        """Replicate one frame; returns only on majority. Called under
        the broker lock right after the leader-local WAL append, so the
        frame log and every follower WAL share one total order."""
        crash_hook("repl_frame_pre_ship")
        if self.deposed:
            raise QuorumLostError(
                f"leader at epoch {self.epoch} was deposed: a newer epoch "
                f"fenced its replication stream"
            )
        self.log.append((kind, event))
        target = len(self.log)
        if self._metrics is not None:
            self._metrics.repl_frames_shipped.add(1)
        acks = 1  # the leader's own WAL append already happened
        for link in self._followers:
            if self._ship_to(link, target):
                acks += 1
        if acks < self.quorum:
            raise QuorumLostError(
                f"frame {target - 1} reached {acks}/{self.quorum} replicas "
                f"(epoch {self.epoch}): mutation not acknowledged"
            )
        if self._metrics is not None:
            self._metrics.repl_quorum_commits.add(1)
        crash_hook("repl_frame_post_majority_pre_ack")

    def sync(self) -> dict[int, int]:
        """Best-effort catch-up: push the full frame-log tail to every
        follower (promotion uses this so the survivors converge on the
        new leader's prefix before fresh traffic lands). Returns
        idx -> applied for the followers that answered."""
        out: dict[int, int] = {}
        target = len(self.log)
        for link in self._followers:
            if self._ship_to(link, target):
                out[link.idx] = link.acked
        return out

    def close(self) -> None:
        for link in self._followers:
            try:
                link.client.close()
            except OSError:
                pass
