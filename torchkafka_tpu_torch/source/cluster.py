"""BrokerCell: one leader + N followers, leases, elections, promotion.

source/replication.py provides the two halves of the data plane — the
leader's quorum ship and the follower's prefix apply. This module is the
CONTROL plane that composes them into a highly-available broker cell:

- **Topology.** One ``InMemoryBroker`` (the leader) serves clients on
  the cell's single ADVERTISED host:port; each follower is a
  ``FollowerReplica`` behind its own ``BrokerServer``, and the leader
  ships every acked WAL frame to them over real sockets. Workers never
  learn follower addresses — the advertised port is the cell.

- **Lease.** Followers heartbeat the leader (``repl_ping`` over the
  wire); every answered beat renews the leader lease. A leader that
  stops answering lets the lease lapse — the same expiry discipline the
  group-membership leases already use for replicas, applied one level
  up.

- **Election.** An expired lease bumps the cell EPOCH and stamps it on
  every reachable follower (``repl_status(epoch)``), which is the
  instant the old leader becomes a zombie: its late ships now meet
  ``StaleEpochError`` and fail their quorum, exactly like a fenced
  replica's commits. The follower holding the LONGEST applied prefix
  wins — majority-acked frames live on ≥ quorum replicas, so the winner
  holds every frame any client was ever acked.

- **Promotion.** The winner replays its WAL through the PR-11 recovery
  path verbatim (``InMemoryBroker(wal_dir=...)``: dangling transactions
  aborted, LSO recomputed, counters advanced) and takes over the
  advertised port with the same close-then-rebind discipline
  ``ProcessFleet.restart_broker`` proved. Clients ride the gap through
  ``RetryPolicy``/``BrokerUnavailableError`` and reconnect unfenced —
  same port, same group state, zero committed-record loss.

``kill_leader()`` is the built-in failover drill: drop the leader the
way SIGKILL would (server gone mid-conversation, WAL abandoned unsynced
— its unbuffered writes are already kernel-side, the honest crash
analog), run the election, and return forensics the way
``ProcessFleet.kill_replica`` does.
"""

from __future__ import annotations

import os
import time

from torchkafka_tpu_torch.errors import BrokerUnavailableError, QuorumLostError
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source import wal as _wal
from torchkafka_tpu_torch.source.memory import InMemoryBroker
from torchkafka_tpu_torch.source.netbroker import BrokerClient, BrokerServer
from torchkafka_tpu_torch.source.replication import (
    FollowerReplica,
    ReplicationConfig,
    Replicator,
)


class _Member:
    """One follower slot: the replica, its server, and the leader's
    client link to it."""

    __slots__ = ("idx", "wal_dir", "replica", "server", "client")

    def __init__(self, idx, wal_dir, replica, server, client):
        self.idx = idx
        self.wal_dir = wal_dir
        self.replica = replica
        self.server = server
        self.client = client


class BrokerCell:
    """A replicated broker: construct with ``replicas=N`` and use
    ``cell.broker`` / the advertised ``cell.host``/``cell.port`` exactly
    like a single ``InMemoryBroker`` + ``BrokerServer`` pair. Mutations
    ack on majority (``wal_durability="quorum"``); ``kill_leader()``
    fails over with zero committed-record loss."""

    def __init__(
        self,
        workdir: str | os.PathLike,
        *,
        replicas: int | None = None,
        config: ReplicationConfig | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        session_timeout_s: float | None = None,
        clock=None,
    ) -> None:
        if config is None:
            config = ReplicationConfig(
                replicas=replicas if replicas is not None else 3
            )
        elif replicas is not None and replicas != config.replicas:
            raise ValueError(
                f"replicas={replicas} contradicts config.replicas="
                f"{config.replicas}"
            )
        self.config = config
        self.workdir = os.fspath(workdir)
        self.session_timeout_s = session_timeout_s
        self._clock = clock if clock is not None else time.monotonic
        self._dead: set[int] = set()
        self.leader_idx = 0
        self.epoch = 1
        self.elections = 0
        os.makedirs(self.workdir, exist_ok=True)
        # Followers first: the leader's replicator needs their addresses.
        self._followers: dict[int, _Member] = {}
        for i in range(1, config.replicas):
            self._followers[i] = self._open_follower(i)
        self.broker = self._open_leader(0)
        self.server = BrokerServer(self.broker, host=host, port=port)
        self.host, self.port = self.server.host, self.server.port
        self._lease_deadline = self._clock() + config.lease_timeout_s
        self._last_beat = float("-inf")

    # ------------------------------------------------------------ build

    def member_dir(self, idx: int) -> str:
        return os.path.join(self.workdir, f"member-{idx:02d}")

    def _open_follower(self, idx: int) -> _Member:
        wal_dir = self.member_dir(idx)
        replica = FollowerReplica(
            wal_dir,
            durability=self.config.durability,
            segment_bytes=self.config.segment_bytes,
        )
        server = BrokerServer(replica)
        client = BrokerClient(
            server.host, server.port, timeout_s=self.config.rpc_timeout_s
        )
        return _Member(idx, wal_dir, replica, server, client)

    def _open_leader(self, idx: int) -> InMemoryBroker:
        """Recover a broker from ``member_dir(idx)`` (PR-11 replay:
        dangling txns aborted, LSO recomputed) and attach the quorum
        replicator, seeded with the replayed frame log so follower
        cursors and catch-up re-ships index into the same history the
        recovery appends (its abort markers included) just wrote."""
        broker = InMemoryBroker(
            session_timeout_s=self.session_timeout_s,
            clock=self._clock if self.session_timeout_s is not None else None,
            wal_dir=self.member_dir(idx),
            wal_durability="quorum",
            wal_segment_bytes=self.config.segment_bytes,
        )
        events, _ = _wal.replay(self.member_dir(idx), repair=False)
        rep = Replicator(
            epoch=self.epoch,
            quorum=self.config.quorum,
            log=list(events),
            metrics=broker.metrics,
        )
        for m in self._followers.values():
            try:
                st = m.client.repl_status(self.epoch)
                acked = st["applied"]
            except (BrokerUnavailableError, ConnectionError, OSError):
                acked = 0
            rep.add_follower(m.idx, m.client, acked=acked)
        broker.replicator = rep
        rep.sync()
        return broker

    # ------------------------------------------------------- lease loop

    def heartbeat(self) -> bool:
        """One round of follower→leader heartbeats: each live follower
        pings the ADVERTISED port (the wire a client would use — a
        leader that answers here is a leader clients can reach); any
        answer renews the lease. Returns True iff the lease is live."""
        now = self._clock()
        try:
            with BrokerClient(
                self.host, self.port, timeout_s=self.config.rpc_timeout_s
            ) as cli:
                cli.repl_ping()
            answered = True
        except (BrokerUnavailableError, ConnectionError, OSError):
            answered = False
        if answered:
            self._lease_deadline = now + self.config.lease_timeout_s
        return now <= self._lease_deadline

    def poll(self) -> dict | None:
        """Supervisor tick: heartbeat on the configured cadence; if the
        leader lease has lapsed, run the election and return its
        forensics (None on a quiet tick)."""
        now = self._clock()
        if now - self._last_beat < self.config.heartbeat_interval_s:
            return None
        self._last_beat = now
        if self.heartbeat():
            return None
        return self._elect()

    # --------------------------------------------------------- failover

    def kill_leader(self) -> dict:
        """Failover drill: drop the leader exactly as SIGKILL would —
        its server vanishes mid-conversation and its WAL is abandoned
        without a clean close (the unbuffered frame writes are already
        in the kernel, which is precisely what process death preserves)
        — then run the epoch-bumped election. Returns forensics."""
        t0 = time.perf_counter()
        victim = self.leader_idx
        old_epoch = self.epoch
        self.server.close()
        self._dead.add(victim)
        deposed = self.broker.replicator
        if deposed is not None:
            deposed.deposed = True  # a real corpse cannot ship either
        self.broker.replicator = None
        fx = self._elect()
        fx.update(
            victim_idx=victim,
            old_epoch=old_epoch,
            victim_wal_dir=self.member_dir(victim),
            failover_ms=(time.perf_counter() - t0) * 1e3,
        )
        return fx

    def _elect(self) -> dict:
        """Epoch-bumped election + promotion. Stamping the bumped epoch
        on every reachable follower FENCES the old leader before the
        winner serves a single request; the longest applied prefix wins
        so no majority-acked frame can be on the losing side."""
        t0 = time.perf_counter()
        new_epoch = self.epoch + 1
        candidates: dict[int, int] = {}
        for m in self._followers.values():
            try:
                st = m.client.repl_status(new_epoch)
            except (BrokerUnavailableError, ConnectionError, OSError):
                continue
            candidates[m.idx] = st["applied"]
        # The respondents (winner included — it is one of them) must form
        # a majority of the FULL membership, or the cell stays leaderless
        # (retryable — a rejoining replica can complete a later round).
        if len(candidates) < self.config.quorum:
            raise QuorumLostError(
                f"election for epoch {new_epoch} reached only "
                f"{len(candidates)} of {self.config.replicas - 1} followers"
                f" (need {self.config.quorum} voters)"
            )
        # Longest applied prefix wins; ties break to the lowest index so
        # the outcome is deterministic under replay.
        winner_idx = min(
            candidates, key=lambda i: (-candidates[i], i)
        )
        crash_hook("election_pre_promote")
        winner = self._followers.pop(winner_idx)
        winner.client.close()
        winner.server.close()
        winner.replica.close()
        self.epoch = new_epoch
        self.leader_idx = winner_idx
        self.elections += 1
        # Same-port takeover, the restart_broker discipline: close(d)
        # listener above, rebind the advertised address around the
        # recovered broker — clients reconnect, unfenced, to the same
        # group state.
        self.broker = self._open_leader(winner_idx)
        self.server = BrokerServer(self.broker, host=self.host, port=self.port)
        self.broker.metrics.elections.add(1)
        self._lease_deadline = self._clock() + self.config.lease_timeout_s
        return {
            "winner_idx": winner_idx,
            "epoch": new_epoch,
            "candidates": candidates,
            "recovery": dict(self.broker.recovery_info or {}),
            "election_ms": (time.perf_counter() - t0) * 1e3,
        }

    # ------------------------------------------------------------ drill

    def forge_deposed_frame(self) -> None:
        """Replay the deposed leader's move: ship a frame carrying the
        PREVIOUS epoch straight at a live follower. The follower must
        raise ``StaleEpochError`` — the append is rejected, never
        applied. (With no live follower, the zombie cannot even reach a
        quorum of one — raise QuorumLostError for symmetry.)"""
        stale_epoch = self.epoch - 1
        for m in self._followers.values():
            st = m.client.repl_status()
            m.client.repl_append(
                stale_epoch, st["applied"], [("produce", {"forged": True})]
            )
            return
        raise QuorumLostError("no live follower to forge at")

    # ---------------------------------------------------------- queries

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    @property
    def quorum(self) -> int:
        return self.config.quorum

    def status(self) -> dict:
        out = {
            "leader_idx": self.leader_idx,
            "epoch": self.epoch,
            "elections": self.elections,
            "quorum": self.config.quorum,
            "replicas": self.config.replicas,
            "dead": sorted(self._dead),
            "frames": len(self.broker.replicator.log)
            if self.broker.replicator is not None else 0,
            "followers": {},
        }
        for m in self._followers.values():
            try:
                out["followers"][m.idx] = m.client.repl_status()
            except (BrokerUnavailableError, ConnectionError, OSError):
                out["followers"][m.idx] = None
        return out

    def client(self, **kw) -> BrokerClient:
        return BrokerClient(self.host, self.port, **kw)

    def close(self) -> None:
        self.server.close()
        self.broker.close()
        for m in self._followers.values():
            try:
                m.client.close()
            except OSError:
                pass
            m.server.close()
            m.replica.close()
        self._followers.clear()

    def __enter__(self) -> "BrokerCell":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
