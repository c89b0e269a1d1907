"""The process-fleet supervisor: real OS-process replicas over the socket
broker, with heartbeat leases, zombie fencing, and warm failover. Port of
``torchkafka_tpu/fleet/supervisor.py``: the workers are the port's
(``python -m torchkafka_tpu_torch.fleet.proc``) and serve on the
fleet's ``device`` (``ProcessFleet(device="cpu")`` for CPU drives; the
default, None, puts every worker on CUDA, and a worker without it dies
with its traceback in its log, which ``diagnose()`` shows).

``ProcessFleet`` is the serving analog of the elastic multi-process
consumer-group tier the ingest path already has (tests/test_pod.py over
``BrokerServer``): it hosts an ``InMemoryBroker`` with a session timeout
behind a ``BrokerServer`` socket, spawns each replica as a REAL process
(``python -m torchkafka_tpu_torch.fleet.proc`` — its own ``BrokerClient``,
its own model and device context, its own on-disk ``DecodeJournal``), and
supervises
liveness through the broker's heartbeat leases:

- a replica that dies (SIGKILL, OOM, crash) stops renewing its lease;
  the supervisor's sweep — or any survivor's heartbeat — FENCES it:
  eviction + rebalance, so its partitions re-deliver to survivors and
  every commit it might still issue carries a dead generation and is
  rejected (the zombie can stall, never corrupt);
- the victim's journal is read FROM DISK across the process boundary
  (survivors rescan the shared journal dir on every rebalance —
  ``DecodeJournal.scan_dir``), so its in-flight prompts resume warm and
  byte-identical instead of re-decoding from token 0;
- ``respawn=True`` keeps the fleet at its target size: a fenced member
  is replaced by a FRESH incarnation (new member id, new journal file)
  that also scans the shared dir at startup — a replacement is a
  survivor too;
- ``scale(n)`` is elastic membership mid-serve: scale-up spawns joiners
  (the rebalance hands them partitions), scale-down SIGTERMs the newest
  incarnations, which drain cooperatively — finish in-flight work,
  commit, leave — so a scale-down loses nothing and (with per-partition
  FIFO admission) replays nothing.

The supervisor is deliberately OUTSIDE the data path: prompts flow
broker → worker → output topic; the supervisor only watches membership,
fences, respawns, and narrates (``FleetMetrics`` counters + optional
``RecordTracer`` membership events: ``replica_joined`` /
``replica_fenced`` / ``journal_handoff``). Everything it knows, it knows
from the broker and the filesystem — exactly what a survivor of ITS
death would know.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from torchkafka_tpu_torch.journal import DecodeJournal
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.records import TopicPartition

_logger = logging.getLogger(__name__)


def sweep_expired(broker, group: str, on_fence=None) -> list[str]:
    """Fence every member of ``group`` whose lease has expired. The
    supervisor's liveness sweep, importable so any process holding a
    broker surface (object or ``BrokerClient``) can run it. Observation
    and action are deliberately split — ``membership`` reaps nothing —
    and the ``lease_expired_pre_fence`` crash point sits exactly in the
    gap: a sweeper that dies there leaves the zombie a member, yet the
    zombie's own next commit still self-fences (commit-time reap), so
    the watermark is safe either way. Returns the fenced member ids."""
    info = broker.membership(group)
    fenced = []
    for member, remaining in info["leases"].items():
        if remaining is not None and remaining <= 0:
            crash_hook("lease_expired_pre_fence")
            broker.fence(group, member)
            fenced.append(member)
            if on_fence is not None:
                on_fence(member, -remaining)
    return fenced


LIVE = "live"
DRAINING = "draining"
ZOMBIE = "zombie"  # fenced by the broker; process may still be running
DEAD = "dead"  # involuntary end (SIGKILL, crash, fenced exit)
DONE = "done"  # voluntary clean exit (drain)


@dataclass
class _Incarnation:
    idx: int
    member: str
    proc: subprocess.Popen | None
    spec_path: str
    journal_path: str
    log_path: str
    metrics_path: str
    role: str = "decode"
    state: str = LIVE
    seen_in_group: bool = False
    exit_code: int | None = None
    fence_reason: str | None = None
    handoff_entries: int = 0

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ProcessFleet:
    """Spawn and supervise R real-process serving replicas.

    ``model``: the JSON-serializable model spec ``fleet.proc.build_model``
    consumes (seed + TransformerConfig fields) — every worker rebuilds
    identical params from it. ``device``: where every worker serves
    ("cpu", "cuda", ...; None = CUDA, raising in the worker without it). ``broker``: pass an existing
    ``InMemoryBroker`` (it must have been built with
    ``session_timeout_s``) or let the fleet build one. Topics must exist
    before ``start()`` unless created here via ``partitions``.
    """

    def __init__(
        self,
        model: dict,
        *,
        topic: str,
        prompt_len: int,
        max_new: int,
        workdir: str | os.PathLike,
        replicas: int = 2,
        out_topic: str = "fleet-out",
        ready_topic: str | None = "fleet-ready",
        group: str = "pfleet",
        partitions: int | None = 4,
        slots: int = 2,
        commit_every: int = 8,
        journal_cadence: int = 4,
        session_timeout_s: float = 2.0,
        heartbeat_interval_s: float = 0.2,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        sampling_seed: int = 0,
        eos_id: int | None = None,
        idle_exit_ms: int | None = None,
        ticks_per_sync: int = 1,
        respawn: bool = True,
        journal: bool = True,
        exactly_once: bool = False,
        prefill_replicas: int = 0,
        handoff_topic: str = "fleet-handoff",
        kv_pages: dict | None = None,
        kv_tier: dict | None = None,
        route_patience: int = 256,
        rollout: bool = False,
        rollout_topic: str = "fleet-rollout",
        ckpt_topic: str = "fleet-ckpt",
        model_version: int = 0,
        distill_replicas: int = 0,
        distill_topic: str = "fleet-distill",
        publish_every: int = 0,
        draft_layers: int | None = None,
        distill_batch: int = 8,
        distill_lr: float = 1e-3,
        distill_seq_len: int | None = None,
        draft_base_version: int = 0,
        wal_dir: str | os.PathLike | None = None,
        wal_durability: str | None = "batch",
        broker_replicas: int = 1,
        resilient: bool = False,
        reconnect_attempts: int = 6,
        reconnect_deadline_s: float = 15.0,
        broker=None,
        metrics=None,
        tracer=None,
        device: str | None = None,
    ) -> None:
        from torchkafka_tpu_torch.fleet.metrics import FleetMetrics
        from torchkafka_tpu_torch.source.memory import InMemoryBroker
        from torchkafka_tpu_torch.source.netbroker import BrokerServer

        self.workdir = os.fspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.journal_dir = os.path.join(self.workdir, "journals")
        os.makedirs(self.journal_dir, exist_ok=True)
        self.group = group
        self.topic = topic
        self.out_topic = out_topic
        self.ready_topic = ready_topic
        self.session_timeout_s = session_timeout_s
        self.respawn = respawn
        self._journal_on = journal
        # Exactly-once output: every worker serves through a
        # TransactionalProducer whose transactional id is keyed by
        # replica INDEX (``_txn_id``), so a respawned replacement's
        # init_producer_id fences its predecessor's epoch — and the
        # supervisor's own fence path aborts a victim's in-flight
        # transaction EAGERLY (``_abort_victim_txn``), so the committed
        # view settles without waiting for a respawn.
        self.exactly_once = exactly_once
        # Broker durability: with ``wal_dir`` set, the hosted broker
        # writes a segmented write-ahead log (source/wal.py) and
        # ``restart_broker`` can crash-and-recover it on the SAME port —
        # workers ride the outage on their reconnect stacks and resume
        # against identical topics/offsets/generations/producer epochs.
        self.wal_dir = None if wal_dir is None else os.fspath(wal_dir)
        self.wal_durability = wal_durability
        # Disaggregated prefill (fleet/prefill.py): ``prefill_replicas``
        # dedicated workers in their own consumer group fill paged KV
        # and publish handoffs on ``handoff_topic``; decode replicas
        # route admission through the handoff shelf (bounded patience →
        # local-prefill fallback). Requires ``kv_pages``.
        self.prefill_replicas = prefill_replicas
        self.handoff_topic = handoff_topic if prefill_replicas else None
        if prefill_replicas and kv_pages is None:
            raise ValueError(
                "prefill_replicas requires kv_pages (the handoff carries "
                "paged KV blocks)"
            )
        # Replicated broker cell: ``broker_replicas >= 2`` hosts the
        # broker as a 1-leader + N-follower quorum cell (source/cluster)
        # instead of a lone InMemoryBroker — every acked mutation is on a
        # majority of WAL replicas, and ``kill_leader()`` fails over to a
        # promoted follower on the SAME advertised port with zero
        # committed-record loss (workers ride it exactly like
        # ``restart_broker``'s outage, reconnect-unfenced).
        self._cell = None
        if broker is None and broker_replicas > 1:
            if self.wal_dir is None:
                raise ValueError(
                    "broker_replicas > 1 requires ProcessFleet(wal_dir=...):"
                    " a quorum cell is made of WAL replicas"
                )
            from torchkafka_tpu_torch.source.cluster import BrokerCell
            from torchkafka_tpu_torch.source.replication import ReplicationConfig
            self._cell = BrokerCell(
                self.wal_dir,
                config=ReplicationConfig(
                    replicas=broker_replicas,
                    durability=(
                        "batch" if wal_durability == "quorum"
                        else wal_durability
                    ),
                    lease_timeout_s=session_timeout_s,
                    heartbeat_interval_s=heartbeat_interval_s,
                ),
                session_timeout_s=session_timeout_s,
            )
            self.broker = self._cell.broker
        else:
            self.broker = broker if broker is not None else InMemoryBroker(
                session_timeout_s=session_timeout_s,
                wal_dir=self.wal_dir, wal_durability=wal_durability,
            )
        # Live model lifecycle (fleet/rollout.py): with ``rollout`` on,
        # workers tail a 1-partition control topic for canary/swap
        # directives and fetch versioned checkpoints from ``ckpt_topic``
        # (CRC'd chunked frames, source/checkpoint_wire.py).
        # ``model_version`` tags the boot weights; every committed output
        # window carries the serving version in its "mv" header.
        self.rollout_topic = rollout_topic if rollout else None
        # Online draft distillation (torchkafka_tpu_torch/distill):
        # ``distill_replicas`` DistillTrainer workers ("d" prefix) in
        # their own consumer group train the layer-truncated draft on the
        # committed-completion corpus decode replicas stage onto
        # ``distill_topic`` inside their commit windows, and publish
        # versioned draft checkpoints onto ``ckpt_topic`` — which is why
        # the checkpoint plane exists for distill fleets even without
        # ``rollout=True``.
        self.distill_replicas = distill_replicas
        self.distill_topic = distill_topic if distill_replicas else None
        self.ckpt_topic = (
            ckpt_topic if (rollout or distill_replicas) else None
        )
        self.model_version = int(model_version)
        self._rollout_driver = None
        for t, p in ((topic, partitions), (out_topic, 1),
                     (ready_topic, 1), (self.handoff_topic, 1),
                     (self.rollout_topic, 1), (self.ckpt_topic, 1),
                     (self.distill_topic, 1)):
            if t is None or p is None:
                continue
            try:
                self.broker.create_topic(t, partitions=p)
            except ValueError:
                pass  # caller already created (and maybe filled) it
        self.server = (
            self._cell.server if self._cell is not None
            else BrokerServer(self.broker)
        )
        self.metrics = metrics if metrics is not None else FleetMetrics()
        self.tracer = tracer
        self._target = replicas
        self._seq = 0
        self._spec_base = {
            "broker": {"host": self.server.host, "port": self.server.port},
            "topic": topic,
            "group": group,
            "out_topic": out_topic,
            "ready_topic": ready_topic,
            "journal_dir": self.journal_dir,
            "journal_cadence": journal_cadence,
            "model": dict(model),
            "prompt_len": prompt_len,
            "max_new": max_new,
            "slots": slots,
            "commit_every": commit_every,
            "ticks_per_sync": ticks_per_sync,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "sampling_seed": sampling_seed,
            "eos_id": eos_id,
            "heartbeat_interval_s": heartbeat_interval_s,
            "idle_exit_ms": idle_exit_ms,
            "exactly_once": exactly_once,
            "resilient": resilient,
            "reconnect_attempts": reconnect_attempts,
            "reconnect_deadline_s": reconnect_deadline_s,
            "kv_pages": kv_pages,
            "kv_tier": kv_tier,
            "handoff_topic": self.handoff_topic,
            "route_patience": route_patience,
            "rollout_topic": self.rollout_topic,
            "ckpt_topic": self.ckpt_topic,
            "model_version": self.model_version,
            "distill_topic": self.distill_topic,
            "publish_every": publish_every,
            "draft_layers": draft_layers,
            "distill_batch": distill_batch,
            "distill_lr": distill_lr,
            "distill_seq_len": distill_seq_len,
            "draft_base_version": draft_base_version,
            "device": device,
        }
        self.incarnations: list[_Incarnation] = []
        self.victims: list[dict] = []  # kill_replica forensics

    # ------------------------------------------------------------ spawning

    def _spawn(self, idx: int, role: str = "decode") -> _Incarnation:
        # Member ids sort by replica INDEX first (r0i* < r1i* < ...), and
        # the broker range-assigns over sorted member ids — so a
        # respawned incarnation slots into its predecessor's position and
        # inherits the same partition range. That bias is what makes the
        # victim's journal (and its radix prefix locality) land where the
        # redelivered prompts do. Prefill ("q") and distill ("d") workers
        # live in their OWN consumer groups, so those prefixes only have
        # to be distinct, not ordered against decode members.
        prefix = {"decode": "r", "prefill": "q", "distill": "d"}[role]
        member = f"{prefix}{idx:03d}i{self._seq:03d}"  # zero-padded
        self._seq += 1                          # order == numeric order
        spec = dict(self._spec_base)
        spec["member_id"] = member
        spec["replica_index"] = idx
        spec["role"] = role
        spec["metrics_path"] = os.path.join(
            self.workdir, f"{member}.metrics.json"
        )
        if not self._journal_on:
            # Journals off (cold-failover baseline for the bench): point
            # each worker at a private throwaway dir so nothing is
            # written where survivors scan.
            spec["journal_dir"] = os.path.join(
                self.workdir, "no-journals", member
            )
        spec_path = os.path.join(self.workdir, f"{member}.spec.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        log_path = os.path.join(self.workdir, f"{member}.log")
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__import__("torchkafka_tpu_torch").__file__)
        ))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        log = open(log_path, "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "torchkafka_tpu_torch.fleet.proc", spec_path],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        log.close()  # the child holds its own fd
        inc = _Incarnation(
            idx=idx, member=member, proc=proc, spec_path=spec_path,
            journal_path=os.path.join(spec["journal_dir"], f"{member}.json"),
            log_path=log_path,
            metrics_path=spec["metrics_path"],
            role=role,
        )
        self.incarnations.append(inc)
        self.metrics.replica_joins.add(1)
        if self.tracer is not None:
            self.tracer.replica_joined(member, replica=idx)
        return inc

    def start(self) -> "ProcessFleet":
        for idx in range(self._target):
            self._spawn(idx)
        for idx in range(self.prefill_replicas):
            self._spawn(idx, role="prefill")
        for idx in range(self.distill_replicas):
            self._spawn(idx, role="distill")
        return self

    def wait_ready(self, timeout_s: float = 120.0) -> None:
        """Block until every live incarnation produced its readiness
        marker (post-warmup) — the paired bench's measured window starts
        here, so per-process warmup never pollutes a slice."""
        if self.ready_topic is None:
            raise ValueError("fleet was built with ready_topic=None")
        deadline = time.monotonic() + timeout_s
        tp = TopicPartition(self.ready_topic, 0)
        while True:
            ready = {
                r.value.decode()
                for r in self.broker.fetch(tp, 0, 100000)
            }
            waiting = [
                inc for inc in self.incarnations
                if inc.state in (LIVE, DRAINING) and inc.member not in ready
            ]
            if not waiting:
                return
            crashed = [inc for inc in waiting if not inc.running]
            if crashed:
                raise RuntimeError(
                    "replica(s) died before ready: "
                    + ", ".join(
                        f"{i.member} rc={i.proc.returncode} "
                        f"(log: {i.log_path})" for i in crashed
                    )
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas not ready after {timeout_s}s: "
                    + ", ".join(i.member for i in waiting)
                )
            time.sleep(0.05)

    # ---------------------------------------------------------- liveness

    def live(self, role: str = "decode") -> list[_Incarnation]:
        return [
            i for i in self.incarnations
            if i.state in (LIVE, DRAINING) and i.role == role
        ]

    def _group_of(self, inc: _Incarnation) -> str:
        return (
            self.group if inc.role == "decode"
            else f"{self.group}-{inc.role}"
        )

    def poll_once(self) -> None:
        """One supervision round: sweep expired leases (fencing) in the
        decode AND prefill groups, update lease-age gauges, reap exited
        children, observe broker-side fencings of still-running
        processes (stalled zombies), trigger journal-handoff accounting,
        and respawn toward the per-role targets."""
        groups = [self.group]
        if self.prefill_replicas:
            groups.append(f"{self.group}-prefill")
        if self.distill_replicas:
            groups.append(f"{self.group}-distill")
        infos: dict[str, dict] = {}
        for group in groups:
            info = self.broker.membership(group)
            timeout = info["session_timeout_s"]
            for member, remaining in info["leases"].items():
                if remaining is not None and timeout is not None:
                    self.metrics.member_lease_age(member).set(
                        max(0.0, timeout - remaining)
                    )
            swept = sweep_expired(
                self.broker, group,
                on_fence=lambda member, age: self._note_fence(
                    member, "lease_expired", age
                ),
            )
            if swept:
                info = self.broker.membership(group)
            infos[group] = info
        for inc in self.incarnations:
            if inc.state not in (LIVE, DRAINING, ZOMBIE):
                continue
            info = infos.get(self._group_of(inc))
            if info is None:
                info = self.broker.membership(self._group_of(inc))
                infos[self._group_of(inc)] = info
            fenced_members = set(info["fenced"])
            if inc.member in info["members"]:
                inc.seen_in_group = True
            if inc.proc is not None and inc.proc.poll() is not None:
                inc.exit_code = inc.proc.returncode
                if inc.exit_code == 0:
                    inc.state = DONE
                    self.metrics.drains.add(1)
                else:
                    # SIGKILL (negative rc), crash, or EXIT_FENCED: an
                    # involuntary end. Make the broker-side fencing
                    # explicit if the sweep has not already done it.
                    was = inc.state
                    inc.state = DEAD
                    if inc.member not in fenced_members:
                        self.broker.fence(self._group_of(inc), inc.member)
                    if was != ZOMBIE and inc.fence_reason is None:
                        self._note_fence(
                            inc.member,
                            "exit_fenced" if inc.exit_code == 3
                            else "process_death",
                            None,
                        )
                    self._abort_victim_txn(inc)
                    self._handoff(inc)
                    self._maybe_respawn(inc)
            elif inc.state != ZOMBIE and inc.member in fenced_members:
                # Fenced broker-side while the process still runs: a
                # stalled (SIGSTOP, GC-of-death, netsplit) zombie. The
                # sweep may not have done it — any survivor's heartbeat
                # reaps expired peers too — so note the fence HERE. Its
                # partitions are already gone; it will learn via
                # heartbeat and exit EXIT_FENCED on its own. Replace it
                # now — the group must not run short while it stalls.
                inc.state = ZOMBIE
                self._note_fence(inc.member, "lease_expired", None)
                self._abort_victim_txn(inc)
                self._handoff(inc)
                self._maybe_respawn(inc)
        if self._rollout_driver is not None and not self._rollout_driver.done:
            # The rollout control plane rides the supervision cadence:
            # worker acks/reports in, next directive out, stale-version
            # zombies fenced after completion.
            self._rollout_driver.pump()
            if self._rollout_driver.controller.phase == "complete":
                # The fleet's incumbent advances ONLY on completion (a
                # rollback leaves it untouched) — the next rollout's
                # controller needs the true incumbent to swap back to.
                self.model_version = self._rollout_driver.controller.version

    def _note_fence(self, member: str, reason: str,
                    lease_age_s: float | None) -> None:
        inc = self._by_member(member)
        if inc is not None and inc.fence_reason is not None:
            return  # already noted (sweep + observation can both fire)
        self.metrics.replica_fences.add(1)
        if inc is not None:
            inc.fence_reason = reason
        if self.tracer is not None:
            self.tracer.replica_fenced(
                member, reason=reason, lease_age_s=lease_age_s,
                replica=inc.idx if inc is not None else None,
            )

    def _txn_id(self, idx: int) -> str:
        """The transactional id for replica index ``idx`` — shared by
        every incarnation of that slot (fleet/proc.py derives the same
        string), which is exactly what makes a respawn's
        init_producer_id fence its predecessor."""
        return f"{self.group}-r{idx:03d}"

    def _abort_victim_txn(self, inc: _Incarnation) -> None:
        """Fence the victim's producer epoch and abort its in-flight
        transaction NOW (exactly_once fleets only). Without this, a
        victim's uncommitted outputs would stay transaction-open —
        blocking read_committed consumers at the LSO — until a
        replacement incarnation happens to re-initialize the id; with
        ``respawn=False`` that is never. Ordered BEFORE any respawn, so
        the replacement's own init lands a newer epoch on top."""
        if not self.exactly_once or inc.role != "decode":
            return
        try:
            self.broker.init_producer_id(self._txn_id(inc.idx))
        except Exception:  # noqa: BLE001 - best effort; the next
            # incarnation's init is the backstop
            _logger.exception(
                "eager transaction fence for %s failed", inc.member
            )

    def _by_member(self, member: str) -> _Incarnation | None:
        for inc in self.incarnations:
            if inc.member == member:
                return inc
        return None

    def _handoff(self, inc: _Incarnation) -> None:
        """Account the victim's on-disk journal as handed off. The ACTUAL
        hint application happens inside the surviving worker processes —
        they rescan the shared journal dir when the rebalance changes
        their assignment; the supervisor only narrates what disk state
        the death left for them."""
        if inc.role != "decode":
            return  # prefill workers hold no decode journal
        entries = len(DecodeJournal.load(inc.journal_path))
        inc.handoff_entries = entries
        if entries:
            self.metrics.journal_handoffs.add(entries)
            if self.tracer is not None:
                self.tracer.journal_handoff(
                    inc.member, entries, replica=inc.idx
                )

    def _maybe_respawn(self, dead: _Incarnation) -> None:
        if not self.respawn:
            return
        alive = len(self.live(dead.role))
        target = {
            "decode": self._target,
            "prefill": self.prefill_replicas,
            "distill": self.distill_replicas,
        }[dead.role]
        if alive < target:
            _logger.info(
                "respawning %s replica %d (member %s %s)",
                dead.role, dead.idx, dead.member, dead.state,
            )
            self._spawn(dead.idx, role=dead.role)

    # ----------------------------------------------------------- control

    def publish_checkpoint(self, version: int, params,
                           kind: str = "serving") -> int:
        """Publish a versioned checkpoint onto the checkpoint topic
        (manifest + CRC'd chunks). Returns the frame count."""
        if self.ckpt_topic is None:
            raise ValueError(
                "fleet was built without rollout=True or distill_replicas"
            )
        from torchkafka_tpu_torch.source.checkpoint_wire import publish_checkpoint

        return publish_checkpoint(
            self.broker, self.ckpt_topic, int(version), params, kind=kind,
        )

    def start_rollout(
        self,
        version: int,
        *,
        canary_member: str | None = None,
        canary_slice: int = 8,
        max_canary_diffs: int = 0,
    ):
        """Begin a rolling hot-swap to ``version`` (already published via
        ``publish_checkpoint``): canary shadow-serve on one member,
        token-diff gate, then drain-swap one member at a time; any
        divergence or checkpoint rejection rolls every swapped member
        back automatically. Driven from ``poll_once`` — ``wait(lambda f:
        f.rollout_done)`` rides the normal supervision loop. Returns the
        ``BrokerRolloutDriver`` (its ``.controller`` is the state
        machine)."""
        if self.rollout_topic is None:
            raise ValueError("fleet was built without rollout=True")
        if self._rollout_driver is not None and not self._rollout_driver.done:
            raise RuntimeError("a rollout is already in flight")
        from torchkafka_tpu_torch.fleet.rollout import (
            BrokerRolloutDriver,
            RolloutController,
        )

        members = sorted(
            self.broker.membership(self.group)["members"]
        ) or sorted(i.member for i in self.live())
        ctl = RolloutController(
            members, int(version),
            canary_member=canary_member,
            canary_slice=canary_slice,
            max_canary_diffs=max_canary_diffs,
            incumbent_version=self.model_version,
            tracer=self.tracer, metrics=self.metrics,
        )
        self._rollout_driver = BrokerRolloutDriver(
            self.broker, self.rollout_topic, ctl, group=self.group,
        )
        self._rollout_driver.start()
        return self._rollout_driver

    @property
    def rollout_done(self) -> bool:
        return self._rollout_driver is not None and self._rollout_driver.done

    @property
    def rollout(self):
        return self._rollout_driver

    def kill_replica(self, idx: int) -> dict:
        """SIGKILL the newest live incarnation of replica ``idx`` — a
        REAL unclean process death (no handlers, no flushes; the decode
        journal is whatever the last cadence fsync left on disk).
        Returns forensics for the zombie-fencing assertions: the victim
        member id and the group generation it held, so a test can forge
        its post-mortem commit and watch it bounce."""
        victims = [
            i for i in self.incarnations
            if i.idx == idx and i.state in (LIVE, DRAINING) and i.running
            and i.role == "decode"
        ]
        if not victims:
            raise ValueError(f"no live process for replica {idx}")
        inc = victims[-1]
        generation = self.broker.membership(self.group)["generation"]
        inc.proc.send_signal(signal.SIGKILL)
        inc.proc.wait()
        forensics = {
            "member": inc.member, "idx": idx, "generation": generation,
            "journal_path": inc.journal_path,
        }
        self.victims.append(forensics)
        return forensics

    def kill_prefill(self, idx: int = 0) -> dict:
        """SIGKILL the newest live prefill-worker incarnation of index
        ``idx`` — the mid-storm disaggregation drill: unpublished
        handoffs vanish with the process, decode replicas' routing
        patience expires and they fall back to local prefills, and (with
        ``respawn=True``) a fresh prefill incarnation re-serves the
        prefill group's uncommitted prompts. Zero decode-path loss by
        construction: the decode group's ledger never depended on a
        handoff existing."""
        victims = [
            i for i in self.incarnations
            if i.idx == idx and i.state in (LIVE, DRAINING) and i.running
            and i.role == "prefill"
        ]
        if not victims:
            raise ValueError(f"no live process for prefill worker {idx}")
        inc = victims[-1]
        inc.proc.send_signal(signal.SIGKILL)
        inc.proc.wait()
        forensics = {
            "member": inc.member, "idx": idx, "role": "prefill",
            "log_path": inc.log_path,
        }
        self.victims.append(forensics)
        return forensics

    def kill_distill(self, idx: int = 0) -> dict:
        """SIGKILL the newest live distill-trainer incarnation of index
        ``idx`` — the trainer-death drill: unpublished draft progress
        (at most ``publish_every`` steps past the last checkpoint)
        vanishes with the process, the serving fleet keeps proposing
        with its incumbent draft (serving never depended on the trainer
        being alive), and (with ``respawn=True``) a fresh incarnation
        resumes from the corpus group's committed offsets — at-least-
        once, so a mid-step death re-delivers that step's records as
        extra gradient samples. Zero committed-token impact by
        construction."""
        victims = [
            i for i in self.incarnations
            if i.idx == idx and i.state in (LIVE, DRAINING) and i.running
            and i.role == "distill"
        ]
        if not victims:
            raise ValueError(f"no live process for distill worker {idx}")
        inc = victims[-1]
        inc.proc.send_signal(signal.SIGKILL)
        inc.proc.wait()
        forensics = {
            "member": inc.member, "idx": idx, "role": "distill",
            "log_path": inc.log_path,
        }
        self.victims.append(forensics)
        return forensics

    def kill_leader(self) -> dict:
        """Leader-death drill for a replicated broker cell
        (``broker_replicas >= 2``): drop the leader the way SIGKILL
        would (its server vanishes mid-conversation, its WAL is
        abandoned un-flushed), run the epoch-bumped election, and
        promote the longest follower onto the SAME advertised port —
        the ``restart_broker`` takeover discipline, minus the outage
        window a lone broker has to ride. Workers reconnect through
        their retry stacks, unfenced; the deposed leader's late ships
        stale-epoch-fence like any zombie's commits. Returns forensics
        (victim/winner indices, epochs, candidate positions, the
        promotion's PR-11 recovery summary, failover wall-clock),
        appended to ``self.victims`` like every other kill drill."""
        if self._cell is None:
            raise ValueError(
                "kill_leader requires ProcessFleet(broker_replicas >= 2): "
                "a lone broker has no follower to promote"
            )
        fx = self._cell.kill_leader()
        self.broker = self._cell.broker
        self.server = self._cell.server
        self.metrics.leader_elections.add(1)
        if self.tracer is not None:
            rec = fx.get("recovery", {})
            self.tracer.broker_restarted(
                replayed_records=rec.get("replayed_records", 0),
                aborted_txns=rec.get("aborted_txns", 0),
                recovery_ms=rec.get("recovery_ms", 0.0),
            )
        forensics = {"kind": "leader", **fx}
        self.victims.append(forensics)
        _logger.info("broker leader failed over: %s", forensics)
        return forensics

    def restart_broker(self, crash: bool = True, down_s: float = 0.0) -> dict:
        """Kill and recover the hosted broker — the broker-death drill.

        ``crash=True`` (default) is an unclean death: the listener and
        every live connection drop mid-RPC (exactly what a SIGKILLed
        broker process looks like from a client socket) and the
        in-memory state object is ABANDONED un-flushed — the only
        surviving truth is whatever the write-ahead log already holds
        per its durability discipline. ``down_s`` holds the port closed
        before recovery so outage-riding (retry storms, circuit
        breakers opening) is actually exercised. Then a fresh
        ``InMemoryBroker(wal_dir=...)`` RECOVERS — records, offsets,
        generations, producer epochs, memberships with fresh leases;
        open transactions aborted — and rebinds a ``BrokerServer`` on
        the SAME port, so every worker's reconnect lands without
        re-configuration. Requires the fleet to have been built with
        ``wal_dir`` (a volatile broker cannot be restarted into
        anything but amnesia). Returns the recovery summary."""
        if self.wal_dir is None:
            raise ValueError(
                "restart_broker requires ProcessFleet(wal_dir=...): "
                "without a WAL there is no state to recover"
            )
        if self._cell is not None:
            raise ValueError(
                "a replicated cell fails over via kill_leader(), not "
                "restart_broker(): promotion, not restart, is its "
                "recovery path"
            )
        from torchkafka_tpu_torch.source.memory import InMemoryBroker
        from torchkafka_tpu_torch.source.netbroker import BrokerServer

        host, port = self.server.host, self.server.port
        self.server.close()  # connections reset: clients see the outage
        if not crash:
            self.broker.close()  # clean shutdown flushes the WAL tail
        # crash=True: the old broker object is simply dropped — no
        # flush, no close; its unfsynced tail is the page cache's
        # problem, exactly as process death leaves it.
        if down_s > 0:
            time.sleep(down_s)
        t0 = time.perf_counter()
        self.broker = InMemoryBroker(
            session_timeout_s=self.session_timeout_s,
            wal_dir=self.wal_dir, wal_durability=self.wal_durability,
        )
        self.server = BrokerServer(self.broker, host=host, port=port)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.broker_restarts.add(1)
        info = dict(self.broker.recovery_info or {})
        info["restart_ms"] = round(elapsed_ms, 3)
        if self.tracer is not None:
            self.tracer.broker_restarted(
                replayed_records=info.get("replayed_records", 0),
                aborted_txns=info.get("aborted_txns", 0),
                recovery_ms=info.get("recovery_ms", 0.0),
            )
        _logger.info("broker restarted on %s:%s from WAL: %s",
                     host, port, info)
        return info

    def scale(self, n: int, role: str = "decode") -> None:
        """Elastic membership mid-serve, per role. Scale-UP spawns fresh
        members (the rebalance hands them partitions — and their startup
        journal scan makes them failover-capable immediately). Scale-DOWN
        SIGTERMs the newest live incarnations: each drains cooperatively
        (finish in-flight generations, commit, sync journal, leave), so
        nothing is lost and nothing replays.

        Reconciled against BROKER truth first: a scale call can land
        while a lease sweep is fencing a victim (the autoscale
        controller reacts to the very fence events the sweep emits), and
        the supervisor's own incarnation bookkeeping only catches up at
        the next ``poll_once``. Counting such a victim as live would
        make scale-down drain a healthy survivor in its place (the fleet
        then converges BELOW target — an orphaned member-id range slot)
        and scale-up under-provision. So capacity here is incarnations
        that are broker-unfenced AND process-alive; a fenced victim's
        replica index is deliberately free for reuse, so the scale-up
        replacement sorts into the victim's member-id range and inherits
        its journal + radix locality (the PR-9 range trick, made
        deliberate)."""
        floor = 1 if role == "decode" else 0
        if n < floor:
            raise ValueError(
                f"scale target for {role!r} must be >= {floor}, got {n}"
            )
        if role == "prefill" and self.handoff_topic is None:
            raise ValueError(
                "cannot scale the prefill role of a fleet built without "
                "prefill_replicas/kv_pages (no handoff plane exists)"
            )
        if role == "distill" and self.distill_topic is None:
            raise ValueError(
                "cannot scale the distill role of a fleet built without "
                "distill_replicas (no distill corpus topic exists)"
            )
        fenced = set(
            self.broker.membership(
                self.group if role == "decode" else f"{self.group}-{role}"
            )["fenced"]
        )
        cur = [
            i for i in self.live(role)
            if i.member not in fenced and i.running
        ]
        if n > len(cur):
            used = {i.idx for i in cur}
            idx = 0
            for _ in range(n - len(cur)):
                while idx in used:
                    idx += 1
                used.add(idx)
                # Target decided, member-id range slot chosen, the
                # replacement not yet alive: the supervisor-death window
                # the crash matrix SIGKILLs at.
                crash_hook("scale_up_pre_spawn")
                self._spawn(idx, role=role)
        elif n < len(cur):
            # Drain the NEWEST incarnations first (LIFO): the longest-
            # lived members keep their partition/cache locality.
            to_drain = sorted(
                cur, key=lambda i: self.incarnations.index(i)
            )[n:]
            for inc in to_drain:
                if inc.running:
                    inc.proc.send_signal(signal.SIGTERM)
                # Drain initiated (SIGTERM in flight), supervisor
                # bookkeeping not yet updated: the mid-drain
                # supervisor-death window.
                crash_hook("scale_down_mid_drain")
                inc.state = DRAINING
        if role == "decode":
            self._target = n
        elif role == "prefill":
            self.prefill_replicas = n
        else:
            self.distill_replicas = n

    def drain(self) -> None:
        """SIGTERM every live worker (prefill and distill included):
        fleet-wide cooperative drain."""
        for inc in (
            self.live() + self.live("prefill") + self.live("distill")
        ):
            if inc.running:
                inc.proc.send_signal(signal.SIGTERM)
            inc.state = DRAINING
        self._target = 0
        self.prefill_replicas = 0
        self.distill_replicas = 0

    def wait(
        self,
        until: Callable[["ProcessFleet"], bool],
        timeout_s: float = 120.0,
        poll_interval_s: float = 0.05,
    ) -> None:
        """Supervision loop: ``poll_once`` until ``until(self)`` or
        timeout (raises TimeoutError with per-worker log tails)."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll_once()
            if until(self):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet condition not reached in {timeout_s}s\n"
                    + self.diagnose()
                )
            time.sleep(poll_interval_s)

    def fully_committed(self) -> bool:
        """True when the group's committed watermark covers every prompt
        partition end-to-end — the zero-lost condition."""
        n = self.broker.partitions_for(self.topic)
        for p in range(n):
            tp = TopicPartition(self.topic, p)
            if (self.broker.committed(self.group, tp) or 0) \
                    < self.broker.end_offset(tp):
                return False
        return True

    # ------------------------------------------------------------ results

    def results(
        self, isolation: str = "read_uncommitted"
    ) -> dict[bytes, list[tuple[str, np.ndarray]]]:
        """Output-topic completions grouped by prompt key:
        ``key -> [(serving member, tokens), ...]`` in produce order —
        duplicates visible, attribution explicit.
        ``isolation="read_committed"``: only records whose transaction
        committed (the downstream consumer's view in an exactly_once
        fleet — the view in which duplicates are asserted ZERO)."""
        out: dict[bytes, list[tuple[str, np.ndarray]]] = {}
        for p in range(self.broker.partitions_for(self.out_topic)):
            tp = TopicPartition(self.out_topic, p)
            if isolation == "read_committed":
                recs, _ = self.broker.fetch_stable(tp, 0, 1000000)
            else:
                recs = self.broker.fetch(tp, 0, 1000000)
            for rec in recs:
                member = dict(rec.headers).get("member", b"?").decode()
                out.setdefault(rec.key, []).append(
                    (member, np.frombuffer(rec.value, dtype=np.int32))
                )
        return out

    def worker_metrics(self) -> list[dict]:
        """Per-incarnation metric dumps (written by workers at clean or
        fenced exit; SIGKILLed victims leave none — honestly)."""
        out = []
        for inc in self.incarnations:
            try:
                with open(inc.metrics_path, encoding="utf-8") as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        return out

    def diagnose(self) -> str:
        parts = []
        for inc in self.incarnations:
            rc = inc.proc.poll() if inc.proc is not None else None
            try:
                with open(inc.log_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
            except OSError:
                tail = "<no log>"
            parts.append(
                f"--- {inc.member} state={inc.state} rc={rc} ---\n{tail}"
            )
        return "\n".join(parts)

    # ------------------------------------------------------------ teardown

    def close(self, grace_s: float = 5.0) -> None:
        for inc in self.incarnations:
            if inc.running:
                inc.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace_s
        for inc in self.incarnations:
            if inc.proc is None:
                continue
            while inc.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if inc.proc.poll() is None:
                inc.proc.kill()
                inc.proc.wait()
        if self._cell is not None:
            self._cell.close()  # leader, followers, servers, WALs
        else:
            self.server.close()
            self.broker.close()  # flush + close the WAL, when one exists

    def __enter__(self) -> "ProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
