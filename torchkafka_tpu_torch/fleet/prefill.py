"""Disaggregated prefill: dedicated workers that fill KV, decode replicas
that adopt it — prompt storms never touch decode's inter-token latency.
Port of ``torchkafka_tpu/fleet/prefill.py``.

DistServe/Splitwise shape over this repo's own primitives: a
``PrefillWorker`` is a ``StreamingGenerator(prefill_role=True)`` in its
OWN consumer group over the prompt topic — it runs the existing
chunked-prefill machinery to fill paged KV blocks and samples token 0
in-dispatch, then publishes each prompt's ``PrefillHandoff`` (record
identity + CRC + sampling contract + RNG key + token 0 + the raw
prompt-block payloads) onto a HANDOFF TOPIC: the broker is the transfer
plane, the PR-9 journal handoff generalized from crash recovery to a
routing primitive. Decode replicas each tail the handoff topic
(broadcast: one private group per replica), install the decoded units on
their generator, and ADOPT at admission — payload scattered into fresh
pool blocks, state merged like a 1-token warm resume, no prompt pass
ever running on the decode path.

Routing is the admission queue's old shedding hook re-aimed: a
``PrefillRouter`` holds a record queued while its handoff is still in
flight (counted once as ``prefill_routed``), releases it the moment the
handoff lands (adoption), and FALLS BACK to a local prefill when
``patience`` pops expire — so a dead prefill worker degrades the
optimization, never correctness. Every path is at-least-once: handoffs
are idempotent by record identity (a duplicate overwrites the identical
unit), the decode group's ledger/exactly-once discipline never depends
on a handoff existing, and the prefill group's own offsets re-deliver
unpublished work to the next prefill incarnation
(``prefill_handoff_pre_publish`` in the crash matrix pins exactly that
window; ``decode_adopt_pre_activate`` pins the adopting side).

Wire format (versioned, self-describing): a 4-byte big-endian length,
a JSON header (identity, contract, token 0, per-array dtype/shape), then
the arrays' raw bytes concatenated — no pickle on the data plane. The
bytes are the JAX package's: a bf16 pool's arrays (CPU bf16 tensors here,
numpy has no bfloat16) travel as their 16-bit patterns under the dtype
name ``bfloat16``, which is the name JAX's ml_dtypes arrays carry, so a
handoff encoded by either package decodes in the other.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from torchkafka_tpu_torch.parallel.lockstep import is_root
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.serve import PrefillHandoff
from torchkafka_tpu_torch.source.checkpoint_wire import (
    _BF16,
    _dtype_name,
    _raw_bytes,
    _wire_dtype,
)
from torchkafka_tpu_torch.source.records import Record

_logger = logging.getLogger(__name__)

_WIRE_VERSION = 1


def encode_handoff(hand: PrefillHandoff) -> bytes:
    header = {
        "v": _WIRE_VERSION,
        "t": hand.topic,
        "p": hand.partition,
        "o": hand.offset,
        "crc": hand.crc,
        "rng": list(hand.key_data),
        "temp": hand.temperature,
        "top_k": hand.top_k,
        "top_p": hand.top_p,
        "tok0": hand.token0,
        "nbp": hand.prompt_blocks,
        "arrays": [
            {"dtype": _dtype_name(a), "shape": list(a.shape)}
            for a in hand.pools
        ],
    }
    hb = json.dumps(header).encode()
    parts = [len(hb).to_bytes(4, "big"), hb]
    parts.extend(_raw_bytes(a) for a in hand.pools)
    return b"".join(parts)


def decode_handoff(data: bytes) -> PrefillHandoff:
    hlen = int.from_bytes(data[:4], "big")
    header = json.loads(data[4:4 + hlen].decode())
    if header.get("v") != _WIRE_VERSION:
        raise ValueError(f"unknown handoff wire version {header.get('v')!r}")
    off = 4 + hlen
    pools = []
    for meta in header["arrays"]:
        dt = _wire_dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        n = dt.itemsize * int(np.prod(shape)) if shape else dt.itemsize
        arr = np.frombuffer(data, dtype=dt, count=n // dt.itemsize,
                            offset=off).reshape(shape).copy()
        pools.append(
            torch.from_numpy(arr).view(torch.bfloat16)
            if meta["dtype"] == _BF16 else arr
        )
        off += n
    return PrefillHandoff(
        topic=str(header["t"]),
        partition=int(header["p"]),
        offset=int(header["o"]),
        crc=int(header["crc"]),
        key_data=tuple(int(x) for x in header["rng"]),
        temperature=float(header["temp"]),
        top_k=None if header["top_k"] is None else int(header["top_k"]),
        top_p=None if header["top_p"] is None else float(header["top_p"]),
        token0=int(header["tok0"]),
        prompt_blocks=int(header["nbp"]),
        pools=tuple(pools),
    )


class PrefillRouter:
    """The admission-queue prefill-routing decision (the shedding hook's
    sibling): hold a record queued while its handoff may still arrive,
    admit it the moment the handoff lands, fall back to a local prefill
    after ``patience`` hold decisions. Deterministic — the counter is
    hold-decisions, not a clock — so same-seed replays route
    identically."""

    def __init__(self, gen, *, patience: int = 256) -> None:
        if patience < 0:
            raise ValueError(f"patience must be >= 0, got {patience}")
        self._gen = gen
        self._patience = patience
        self._age: dict[tuple[str, int, int], int] = {}
        self._routed: set[tuple[str, int, int]] = set()

    def should_hold(self, rec: Record) -> bool:
        key = (rec.topic, rec.partition, rec.offset)
        if self._gen.has_prefill_handoff(key):
            self._age.pop(key, None)
            return False  # admit: adoption consumes the handoff
        n = self._age.get(key, 0) + 1
        self._age[key] = n
        if key not in self._routed:
            self._routed.add(key)
            self._gen.metrics.prefill_routed.add(1)
        if n > self._patience:
            # The handoff never came (prefill worker dead or drowning):
            # release — local prefill is the always-correct fallback.
            self._age.pop(key, None)
            return False
        return True


def drain_handoffs(consumer, gen, *, max_records: int = 256) -> int:
    """Tail the handoff topic into the generator's shelf; returns units
    installed. Undecodable payloads are logged and skipped (a handoff is
    an optimization, never load-bearing)."""
    records = consumer.poll(max_records=max_records, timeout_ms=0)
    installed = 0
    entries = {}
    for rec in records:
        try:
            hand = decode_handoff(rec.value)
        except Exception:  # noqa: BLE001 - fall back to local prefill
            _logger.exception("dropping undecodable prefill handoff")
            continue
        entries[hand.key] = hand
        installed += 1
    if entries:
        gen.add_prefill_handoffs(entries)
    return installed


class PrefillWorker:
    """One prefill worker: pump the prefill-role generator, publish the
    harvested handoffs, commit the prefill group's offsets at cadence.
    The ledger emit happens only AFTER the publish is issued
    (``note_handoff_published``), with the producer flushed before any
    offset commit — a death mid-transfer re-delivers the prompt to the
    next prefill incarnation (at-least-once on the handoff plane).

    On a serving mesh every rank runs a worker over its rank's ``gen``
    and the mesh's ``parallel.lockstep.MeshConsumer``; the root publishes
    (the handoff holds every layer and kv head, gathered over pp and tp)
    and the other ranks pass ``producer=None``."""

    def __init__(self, gen, consumer, producer, handoff_topic: str, *,
                 commit_every: int = 8, max_poll_records: int = 64) -> None:
        if not getattr(gen, "_prefill_role", False):
            raise ValueError(
                "PrefillWorker needs a StreamingGenerator built with "
                "prefill_role=True"
            )
        shard = getattr(gen, "_shard", None)
        off_root = shard is not None and not is_root(shard.mesh)
        if off_root and producer is not None:
            raise ValueError(
                "only the serving mesh's root publishes handoffs: pass "
                "producer=None on its other ranks"
            )
        if not off_root and producer is None:
            raise ValueError(
                "PrefillWorker needs a producer (only a serving mesh's "
                "ranks other than the root pass producer=None)"
            )
        self.gen = gen
        self.consumer = consumer
        self.producer = producer
        self.handoff_topic = handoff_topic
        self._commit_every = commit_every
        self._max_poll = max_poll_records
        self._since_commit = 0
        self._retry_flush = False
        # Warm drain (PrefillPool scale-down): stop polling new prompts,
        # finish + publish + commit the in-flight ones, then leave.
        self.draining = False

    def start_drain(self) -> None:
        self.draining = True

    def pump(self) -> int:
        """One quantum: poll → admit → chunk tick → publish harvested
        handoffs. Returns handoffs published."""
        free = self.gen.free_slots() - self.gen.pending_admissions
        if free > 0 and not self.draining:
            records = self.consumer.poll(
                max_records=min(free, self._max_poll), timeout_ms=0,
            )
            if records:
                self.gen.note_fetched(records)
                self.gen.admit_records(records)
        elif self.gen.pending_admissions:
            self.gen.admit_records([])
        self.gen.step()
        published = 0
        for rec, hand in self.gen.take_prefilled():
            # Filled blocks extracted, nothing published: death here is
            # the mid-transfer window the crash matrix SIGKILLs at.
            crash_hook("prefill_handoff_pre_publish")
            if self.producer is not None:
                self.producer.send(
                    self.handoff_topic, encode_handoff(hand), key=rec.key,
                )
            self.gen.note_handoff_published(rec, blocks=hand.prompt_blocks)
            published += 1
        if published:
            if self.producer is not None:
                self.producer.flush()
            self._since_commit += published
        if self._retry_flush or self._since_commit >= self._commit_every:
            ok = self.gen.flush_commits()
            self._since_commit = 0
            self._retry_flush = ok is False
        return published

    def idle(self) -> bool:
        return not self.gen.has_active() and self.gen.pending_admissions == 0

    def close(self) -> None:
        try:
            if self.producer is not None:
                self.producer.flush()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        self.gen.flush_commits()


class PrefillPool:
    """N in-process prefill workers over one broker — the prefill role's
    twin of ``ServingFleet``'s decode replicas, elastic via ``scale_to``
    (the autoscale controller's prefill actuation surface).

    Every member is a ``PrefillWorker`` over its own group-managed
    consumer (one consumer group for the whole pool: partitions of the
    prompt topic range-assign across members) and a producer onto the
    handoff topic. ``pump_once()`` runs one cooperative quantum across
    live members — call it once per fleet scheduling round and the whole
    disaggregated pipeline shares one deterministic timeline (same-seed
    replays place every handoff identically).

    Scale-up builds a fresh member (warmed at once after the pool's
    ``warmup``; members share the caller's params tree). Scale-down
    drains WARM: the member stops
    polling, finishes + publishes + commits its in-flight prompts, then
    leaves the group — unpublished work never commits, so nothing is
    lost and the survivors (or the decode fallback path) pick up
    whatever a slow drain leaves behind."""

    def __init__(
        self,
        broker,
        topic: str,
        group: str,
        handoff_topic: str,
        params,
        cfg,
        *,
        workers: int = 1,
        slots: int = 2,
        prompt_len: int,
        max_new: int,
        kv_pages: dict,
        commit_every: int = 4,
        max_poll_records: int = 64,
        gen_kwargs: dict | None = None,
    ) -> None:
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        self.broker = broker
        self.topic = topic
        self.group = group
        self.handoff_topic = handoff_topic
        self._params = params
        self._cfg = cfg
        self._slots = slots
        self._prompt_len = prompt_len
        self._max_new = max_new
        self._kv_pages = dict(kv_pages)
        self._commit_every = commit_every
        self._max_poll = max_poll_records
        self._gen_kwargs = dict(gen_kwargs or {})
        self._warmed = False
        self._seq = 0
        self.workers: list[PrefillWorker] = []
        self.drained = 0  # members that completed a warm drain
        for _ in range(workers):
            self._spawn()

    def _spawn(self) -> PrefillWorker:
        from torchkafka_tpu_torch.serve import StreamingGenerator
        from torchkafka_tpu_torch.source.memory import MemoryConsumer
        from torchkafka_tpu_torch.source.producer import MemoryProducer

        member = f"pf{self._seq:03d}"
        self._seq += 1
        consumer = MemoryConsumer(
            self.broker, self.topic, group_id=self.group, member_id=member,
        )
        gen = StreamingGenerator(
            consumer, self._params, self._cfg,
            slots=self._slots, prompt_len=self._prompt_len,
            max_new=self._max_new, commit_every=2**31 - 1,
            ticks_per_sync=1, max_poll_records=self._max_poll,
            kv_pages=dict(self._kv_pages), prefill_role=True,
            **self._gen_kwargs,
        )
        if self._warmed:
            gen.warmup()
        worker = PrefillWorker(
            gen, consumer, MemoryProducer(self.broker), self.handoff_topic,
            commit_every=self._commit_every,
            max_poll_records=self._max_poll,
        )
        self.workers.append(worker)
        return worker

    def warmup(self) -> None:
        for w in self.workers:
            w.gen.warmup()
        self._warmed = True

    def live_count(self) -> int:
        """Members still polling new work (draining members are winding
        down and no longer count as capacity)."""
        return sum(1 for w in self.workers if not w.draining)

    def backlog(self) -> int:
        """The prefill role's queue-depth signal: prompt-topic offsets
        the pool's group has not committed yet (offered prefill work not
        yet published-and-retired — the handoff-plane lag an autoscale
        controller scales this role on)."""
        from torchkafka_tpu_torch.source.records import TopicPartition

        total = 0
        for p in range(self.broker.partitions_for(self.topic)):
            tp = TopicPartition(self.topic, p)
            total += self.broker.end_offset(tp) - (
                self.broker.committed(self.group, tp) or 0
            )
        return total

    def occupancy(self) -> float:
        """Mean slot occupancy over live members (scale-down guard)."""
        live = [w for w in self.workers if not w.draining]
        if not live:
            return 0.0
        return sum(
            1.0 - w.gen.free_slots() / max(1, w.gen.slots) for w in live
        ) / len(live)

    def scale_to(self, n: int) -> None:
        """Elastic pool membership: up spawns fresh members (the group
        rebalance hands them partitions), down warm-drains the NEWEST
        members (LIFO — the longest-lived keep their partition
        locality); ``pump_once`` completes the drain."""
        if n < 0:
            raise ValueError(f"scale target must be >= 0, got {n}")
        live = [w for w in self.workers if not w.draining]
        if n > len(live):
            for _ in range(n - len(live)):
                self._spawn()
        elif n < len(live):
            for w in live[n:]:
                w.start_drain()

    def pump_once(self) -> int:
        """One cooperative quantum across every open member; completes
        pending drains. Returns handoffs published this quantum."""
        published = 0
        still: list[PrefillWorker] = []
        for w in self.workers:
            published += w.pump()
            if w.draining and w.idle():
                # In-flight work finished, published, committed: leave.
                w.close()
                w.consumer.close()
                self.drained += 1
            else:
                still.append(w)
        self.workers = still
        return published

    def idle(self) -> bool:
        return all(w.idle() for w in self.workers)

    def close(self) -> None:
        for w in self.workers:
            w.close()
            try:
                w.consumer.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        self.workers = []


def run_prefill_worker(spec: dict, broker=None, shutdown=None) -> int:
    """One prefill-worker incarnation as a fleet process (the
    ``role: "prefill"`` twin of ``fleet.proc.run_replica_worker``): own
    BrokerClient, own model on ``spec["device"]`` (CUDA when absent),
    its own consumer group ``<group>-prefill`` over the prompt topic,
    heartbeat-leased there, publishing handoffs to
    ``spec["handoff_topic"]``. The metrics dump carries the worker's
    kernel launch counts (``proc.launch_counts``)."""
    from torchkafka_tpu_torch.errors import BrokerUnavailableError, FencedMemberError
    from torchkafka_tpu_torch.fleet.proc import (
        _HeartbeatSender,
        build_model,
        launch_counts,
    )
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import MemoryConsumer
    from torchkafka_tpu_torch.source.producer import MemoryProducer

    EXIT_CLEAN, EXIT_FENCED = 0, 3
    own_client = broker is None
    if own_client:
        from torchkafka_tpu_torch.resilience import RetryPolicy
        from torchkafka_tpu_torch.source.netbroker import BrokerClient

        b = spec["broker"]
        broker = BrokerClient(
            b["host"], int(b["port"]),
            timeout_s=float(spec.get("connect_timeout_s", 30.0)),
            retry=RetryPolicy(
                max_attempts=int(spec.get("reconnect_attempts", 6)),
                base_delay_s=0.05, max_delay_s=1.0,
                deadline_s=float(spec.get("reconnect_deadline_s", 15.0)),
            ),
        )
    member = spec["member_id"]
    consumer = None
    hb = None
    gen = None
    warm_launches = None
    try:
        from torchkafka_tpu_torch.utils import prng

        cfg, params = build_model(spec["model"], spec.get("device"))
        group = f"{spec['group']}-prefill"
        consumer = MemoryConsumer(
            broker, spec["topic"], group_id=group, member_id=member,
        )
        hb_interval = spec.get("heartbeat_interval_s", 0.25)
        if hb_interval is not None and spec.get(
            "heartbeat_mode", "thread"
        ) == "thread":
            hb = _HeartbeatSender(consumer, float(hb_interval))
            hb.start()
        producer = MemoryProducer(broker)
        gen = StreamingGenerator(
            consumer, params, cfg,
            slots=int(spec.get("slots", 2)),
            prompt_len=int(spec["prompt_len"]),
            max_new=int(spec["max_new"]),
            commit_every=2**31 - 1,
            ticks_per_sync=1,
            max_poll_records=int(spec.get("max_poll_records", 64)),
            temperature=float(spec.get("temperature", 0.0)),
            top_k=spec.get("top_k"),
            top_p=spec.get("top_p"),
            rng=prng.key(int(spec.get("sampling_seed", 0))),
            kv_pages=spec.get("kv_pages"),
            kv_tier=spec.get("kv_tier"),
            prefill_role=True,
            device=spec.get("device"),
        )
        gen.warmup()
        warm_launches = launch_counts()
        if spec.get("ready_topic"):
            MemoryProducer(broker).send(
                spec["ready_topic"], member.encode()
            )
        worker = PrefillWorker(
            gen, consumer, producer, spec["handoff_topic"],
            commit_every=int(spec.get("commit_every", 8)),
            max_poll_records=int(spec.get("max_poll_records", 64)),
        )
        idle_exit_ms = spec.get("idle_exit_ms")
        idle_since = None
        while True:
            if shutdown is not None and shutdown.requested:
                worker.close()
                return EXIT_CLEAN
            if hb is not None and hb.fenced:
                raise FencedMemberError(
                    f"prefill member {member!r} fenced"
                )
            if hb is not None and hb.error is not None:
                raise hb.error
            try:
                if hb is None and hb_interval is not None:
                    consumer.heartbeat()
                published = worker.pump()
            except BrokerUnavailableError:
                time.sleep(0.02)
                continue
            if published or not worker.idle():
                idle_since = None
            else:
                now = time.monotonic()
                if idle_since is None:
                    idle_since = now
                elif (
                    idle_exit_ms is not None
                    and (now - idle_since) * 1e3 >= idle_exit_ms
                ):
                    worker.close()
                    return EXIT_CLEAN
                time.sleep(0.002)
    except FencedMemberError:
        return EXIT_FENCED
    finally:
        if hb is not None:
            hb.stop()
        if gen is not None and spec.get("metrics_path"):
            try:
                doc = {
                    "member": member,
                    "role": "prefill",
                    **gen.metrics.disagg_summary(),
                    "prefill_tokens": gen.metrics.prefill_tokens.count,
                    "prefix_hits": gen.metrics.prefix_hits.count,
                    "launches": launch_counts(since=warm_launches),
                }
                tmp = spec["metrics_path"] + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(doc, f)
                import os

                os.replace(tmp, spec["metrics_path"])
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        if consumer is not None:
            try:
                consumer.close()
            except Exception:  # noqa: BLE001
                pass
        if own_client:
            try:
                broker.close()
            except Exception:  # noqa: BLE001
                pass
