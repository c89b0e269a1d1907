"""One serving replica as a real OS process: the process fleet's worker.
Port of ``torchkafka_tpu/fleet/proc.py``.

``run_replica_worker(spec)`` is a complete replica incarnation — its own
``BrokerClient`` over the supervisor's socket broker, its own model on
its own device context (params rebuilt deterministically from the spec's
model seed, so every process decodes identically), its own on-disk
``DecodeJournal`` — driven
by the same ``Replica`` pump the in-process fleet uses, plus the three
things only a real process needs:

- **heartbeat leases**: every ``heartbeat_interval_s`` the worker renews
  its broker-side lease (``MemoryConsumer.heartbeat``, crash point
  ``heartbeat_pre_send``). A worker that dies — or stalls past the
  session timeout — is FENCED: evicted with a rebalance, its partitions
  re-delivered to survivors, its stale-generation commits rejected. A
  fenced worker learns its fate from ``FencedMemberError`` and exits
  ``EXIT_FENCED`` so a supervisor can respawn a fresh incarnation.
- **cross-process warm failover**: at startup and on every observed
  assignment change (a rebalance means someone died or scaled), the
  worker rescans the shared ``journal_dir`` (``DecodeJournal.scan_dir``,
  crash point ``journal_handoff_pre_load``) and installs every peer
  journal's live entries as warm-resume hints — the victim's in-flight
  generations resume on the survivor byte-identical, bounded re-decode.
- **reconnect-with-backoff**: the ``BrokerClient`` runs behind a
  ``resilience.RetryPolicy``, so a socket drop mid-serve is a retryable
  ``BrokerUnavailableError`` absorbed by jittered reconnects — an outage
  longer than the session timeout still ends in a clean fencing, never
  corruption.

Runnable as ``python -m torchkafka_tpu_torch.fleet.proc <spec.json>``
(the supervisor writes the spec); importable so the crash matrix and tests
can run the SAME incarnation logic in-process as the recovery run.

Device rule: a worker serves on ``spec["device"]``; absent, on CUDA, and
without CUDA it raises (a nonzero exit with the traceback in its log),
never serving on the CPU in silence. The heartbeat thread touches no
device. Each worker's metrics dump carries its kernel launch counts
(``launch_counts``), which its parent cannot see.

Outputs are produced to ``spec["out_topic"]`` keyed by the prompt
record's key, with a ``member`` header naming the serving incarnation —
so a supervisor (or a test) can attribute every completion, count
duplicates, and pick a mid-generation victim without reaching into the
worker's memory.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

EXIT_CLEAN = 0
EXIT_FENCED = 3  # this incarnation was fenced; respawn a fresh member


class _HeartbeatSender(threading.Thread):
    """The lease keeper, on its own thread — Kafka's own split between
    session liveness (the background heartbeat) and processing liveness
    (max.poll.interval): a replica mid-warmup or mid-tick on a
    contended core is SLOW, not DEAD, and must not fence itself. The
    thread renews every ``interval_s``; the serving loop only reads
    ``fenced`` at its own safe points. Transport faults ride the
    client's retry policy; an outage that outlives the session timeout
    ends in FencedMemberError here — observed, flagged, thread exits."""

    def __init__(self, consumer, interval_s: float) -> None:
        super().__init__(name="replica-heartbeat", daemon=True)
        self._consumer = consumer
        self._interval_s = interval_s
        self._stop = threading.Event()
        self.fenced = False
        self.outages = 0  # renewals that found the broker unreachable
        self.error: BaseException | None = None

    def run(self) -> None:
        from torchkafka_tpu_torch.errors import (
            BrokerUnavailableError,
            FencedMemberError,
        )

        while not self._stop.is_set():
            try:
                self._consumer.heartbeat()
            except FencedMemberError:
                self.fenced = True
                return
            except BrokerUnavailableError:
                # Outage outlived the client's retry budget: keep trying
                # — a WAL-recovered broker restores this member with a
                # fresh lease, so the next renewal that lands simply
                # resumes the session. If the broker instead comes back
                # without us (or never), the outcome is FencedMemberError
                # or shutdown, both handled above/outside.
                self.outages += 1
                self._stop.wait(self._interval_s)
                continue
            except Exception as exc:  # noqa: BLE001 - flagged, loop decides
                # A teardown race or a genuine bug: the serving loop
                # surfaces it at its next safe point.
                self.error = exc
                return
            self._stop.wait(self._interval_s)

    def stop(self) -> None:
        self._stop.set()


def build_model(model_spec: dict, device=None):
    """Deterministic f32 params from the spec — every process that holds
    the same model spec decodes identically (greedy) or samples
    identically (the per-record key schedule folds from record identity).
    Drawn on the CPU from a ``torch.Generator`` seeded with
    ``model_spec["seed"]`` (the same bytes whatever the device), then
    moved to ``device`` (None = CUDA, raising without it). The numbers
    differ from the JAX package's ``build_model`` (another generator)."""
    import torch

    from torchkafka_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from torchkafka_tpu_torch.serve import _params_to
    from torchkafka_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)  # before the draw: no CUDA fails fast
    cfg = TransformerConfig(
        vocab_size=int(model_spec["vocab_size"]),
        d_model=int(model_spec["d_model"]),
        n_layers=int(model_spec["n_layers"]),
        n_heads=int(model_spec["n_heads"]),
        n_kv_heads=int(model_spec["n_kv_heads"]),
        d_ff=int(model_spec["d_ff"]),
        max_seq_len=int(model_spec["max_seq_len"]),
        dtype=torch.float32,
        param_dtype=torch.float32,
    )
    gen = torch.Generator().manual_seed(int(model_spec.get("seed", 0)))
    params = init_params(gen, cfg, "cpu")
    return cfg, _params_to(params, dev)


def launch_counts(since: dict | None = None) -> dict:
    """This process's kernel launch counters (``ops.flash`` and
    ``ops.kvattn``), less ``since`` (an earlier reading, e.g. the one
    taken after warmup): what a worker's metrics dump reports, since its
    parent cannot read another process's counters."""
    from torchkafka_tpu_torch.ops import flash, kvattn

    out = {}
    for name, fn in (("flash_fwd", flash.flash_fwd_bhsd),
                     ("flash_dq", flash.flash_dq_bhsd),
                     ("flash_dkv", flash.flash_dkv_bhsd)):
        out[name] = fn.launches
        out[name + "_tc"] = fn.tc_launches
    for name, fn in (("kvattn_dynlen", kvattn.int8_decode_attention_dynlen),
                     ("kvattn_paged", kvattn.int8_paged_decode_attention)):
        out[name] = fn.launches
    return {k: v - (since or {}).get(k, 0) for k, v in out.items()}


class _TaggingProducer:
    """Wrap a producer so every output record carries a ``member`` header
    naming this incarnation — the supervisor's attribution handle. Every
    OTHER attribute (the transactional surface — begin/commit/abort/
    send_offsets/in_transaction — when the inner producer is a
    ``TransactionalProducer``) forwards untouched, so serve.py's
    exactly_once mode drives transactions straight through the tag."""

    def __init__(self, inner, member: str) -> None:
        self._inner = inner
        self._member = member.encode()

    def send(self, topic, value, *, key=None, partition=None,
             timestamp_ms=None, headers=()):
        return self._inner.send(
            topic, value, key=key, partition=partition,
            timestamp_ms=timestamp_ms,
            headers=tuple(headers) + (("member", self._member),),
        )

    def flush(self, timeout_s=None):
        return self._inner.flush(timeout_s)

    def close(self):
        return self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _dump_metrics(
    spec: dict, gen, fleet_metrics, exit_code: int, breaker=None, hb=None,
    warm_launches: dict | None = None, rollout=None,
) -> None:
    path = spec.get("metrics_path")
    if not path:
        return
    m = gen.metrics
    doc = {
        "member": spec["member_id"],
        "exit": exit_code,
        "decoded_tokens": m.decoded_tokens.count,
        "warm_resumes": m.warm_resumes.count,
        "tokens_restored": m.journal_tokens_restored.count,
        "served_from_journal": m.journal_served.count,
        "resume_rejected": m.resume_rejected.count,
        "completions": fleet_metrics.completions.count,
        "commit_failures": m.commit_failures.count,
        # Which weights this incarnation EXITED on — the rollout audit's
        # per-worker version attribution (journal meta is the durable twin).
        "model_version": gen.model_version,
        # Disaggregated decode: slots admitted by handoff adoption (no
        # prompt pass here) vs locally prefilled tokens, plus the tick
        # p50/p99 the "decode ITL never stalls" audit reads.
        "adopted_slots": m.adopted_slots.count,
        "prefill_routed": m.prefill_routed.count,
        "prefill_tokens": m.prefill_tokens.count,
        "step_p50_ms": m.tick_time.summary()["p50_ms"],
        "step_p99_ms": m.tick_time.summary()["p99_ms"],
        "circuit_opens": breaker.opens if breaker is not None else 0,
        "circuit_closes": breaker.closes if breaker is not None else 0,
        "heartbeat_outages": hb.outages if hb is not None else 0,
        # The port's own: the kernel launches since the ready marker, the
        # prefills K1 follows (layers x (prefills + warm resumes + canary
        # shadow prefills) on a dense pool), and the device served on.
        "prefills": m.prefills.count,
        "shadow_prefills": rollout.shadow_prefills if rollout is not None else 0,
        "launches": launch_counts(since=warm_launches),
        "device": str(gen._device),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def run_replica_worker(spec: dict, broker=None, shutdown=None) -> int:
    """One replica incarnation over ``broker`` (a ``BrokerClient`` built
    from the spec when None — the subprocess path; pass an
    ``InMemoryBroker`` directly for in-process recovery runs). Returns
    the process exit code: ``EXIT_CLEAN`` after a drain (idle-exit or
    SIGTERM via ``shutdown``), ``EXIT_FENCED`` when the broker evicted
    this member."""
    from torchkafka_tpu_torch.errors import (
        BrokerUnavailableError,
        FencedMemberError,
        ProducerFencedError,
    )
    from torchkafka_tpu_torch.fleet.metrics import FleetMetrics
    from torchkafka_tpu_torch.fleet.qos import AdmissionQueue, QoSConfig, TenantBuckets
    from torchkafka_tpu_torch.fleet.replica import Replica, SERVING
    from torchkafka_tpu_torch.journal import DecodeJournal
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import MemoryConsumer
    from torchkafka_tpu_torch.source.producer import MemoryProducer

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
    jdir = spec["journal_dir"]
    jpath = os.path.join(jdir, f"{member}.json")
    consumer = None
    gen = None
    journal = None
    hb = None
    breaker = None
    ho_consumer = None
    router = None
    rollout = None
    warm_launches = None
    metrics = FleetMetrics()
    exit_code = EXIT_CLEAN
    try:
        # Model first (slow: the draw and the copy to the device): the
        # lease clock must not run against it before we have even joined.
        cfg, params = build_model(spec["model"], spec.get("device"))
        from torchkafka_tpu_torch.utils import prng

        # Version restore: the journal's durable meta — flipped BEFORE the
        # in-memory rebind at every swap — is the restart authority. A
        # worker SIGKILL'd mid-rollout comes back here, reads the version
        # its previous life committed to, and rebuilds THOSE weights from
        # the checkpoint topic byte-identically before serving a single
        # token. A torn/unfetchable checkpoint falls back to the boot
        # weights: the version-tagged resume hints then reject (cold
        # replay — slower, still exactly-once), never a crash.
        boot_version = int(spec.get("model_version", 0))
        boot_params = params
        model_version = boot_version
        ckpt_topic = spec.get("ckpt_topic")
        if ckpt_topic:
            from torchkafka_tpu_torch.journal import DecodeJournal as _DJ

            journaled = _DJ.load_meta(jpath).get("model_version")
            if journaled is not None and int(journaled) != boot_version:
                from torchkafka_tpu_torch.errors import CheckpointWireError
                from torchkafka_tpu_torch.source.checkpoint_wire import (
                    fetch_checkpoint,
                    rebuild_tree,
                )

                try:
                    flat, _mf = fetch_checkpoint(
                        broker, ckpt_topic, int(journaled),
                    )
                    params = rebuild_tree(boot_params, flat)
                    model_version = int(journaled)
                except CheckpointWireError:
                    metrics.checkpoint_reject("restore").add(1)

        consumer = MemoryConsumer(
            broker, spec["topic"], group_id=spec["group"], member_id=member,
        )
        if spec.get("resilient"):
            # Broker-outage riding, made observable: poll/commit run
            # behind a RetryPolicy + CircuitBreaker (resilience/), so a
            # broker-process death mid-storm degrades to empty polls and
            # fast-failed (survivable) commits while the circuit is open,
            # then closes when the WAL-recovered broker answers again —
            # the open-then-close transition counters land in the metrics
            # dump for the supervisor's audit.
            from torchkafka_tpu_torch.resilience import (
                CircuitBreaker,
                ResilientConsumer,
                RetryPolicy,
            )
            from torchkafka_tpu_torch.utils.metrics import ResilienceMetrics

            breaker = CircuitBreaker(
                failure_threshold=int(spec.get("breaker_threshold", 3)),
                reset_timeout_s=float(spec.get("breaker_cooldown_s", 0.25)),
            )
            consumer = ResilientConsumer(
                consumer,
                policy=RetryPolicy(
                    max_attempts=2, base_delay_s=0.02, max_delay_s=0.2,
                    deadline_s=2.0,
                ),
                breaker=breaker,
                metrics=ResilienceMetrics(),
            )
        hb_interval = spec.get("heartbeat_interval_s", 0.25)
        # "thread" (default, Kafka's own split: session liveness on a
        # background sender, so warmup/tick stalls are SLOW, not dead) or
        # "loop" (renew once per pump — deterministic arrival counts, the
        # crash matrix's mode; pair it with a generous session timeout).
        hb_mode = spec.get("heartbeat_mode", "thread")
        if hb_interval is not None and hb_mode == "thread":
            hb = _HeartbeatSender(consumer, float(hb_interval))
            hb.start()
        exactly_once = bool(spec.get("exactly_once", False))
        if exactly_once:
            from torchkafka_tpu_torch.source.producer import TransactionalProducer

            # The transactional id is keyed by replica INDEX, not
            # incarnation: a respawned replacement re-initializes the
            # SAME id, which bumps the epoch — fencing the victim and
            # aborting whatever transaction its death left open. That
            # epoch bump IS the exactly-once handoff (the consumer-side
            # twin is the member-id range slot trick above).
            txn_id = spec.get(
                "transactional_id",
                f"{spec['group']}-r{int(spec.get('replica_index', 0)):03d}",
            )
            inner_producer = TransactionalProducer(broker, txn_id)
        else:
            inner_producer = MemoryProducer(broker)
        producer = _TaggingProducer(inner_producer, member)
        journal = DecodeJournal(
            jpath, cadence=int(spec.get("journal_cadence", 4)),
        )

        gen = StreamingGenerator(
            consumer, params, cfg,
            slots=int(spec.get("slots", 2)),
            prompt_len=int(spec["prompt_len"]),
            max_new=int(spec["max_new"]),
            eos_id=spec.get("eos_id"),
            # The worker loop owns the cadence (commit-follows-completion
            # via Replica.maybe_flush); the generator never self-commits.
            commit_every=2**31 - 1,
            ticks_per_sync=int(spec.get("ticks_per_sync", 1)),
            max_poll_records=int(spec.get("max_poll_records", 64)),
            temperature=float(spec.get("temperature", 0.0)),
            top_k=spec.get("top_k"),
            top_p=spec.get("top_p"),
            rng=prng.key(int(spec.get("sampling_seed", 0))),
            output_producer=producer,
            output_topic=spec["out_topic"],
            exactly_once=exactly_once,
            kv_pages=spec.get("kv_pages"),
            kv_tier=spec.get("kv_tier"),
            journal=journal,
            model_version=model_version,
            # Online distillation corpus: committed completions ride the
            # same commit window (exactly-once: same transaction) onto
            # the distill topic, so the trainer only ever sees tokens the
            # committed view holds.
            distill_topic=spec.get("distill_topic"),
            device=spec.get("device"),
        )
        # Disaggregated decode: tail the handoff topic (broadcast — one
        # private group per replica) into the generator's shelf, and
        # route admission through the PrefillRouter so records wait
        # (bounded) for their prefill worker's filled KV instead of
        # prefilling locally.
        handoff_topic = spec.get("handoff_topic")
        if handoff_topic:
            from torchkafka_tpu_torch.fleet.prefill import (
                PrefillRouter,
                drain_handoffs,
            )

            ho_consumer = MemoryConsumer(
                broker, handoff_topic,
                group_id=f"{spec['group']}-ho-{member}",
                member_id=member,
            )
            router = PrefillRouter(
                gen, patience=int(spec.get("route_patience", 256)),
            )
        # Cross-process warm failover, incarnation-start edition: every
        # journal a previous incarnation (own or peer) left in the shared
        # dir becomes a resume hint — CRC-gated at apply, so stale or
        # already-served entries sit harmlessly.
        hints = DecodeJournal.scan_dir(jdir, exclude=(jpath,))
        if hints:
            gen.add_resume_hints(hints)
        gen.warmup()
        warm_launches = launch_counts()
        if spec.get("ready_topic"):
            # Readiness marker: lets a supervisor (or a paired bench)
            # exclude per-process warmup from the measured window.
            MemoryProducer(broker).send(
                spec["ready_topic"], member.encode()
            )
        qos = QoSConfig()
        queue = AdmissionQueue(
            qos, TenantBuckets(qos), metrics,
            prefill_router=(
                router.should_hold if router is not None else None
            ),
        )
        rep = Replica(
            int(spec.get("replica_index", 0)), gen, consumer, queue, qos,
            metrics,
            commit_every=int(spec.get("commit_every", 8)),
            max_poll_records=int(spec.get("max_poll_records", 64)),
            # A survivor keeps its partitions through a peer's death, and
            # the rebalance fetches their queued records again: serve each
            # once, so a kill re-serves at most commit_every + slots here.
            drop_refetched=True,
        )
        if spec.get("rollout_topic") and ckpt_topic:
            from torchkafka_tpu_torch.fleet.rollout import RolloutWorker

            rollout = RolloutWorker(
                broker, spec["rollout_topic"], ckpt_topic, member, rep,
                boot_params=boot_params, boot_version=boot_version,
                metrics=metrics,
            )
            if model_version != boot_version:
                # The restored tree is this incarnation's incumbent —
                # a later rollback to it must not need the wire.
                rollout.cache(model_version, params)

        idle_exit_ms = spec.get("idle_exit_ms")
        last_assign: frozenset = frozenset()
        idle_since: float | None = None
        while True:
            now = time.monotonic()
            if shutdown is not None and shutdown.requested:
                if rep.state == SERVING:
                    rep.start_drain()
            if hb is not None and hb.fenced:
                # The broker already gave our partitions away: stop at
                # this safe point — serving on would be zombie work whose
                # commits are all doomed (and whose outputs survivors are
                # already regenerating byte-identically).
                raise FencedMemberError(
                    f"member {member!r} fenced (observed by heartbeat)"
                )
            if hb is not None and hb.error is not None:
                raise hb.error
            if breaker is not None and not breaker.allow():
                # Circuit open: the broker outage is declared. Stop
                # hammering a dead socket; in-flight decode state, the
                # journal, and the outbox keep. The cooldown's half-open
                # probe (the next allowed pump) decides recovery.
                time.sleep(0.02)
                continue
            try:
                if hb is None and hb_interval is not None:
                    consumer.heartbeat()  # loop mode: one renewal per pump
                if ho_consumer is not None:
                    drain_handoffs(ho_consumer, gen)
                assigned = frozenset(consumer.assignment())
                if assigned != last_assign:
                    if assigned - last_assign:
                        # Gained partitions: a peer died or the fleet
                        # rescaled. Its journal, read FROM DISK across the
                        # process boundary, is the warm-failover handoff.
                        fresh = DecodeJournal.scan_dir(jdir, exclude=(jpath,))
                        if fresh:
                            gen.add_resume_hints(fresh)
                    last_assign = assigned
                completions = rep.pump()
                rep.maybe_flush()
                if rollout is not None:
                    # One rollout-plane sweep per pump: control-topic
                    # directives in, canary comparisons over this pump's
                    # completions, a pending drain-swap completed the
                    # moment the replica quiesces.
                    rollout.pump(completions)
            except BrokerUnavailableError:
                # The broker is DOWN past the client's retry budget (a
                # broker-process death; the supervisor is restarting it
                # from the WAL). Ride the outage: commits stay pending
                # and the next pump retries — a recovered broker restores
                # this member's lease and generation, so serving resumes
                # with zero lost records. The breaker counts the outage
                # evidence (open-then-close lands in the metrics dump).
                if breaker is not None:
                    breaker.record_failure()
                time.sleep(0.02)
                continue
            if breaker is not None:
                breaker.record_success()
            if rep.drain_idle:
                rep.finish_drain()
                return EXIT_CLEAN
            if completions or gen.has_active() or queue.depth():
                idle_since = None
            elif rep.state == SERVING and not rep.admission_paused:
                # A quiesced-for-swap replica is WORKING (the swap lands
                # on the next pump), not idle — never idle-exit it.
                if idle_since is None:
                    idle_since = now
                    # Going idle: commit the completions the cadence has
                    # not reached yet. Without this they wait for more
                    # completions that may never come, and the group's
                    # watermark stalls short of the end (a supervisor's
                    # fully_committed wait then times out).
                    rep.maybe_flush(force=True)
                elif (
                    idle_exit_ms is not None
                    and (now - idle_since) * 1e3 >= idle_exit_ms
                ):
                    rep.start_drain()
                    continue
                time.sleep(0.002)
    except (FencedMemberError, ProducerFencedError):
        exit_code = EXIT_FENCED
        # Best-effort journal flush: we are a zombie for the GROUP, but
        # our disk state is still the freshest record of the in-flight
        # work survivors are about to redo — a current journal shrinks
        # their re-decode (CRC/identity gating keeps stale entries inert).
        try:
            if gen is not None:
                gen.sync_journal()
        except Exception:  # noqa: BLE001 - fenced exit must not mask
            pass
        return EXIT_FENCED
    finally:
        if hb is not None:
            hb.stop()
        if gen is not None:
            _dump_metrics(spec, gen, metrics, exit_code, breaker=breaker,
                          hb=hb, warm_launches=warm_launches, rollout=rollout)
        if journal is not None:
            try:
                journal.close()  # flush + release the single-writer lock
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        if ho_consumer is not None:
            try:
                ho_consumer.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        if consumer is not None:
            try:
                consumer.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        if own_client:
            try:
                broker.close()
            except Exception:  # noqa: BLE001
                pass


def main(argv: list[str]) -> int:
    spec_path = argv[1]
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    # SIGUSR1 → all-thread stack dump on stderr (the worker log): the
    # supervisor-side diagnosis tool for a wedged-but-alive replica.
    import faulthandler
    import signal as _signal

    faulthandler.register(_signal.SIGUSR1)
    from torchkafka_tpu_torch.resilience.crashpoint import arm_from_env
    from torchkafka_tpu_torch.utils.shutdown import ShutdownSignal

    arm_from_env()
    with ShutdownSignal() as stop:
        if spec.get("role") == "prefill":
            from torchkafka_tpu_torch.fleet.prefill import run_prefill_worker

            return run_prefill_worker(spec, shutdown=stop)
        if spec.get("role") == "distill":
            from torchkafka_tpu_torch.distill.worker import run_distill_worker

            return run_distill_worker(spec, shutdown=stop)
        return run_replica_worker(spec, shutdown=stop)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
