"""run_distill_worker — the DistillTrainer as a real fleet process.
Port of ``torchkafka_tpu/distill/worker.py``: the trainer runs on the
spec's ``device`` (CUDA when absent, raising without it), and its metrics
dump carries the process's kernel launch counts.

The ``role: "distill"`` sibling of ``fleet.proc.run_replica_worker``
and ``fleet.prefill.run_prefill_worker``: its own BrokerClient, its own
consumer group ``<group>-distill`` over the distill topic (heartbeat-
leased there — the supervisor's lease sweep fences and respawns it like
any other worker), training the layer-truncated draft on the committed
corpus and publishing versioned draft checkpoints the serving fleet's
DistillController picks up. Training is pumped in bounded step chunks
so fence/shutdown checks interleave with the training loop.

Crash discipline: the corpus group is at-least-once (offsets commit
after each step; a re-delivered record is one more gradient sample), a
death at ``distill_pre_publish`` loses at most ``publish_every`` steps
and never a committed token, and a torn checkpoint publish is rejected
by the fetch-side CRC — all three SIGKILL-matrixed.
"""

from __future__ import annotations

import json
import time


def run_distill_worker(spec: dict, broker=None, shutdown=None) -> int:
    from torchkafka_tpu_torch.distill.trainer import DistillTrainer
    from torchkafka_tpu_torch.errors import (
        BrokerUnavailableError,
        FencedMemberError,
    )
    from torchkafka_tpu_torch.fleet.proc import (
        _HeartbeatSender,
        build_model,
        launch_counts,
    )
    from torchkafka_tpu_torch.serve import ServeMetrics
    from torchkafka_tpu_torch.source.memory import MemoryConsumer

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
    trainer = None
    metrics = ServeMetrics()
    try:
        cfg, params = build_model(spec["model"], spec.get("device"))
        group = f"{spec['group']}-distill"
        consumer = MemoryConsumer(
            broker, spec["distill_topic"], group_id=group, member_id=member,
        )
        hb_interval = spec.get("heartbeat_interval_s", 0.25)
        if hb_interval is not None and spec.get(
            "heartbeat_mode", "thread"
        ) == "thread":
            hb = _HeartbeatSender(consumer, float(hb_interval))
            hb.start()
        trainer = DistillTrainer(
            consumer, params, cfg,
            seq_len=int(
                spec.get("distill_seq_len")
                or int(spec["prompt_len"]) + int(spec["max_new"])
            ),
            batch_size=int(spec.get("distill_batch", 8)),
            draft_layers=spec.get("draft_layers"),
            learning_rate=float(spec.get("distill_lr", 1e-3)),
            broker=broker,
            ckpt_topic=spec.get("ckpt_topic"),
            publish_every=int(spec.get("publish_every", 0)),
            base_version=int(spec.get("draft_base_version", 0)),
            metrics=metrics,
        )
        if spec.get("ready_topic"):
            from torchkafka_tpu_torch.source.producer import MemoryProducer

            MemoryProducer(broker).send(
                spec["ready_topic"], member.encode()
            )
        idle_exit_ms = spec.get("idle_exit_ms")
        chunk = int(spec.get("distill_chunk_steps", 4))
        idle_since = None
        while True:
            if shutdown is not None and shutdown.requested:
                return EXIT_CLEAN
            if hb is not None and hb.fenced:
                raise FencedMemberError(f"distill member {member!r} fenced")
            if hb is not None and hb.error is not None:
                raise hb.error
            before = trainer.steps
            try:
                if hb is None and hb_interval is not None:
                    consumer.heartbeat()
                trainer.run(max_steps=chunk, idle_timeout_ms=100)
            except BrokerUnavailableError:
                time.sleep(0.02)
                continue
            if trainer.steps > before:
                idle_since = None
            else:
                now = time.monotonic()
                if idle_since is None:
                    idle_since = now
                elif (
                    idle_exit_ms is not None
                    and (now - idle_since) * 1e3 >= idle_exit_ms
                ):
                    return EXIT_CLEAN
                time.sleep(0.002)
    except FencedMemberError:
        return EXIT_FENCED
    finally:
        if hb is not None:
            hb.stop()
        if trainer is not None and spec.get("metrics_path"):
            try:
                doc = {
                    "member": member,
                    "role": "distill",
                    **trainer.report(),
                    "launches": launch_counts(),
                    "device": str(trainer._device),
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
