"""Streaming CTR on the PyTorch/CUDA port: train a DLRM-style recommender
straight off a Kafka topic.

Click events (label, dense features, hashed categorical ids) stream in;
offsets commit only after the step that consumed each batch retires
(at-least-once, zero loss on crash).

    python examples/ctr_train_torch.py --steps 40 --batch 1024
    python examples/ctr_train_torch.py --device cpu --steps 10 --batch 64

Swap the broker for ``tk.KafkaConsumer(...)`` against a real cluster; the
record layout is ``models.recsys.parse_record``'s. One device: the JAX
package's row-sharded tables over a ``tp`` mesh are not ported, so
``--processes`` above 1 raises.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo checkout

import numpy as np
import torch

import torchkafka_tpu_torch as tk
from torchkafka_tpu_torch.models.recsys import (
    DLRMConfig,
    count_params,
    make_chunk_processor,
    make_dlrm_train_step,
)
from torchkafka_tpu_torch.utils.devices import resolve_device

N_PARTS = 8


def make_broker(cfg: DLRMConfig, n_records: int) -> tk.InMemoryBroker:
    """Synthetic click stream with a learnable rule (so loss visibly
    drops): label = f(dense sum, first categorical's parity)."""
    broker = tk.InMemoryBroker()
    broker.create_topic("clicks", partitions=N_PARTS)
    rng = np.random.default_rng(0)
    highs = np.asarray(cfg.vocab_sizes)

    def records():
        for _ in range(n_records):
            dense = rng.normal(size=cfg.dense_dim).astype(np.float32)
            cats = rng.integers(0, highs, dtype=np.int32)  # one call, [C]
            label = np.float32(dense.sum() + (cats[0] % 2) > 0.5)
            yield label.tobytes() + dense.tobytes() + cats.tobytes()

    broker.produce_many("clicks", records())
    return broker


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--processes", type=int, default=1,
                    help="processes of a pod (not ported: > 1 raises)")
    ap.add_argument("--device", default=None,
                    help="where to train (e.g. cpu); default: the CUDA card")
    args = ap.parse_args()
    if args.processes > 1:
        raise NotImplementedError(
            f"--processes {args.processes} is not ported yet (ROADMAP queue A: "
            "Pipeline and expert parallelism)"
        )
    dev = resolve_device(args.device)
    cfg = DLRMConfig()  # 8 tables x 100k x 64: the tables are the bytes

    broker = make_broker(cfg, args.steps * args.batch)
    consumer = tk.MemoryConsumer(
        broker, "clicks", group_id="ctr-trainer",
        assignment=tk.partitions_for_process("clicks", N_PARTS, 0, 1),
    )
    init_fn, step_fn = make_dlrm_train_step(cfg, None, tk.adam(1e-2), device=dev)
    params, opt = init_fn(torch.Generator(device=dev).manual_seed(0))
    print(f"DLRM {count_params(params) / 1e6:.1f}M params, mesh {{'data': 1}}, {dev}")

    with tk.KafkaStream(
        consumer, make_chunk_processor(cfg), batch_size=args.batch,
        idle_timeout_ms=2000, owns_consumer=True, device=dev,
    ) as stream:
        step = 0
        for batch, token in stream:
            mask = torch.as_tensor(batch.valid_mask(), dtype=torch.float32, device=dev)
            params, opt, loss = step_fn(
                params, opt, batch.data["dense"], batch.data["cats"],
                batch.data["label"], mask,
            )
            token.commit(wait_for=loss)
            if step % 5 == 0:
                print(f"step {step}  loss {float(loss):.4f}")
            step += 1
            if step >= args.steps:
                break
    committed = sum(broker.committed("ctr-trainer", tk.TopicPartition("clicks", p)) or 0
                    for p in range(N_PARTS))
    end = sum(broker.end_offset(tk.TopicPartition("clicks", p)) for p in range(N_PARTS))
    print(f"done: {step} steps; metrics: {stream.metrics.summary()}")
    print(f"offsets: committed={committed} end={end}")


if __name__ == "__main__":
    main()
