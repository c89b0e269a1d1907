"""End-to-end example on the PyTorch/CUDA port: Kafka-streamed training
with commit-after-step and checkpoint/resume of a transformer.

Runs on the in-memory broker, on the card by default or on the CPU:

    python examples/train_stream_torch.py --steps 50 --ckpt /tmp/tk-ckpt
    python examples/train_stream_torch.py --device cpu --steps 4 --batch 4

Swap ``make_consumer`` for ``tk.KafkaConsumer(...)`` to point at a real
cluster. Kill it anywhere; rerun with the same --ckpt and it resumes from
the last checkpoint with the stream seeked to exactly the matching
offsets. One device; ``examples/pod_train_torch.py`` trains across processes.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo checkout

import numpy as np
import torch

import torchkafka_tpu_torch as tk
from torchkafka_tpu_torch.models import TransformerConfig, make_train_step
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_leaves

TOPIC = "tokens"
N_PARTS = 8
SEQ = 128
VOCAB = 8192


def make_broker(n_records: int) -> tk.InMemoryBroker:
    """Stand-in for a real Kafka cluster: one topic of token records."""
    broker = tk.InMemoryBroker()
    broker.create_topic(TOPIC, partitions=N_PARTS)
    rng = np.random.default_rng(0)
    broker.produce_many(
        TOPIC,
        (rng.integers(0, VOCAB, SEQ, dtype=np.int32).tobytes() for _ in range(n_records)),
    )
    return broker


def make_consumer(broker: tk.InMemoryBroker) -> tk.MemoryConsumer:
    # Static assignment: this process owns every partition (one process).
    return tk.MemoryConsumer(
        broker, TOPIC, group_id="example-trainer",
        assignment=tk.partitions_for_process(TOPIC, N_PARTS, 0, 1),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt", default="/tmp/tk-example-ckpt-torch")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--records", type=int, default=None,
                    help="records on the topic (default: twice what --steps uses)")
    ap.add_argument("--device", default=None,
                    help="where to train (e.g. cpu); default: the CUDA card")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=VOCAB, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
        d_ff=704, max_seq_len=SEQ,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
    )
    optimizer = tk.adamw(3e-4)
    init_fn, step_fn = make_train_step(cfg, None, optimizer, device=dev)

    n_records = args.records or args.steps * args.batch * 2
    broker = make_broker(n_records)
    consumer = make_consumer(broker)
    ckpt = tk.StreamCheckpointer(args.ckpt)

    params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(0))
    if ckpt.latest_step() is not None:
        # Resume: weights, optimizer moments AND stream position as one unit.
        state, start = ckpt.resume(consumer)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(state["params"])):
                dst.copy_(src)
        opt_state.optimizer.load_state_dict(state["opt"])
        start += 1
        print(f"resumed at step {start}")
    else:
        start = 0

    try:
        with tk.ShutdownSignal() as stop, tk.KafkaStream(
            consumer, tk.fixed_width(SEQ, np.int32), batch_size=args.batch,
            idle_timeout_ms=2000, owns_consumer=True, device=dev,
        ) as stream:
            step = start
            fut = None
            for batch, token in stream:
                mask = torch.as_tensor(batch.valid_mask()[:, None], device=dev)
                mask = mask.expand(batch.data.shape).to(torch.int32)
                params, opt_state, loss = step_fn(params, opt_state, batch.data, mask)
                # Pipelined commit-after-step: offsets become durable only
                # once this step's loss is complete on the device.
                fut = token.commit_async(wait_for=loss)
                if step % 10 == 0:
                    print(f"step {step}  loss {float(loss):.4f}")
                draining = stop.requested
                at_ckpt = step and step % args.ckpt_every == 0
                if at_ckpt or draining:
                    fut.result()  # offsets for this state are durable
                    ckpt.save_async(
                        step, {"params": params, "opt": opt_state.optimizer.state_dict()},
                        token.offsets,
                    )
                    print(f"checkpoint @ step {step} (async)")
                if draining:
                    print(f"preempted: drained cleanly at step {step}")
                    break
                step += 1
                if step - start >= args.steps:
                    break
            if fut is not None:
                fut.result()
    finally:
        ckpt.wait_until_finished()
    committed = sum(broker.committed("example-trainer", tk.TopicPartition(TOPIC, p)) or 0
                    for p in range(N_PARTS))
    end = sum(broker.end_offset(tk.TopicPartition(TOPIC, p)) for p in range(N_PARTS))
    print(f"done at step {step}; metrics: {stream.metrics.summary()}")
    print(f"offsets: committed={committed} end={end}")


if __name__ == "__main__":
    main()
