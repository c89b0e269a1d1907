"""End-to-end example on the PyTorch/CUDA port: continuous-batching
serving from a prompt topic.

Prompts stream in from Kafka; a fixed pool of decode slots generates
continuations, admitting a new prompt the moment a slot finishes (EOS or
length), and each prompt's offset commits only after ITS generation
completed. Completions are produced to an output topic before the prompts
that made them commit.

    python examples/serve_prompts_torch.py --prompts 64 --slots 8 --max-new 32
    python examples/serve_prompts_torch.py --device cpu --prompts 8

Swap the broker for ``tk.KafkaConsumer(...)`` to point at a real cluster.
One device: ``--tp`` (model-sharded serving) and ``--cpu-devices`` (a
virtual device mesh) belong to the mesh paths, which are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo checkout

import numpy as np
import torch

import torchkafka_tpu_torch as tk
from torchkafka_tpu_torch.models import TransformerConfig
from torchkafka_tpu_torch.models.transformer import init_params
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.utils.devices import resolve_device

TOPIC = "prompts"
PROMPT_LEN = 32
VOCAB = 2048
MESH_NOT_PORTED = "is not ported yet (ROADMAP queue A: Sharded serving)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--eos", type=int, default=None,
                    help="optional EOS token id (slots recycle early)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-sharded serving over a tp axis (not ported: > 1 raises)")
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="a virtual device mesh (not ported: raises)")
    ap.add_argument("--device", default=None,
                    help="where to serve (e.g. cpu); default: the CUDA card")
    args = ap.parse_args()
    if args.tp > 1:
        raise NotImplementedError(f"--tp {args.tp} {MESH_NOT_PORTED}")
    if args.cpu_devices:
        raise NotImplementedError(f"--cpu-devices {MESH_NOT_PORTED}")
    dev = resolve_device(args.device)

    broker = tk.InMemoryBroker()
    broker.create_topic(TOPIC, partitions=2)
    broker.create_topic("completions", partitions=2)
    rng = np.random.default_rng(0)
    for i in range(args.prompts):
        broker.produce(
            TOPIC, rng.integers(0, VOCAB, PROMPT_LEN, dtype=np.int32).tobytes(),
            partition=i % 2,
        )

    cfg = TransformerConfig(
        vocab_size=VOCAB, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=PROMPT_LEN + args.max_new,
    )
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    consumer = tk.MemoryConsumer(broker, TOPIC, group_id="serve-demo")
    producer = tk.MemoryProducer(broker)
    with StreamingGenerator(
        consumer, params, cfg,
        slots=args.slots, prompt_len=PROMPT_LEN, max_new=args.max_new,
        eos_id=args.eos, commit_every=args.slots,
        # consume→generate→produce: completions become durable on their
        # topic BEFORE the prompts that produced them commit.
        output_producer=producer, output_topic="completions", device=dev,
    ) as server:  # exit commits completed work (crash semantics unchanged)
        print(f"warming up ({args.slots} slots)...", file=sys.stderr)
        server.warmup()

        t0 = time.perf_counter()
        toks = 0
        for i, (rec, out) in enumerate(server.run(max_records=args.prompts)):
            toks += len(out)
            print(
                f"#{i:3d} {rec.topic}@{rec.partition}:{rec.offset} "
                f"-> {len(out)} tokens: {out[:8].tolist()}{'...' if len(out) > 8 else ''}"
            )
        dt = time.perf_counter() - t0
    committed = sum(
        broker.committed("serve-demo", tk.TopicPartition(TOPIC, p)) or 0 for p in (0, 1)
    )
    end = sum(broker.end_offset(tk.TopicPartition(TOPIC, p)) for p in (0, 1))
    out_c = tk.MemoryConsumer(broker, "completions", group_id="audit")
    published = len(out_c.poll(max_records=10_000, timeout_ms=200))
    out_c.close()
    print(
        f"\n{args.prompts} completions, {toks} tokens in {dt:.2f}s "
        f"({toks / dt:,.0f} tok/s); {committed} offsets committed; "
        f"{published} completions on the output topic\n"
        f"metrics: {server.metrics.summary()}",
        file=sys.stderr,
    )
    consumer.close()
    print(f"offsets: committed={committed} end={end} published={published}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
