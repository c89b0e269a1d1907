"""End-to-end example on the PyTorch/CUDA port: continuous-batching
serving from a prompt topic.

Prompts stream in from Kafka; a fixed pool of decode slots generates
continuations, admitting a new prompt the moment a slot finishes (EOS or
length), and each prompt's offset commits only after ITS generation
completed. Completions are produced to an output topic before the prompts
that made them commit.

    python examples/serve_prompts_torch.py --prompts 64 --slots 8 --max-new 32
    python examples/serve_prompts_torch.py --device cpu --prompts 8
    python examples/serve_prompts_torch.py --tp 2 --device cpu --prompts 8

Swap the broker for ``tk.KafkaConsumer(...)`` to point at a real cluster.
``--tp N`` serves model-sharded over a {"tp": N} mesh of N ranks started
here as a localhost pod (as ``examples/ctr_train_torch.py --processes``
does; ranks sharing a card run gloo): rank 0 owns the broker, the consumer
and the producer, the other ranks pass ``consumer=None`` and serve the
same records. The JAX example's ``--cpu-devices`` (virtual XLA devices)
has no counterpart here: the port's mesh positions are processes.
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


def serve(args) -> int:
    from torchkafka_tpu_torch.parallel import multihost

    pod = args.nproc > 1
    mesh = None
    if pod:  # a spawned rank: join the local pod, one rank a tp position
        multihost.initialize(args.coordinator, args.nproc, args.pid, device=args.device)
        dev = multihost.ensure_group(args.device)
        if dev.type == "cpu":
            # The ranks share the host's cores; at these widths one
            # thread a rank serves fastest (more spin against each other).
            torch.set_num_threads(1)
        mesh = tk.make_mesh({"tp": args.nproc}, device=args.device)
    else:
        dev = resolve_device(args.device)
    root = args.pid == 0

    broker = consumer = producer = None
    if root:  # the root alone owns the broker, the consumer and the producer
        broker = tk.InMemoryBroker()
        broker.create_topic(TOPIC, partitions=2)
        broker.create_topic("completions", partitions=2)
        rng = np.random.default_rng(0)
        for i in range(args.prompts):
            broker.produce(
                TOPIC, rng.integers(0, VOCAB, PROMPT_LEN, dtype=np.int32).tobytes(),
                partition=i % 2,
            )
        consumer = tk.MemoryConsumer(broker, TOPIC, group_id="serve-demo")
        producer = tk.MemoryProducer(broker)

    cfg = TransformerConfig(
        vocab_size=VOCAB, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=PROMPT_LEN + args.max_new,
    )
    # The same weights on every rank (one seed); under --tp each rank
    # keeps its heads, d_ff columns and vocabulary rows of them.
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    with StreamingGenerator(
        consumer, params, cfg,
        slots=args.slots, prompt_len=PROMPT_LEN, max_new=args.max_new,
        eos_id=args.eos, commit_every=args.slots,
        # consume→generate→produce: completions become durable on their
        # topic BEFORE the prompts that produced them commit.
        output_producer=producer, output_topic="completions", mesh=mesh, device=dev,
    ) as server:  # exit commits completed work (crash semantics unchanged)
        print(f"warming up ({args.slots} slots)...", file=sys.stderr)
        server.warmup()

        t0 = time.perf_counter()
        toks = 0
        for i, (rec, out) in enumerate(server.run(max_records=args.prompts)):
            toks += len(out)
            if root:
                print(
                    f"#{i:3d} {rec.topic}@{rec.partition}:{rec.offset} -> {len(out)} "
                    f"tokens: {out[:8].tolist()}{'...' if len(out) > 8 else ''}"
                )
        dt = time.perf_counter() - t0
    if not root:
        print(f"rank {args.pid}: served {toks} tokens", flush=True)
        multihost.shutdown()
        return 0
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
    prefix = f"rank 0: served {toks} tokens " if pod else ""
    print(f"{prefix}offsets: committed={committed} end={end} published={published}",
          flush=True)
    if pod:
        multihost.shutdown()
    return 0


def spawn(args) -> int:
    """Start ``--tp`` copies of this script as a localhost pod and wait."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.tp):
        cmd = [sys.executable, os.path.abspath(__file__), "--coordinator",
               f"127.0.0.1:{port}", "--nproc", str(args.tp), "--pid", str(pid),
               "--prompts", str(args.prompts), "--slots", str(args.slots),
               "--max-new", str(args.max_new)]
        if args.eos is not None:
            cmd += ["--eos", str(args.eos)]
        if args.device:
            cmd += ["--device", args.device]
        procs.append(subprocess.Popen(cmd))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"pod failed: exit codes {codes}")
    print(f"pod of {args.tp} processes completed cleanly", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--eos", type=int, default=None,
                    help="optional EOS token id (slots recycle early)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-sharded serving over a {'tp': N} mesh of N ranks, "
                    "started here as a localhost pod (1: this process)")
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="the JAX example's virtual XLA devices; no counterpart "
                    "here (the port's mesh positions are processes: use --tp)")
    ap.add_argument("--device", default=None,
                    help="where to serve (e.g. cpu); default: the CUDA card")
    ap.add_argument("--coordinator", default="", help="(internal) host:port of rank 0's store")
    ap.add_argument("--nproc", type=int, default=1, help="(internal) ranks of the pod")
    ap.add_argument("--pid", type=int, default=0, help="(internal) this rank")
    args = ap.parse_args()
    if args.cpu_devices:
        raise ValueError(
            "--cpu-devices has no counterpart in the port: a mesh position is a "
            "process, so serve on a mesh with --tp N (N ranks)"
        )
    if args.tp > 1:
        return spawn(args)
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
