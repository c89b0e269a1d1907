"""Multi-process pod training on the PyTorch/CUDA port: N ranks, one script.

Every rank runs the SAME program: its own consumer over disjoint
partitions, rank-local batches wrapped into global sharded batches
(``KafkaStream(mesh=)``), the data-parallel train step (K1 forward, K2/K3
backward on each rank's rows, gradients summed across ranks), and the
commit barrier guaranteeing offsets commit only after the step retired on
every rank (the replacement for the reference's signal-based cross-process
commit protocol, /root/reference/src/auto_commit.py:59-72).

Two ways to run it:

  # Self-spawned local pod (on the card by default; ranks share it):
  python examples/pod_train_torch.py --spawn 2 --steps 20
  python examples/pod_train_torch.py --spawn 2 --steps 4 --device cpu

  # Under torch.distributed.run, one copy per rank (its environment gives
  # the ranks and the store):
  python -m torch.distributed.run --nproc-per-node 2 examples/pod_train_torch.py

``parallel.multihost.initialize`` places rank r on ``cuda:r`` (the cards
in turn when ranks outnumber them) and picks gloo when ranks share a card.
Swap ``make_consumer`` for ``tk.KafkaConsumer(...)`` against a real
cluster; the partition assignment via ``tk.partitions_for_process`` stays
the same.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo checkout

TOPIC = "events"
N_PARTS = 8
SEQ = 32
VOCAB = 1024
RECORDS = 4096


def build_broker(tk):
    """Deterministic stand-in for a shared Kafka cluster: every rank builds
    identical content (same seed), so their disjoint partition views
    compose exactly like one real broker's would."""
    import numpy as np

    broker = tk.InMemoryBroker()
    broker.create_topic(TOPIC, partitions=N_PARTS)
    rng = np.random.default_rng(0)
    for i in range(RECORDS):
        toks = rng.integers(0, VOCAB, SEQ, dtype=np.int32)
        broker.produce(TOPIC, toks.tobytes(), partition=i % N_PARTS)
    return broker


def make_consumer(tk, broker, index: int, count: int):
    return tk.MemoryConsumer(
        broker, TOPIC, group_id="pod-trainer",
        assignment=tk.partitions_for_process(TOPIC, N_PARTS, index, count),
    )


def train(args) -> None:
    import numpy as np
    import torch

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models import TransformerConfig, make_train_step
    from torchkafka_tpu_torch.parallel import collectives, multihost

    if args.coordinator:  # self-spawned worker: join the local pod
        multihost.initialize(args.coordinator, args.nproc, args.pid, device=args.device)
    else:
        multihost.initialize(device=args.device)
    pid, nproc = tk.parallel.process_index(), tk.parallel.process_count()
    mesh = tk.make_mesh({"data": nproc}, device=args.device)
    dev = multihost.ensure_group(args.device)
    cfg = TransformerConfig(
        vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=SEQ,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
    )
    init_fn, step_fn = make_train_step(cfg, mesh, tk.adamw(1e-3), device=dev)
    params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(0))
    if pid == 0:
        print(f"rules: {multihost.rules()}", flush=True)

    broker = build_broker(tk)
    consumer = make_consumer(tk, broker, pid, nproc)
    local_batch = args.batch  # rows THIS rank contributes per step
    step = 0
    with tk.ShutdownSignal() as stop, tk.KafkaStream(
        consumer, tk.fixed_width(SEQ, np.int32), batch_size=local_batch,
        mesh=mesh, idle_timeout_ms=2000, device=dev,
    ) as stream:
        for batch, token in stream:
            params, opt_state, loss = step_fn(params, opt_state, batch.data, None)
            # The barrier inside: offsets commit only after every rank
            # retired this step (all ranks or none).
            token.commit(wait_for=loss)
            if pid == 0 and step % 5 == 0:
                print(f"step {step}  loss {float(loss):.4f}", flush=True)
            step += 1
            if step >= args.steps:
                break
            # Draining must be a GLOBAL decision: a preemption signals
            # every rank, but the notices land at slightly different
            # moments; a rank that drained alone would leave the rest
            # wedged in the next collective. Sum the flags (on the
            # barrier's gloo group) so every rank breaks at the same step.
            flag = torch.tensor([float(stop.requested)])
            if nproc > 1:
                collectives.all_reduce_(flag, multihost.barrier_group())
            if flag.item() > 0:
                if pid == 0:
                    print(f"preempted: pod drained cleanly at step {step}", flush=True)
                break
    committed = sum(broker.committed("pod-trainer", tp) or 0
                    for tp in tk.partitions_for_process(TOPIC, N_PARTS, pid, nproc))
    print(f"rank {pid}: {step} steps, offsets: committed={committed} "
          f"end={RECORDS // nproc}", flush=True)
    if pid == 0:
        print(f"done: {step} steps, metrics: {stream.metrics.summary()}", flush=True)
    consumer.close()
    multihost.shutdown()


def spawn(args) -> int:
    """Start N copies of this script as a localhost pod and wait."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.spawn):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--coordinator", f"127.0.0.1:{port}", "--nproc", str(args.spawn),
               "--pid", str(pid), "--steps", str(args.steps), "--batch", str(args.batch)]
        if args.device:
            cmd += ["--device", args.device]
        procs.append(subprocess.Popen(cmd))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"pod failed: exit codes {codes}")
    print(f"pod of {args.spawn} processes completed cleanly", flush=True)
    return 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="start a local pod of this many processes")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8, help="rank-local rows per step")
    ap.add_argument("--device", default=None,
                    help="cpu for every rank; default: the device rule over the cards")
    ap.add_argument("--coordinator", default="",
                    help="(internal) host:port of rank 0's store")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    args = ap.parse_args()
    if args.spawn:
        spawn(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
