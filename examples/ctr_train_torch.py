"""Streaming CTR on the PyTorch/CUDA port: train a DLRM-style recommender
straight off a Kafka topic.

Click events (label, dense features, hashed categorical ids) stream in;
offsets commit only after the step that consumed each batch retires
(at-least-once, zero loss on crash).

    python examples/ctr_train_torch.py --steps 40 --batch 1024
    python examples/ctr_train_torch.py --device cpu --steps 10 --batch 64
    # A local pod: N ranks on a {"data": N/tp, "tp": tp} mesh (tp = 2 for
    # an even N), the tables row-sharded over tp, each data index consuming
    # its own partitions (tp peers read the same ones):
    python examples/ctr_train_torch.py --processes 2 --device cpu --steps 4 --batch 16

Swap the broker for ``tk.KafkaConsumer(...)`` against a real cluster; the
record layout is ``models.recsys.parse_record``'s. ``--processes`` starts
the ranks the way ``examples/pod_train_torch.py --spawn`` does;
``parallel.multihost.initialize`` places them (ranks sharing a card run
under gloo).
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


def train(args) -> None:
    from torchkafka_tpu_torch.parallel import multihost

    pod = args.nproc > 1
    if pod:  # a spawned rank: join the local pod
        multihost.initialize(args.coordinator, args.nproc, args.pid, device=args.device)
        dev = multihost.ensure_group(args.device)
    else:
        dev = resolve_device(args.device)
    tp = 2 if args.nproc % 2 == 0 else 1
    n_data = args.nproc // tp
    mesh = tk.make_mesh({"data": n_data, "tp": tp}, device=args.device) if pod else None
    data_index = args.pid // tp  # the mesh lays data out first
    cfg = DLRMConfig()  # 8 tables x 100k x 64: the tables are the bytes

    # Each data index consumes its stride of partitions, so the topic needs
    # steps*batch records per data index for every rank to reach --steps.
    broker = make_broker(cfg, args.steps * args.batch * n_data)
    parts = tk.partitions_for_process("clicks", N_PARTS, data_index, n_data)
    consumer = tk.MemoryConsumer(broker, "clicks", group_id="ctr-trainer", assignment=parts)
    init_fn, step_fn = make_dlrm_train_step(cfg, mesh, tk.adam(1e-2), device=dev)
    params, opt = init_fn(torch.Generator(device=dev).manual_seed(0))
    if args.pid == 0:
        print(f"DLRM {count_params(params) / 1e6:.1f}M params, "
              f"mesh {{'data': {n_data}, 'tp': {tp}}}, {dev}", flush=True)

    with tk.KafkaStream(
        consumer, make_chunk_processor(cfg), batch_size=args.batch,
        idle_timeout_ms=2000, owns_consumer=True, device=dev, mesh=mesh,
    ) as stream:
        step = 0
        for batch, token in stream:
            mask = batch.valid_mask().astype(np.float32)
            params, opt, loss = step_fn(
                params, opt, batch.data["dense"], batch.data["cats"],
                batch.data["label"], mask,
            )
            token.commit(wait_for=loss)
            if args.pid == 0 and step % 5 == 0:
                print(f"step {step}  loss {float(loss):.4f}", flush=True)
            step += 1
            if step >= args.steps:
                break
    committed = sum(broker.committed("ctr-trainer", p) or 0 for p in parts)
    end = sum(broker.end_offset(p) for p in parts)
    if args.pid == 0:
        print(f"done: {step} steps; metrics: {stream.metrics.summary()}", flush=True)
    prefix = f"rank {args.pid}: trained={step * args.batch} " if pod else ""
    print(f"{prefix}offsets: committed={committed} end={end}", flush=True)
    if pod:
        multihost.shutdown()


def spawn(args) -> None:
    """Start ``--processes`` copies of this script as a localhost pod and
    wait for them."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.processes):
        cmd = [sys.executable, os.path.abspath(__file__), "--coordinator",
               f"127.0.0.1:{port}", "--nproc", str(args.processes), "--pid", str(pid),
               "--steps", str(args.steps), "--batch", str(args.batch)]
        if args.device:
            cmd += ["--device", args.device]
        procs.append(subprocess.Popen(cmd))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"pod failed: exit codes {codes}")
    print(f"pod of {args.processes} processes completed cleanly", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024, help="rows a data index trains per step")
    ap.add_argument("--processes", type=int, default=1,
                    help="ranks of a local pod on a {data, tp} mesh (1: this process)")
    ap.add_argument("--device", default=None,
                    help="where to train (e.g. cpu); default: the CUDA card")
    ap.add_argument("--coordinator", default="", help="(internal) host:port of rank 0's store")
    ap.add_argument("--nproc", type=int, default=1, help="(internal) ranks of the pod")
    ap.add_argument("--pid", type=int, default=0, help="(internal) this rank")
    args = ap.parse_args()
    if args.processes > 1:
        spawn(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
