"""What torch.distributed does with two ranks on one card.

Run on the H100 from the repo root: ``python3 chip_probe_dist.py``. It
starts pairs of ranks on ``cuda:0`` through ``torch.distributed.run`` and
prints one JSON line a rank and mode:

- ``nccl``: one all_reduce under NCCL with both ranks on the same card
  (expected to be refused: NCCL rejects a duplicate GPU);
- ``gloo_sequence``: gloo's own CUDA path for all_reduce, all_gather,
  all_gather_into_tensor, reduce_scatter_tensor and reduce_scatter, one
  after the other in one process (a crash ends the pair: its exit code is
  printed);
- ``gloo_<op>``: each of those alone, in a pair of its own;
- ``gloo_sequence_barrier``: the sequence, then ``dist.barrier()``;
- ``dtensor``: a ``DeviceMesh`` over the CUDA ranks, a ``DTensor`` of each
  rank's rows, its ``sum().full_tensor()`` and ``full_tensor()``: the
  functional collectives DTensor issues, through gloo's CUDA path;
- ``staged``: the rule ``parallel/collectives.py`` applies under gloo: a
  CUDA tensor copied into pinned host memory, all-reduced there and copied
  back, timed on the host clock at 1,024 and 5,040 MiB (the 1b model's f32
  gradients), twice each.

The card's name and power limit print first. A rank's lines carry its
mode; ``rc`` lines give each pair's exit code. Name modes as arguments to
run only those.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
       "reduce_scatter")


def _op(torch, dist, name: str, t, world: int):
    dev = t.device
    if name == "all_reduce":
        x = t.clone()
        dist.all_reduce(x)
        return x
    if name == "all_gather":
        xs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(xs, t)
        return torch.cat(xs)
    if name == "all_gather_into_tensor":
        out = torch.empty(t.numel() * world, device=dev)
        dist.all_gather_into_tensor(out, t)
        return out
    if name == "reduce_scatter_tensor":
        x = torch.arange(t.numel() * world, dtype=torch.float32, device=dev)
        out = torch.empty(t.numel(), device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out
    xs = [t.clone() for _ in range(world)]
    out = torch.empty_like(t)
    dist.reduce_scatter(out, xs)
    return out


def rank_main(mode: str) -> int:
    """One rank of a pair (started by ``torch.distributed.run``)."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    backend = "nccl" if mode == "nccl" else "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=60))

    def say(**kw):
        print(json.dumps({"mode": mode, "rank": rank, "torch": torch.__version__, **kw}),
              flush=True)

    t = torch.arange(8, dtype=torch.float32, device=dev) + rank
    if mode == "nccl":
        try:
            _op(torch, dist, "all_reduce", t, world)
            torch.cuda.synchronize()
            say(result="ok")
        except Exception as e:  # noqa: BLE001 - the refusal is the finding
            say(error=f"{type(e).__name__}: {e}"[:400])
    elif mode in ("gloo_sequence", "gloo_sequence_barrier"):
        for name in OPS:
            say(op=name, stage="start")
            _op(torch, dist, name, t, world)
            torch.cuda.synchronize()
            say(op=name, result="ok")
        if mode == "gloo_sequence_barrier":
            say(op="barrier", stage="start")
            dist.barrier()
            say(op="barrier", result="ok")
    elif mode == "dtensor":
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
        d = DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
        say(op="sum_full_tensor", stage="start")
        total = d.sum().full_tensor()
        torch.cuda.synchronize()
        say(op="sum_full_tensor", result=float(total))
        say(op="full_tensor", stage="start")
        full = d.full_tensor()
        torch.cuda.synchronize()
        say(op="full_tensor", result=full.tolist())
    elif mode.startswith("gloo_"):
        out = _op(torch, dist, mode[len("gloo_"):], t, world)
        torch.cuda.synchronize()
        say(result=out.tolist())
    else:  # staged
        for mib in (1024, 5040):
            n = mib << 18  # f32 elements
            x = torch.ones(n, dtype=torch.float32, device=dev)
            host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            for rep in range(2):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host.copy_(x)
                t1 = time.perf_counter()
                dist.all_reduce(host)
                t2 = time.perf_counter()
                x.copy_(host)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                say(mib=mib, rep=rep, d2h_s=t1 - t0, all_reduce_s=t2 - t1, h2d_s=t3 - t2,
                    correct=bool((x == world ** (rep + 1)).all()))
            del x, host
    dist.destroy_process_group()
    return 0


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-mode":
        return rank_main(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_dist: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip(), flush=True)
    here = os.path.abspath(__file__)
    modes = ("nccl", "gloo_sequence", *(f"gloo_{op}" for op in OPS),
             "gloo_sequence_barrier", "dtensor", "staged")
    if len(sys.argv) > 1:
        modes = tuple(sys.argv[1:])  # e.g. ``dtensor staged``
    for mode in modes:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
             "--master-addr", "127.0.0.1", "--master-port", str(_port()), here,
             "--rank-mode", mode],
            capture_output=True, text=True, timeout=300)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        print(json.dumps({"mode": mode, "rc": proc.returncode,
                          "stderr_tail": proc.stderr[-300:] if proc.returncode else ""}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
