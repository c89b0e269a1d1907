"""Paired on-card timings of two checkouts of this repository (a parent and
a change), on one card in one run, so that machine drift cannot pose as a
difference between them.

    python3 chip_pair.py PARENT_DIR CHANGE_DIR [--what train,serve] [--profile]

Each measurement runs in a fresh process per checkout, in the order
parent, change, change, parent, through that checkout's own
``chip_smoke.py`` (its ``train`` and ``serve`` functions, so each side
runs its own code end to end):

- train: the 1b streaming train loop, 6 steps of B=8, S=512 (the step
  median after the first, trained tokens/s, peak memory);
- serve: the 1b dense int8 serve run, 32 prompts of 128 tokens, 64 new
  tokens each (tokens/s, tick-block p50).

``--profile`` then traces one train step of the change under
torch.profiler (``chip_smoke.profile_summary``). Prints one JSON line per
run and a summary line last; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def one(root: str, what: str) -> dict:
    """One measurement of the checkout at ``root`` (in this process)."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from torchkafka_tpu_torch.ops import _native

    if not torch.cuda.is_available():
        raise SystemExit("chip_pair: no CUDA device")
    _native.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if what == "train":
        row = cs.train(torch)
        return {"step_ms": row["step_ms"], "step_ms_median": row["step_ms_median_after_first"],
                "trained_tokens_per_s": row["trained_tokens_per_s"],
                "peak_mem_gb": row["peak_mem_gb"], "launches": row["launches"]}
    if what == "profile":
        prof = cs._profiler(torch)
        row = cs.train(torch, prof=prof)
        return cs.profile_summary(prof, "one 1b train step (B=8, S=512) under torch.profiler",
                                  {"unprofiled_step_ms": row["step_ms_median_after_first"]})
    from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config

    cfg = zoo_config("1b")
    params = random_serving_params(torch.Generator(device="cuda").manual_seed(cs.SEED), cfg,
                                   device="cuda")
    prompts = np.random.default_rng(cs.SEED).integers(0, cfg.vocab_size, (32, 128),
                                                       dtype=np.int32)
    _, row = cs.serve(torch, cfg, params, prompts, "int8")
    return {"tokens_per_s": row["tokens_per_s"], "tick_block_ms_p50": row["tick_block_ms_p50"],
            "launches": row["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--what", default="train,serve")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "WHAT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("CHIP_PAIR " + json.dumps(one(*args.one)), flush=True)
        return 0
    runs = [(w, side) for w in args.what.split(",")
            for side in ("parent", "change", "change", "parent")]
    if args.profile:
        runs.append(("profile", "change"))
    summary = {}
    for what, side in runs:
        root = getattr(args, side)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent,
                              args.change, "--one", root, what],
                             capture_output=True, text=True, check=False)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("CHIP_PAIR ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_pair: {what} on {side} ({root}) failed")
        row = {"what": what, "side": side, **json.loads(lines[-1][len("CHIP_PAIR "):])}
        print(json.dumps(row), flush=True)
        if what != "profile":
            key = "step_ms_median" if what == "train" else "tokens_per_s"
            summary.setdefault(what, []).append((side, row[key]))
    print(json.dumps({"pairs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
