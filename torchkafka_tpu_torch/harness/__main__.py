"""CLI: python -m torchkafka_tpu_torch.harness --scenario 7 --size tiny --device cpu"""

from __future__ import annotations

import argparse
import json

from torchkafka_tpu_torch.harness.scenarios import PORTED, SCENARIOS, run_scenario


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="torchkafka_tpu_torch benchmark harness")
    ap.add_argument("--scenario", type=int, choices=sorted(SCENARIOS), default=None,
                    help="which BASELINE scenario; default: all of them")
    ap.add_argument("--size", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--device", default=None,
                    help="where the scenarios run (e.g. cpu, cuda:0); default: "
                    "the current CUDA device, an error without one")
    ap.add_argument("--model-scale", choices=("45m", "1b", "8b"), default=None,
                    help="serving scenarios (5/7) only: serve the zoo model "
                    "at this scale (8b = int8) with HBM roofline accounting")
    ap.add_argument("--serve-eos", action="store_true",
                    help="scenario 7 at a model scale: EOS ON with 8-tick "
                    "blocks — the continuous-batching row (slots readmit "
                    "mid-stream); default at scale is EOS off, one tick block "
                    "per generation (the throughput ceiling)")
    ap.add_argument("--quantized", action="store_true", default=None,
                    help="serve the zoo scale weight-only int8 (default: "
                    "only 8b; decode is bytes-bound, so int8 halves the "
                    "streamed bytes vs bf16)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="scenario 7: the int8 slot pool (payload plus one "
                    "f32 scale a position and head)")
    ap.add_argument("--kv-kernel", choices=("auto", "on", "off"),
                    default="auto",
                    help="scenario 7 with --kv-int8: the fill-bounded CUDA "
                    "decode-attention kernel for the pool read (auto = on "
                    "where it applies; on = require, raise otherwise; off = "
                    "the plain scale-folded read — the paired control)")
    ap.add_argument("--spec", action="store_true",
                    help="scenario 7: speculative continuous-batching "
                    "serving (SpecStreamingGenerator) — the layer-truncated "
                    "self-draft proposes k tokens per slot, one multi-query "
                    "verify advances each slot by its accepted length; "
                    "token-exact vs the plain path, reports MEASURED "
                    "acceptance")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="--spec: draft tokens proposed per verify round")
    ap.add_argument("--spec-draft-layers", type=int, default=None,
                    help="--spec: layers in the truncated self-draft "
                    "(default: half the target's)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="scenario 7: sampled serving (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="scenario 7 with --temperature: per-step top-k filter")
    ap.add_argument("--top-p", type=float, default=None,
                    help="scenario 7 with --temperature: nucleus mass in "
                    "(0, 1] — minimal prefix reaching p stays sampleable")
    ap.add_argument("--replicas", type=int, default=2,
                    help="scenarios 10-13, 15-21, 23-25: replica count "
                    "(decode replicas in 21; scenario 22 starts at 1)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="scenario 14: suffix tokens the "
                    "fused tick carries alongside decode")
    args = ap.parse_args(argv)
    if args.scenario:
        nums = [args.scenario]
    elif args.model_scale:
        nums = [5, 7]  # the scenarios the flag applies to
    else:
        nums = list(PORTED)
    for n in nums:
        result = run_scenario(
            n, args.size, model_scale=args.model_scale,
            serve_eos=args.serve_eos, quantized=args.quantized,
            kv_int8=args.kv_int8,
            kv_kernel={"auto": "auto", "on": True, "off": False}[args.kv_kernel],
            spec=args.spec, spec_k=args.spec_k,
            spec_draft_layers=args.spec_draft_layers,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            replicas=args.replicas, prefill_chunk=args.prefill_chunk,
            device=args.device,
        )
        if result is not None:  # ranks of scenario 20's mesh other than its root
            print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
