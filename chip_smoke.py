"""On-card smoke check of the PyTorch/CUDA port (``torchkafka_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every CUDA kernel built from ``torchkafka_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together);
3. flash_fwd: the flash-attention forward (K1) against its plain PyTorch
   version, each case through the kernel that ``_route`` picks (its
   route printed): at the 1b prefill and training shapes in bf16 (the
   tensor-core kernel), at the 1b prefill shape in f32 (the CUDA-core kernel), the 8b prefill shape (32 q / 8
   kv heads), a ragged S, k_offsets with fully masked rows (o = 0, lse <
   -1e29, no NaN), and bf16 at D=64/16, rep 1 and 4, S=17, S=200,
   non-causal and a q_offset; D=40 and D=160 take the CUDA cores in bf16.
   Two launches bitwise equal; the tensor-core kernel's registers and
   spill bytes (0 required); timings (CUDA events, median of 25, L2
   flushed before each timed launch) and TFLOP/s at the 1b prefill and
   training shapes, beside the CUDA-core kernel on the same bf16 inputs,
   the plain version and SDPA's forward;
4. flash_bwd: the backward kernels, dQ (K2) and dK/dV (K3), against their
   plain versions at the 1b training shape (B=8, S=512, 16 q / 8 kv heads,
   D=128, bf16: the tensor-core kernels), in f32 (the CUDA-core kernels),
   and in bf16 at the 8b heads, D=64/32/16, non-causal, S=17, a ragged
   S=200 and a k_offset with fully masked rows (dq = 0 there, no NaN
   anywhere); D=160 and D=256 in bf16 and f32 through the CUDA-core
   kernels; K3 bitwise equal across two launches; each tensor-core
   kernel's registers and spill bytes (0 required); timings and TFLOP/s,
   beside the CUDA-core kernels on the same bf16 inputs, with SDPA's
   backward as the pair's yardstick;
5. kvattn_dynlen: the split-K int8 decode kernel (K4) against its plain
   version at the 1b decode shape with pools of 192 and 2048 positions, at
   the serving watermarks and at span and tile edges (0, L-1, L, L+1, ...;
   where the planner keeps one span, also under forced spans of 64, so the
   merge runs at the serving pool), and at rep 1, 4 (the 8b decode shape)
   and 8 on the 192 pool; each case's span L and n_split; the kernels' int8
   conversion exact for all 256 values; where the read splits, two
   launches bitwise equal, and launches on two streams (each with its own
   merge counter buffer) bitwise equal to them; registers and spill bytes
   at rep 2 and 8 (0 required); timings at the planner's split, forced to
   one span and to spans of 64, 128 and 256, beside the plain version and
   the bound, and what the same events give a one-element add (the launch
   in every event time);
5b. kvattn_paged: the split-K block-table int8 decode kernel (K5) the same
   way at block size 16, logical views of 192 and 2048 positions (shared
   prefix blocks, sink entries, unreferenced garbage blocks), and at block
   sizes 16, 32 and 64 with table entries outside [0, NB) past the live
   range; K4's time on the same fills laid out dense;
5c. qmatmul: the int8 weight matmul (K6) against its plain version on
   int8 weights drawn by the zoo at the 8b shapes (w_gate, w_down, lm_head)
   with 16 decode rows, w_gate and w_down with 2048 prefill rows, and w_gate
   with 8, 24, 64 and 200 rows, in bf16 (the tensor-core kernel) and, on
   w_gate's 16 rows, f32 (the CUDA-core kernel); each case's route and plan
   (BM, BN, BK, K splits); tc_launches == the bf16 calls; where K splits,
   two launches and two streams bitwise equal; the int8 -> bf16 conversion
   exact for all 256 values; registers and spill bytes (0 required);
   timings of the tensor-core kernel beside the CUDA-core kernel on the
   same bf16 inputs, forced K splits, the plain version and the library's int8
   matmul, with the bound, TFLOP/s and GB/s (and, for information only,
   a dense bf16 matmul on a weight dequantised beforehand);
5d. kvattn_full: the full-pool masked int8 reads, K-major (K7) and M-major
   (K8), on the split-K body in its mask mode, at the 8b decode shape
   (B=16, K=8, rep=4, Dh=128) with pools of 192 and 2048, at the planner's
   split and, at 192, under forced spans of 64: on prefix masks K7, K8 (on
   the transposed pool), K4 and the plain version agree (K7 against K4 at
   the same span, bitwise or not, printed); on masks with holes, an
   all-false row and a row whose only readable position is the last, K7
   and K8 agree with the plain version; where the read splits, two
   launches and two streams bitwise; registers and spill bytes at rep 4
   and 8 (0 required); timings at the planner's split, one span and spans
   of 64, 128, 256 and 512, beside the plain version and the bound, K4
   reading every position on K7's spans, and K7 at rep 1, 2, 4 and 8;
6. train_grad: one training loss and backward at 1b width, 2 layers,
   S=512, B=2, through the kernels and through dense attention: the loss
   and every parameter's gradient must agree within bf16 tolerance;
7. train: the streaming train loop at the 1b scale, full width and depth,
   f32 master weights (the zoo's 1b stores bf16 for serving; training keeps
   f32 masters, ``TransformerConfig``'s default), made on the card by
   ``init_params`` from a seed: 48 records of 512 tokens on four partitions
   → ``KafkaStream`` → ``make_train_step`` with AdamW(1e-3), 6 steps of 8,
   each ``token.commit(wait_for=loss)``. Every loss finite, every
   partition's watermark advanced, Σ watermarks == 48, and K1/K2/K3 each
   launched 24 × 6 times, every time on the tensor cores (the main path:
   the counts are zeroed just before the loop and read just after);
8. serve: the 1b model at full width and depth, random bf16 weights made on
   the card from a seed, 32 prompts of 128 tokens on two partitions served
   by ``StreamingGenerator`` with the int8 pool (a main path: every kernel
   launch count is zeroed just before it and read just after; every K1
   launch on the tensor cores), then again with the bf16 pool;
8b. serve_paged: the same 1b model through the PAGED pool (int8, block
   size 16, radix prefix reuse, chunked prefill, K5 on decode-only ticks):
   48 prompts of 128 tokens from three tenants, each a fixed 96-token
   system prompt plus 32 random tokens, produced keyed by tenant onto four
   partitions (scenario 12's stream shape). 48/48 completions of 64 tokens,
   committed == end offset on every partition, prefix hits, fewer prefill
   tokens than 48 × 128, and K5 launched n_layers × (decode ticks − chunk
   ticks) times (counts zeroed just before the run, read just after). Then
   the same stream through the gathered read (no K5 launch): identical
   commits and token 0;
8c. serve_paged_f32: 1b width, 2 layers, f32 weights, the same stream
   through K5 and through the gathered read: every token identical;
8d. serve_8b: harness scenario 7 at the 8b scale with an output topic
   (BASELINE config 5), full width and depth, random int8 weights made on
   the card from a seed: 48 prompts of 128 tokens produced round-robin on
   two partitions, 16 slots, 64 new tokens, the dense int8 pool, each
   completion published to "completions" keyed by its prompt before its
   offset commits. Run twice, with the K4 read and then with the plain
   M-major read (kv_kernel=False); each run serves 48/48 completions of 64
   tokens, commits the end offsets, publishes exactly 48 records equal to
   the completions, and launches K1 = 32 × prefills (all on the tensor
   cores; none in the f32 run below), K4 = 32 × decode ticks
   (0 in the second run) and K6-K8 never (counts zeroed just before each
   run, read just after); the two runs commit the same offsets and agree
   on token 0;
8e. serve_8b_f32: the same stream and checks at 8b width, 2 layers, f32
   compute over the int8 weights, through K4 and through the plain M-major
   read: every token identical;
9. kernels: one line for every ported kernel (all eight);
then the card's nvidia-smi line and, last, ``{"ok": true, "device": ...}``.

Float32 matmuls run in full precision (TF32 off for matmul and cuDNN).
Any failure raises and exits non-zero without the last line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 0
MAX_NEW = 64  # scenario 7's full size: 64 new tokens per prompt


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, flush, n: int = 25, warm: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms, L2 flushed first.
    A ~1 ms device sleep ahead of the start event keeps the card busy
    while the host enqueues ``fn``'s kernels, so the events time the
    kernels and not the host's launch latency."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash(torch, F, flash, flush, gen) -> dict:
    """K1 against its plain version, each case through the kernel that
    ``_route`` picks (the route of each is printed and its tensor-core
    count checked): bf16 at the 1b prefill shape and at the training shape
    (B=8, S=512; the tensor cores), a
    ragged S, k_offsets whose fully masked rows lie in a skipped tile (64)
    and inside a computed one (40; o = 0 and lse < -1e29 there, no NaN),
    f32 for a tight check (the CUDA cores), bf16 and f32 at the 8b prefill
    shape (32 q / 8 kv heads), and bf16 at D=64 and D=16 with rep 1 and 4,
    S=17, a ragged S=200, non-causal and a q_offset; D=40 and D=160 take
    the CUDA cores in bf16. Two launches at the training shape must agree
    bitwise; the tensor-core kernel's registers and spill bytes (0
    required). Timings at the 1b prefill shape and the training shape
    (B=8, S=512), beside the CUDA-core kernel on the same bf16 inputs, the
    plain version and SDPA's forward."""
    B, S, H, K, D = 16, 128, 16, 8, 128
    H8 = 32  # the 8b scale's q heads: H/K = 4
    tol = {"bf16_o": 4e-2, "lse": 1e-3, "f32_o": 1e-4}
    bf16, f32 = torch.bfloat16, torch.float32

    def make(b, s, dtype, h=H, kh=K, d=D):
        mk = lambda n: torch.randn((n, s, d), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(b * h), mk(b * kh), mk(b * kh)

    cases = {  # b, s, dtype, q_offset, k_offset, H, K, D, causal
        "main_bf16": (B, S, bf16, 0, 0, H, K, D, True),
        "train_bf16": (8, 512, bf16, 0, 0, H, K, D, True),
        "ragged_s200_bf16": (B, 200, bf16, 0, 0, H, K, D, True),
        "k_offset64_bf16": (B, S, bf16, 0, 64, H, K, D, True),
        "main_f32": (B, S, f32, 0, 0, H, K, D, True),
        "main_8b_bf16": (B, S, bf16, 0, 0, H8, K, D, True),
        "main_8b_f32": (B, S, f32, 0, 0, H8, K, D, True),
        "k_offset40_bf16": (2, S, bf16, 0, 40, H, K, D, True),
        "d64_rep1_bf16": (2, 256, bf16, 0, 0, 8, 8, 64, True),
        "d64_rep4_s200_bf16": (2, 200, bf16, 0, 0, H8, K, 64, True),
        "d16_rep4_s17_bf16": (2, 17, bf16, 0, 0, 16, 4, 16, True),
        "d16_rep1_noncausal_bf16": (2, 77, bf16, 0, 0, 8, 8, 16, False),
        "d64_q_offset32_bf16": (2, 100, bf16, 32, 0, H, K, 64, True),
        "noncausal_s200_bf16": (2, 200, bf16, 0, 0, H, K, D, False),
        "d40_simt_bf16": (2, 96, bf16, 0, 0, H, K, 40, True),
        "d160_simt_bf16": (2, 96, bf16, 0, 0, H, K, 160, True),
    }
    fwd = flash.flash_fwd_bhsd
    errs, routes = {}, {}
    for name, (b, s, dtype, qo, ko, h, kh, d, causal) in cases.items():
        q, k, v = make(b, s, dtype, h, kh, d)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko, n_q_heads=h, n_kv_heads=kh)
        before = fwd.tc_launches
        o, lse = fwd(q, k, v, **kw)
        tc = fwd.tc_launches - before
        po, plse = flash.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        route = flash._route(dtype, d)
        if tc != (route == "tc"):
            raise AssertionError(f"flash_fwd {name}: route {route} but tc launches {tc}")
        routes[name] = route
        e_o, e_l = max_err(torch, o, po), max_err(torch, lse, plse)
        limit = tol["f32_o"] if dtype == torch.float32 else tol["bf16_o"]
        if not (e_o <= limit and e_l <= tol["lse"]):
            raise AssertionError(f"flash_fwd {name}: o err {e_o}, lse err {e_l}")
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
                and o.shape == po.shape):
            raise AssertionError(f"flash_fwd {name}: bad output")
        if causal and ko > qo:  # rows before the first key: o = 0, lse ≈ -1e30
            rows = slice(0, ko - qo)
            if o[:, rows].abs().max().item() != 0.0 or lse[:, rows].max().item() >= -1e29:
                raise AssertionError(f"flash_fwd {name}: fully masked rows not 0 / -1e30")
        errs[name] = {"o": e_o, "lse": e_l}

    resources = {f"d{d}": flash.fwd_tc_attrs(d) for d in (64, 128)}
    if any(r["local_bytes"] for r in resources.values()):
        raise AssertionError(f"flash_fwd: the tensor-core kernel spills {resources}")

    def timed(b, s, check_bits: bool) -> dict:
        q, k, v = make(b, s, bf16)
        kw = dict(causal=True, n_q_heads=H, n_kv_heads=K)
        if check_bits:  # no atomics: the same inputs give the same bits
            o1, l1 = fwd(q, k, v, **kw)
            o2, l2 = fwd(q, k, v, **kw)
            if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
                raise AssertionError("flash_fwd: two launches differ")
        ms = cuda_ms(torch, lambda: fwd(q, k, v, **kw), flush)
        # The CUDA-core kernel on the same bf16 inputs, which the route
        # rule sends to the tensor cores: launched directly, not counted.
        simt_ms = cuda_ms(torch, lambda: flash._launch_fwd(q, k, v, "simt", **kw), flush)
        plain_ms = cuda_ms(torch, lambda: flash.flash_fwd_plain(q, k, v, **kw), flush, n=5)
        # The library yardstick, in its own [B, H, S, D] layout (views of
        # the same inputs); never called by the port.
        qs, ks, vs = (x.reshape(b, -1, s, D) for x in (q, k, v))
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), flush)
        pairs = s * (s + 1) // 2  # allowed (q, k) pairs per head, causal
        flops = 4.0 * D * pairs * b * H  # q·k and p·v multiply-adds
        nbytes = 2 * D * s * (2 * b * H + 2 * b * K) + 4 * b * H * s
        bms, by = bound(flops, nbytes)
        return {"shape": {"B": b, "S": s, "H": H, "K": K, "D": D},
                "route": flash._route(bf16, D), "kernel_ms": ms,
                "tflops": flops / ms / 1e9, "simt_bf16_ms": simt_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}

    prefill = timed(B, S, check_bits=False)
    train_shape = timed(8, 512, check_bits=True)
    return {"phase": "flash_fwd", "shape": prefill["shape"], "tolerance": tol,
            "max_abs_err": errs, "routes": routes, "deterministic": True,
            "tc_resources": resources, "kernel_ms": prefill["kernel_ms"],
            "plain_ms": prefill["plain_ms"], "library_ms": prefill["library_ms"],
            "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
            "prefill": prefill, "train_shape": train_shape,
            "err_main": errs["main_bf16"]["o"]}


def check_flash_bwd(torch, F, flash, flush, gen) -> dict:
    """K2 (dQ) and K3 (dK/dV) against their plain versions: at the 1b
    training shape in bf16 (the tensor-core kernels) and f32 (the CUDA-core
    kernels), and in bf16 at the 8b heads (rep 4), D=64, D=32 with rep 8
    and a q_offset, D=16, non-causal, S=17, a ragged S=200 and a k_offset
    with fully masked rows (dq = 0 there, no NaN anywhere); D=40, D=160 and
    D=256 take the CUDA-core kernels (D=160 and 256 in bf16 and f32, the
    32-row tiles past D=128). K3 twice on the same inputs must agree
    bitwise. Timings at the training shape beside the CUDA-core kernels on
    the same bf16 inputs, the plain versions and SDPA's backward."""
    B, S, H, K, D = 8, 512, 16, 8, 128
    # Relative to the largest |plain value| of each output: bf16 about one
    # ulp (2^-7 = 7.8e-3) at the top of the range, f32 sums of 512 terms.
    tol = {"bf16_rel": 1e-2, "f32_rel": 1e-5}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {  # b, s, dtype, q_offset, k_offset, H, K, D, causal
        "main_bf16": (B, S, bf16, 0, 0, H, K, D, True),
        "main_f32": (B, S, f32, 0, 0, H, K, D, True),
        "ragged_s200_bf16": (2, 200, bf16, 0, 0, H, K, D, True),
        "k_offset64_f32": (2, 256, f32, 0, 64, H, K, D, True),
        "k_offset64_bf16": (2, 256, bf16, 0, 64, H, K, D, True),
        "heads_8b_bf16": (2, S, bf16, 0, 0, 32, K, D, True),
        "d64_bf16": (2, 256, bf16, 0, 0, H, K, 64, True),
        "noncausal_bf16": (2, 256, bf16, 0, 0, H, K, D, False),
        "s17_bf16": (2, 17, bf16, 0, 0, H, K, D, True),
        "d32_rep8_q_offset32_bf16": (2, 100, bf16, 32, 0, H, 2, 32, True),
        "d16_s77_noncausal_bf16": (2, 77, bf16, 0, 0, 8, 4, 16, False),
        "d40_simt_bf16": (2, 96, bf16, 0, 0, H, K, 40, True),
        # Past the tensor cores' D <= 128: the CUDA-core kernels' 32-row tiles.
        "d160_s200_simt_bf16": (2, 200, bf16, 0, 0, H, K, 160, True),
        "d160_s200_simt_f32": (2, 200, f32, 0, 0, H, K, 160, True),
        "d256_simt_bf16": (2, 256, bf16, 0, 0, H, K, 256, True),
        "d256_k_offset32_simt_f32": (2, 256, f32, 0, 32, H, K, 256, True),
    }

    def make(b, s, dtype, h=H, kh=K, d=D):
        mk = lambda n: torch.randn((n, s, d), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(b * h), mk(b * kh), mk(b * kh), mk(b * h)

    kernels = (flash.flash_dq_bhsd, flash.flash_dkv_bhsd)
    errs, routes = {}, {}
    for name, (b, s, dtype, qo, ko, h, kh, d, causal) in cases.items():
        q, k, v, do = make(b, s, dtype, h, kh, d)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko, n_q_heads=h, n_kv_heads=kh)
        o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
        before = [fn.tc_launches for fn in kernels]
        got = flash.flash_bwd_bhsd(q, k, v, o, lse, do, **kw)
        tc = [fn.tc_launches - n for fn, n in zip(kernels, before)]
        ref = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        route = flash._route(dtype, d)
        if tc != ([1, 1] if route == "tc" else [0, 0]):
            raise AssertionError(f"flash_bwd {name}: route {route} but tc launches {tc}")
        routes[name] = route
        rel = tol["f32_rel"] if dtype == torch.float32 else tol["bf16_rel"]
        row = {}
        for label, a, r in zip(("dq", "dk", "dv"), got, ref):
            e = max_err(torch, a, r)
            limit = rel * float(r.float().abs().max())
            if not (e <= limit and torch.isfinite(a.float()).all()):
                raise AssertionError(f"flash_bwd {name} {label}: err {e} > {limit}")
            row[label] = e
        if ko > qo:  # rows before the first key: no allowed key, dq = 0
            masked = got[0][:, : ko - qo]
            if masked.abs().max().item() != 0.0:
                raise AssertionError(f"flash_bwd {name}: fully masked rows have dq != 0")
        errs[name] = row

    q, k, v, do = make(B, S, torch.bfloat16)
    kw = dict(causal=True, n_q_heads=H, n_kv_heads=K)
    o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
    delta = flash.flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    # No atomics: the same inputs give the same bits.
    first, second = flash.flash_dkv_bhsd(*args, **kw), flash.flash_dkv_bhsd(*args, **kw)
    dq1, dq2 = flash.flash_dq_bhsd(*args, **kw), flash.flash_dq_bhsd(*args, **kw)
    deterministic = {"dkv": all(torch.equal(a, b) for a, b in zip(first, second)),
                     "dq": torch.equal(dq1, dq2)}
    if not all(deterministic.values()):
        raise AssertionError(f"flash_bwd: two launches differ {deterministic}")
    resources = {f"{w}_d{d}": flash.bwd_tc_attrs(w, d) for w in ("dq", "dkv") for d in (64, 128)}
    if any(r["local_bytes"] for r in resources.values()):
        raise AssertionError(f"flash_bwd: a tensor-core kernel spills {resources}")

    dq_ms = cuda_ms(torch, lambda: flash.flash_dq_bhsd(*args, **kw), flush)
    dkv_ms = cuda_ms(torch, lambda: flash.flash_dkv_bhsd(*args, **kw), flush)
    simt_dq_ms, simt_dkv_ms = (cuda_ms(torch, fn, flush)
                               for fn in _simt_bwd_calls(torch, flash, args, kw))
    dq_plain = cuda_ms(torch, lambda: flash.flash_dq_plain(*args, **kw), flush, n=5)
    dkv_plain = cuda_ms(torch, lambda: flash.flash_dkv_plain(*args, **kw), flush, n=5)
    # The library yardstick: SDPA's backward at the same shape, in its own
    # [B, H, S, D] layout, as (forward + backward) - forward; never called
    # by the port.
    qs, ks, vs, dos = (x.reshape(B, -1, S, D).detach() for x in (q, k, v, do))
    for x in (qs, ks, vs):
        x.requires_grad_(True)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), dos)

    lib_ms = cuda_ms(torch, sdpa_fwd_bwd, flush) - cuda_ms(torch, sdpa_fwd, flush)
    pairs = S * (S + 1) // 2 * B * H  # allowed (q, k) pairs, causal
    io = 2 * D * S * (2 * B * H + 2 * B * K) + 2 * 4 * B * H * S  # q,do,k,v + lse,delta
    dq_flops, dkv_flops = 6.0 * D * pairs, 8.0 * D * pairs
    dq_bound = bound(dq_flops, io + 2 * D * S * B * H)
    dkv_bound = bound(dkv_flops, io + 2 * 2 * D * S * B * K)
    return {"phase": "flash_bwd", "shape": {"B": B, "S": S, "H": H, "K": K, "D": D},
            "tolerance": tol, "max_abs_err": errs, "routes": routes,
            "deterministic": deterministic, "tc_resources": resources,
            "dq": {"kernel_ms": dq_ms, "tflops": dq_flops / dq_ms / 1e9,
                   "simt_bf16_ms": simt_dq_ms, "plain_ms": dq_plain,
                   "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
            "dkv": {"kernel_ms": dkv_ms, "tflops": dkv_flops / dkv_ms / 1e9,
                    "simt_bf16_ms": simt_dkv_ms, "plain_ms": dkv_plain,
                    "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]},
            "library_ms_sdpa_bwd": lib_ms}


def _simt_bwd_calls(torch, flash, args, kw):
    """The CUDA-core dQ and dK/dV kernels on bf16 inputs that the route
    rule sends to the tensor cores: launched through the C entry points
    directly, for a timing beside the tensor-core kernels in the same run
    (not counted: no path launches them this way)."""
    import ctypes

    q, k, v, do, lse, delta = args
    lib = flash._bwd_lib()
    _, dtype, *scalars = flash._launch_args("flash_bwd", args, q_offset=0, k_offset=0, **kw)
    ptrs = [t.data_ptr() for t in args]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def dq_call():
        flash._native.check(lib.tk_flash_dq(*ptrs, dq.data_ptr(), dtype, q.shape[0],
                                            *scalars, stream), "simt dq")

    def dkv_call():
        flash._native.check(lib.tk_flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), dtype,
                                             k.shape[0], *scalars, stream), "simt dkv")

    return dq_call, dkv_call


KV_TOL = {"bf16": 3e-2, "f32": 1e-4}


def _kv_errs(torch, kernel, plain, make_q, what: str) -> dict:
    """The kernel against its plain version on the same inputs, bf16 and
    f32 q (``make_q(dtype)``): max |difference| of each, within KV_TOL."""
    row = {}
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q = make_q(dtype)
        got, ref = kernel(q), plain(q)
        torch.cuda.synchronize()
        err = max_err(torch, got, ref)
        if not (err <= KV_TOL[dn] and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{what} {dn}: err {err}")
        row[dn] = err
    return row


@contextlib.contextmanager
def _span(kvattn, span):
    """Force the span length of the split reads (None: the planner's)."""
    kvattn._forced_span = span
    try:
        yield
    finally:
        kvattn._forced_span = None


def _kv_bitwise(torch, kvattn, call, what: str) -> dict:
    """Two launches bitwise equal; one launch on each of two side streams,
    queued together, each stream with its own merge counter buffer, bitwise
    equal to them; every counter buffer back at zero afterwards. Run where
    the read splits (n_split > 1), so that the merge runs."""
    a, b = call(), call()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        c = call()
    with torch.cuda.stream(s2):
        d = call()
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    res = {"two_launches_equal": torch.equal(a, b),
           "two_streams_equal": torch.equal(a, c) and torch.equal(a, d),
           "own_counter_per_stream": {(dev, s1.cuda_stream), (dev, s2.cuda_stream)}
           <= set(kvattn._counters),
           "counters_zero_after": all(int(t.count_nonzero()) == 0
                                      for t in kvattn._counters.values())}
    if not all(res.values()):
        raise AssertionError(f"{what}: {res}")
    return res


def _kv_times(torch, kvattn, kernel, plain, flush, m_len: int, sweep=()) -> dict:
    """The kernel at the planner's split, forced to one span (the old
    single-block schedule) and to each span length of ``sweep``, and the
    plain version, on the same inputs."""
    row = {"kernel_ms": cuda_ms(torch, kernel, flush)}
    for key, span in (("one_span_ms", m_len), *((f"span{L}_ms", L) for L in sweep)):
        with _span(kvattn, span):
            row[key] = cuda_ms(torch, kernel, flush)
    row["plain_ms"] = cuda_ms(torch, plain, flush)
    return row


def _kv_bound(torch, pos, K: int, REP: int, DH: int, extra_bytes: int = 0):
    """(bound ms, by) of one read: the positions this run's watermarks need,
    K and V rows with their scales, q and the output in bf16, pos."""
    B = pos.shape[0]
    n_read = int((pos.long() + 1).sum())
    nbytes = n_read * K * 2 * (DH + 4) + 2 * (2 * B * K * REP * DH) + 4 * B + extra_bytes
    return bound(4.0 * n_read * K * REP * DH, nbytes)


def _spans(row: dict) -> dict:
    """The forced span lengths' times of a timed row: {"64": ms, ...}."""
    return {key[4:-3]: v for key, v in row.items() if key.startswith("span") and key.endswith("_ms")}


def check_i8_convert(torch, kvattn) -> dict:
    """The kernels' int8 -> f32 and -> bf16 conversion run on the card for
    all 256 int8 values, against the exact (float)x."""
    f32, b16 = kvattn.i8_convert_table()
    want = torch.arange(-128, 128, device="cuda").to(torch.int8).float()
    ok = {"f32": torch.equal(f32, want), "bf16": torch.equal(b16.float(), want)}
    if not all(ok.values()):
        raise AssertionError(f"int8 conversion not exact: {ok}")
    return {"values": 256, "exact": ok}


SPAN_SWEEP = (64, 128, 256)  # span lengths timed beside the planner's


def _edge_pos(torch, M: int, L: int):
    """16 watermarks at span and tile edges: 0 (one position), L-1, L,
    L+1, 2L-1, 2L, 2L+1, 63, 64, 65, 127, 128, 129, M/2, M-2 and M-1,
    clamped into the pool."""
    edges = (0, L - 1, L, L + 1, 2 * L - 1, 2 * L, 2 * L + 1, 63, 64, 65, 127, 128, 129,
             M // 2, M - 2, M - 1)
    return torch.tensor([min(p, M - 1) for p in edges], dtype=torch.int32, device="cuda")


def check_kvattn(torch, kvattn, flush, gen) -> dict:
    """K4 against its plain version at the 1b decode shape (B=16, K=8,
    rep=2, Dh=128) with pools of 192 (the serve phase's) and 2048, at the
    serving watermarks and at span edges; rep 1, 4 (the 8b decode shape)
    and 8 at a pool of 192; two launches and two streams bitwise; the
    kernel's registers and spills; timings at the planner's split and at
    one span."""
    B, K, REP, DH = 16, 8, 2, 128
    out = {"phase": "kvattn_dynlen", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH},
           "tolerance": KV_TOL, "pools": {}, "reps": {},
           "i8_convert": check_i8_convert(torch, kvattn)}
    # What cuda_ms gives a one-element add: the launch in every event time.
    one = torch.zeros(1, device="cuda")
    out["event_floor_ms"] = cuda_ms(torch, lambda: one.add_(1), flush)
    attrs = {f"rep{r}": kvattn.dynlen_attrs(torch.bfloat16, r) for r in (2, 8)}
    attrs["rep8_f32"] = kvattn.dynlen_attrs(torch.float32, 8)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_dynlen spills: {attrs}")
    out["attrs"] = attrs

    def pool(M):
        kq, vq = (torch.randint(-127, 127, (B, K, M, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, K, M), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        return kq, ks, vq, vs

    def make_q(rep):
        return lambda dtype: torch.randn((B, 1, K * rep, DH), generator=gen,
                                         device="cuda").to(dtype)

    def case(kv, pos, rep, what):
        return _kv_errs(torch, lambda q: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                        lambda q: kvattn.int8_decode_attention_plain(q, *kv, pos),
                        make_q(rep), what)

    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M)
        base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
        pos = torch.tensor((base * 2)[:B], dtype=torch.int32, device="cuda")
        kv = pool(M)
        row = {"L": L, "n_split": n_split, "watermarks": pos.tolist(),
               "max_abs_err": case(kv, pos, REP, f"kvattn M={M}"), "split": {}}
        # The planner's spans and, where it does not split, forced spans of
        # 64: the merge at this pool's span edges.
        q = make_q(REP)(torch.bfloat16)
        for span in ((None, 64) if n_split == 1 else (None,)):
            with _span(kvattn, span):
                Ls, ns = kvattn._split_plan(M, span=span)
                edges = _edge_pos(torch, M, Ls)
                row["split"][f"L{Ls}"] = {
                    "L": Ls, "n_split": ns, "edge_watermarks": edges.tolist(),
                    "edge_max_abs_err": case(kv, edges, REP, f"kvattn M={M} L={Ls} edges")}
                if ns > 1:
                    row["split"][f"L{Ls}"]["bitwise"] = _kv_bitwise(
                        torch, kvattn, lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                        f"kvattn M={M} L={Ls}")
        row.update(_kv_times(torch, kvattn,
                             lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                             lambda: kvattn.int8_decode_attention_plain(q, *kv, pos), flush,
                             M, [x for x in SPAN_SWEEP if x < M]))
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH)
        row["library_ms"] = None
        out["pools"][str(M)] = row
        if M == 192:
            edges = _edge_pos(torch, M, 64)
            for rep in (1, 4, 8):
                r = {"L": L, "n_split": n_split,
                     "max_abs_err": case(kv, pos, rep, f"kvattn rep={rep}"),
                     "edge_max_abs_err": case(kv, edges, rep, f"kvattn rep={rep} edges")}
                with _span(kvattn, 64):
                    r["span64_edge_max_abs_err"] = case(kv, edges, rep,
                                                        f"kvattn rep={rep} L=64 edges")
                q = make_q(rep)(torch.bfloat16)
                r.update(_kv_times(
                    torch, kvattn, lambda: kvattn.int8_decode_attention_dynlen(q, *kv, pos),
                    lambda: kvattn.int8_decode_attention_plain(q, *kv, pos), flush, M, (64,)))
                r["bound_ms"], r["bound_by"] = _kv_bound(torch, pos, K, rep, DH)
                out["reps"][str(rep)] = r
    return out


def paged_case(np, B: int, M: int, bs: int, rng):
    """Block tables for B slots over logical views of M positions: slots
    0..B/2-1 share one prefix run of blocks and the rest share another
    (the radix shape), every other block is private, entries past a slot's
    watermark point at the sink (block 0), and a few garbage blocks stay
    unreferenced. Returns (table [B, nblk] int32, pos [B] int32, NB)."""
    nblk = M // bs
    shared = max(1, nblk // 4)
    n_priv = B * (nblk - shared)
    nb = 1 + 2 * shared + n_priv + 8  # + sink and 8 garbage blocks
    ids = rng.permutation(np.arange(1, nb)).astype(np.int32)
    prefix = (ids[:shared], ids[shared:2 * shared])
    priv = ids[2 * shared:2 * shared + n_priv].reshape(B, nblk - shared)
    table = np.concatenate(
        [np.stack([prefix[b >= B // 2] for b in range(B)]), priv], axis=1)
    base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
    pos = np.asarray((base * 2)[:B], np.int32)
    live = np.arange(nblk)[None, :] <= (pos // bs)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return table, pos, nb


def check_kvattn_paged(torch, kvattn, flush, gen) -> dict:
    """K5 against its plain version at the 1b decode shape (B=16, K=8,
    rep=2, Dh=128), block size 16, logical views of 192 (the serve_paged
    phase's) and 2048 positions, at the serving watermarks and at span
    edges; block sizes 16, 32 and 64 at the 192 view with table entries
    outside [0, NB) past the live range (the reference reads the clamped
    table, as the kernel does); two launches and two streams bitwise; the
    kernel's registers and spills; timings at the planner's split and at
    one span, and K4's time on the same fills laid out dense as context."""
    import numpy as np

    B, K, REP, DH, BS = 16, 8, 2, 128, 16
    out = {"phase": "kvattn_paged", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH,
                                              "bs": BS},
           "tolerance": KV_TOL, "views": {}, "block_sizes": {}}
    attrs = {f"rep{r}": kvattn.paged_attrs(torch.bfloat16, r) for r in (2, 8)}
    attrs["rep8_f32"] = kvattn.paged_attrs(torch.float32, 8)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_paged spills: {attrs}")
    out["attrs"] = attrs
    rng = np.random.default_rng(SEED + 5)

    def make_q(dtype):
        return torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(dtype)

    def pools(nb, bs):
        kq, vq = (torch.randint(-127, 127, (nb, K, bs, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((nb, K, bs), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        return kq, ks, vq, vs

    def case(kv, table, pos, what, ref_table=None):
        ref_table = table if ref_table is None else ref_table
        return _kv_errs(
            torch, lambda q: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda q: kvattn.int8_paged_decode_attention_plain(q, *kv, ref_table, pos),
            make_q, what)

    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M, BS)
        table_np, pos_np, NB = paged_case(np, B, M, BS, rng)
        table = torch.from_numpy(table_np).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        kv = pools(NB, BS)
        # The edge watermarks on the same pool: every table entry live.
        full = torch.from_numpy(paged_case(np, B, M, BS, rng)[0]).cuda()
        full = torch.where(full == 0, torch.randint(1, NB, full.shape, generator=gen,
                                                    device="cuda", dtype=torch.int32), full)
        row = {"L": L, "n_split": n_split, "watermarks": pos_np.tolist(), "pool_blocks": NB,
               "max_abs_err": case(kv, table, pos, f"kvattn_paged M={M}"), "split": {}}
        q = make_q(torch.bfloat16)
        for span in ((None, 64) if n_split == 1 else (None,)):
            with _span(kvattn, span):
                Ls, ns = kvattn._split_plan(M, BS, span=span)
                edges = _edge_pos(torch, M, Ls)
                row["split"][f"L{Ls}"] = {
                    "L": Ls, "n_split": ns, "edge_watermarks": edges.tolist(),
                    "edge_max_abs_err": case(kv, full, edges, f"kvattn_paged M={M} L={Ls} edges")}
                if ns > 1:
                    row["split"][f"L{Ls}"]["bitwise"] = _kv_bitwise(
                        torch, kvattn,
                        lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
                        f"kvattn_paged M={M} L={Ls}")
        row.update(_kv_times(
            torch, kvattn, lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda: kvattn.int8_paged_decode_attention_plain(q, *kv, table, pos), flush,
            M, [x for x in SPAN_SWEEP if x < M]))
        # K4 on the same fills, laid out dense K-major [B, K, M, Dh].
        dense = [kvattn.paged_gather_kmajor(t, table).transpose(1, 2).contiguous()
                 for t in kv]
        row["k4_dense_same_fill_ms"] = cuda_ms(
            torch, lambda: kvattn.int8_decode_attention_dynlen(q, *dense, pos), flush)
        n_ent = int(((pos.long() + BS) // BS).sum())  # table entries it reads
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH, 4 * n_ent)
        row["library_ms"] = None
        out["views"][str(M)] = row

    M = 192
    for bs in (16, 32, 64):
        L, n_split = kvattn._split_plan(M, bs)
        table_np, pos_np, NB = paged_case(np, B, M, bs, rng)
        # Entries past the live range outside [0, NB): clamped, never read.
        table_np[0, -1], table_np[1, -1] = NB + 7, -3
        table = torch.from_numpy(table_np).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        kv = pools(NB, bs)
        clamped = table.clamp(0, NB - 1)
        row = {"L": L, "n_split": n_split, "pool_blocks": NB,
               "max_abs_err": case(kv, table, pos, f"kvattn_paged bs={bs}", clamped)}
        with _span(kvattn, 64):
            row["span64_max_abs_err"] = case(kv, table, pos, f"kvattn_paged bs={bs} L=64",
                                             clamped)
        q = make_q(torch.bfloat16)
        row.update(_kv_times(
            torch, kvattn, lambda: kvattn.int8_paged_decode_attention(q, *kv, table, pos),
            lambda: kvattn.int8_paged_decode_attention_plain(q, *kv, clamped, pos), flush,
            M, (64,)))
        n_ent = int(((pos.long() + bs) // bs).sum())
        row["bound_ms"], row["bound_by"] = _kv_bound(torch, pos, K, REP, DH, 4 * n_ent)
        out["block_sizes"][str(bs)] = row
    return out


def _library_int8_mm(torch, x, q, scale):
    """The library yardstick for one int8 weight matmul: PyTorch's
    ``_weight_int8pack_mm`` (q as [N, K], scales [N] in x's dtype) where
    this build has a CUDA implementation of it, else ``x @ load_weight(q)``
    (the dequantized bf16 matmul). Returns (label, zero-argument call);
    the operands are prepared here, outside any timed region."""
    from torchkafka_tpu_torch.models.quant import QTensor, load_weight

    qt, st = q.t().contiguous(), scale.reshape(-1).to(x.dtype)
    if hasattr(torch, "_weight_int8pack_mm"):
        try:  # a feature probe: does this build run it on the card?
            torch._weight_int8pack_mm(x[:1], qt, st)
            torch.cuda.synchronize()
            return "torch._weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, qt, st)
        except (RuntimeError, NotImplementedError):
            pass
    w = QTensor(q, scale)
    return "x @ load_weight(q)", lambda: x @ load_weight(w, x.dtype)


def check_qmatmul(torch, kvattn, flush, gen) -> dict:
    """K6 against its plain version on int8 weights drawn by the zoo
    (``_rand_q``) at the 8b shapes: 16 decode rows on w_gate, w_down and
    lm_head, 2048 prefill rows (16 × 128) on w_gate and w_down, and on
    w_gate 8, 24, 64 and 200 rows (200: a ragged last tile); x bf16 (the
    tensor-core kernel), and f32 on w_gate's decode rows (the CUDA-core
    kernel). Every shape tiles, so every call must launch a kernel, by the
    route ``_route`` names; each case prints its route and plan. Where the
    plan splits K, two launches and two streams bitwise equal. The
    tensor-core kernel's int8 conversion exact for all 256 values, its
    registers and spill bytes (0 required). At the 8b shapes, timings of
    the tensor-core kernel beside the CUDA-core kernel on the same bf16
    inputs, the plain version, ``torch._weight_int8pack_mm``, forced
    splits of 1, 2, 4, 8 and 16 (decode rows), the bound, TFLOP/s and
    GB/s; at 2048 rows, how many outputs a sequential f32 GEMM puts
    outside the tolerance of the plain version's exact f32 sum."""
    from torchkafka_tpu_torch.models.quant import QTensor, load_weight
    from torchkafka_tpu_torch.models.zoo import _rand_q
    from torchkafka_tpu_torch.ops import qmatmul as qmm

    quantized_matmul, plain = qmm.quantized_matmul, qmm.quantized_matmul_plain
    # bf16: one bf16 ulp of the plain value (the plain version rounds the
    # exact sum once to f32, the kernel's f32 sums differ from it by their
    # own rounding, so the two bf16 roundings land at most one step apart);
    # f32: the f32 sum order over up to 14,336 terms, on outputs of unit
    # scale.
    tol = {"bf16_ulp_rel": 2.0 ** -7, "f32_abs": 1e-4}
    shapes = {"w_gate": (4096, 14336), "w_down": (14336, 4096), "lm_head": (4096, 128256)}
    weights = {nm: _rand_q(gen, s, (0,), "cuda") for nm, s in shapes.items()}
    bf16 = torch.bfloat16
    timed = {("w_gate", 16), ("w_down", 16), ("lm_head", 16), ("w_gate", 2048),
             ("w_down", 2048)}
    cases = [("w_gate", 16, bf16), ("w_down", 16, bf16), ("lm_head", 16, bf16),
             ("w_gate", 2048, bf16), ("w_gate", 16, torch.float32),
             ("w_gate", 8, bf16), ("w_gate", 24, bf16), ("w_gate", 64, bf16),
             ("w_gate", 200, bf16), ("w_down", 2048, bf16)]
    table = qmm.i8_convert_table()
    want = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8).view(
        torch.int8).to(bf16)
    if not torch.equal(table.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("qmatmul: the int8 -> bf16 conversion is not exact")
    attrs = {f"bm{bm}": qmm.tc_attrs(bm) for bm in (16, 32, 64, 128)}
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"qmatmul: the tensor-core kernel spills {attrs}")
    out = {"phase": "qmatmul", "tolerance": tol, "i8_convert_exact": True,
           "tc_resources": attrs, "cases": {}}
    quantized_matmul.launches = quantized_matmul.tc_launches = 0
    inputs = {}
    for name, m, dtype in cases:  # one counted call a case: the checks
        w = weights[name]
        k, n = shapes[name]
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        inputs[(name, m, dtype)] = x
        before = (quantized_matmul.launches, quantized_matmul.tc_launches)
        got = quantized_matmul(x, w.q, w.scale)
        route = qmm._route(dtype, k, n)
        after = (quantized_matmul.launches, quantized_matmul.tc_launches)
        if after != (before[0] + 1, before[1] + (route == "tc")):
            raise AssertionError(f"qmatmul {name} M={m}: launches {before} -> {after}, "
                                 f"route {route}")
        ref = plain(x, w.q, w.scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if dtype == bf16:
            ok = bool((err <= tol["bf16_ulp_rel"] * ref.float().abs() + 1e-6).all())
        else:
            ok = float(err.max()) <= tol["f32_abs"]
        if not (ok and torch.isfinite(got.float()).all() and got.shape == (m, n)):
            raise AssertionError(f"qmatmul {name} M={m} {dtype}: max err {float(err.max())}")
        row = {"shape": {"M": m, "K": k, "N": n}, "route": route,
               "max_abs_err": float(err.max())}
        if route == "tc":
            bm, bn, bk, n_split = qmm._qmm_plan(m, k, n)
            row["plan"] = {"BM": bm, "BN": bn, "BK": bk, "n_split": n_split,
                           "split_rows": qmm._split_rows(k, bk, n_split)}
        out["cases"][f"{name}_m{m}_{str(dtype).replace('torch.', '')}"] = row
    bf16_calls = sum(dtype == bf16 for _, _, dtype in cases)
    out["launches"] = quantized_matmul.launches
    out["tc_launches"] = quantized_matmul.tc_launches
    out["bf16_calls"] = bf16_calls
    if (out["launches"], out["tc_launches"]) != (len(cases), bf16_calls):
        raise AssertionError(f"qmatmul: {out['launches']} launches, {out['tc_launches']} "
                             f"on the tensor cores, for {len(cases)} calls, {bf16_calls} bf16")

    for (name, m, dtype), x in inputs.items():  # bitwise repeats and timings
        w = weights[name]
        k, n = shapes[name]
        row = out["cases"][f"{name}_m{m}_{str(dtype).replace('torch.', '')}"]
        call = lambda: quantized_matmul(x, w.q, w.scale)  # noqa: E731
        if row.get("plan", {}).get("n_split", 1) > 1:
            row["bitwise"] = _kv_bitwise(torch, kvattn, call, f"qmatmul {name} M={m}")
        if (name, m) not in timed or dtype != bf16:
            continue
        row["kernel_ms"] = cuda_ms(torch, call, flush)
        # The CUDA-core kernel on the same bf16 inputs, launched uncounted
        # through the wrapper's own launcher (no path runs it on bf16).
        simt_out = torch.empty((m, n), dtype=bf16, device="cuda")
        scale32 = w.scale.reshape(-1).float().contiguous()
        row["simt_bf16_ms"] = cuda_ms(torch, lambda: qmm._native.check(
            qmm._launch("simt", x, w.q, scale32, simt_out), "simt qmatmul"), flush)
        if m <= 64:  # forced split counts beside the plan's
            row["split_ms"] = {}
            try:
                for ns in (1, 2, 4, 8, 16):
                    qmm._forced_split = ns
                    row["split_ms"][str(ns)] = cuda_ms(torch, call, flush)
            finally:
                qmm._forced_split = None
        row["plain_ms"] = cuda_ms(torch, lambda: plain(x, w.q, w.scale), flush, n=5)
        lib, lib_fn = _library_int8_mm(torch, x, w.q, w.scale)
        row["library"] = lib
        row["library_ms"] = cuda_ms(torch, lib_fn, flush, n=5 if m > 64 else 25)
        nbytes = k * n + 2 * m * k + 2 * m * n + 4 * n
        flops = 2.0 * m * k * n
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["gb_per_s"] = nbytes / row["kernel_ms"] / 1e6
        row["tc_faster_than_simt"] = row["kernel_ms"] < row["simt_bf16_ms"]
        if m > 64:  # why the plain version sums bf16 x in f64
            ref = plain(x, w.q, w.scale).float()
            f32_gemm = ((x.float() @ w.q.float()) * w.scale.float()).to(bf16).float()
            row["f32_gemm_outputs_off_plain"] = int(
                ((f32_gemm - ref).abs() > tol["bf16_ulp_rel"] * ref.abs() + 1e-6).sum())
            del ref, f32_gemm
        # For information only, NOT K6's function (a bf16 weight rounded
        # from q·scale, twice the bytes): the dense bf16 GEMM on a weight
        # dequantised beforehand.
        wd = load_weight(QTensor(w.q, w.scale), bf16)
        row["info_dense_bf16_matmul_ms_not_k6"] = cuda_ms(torch, lambda: x @ wd, flush)
        del wd
    return out


def check_kvattn_full(torch, kvattn, flush, gen) -> dict:
    """K7 (K-major) and K8 (M-major) against their plain version at the 8b
    decode shape (B=16, K=8, rep=4, Dh=128), pools of 192 and 2048, each
    pool's L and n_split, at the planner's split and, where it keeps one
    span, under forced spans of 64 (the merge at this pool). Prefix masks
    from ``check_kvattn``'s watermarks: K7, K8 on the transposed pool, K4
    and the plain version agree with each other, and K7 against K4 at the
    same span (the difference, and whether it is bitwise). Masks with
    holes, one all-false row and one row whose only readable position is
    the pool's last: K7 and K8 against the plain version. Where the read
    splits, two launches and two streams bitwise for K7 and K8. Registers
    and spills at rep 4 and 8 (0 required); timings at the planner's
    split, one span and spans of 64/128/256/512, beside the plain version,
    K4 reading every position on the same spans, and K7 at rep 1/2/4/8."""
    B, K, REP, DH = 16, 8, 4, 128
    out = {"phase": "kvattn_full", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH},
           "tolerance": KV_TOL, "pools": {}}
    attrs = {}
    for kmajor, name in ((True, "k7"), (False, "k8")):
        for rep in (4, 8):
            attrs[f"{name}_rep{rep}"] = kvattn.full_attrs(torch.bfloat16, rep, kmajor)
        attrs[f"{name}_rep8_f32"] = kvattn.full_attrs(torch.float32, 8, kmajor)
    if any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"kvattn_full spills: {attrs}")
    out["attrs"] = attrs
    kvattn.int8_decode_attention_kmajor.launches = 0
    kvattn.int8_decode_attention.launches = 0
    for M in (192, 2048):
        L, n_split = kvattn._split_plan(M, max_split=kvattn._MAX_SPLIT_FULL)
        base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
        pos = torch.tensor((base * 2)[:B], dtype=torch.int32, device="cuda")
        kq, vq = (torch.randint(-127, 127, (B, K, M, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, K, M), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        km = (kq, ks, vq, vs)
        mm = tuple(t.transpose(1, 2).contiguous() for t in km)  # M-major copies
        prefix = torch.arange(M, device="cuda")[None, :] <= pos[:, None].long()
        holes = torch.rand((B, M), generator=gen, device="cuda") < 0.6
        holes[3] = False  # an all-false row: the uniform average over all M
        holes[5] = False
        holes[5, M - 1] = True  # the only readable position in the last span
        row = {"L": L, "n_split": n_split, "watermarks": pos.tolist(), "split": {}}
        # The planner's spans and, where it keeps one span, forced spans of
        # 64. Each is forced on K4 as well, so that K7 and K4 split alike.
        for Ls in ((L, 64) if n_split == 1 else (L,)):
            with _span(kvattn, Ls):
                ns = kvattn._split_plan(M, span=Ls)[1]
                errs_by, k7_k4 = {}, {}
                for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                    q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(dtype)
                    k7 = kvattn.int8_decode_attention_kmajor(q, *km, prefix)
                    k8 = kvattn.int8_decode_attention(q, *mm, prefix)
                    k4 = kvattn.int8_decode_attention_dynlen(q, *km, pos)
                    ref = kvattn.int8_decode_attention_kmajor_plain(q, *km, prefix)
                    h7 = kvattn.int8_decode_attention_kmajor(q, *km, holes)
                    h8 = kvattn.int8_decode_attention(q, *mm, holes)
                    href = kvattn.int8_decode_attention_mmajor_plain(q, *mm, holes)
                    torch.cuda.synchronize()
                    errs = {"k7_vs_plain": max_err(torch, k7, ref),
                            "k8_vs_plain": max_err(torch, k8, ref),
                            "k4_vs_plain": max_err(torch, k4, ref),
                            "k7_vs_k8": max_err(torch, k7, k8),
                            "k7_vs_k4": max_err(torch, k7, k4),
                            "holes_k7_vs_plain": max_err(torch, h7, href),
                            "holes_k8_vs_plain": max_err(torch, h8, href)}
                    finite = all(torch.isfinite(t.float()).all() for t in (k7, k8, h7, h8))
                    if not (finite and max(errs.values()) <= KV_TOL[dn]):
                        raise AssertionError(f"kvattn_full M={M} L={Ls} {dn}: {errs}")
                    errs_by[dn] = errs
                    k7_k4[dn] = torch.equal(k7, k4)
                split = {"L": Ls, "n_split": ns, "max_abs_err": errs_by,
                         "k7_bitwise_equals_k4": k7_k4}
                if ns > 1:
                    q = torch.randn((B, 1, K * REP, DH), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    split["bitwise_k7"] = _kv_bitwise(
                        torch, kvattn,
                        lambda: kvattn.int8_decode_attention_kmajor(q, *km, holes),
                        f"kvattn_full K7 M={M} L={Ls}")
                    split["bitwise_k8"] = _kv_bitwise(
                        torch, kvattn, lambda: kvattn.int8_decode_attention(q, *mm, holes),
                        f"kvattn_full K8 M={M} L={Ls}")
                row["split"][f"L{Ls}"] = split
        row["max_abs_err"] = row["split"][f"L{L}"]["max_abs_err"]
        q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(torch.bfloat16)
        sweep = [x for x in (*SPAN_SWEEP, 512) if x < M]
        row["k7"] = _kv_times(
            torch, kvattn, lambda: kvattn.int8_decode_attention_kmajor(q, *km, prefix),
            lambda: kvattn.int8_decode_attention_kmajor_plain(q, *km, prefix), flush, M, sweep)
        row["k8"] = _kv_times(
            torch, kvattn, lambda: kvattn.int8_decode_attention(q, *mm, prefix),
            lambda: kvattn.int8_decode_attention_mmajor_plain(q, *mm, prefix), flush, M, sweep)
        row.update({"k7_ms": row["k7"]["kernel_ms"], "k8_ms": row["k8"]["kernel_ms"],
                    "k4_same_fill_ms": cuda_ms(
                        torch, lambda: kvattn.int8_decode_attention_dynlen(q, *km, pos), flush),
                    "plain_kmajor_ms": row["k7"]["plain_ms"],
                    "plain_mmajor_ms": row["k8"]["plain_ms"]})
        # What the body costs when it reads every position: K4 at watermarks
        # M-1 on K7's spans, and K7 at other q rows per kv head (the bytes
        # stay, the arithmetic scales with rep).
        last = torch.full((B,), M - 1, dtype=torch.int32, device="cuda")
        with _span(kvattn, L):
            row["k4_full_fill_ms"] = cuda_ms(
                torch, lambda: kvattn.int8_decode_attention_dynlen(q, *km, last), flush)
        row["k7_rep_ms"] = {}
        for rep in (1, 2, 4, 8):
            qr = torch.randn((B, 1, K * rep, DH), generator=gen, device="cuda").to(torch.bfloat16)
            row["k7_rep_ms"][str(rep)] = cuda_ms(
                torch, lambda: kvattn.int8_decode_attention_kmajor(qr, *km, prefix), flush)
        # The full pool is read whatever the mask: payloads, scales, the
        # mask, q and the output once each.
        nbytes = B * K * M * 2 * (DH + 4) + B * M + 2 * (2 * B * K * REP * DH)
        row["bound_ms"], row["bound_by"] = bound(4.0 * B * M * K * REP * DH, nbytes)
        row["library_ms"] = None
        out["pools"][str(M)] = row
    out["launches"] = {"kvattn_kmajor": kvattn.int8_decode_attention_kmajor.launches,
                       "kvattn_mmajor": kvattn.int8_decode_attention.launches}
    return out


def train_config(torch, **overrides):
    """The 1b scale for training: the zoo's shapes with f32 master weights
    (its bf16 params are the serving footprint)."""
    from torchkafka_tpu_torch.models.zoo import zoo_config

    return dataclasses.replace(
        zoo_config("1b", max_seq_len=512), param_dtype=torch.float32, **overrides
    )


def check_train_grads(torch) -> dict:
    """One loss + backward at 1b width, 2 layers, S=512, B=2, through the
    flash kernels (K1, K2, K3) and through dense attention, from the same
    f32 master weights: the loss and every gradient must agree. Both run
    the bf16 compute path; the tolerance is a few bf16 roundings (2^-8
    relative each) compounded through two layers. A dense run in f32
    compute is printed beside them, to show how far each bf16 path sits
    from exact arithmetic."""
    import numpy as np

    from torchkafka_tpu_torch.models.transformer import Transformer, init_params

    tol = {"loss_abs": 2e-2, "grad_rel_l2": 2e-2}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    base = init_params(gen, train_config(torch, n_layers=2), device="cuda")
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 32_000, (2, 512), dtype=np.int32)).cuda()
    out = {}
    for name, impl, dtype in (("flash", "flash", torch.bfloat16),
                              ("dense", "dense", torch.bfloat16),
                              ("dense_f32", "dense", torch.float32)):
        params = _clone_tree(torch, base)
        cfg = train_config(torch, n_layers=2, attn_impl=impl, dtype=dtype)
        loss = Transformer(cfg).loss(params, toks)
        loss.backward()
        out[name] = (loss.item(), _grads(params))

    def rel_l2(a, b):
        ga, gb = out[a][1], out[b][1]
        return {n: float((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n in gb}

    rel = rel_l2("flash", "dense")
    worst = max(rel, key=rel.get)
    l_f, l_d = out["flash"][0], out["dense"][0]
    if not (abs(l_f - l_d) <= tol["loss_abs"] and rel[worst] <= tol["grad_rel_l2"]
            and np.isfinite(l_f)):
        raise AssertionError(f"train_grad: loss {l_f} vs {l_d}, worst grad {worst} {rel[worst]}")
    return {"phase": "train_grad", "model": "1b width, 2 layers", "B": 2, "S": 512,
            "tolerance": tol, "loss_flash": l_f, "loss_dense": l_d,
            "loss_dense_f32": out["dense_f32"][0], "grad_rel_l2": rel, "worst": worst,
            "worst_vs_f32": {n: max(rel_l2(n, "dense_f32").values())
                             for n in ("flash", "dense")}}


def _clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.grad.float()
    return out


def train(torch, steps: int = 6, batch: int = 8, seq: int = 512, parts: int = 4,
          prof=None) -> dict:
    """The main training path: broker → MemoryConsumer → KafkaStream
    (fixed_width decode, pinned side-stream H2D) → make_train_step (K1
    forward, fused CE, K2+K3 backward, AdamW) → token.commit(wait_for=loss)
    → consumer.commit. K1/K2/K3 launch counts (and their tensor-core
    counts) are zeroed just before the loop and read just after. ``prof``:
    an optional profiler context wrapped around one extra step after the
    run."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.ops.flash import flash_dkv_bhsd, flash_dq_bhsd, flash_fwd_bhsd

    cfg = train_config(torch)
    init_fn, step_fn = tk.make_train_step(cfg, optimizer=tk.adamw(1e-3), device="cuda")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "ln_f", "lm_head"))
    broker = tk.InMemoryBroker()
    broker.create_topic("train", partitions=parts)
    rng = np.random.default_rng(SEED)
    for i in range(steps * batch):  # exactly what the steps consume
        toks = rng.integers(0, cfg.vocab_size, seq, dtype=np.int32)
        broker.produce("train", toks.tobytes(), partition=i % parts)
    consumer = tk.MemoryConsumer(
        broker, "train", group_id="train-group",
        assignment=tk.partitions_for_process("train", parts, 0, 1),
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_fwd_bhsd, flash_dq_bhsd, flash_dkv_bhsd):
        fn.launches = 0
        fn.tc_launches = 0
    losses, step_ms, wall_ms = [], [], []
    t0 = time.perf_counter()
    with tk.KafkaStream(consumer, tk.fixed_width(seq, np.int32), batch_size=batch,
                        idle_timeout_ms=2000, owns_consumer=True, device="cuda") as stream:
        it = iter(stream)
        for _ in range(steps):
            b, token = next(it)
            if tuple(b.data.shape) != (batch, seq):
                raise AssertionError(f"batch shape {tuple(b.data.shape)}")
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            s_ev.record()
            params, opt, loss = step_fn(params, opt, b.data, None)
            e_ev.record()
            if not token.commit(wait_for=loss):
                raise AssertionError("offset commit failed")
            wall_ms.append((time.perf_counter() - h0) * 1e3)
            step_ms.append(s_ev.elapsed_time(e_ev))
            losses.append(loss.item())
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"flash_fwd": flash_fwd_bhsd.launches, "flash_dq": flash_dq_bhsd.launches,
                    "flash_dkv": flash_dkv_bhsd.launches}
        tc_launches = {"flash_fwd": flash_fwd_bhsd.tc_launches,
                       "flash_dq": flash_dq_bhsd.tc_launches,
                       "flash_dkv": flash_dkv_bhsd.tc_launches}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if prof is not None:  # one more step on the last batch, traced
            with prof:
                step_fn(params, opt, b.data, None)
                torch.cuda.synchronize()
    committed = {p: broker.committed("train-group", tk.TopicPartition("train", p))
                 for p in range(parts)}
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if not all(o is not None and o > 0 for o in committed.values()):
        raise AssertionError(f"a partition's watermark did not advance: {committed}")
    if sum(committed.values()) != steps * batch:
        raise AssertionError(f"Σ watermarks {committed} != {steps * batch} rows consumed")
    want = cfg.n_layers * steps
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches}, want {want} each")
    if any(n != want for n in tc_launches.values()):  # bf16, D=128: the tensor cores
        raise AssertionError(f"tensor-core launches {tc_launches}, want {want} each")
    steady = statistics.median(step_ms[1:])
    return {"phase": "train", "model": "1b", "params": n_params,
            "param_dtype": "float32", "compute_dtype": "bfloat16",
            "batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "step_ms": step_ms, "step_ms_median_after_first": steady,
            "host_step_wall_ms": wall_ms,
            "trained_tokens_per_s": batch * seq / (steady / 1e3),
            "records_per_s_loop": steps * batch / elapsed, "loop_s": elapsed,
            "committed": committed, "launches": launches, "tc_launches": tc_launches,
            "peak_mem_gb": peak}


def serve(torch, cfg, params, prompts, kv_dtype, prof=None):
    """Serve ``prompts`` once through the port's StreamingGenerator; the
    kernel launch counts are zeroed just before ``run`` and read after.
    ``prof``: an optional profiler context wrapped around ``run``."""
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import int8_decode_attention_dynlen
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    n, plen = prompts.shape
    broker = InMemoryBroker()
    broker.create_topic("t7", partitions=2)
    for i in range(n):
        broker.produce("t7", prompts[i].tobytes(), partition=i % 2)
    consumer = MemoryConsumer(broker, "t7", group_id="s7")
    max_new = MAX_NEW
    server = StreamingGenerator(
        consumer, params, cfg, slots=16, prompt_len=plen, max_new=max_new,
        commit_every=16, ticks_per_sync=max_new - 1, kv_dtype=kv_dtype,
        kv_kernel=True if kv_dtype else "auto", device="cuda",
    )
    server.warmup()
    torch.cuda.reset_peak_memory_stats()
    flash_fwd_bhsd.launches = 0
    flash_fwd_bhsd.tc_launches = 0
    int8_decode_attention_dynlen.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd_bhsd.launches,
                "flash_fwd_tc": flash_fwd_bhsd.tc_launches,
                "kvattn_dynlen": int8_decode_attention_dynlen.launches}
    consumer.close()
    tps = [TopicPartition("t7", p) for p in (0, 1)]
    committed = [broker.committed("s7", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    m = server.metrics.summary()
    if len(outs) != n or any(len(o) != max_new for o in outs.values()):
        raise AssertionError(f"{len(outs)} completions, lengths {sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError("token out of the vocabulary")
    nl = cfg.n_layers
    if launches["flash_fwd"] != nl * m["prefills"] or m["prefills"] == 0:
        raise AssertionError(f"flash launches {launches} vs {m['prefills']} prefills")
    if launches["flash_fwd_tc"] != launches["flash_fwd"]:  # bf16, D=128: the tensor cores
        raise AssertionError(f"flash tensor-core launches {launches}")
    want_k4 = nl * m["decode_ticks"] if kv_dtype else 0
    if launches["kvattn_dynlen"] != want_k4 or (kv_dtype and want_k4 == 0):
        raise AssertionError(f"kvattn launches {launches} vs {m['decode_ticks']} ticks")
    tokens = sum(len(o) for o in outs.values())
    row = {"phase": "serve", "model": "1b", "kv_dtype": kv_dtype or "bf16",
           "completions": len(outs), "tokens": tokens, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "committed": committed,
           "end_offsets": ends, "prefills": m["prefills"],
           "decode_ticks": m["decode_ticks"], "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return outs, row


TENANTS = ("alpha", "beta", "gamma")
PAGED_BS = 16  # vLLM's default page size


def tenant_prompts(np, vocab: int, n: int = 48, plen: int = 128, sys_len: int = 96):
    """Scenario 12's stream shape at the serve phase's lengths: three tenants,
    each with a fixed system prompt of ``sys_len`` tokens (whole blocks of
    16) followed by random tokens. Returns (prompts [n, plen], keys)."""
    rng = np.random.default_rng(SEED + 12)
    system = rng.integers(0, vocab, (len(TENANTS), sys_len), dtype=np.int32)
    prompts = rng.integers(0, vocab, (n, plen), dtype=np.int32)
    prompts[:, :sys_len] = system[np.arange(n) % len(TENANTS)]
    return prompts, [TENANTS[i % len(TENANTS)].encode() for i in range(n)]


def serve_paged(torch, cfg, params, prompts, keys, kv_kernel: bool, parts: int = 4,
                prof=None):
    """Serve the tenant stream once through the port's paged
    StreamingGenerator (int8 pool, radix prefix reuse, chunked prefill),
    produced keyed by tenant onto ``parts`` partitions. Every kernel launch
    count is zeroed just before ``run`` and read just after; the peak of
    live pool blocks is sampled around every tick block. ``prof``: an
    optional profiler context wrapped around ``run``."""
    import numpy as np

    from torchkafka_tpu_torch.kvcache import PagedKVConfig
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.kvattn import (
        int8_decode_attention_dynlen,
        int8_paged_decode_attention,
    )
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
    from torchkafka_tpu_torch.source.records import TopicPartition

    n, plen = prompts.shape
    slots, ticks = 16, 8
    nblk = -(-(plen + MAX_NEW) // PAGED_BS)
    pages = PagedKVConfig(block_size=PAGED_BS, num_blocks=slots * nblk + 24 + 1,
                          prefill_chunk=None)
    broker = InMemoryBroker()
    broker.create_topic("t12", partitions=parts)
    for i in range(n):
        broker.produce("t12", prompts[i].tobytes(), key=keys[i])
    consumer = MemoryConsumer(broker, "t12", group_id="s12")
    server = StreamingGenerator(
        consumer, params, cfg, slots=slots, prompt_len=plen, max_new=MAX_NEW,
        commit_every=16, ticks_per_sync=ticks, kv_dtype="int8", kv_kernel=kv_kernel,
        kv_pages=pages, device="cuda",
    )
    server.warmup()
    peak_blocks = [0, 0]  # allocated (slot-held + cached), slot-held
    step = server.step

    def sample():
        tbl = server._table_np
        held = len(np.unique(tbl[tbl != 0]))
        peak_blocks[0] = max(peak_blocks[0], server._kv_alloc.allocated())
        peak_blocks[1] = max(peak_blocks[1], held)

    def sampled_step():
        sample()
        out = step()
        sample()
        return out

    server.step = sampled_step
    kernels = (flash_fwd_bhsd, int8_decode_attention_dynlen, int8_paged_decode_attention)
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_fwd": kernels[0].launches, "kvattn_dynlen": kernels[1].launches,
                "kvattn_paged": kernels[2].launches}
    consumer.close()
    tps = [TopicPartition("t12", p) for p in range(parts)]
    committed = [broker.committed("s12", tp) or 0 for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    m = server.metrics.summary()
    cache, chunks = m["prefix_cache"], m["chunked_prefill"]
    if len(outs) != n or any(len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"paged: {len(outs)} completions, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"paged: committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError("paged: token out of the vocabulary")
    if not (cache["hits"] > 0 and cache["prefill_tokens"] < n * plen):
        raise AssertionError(f"paged: no prefix reuse {cache}")
    want_k5 = cfg.n_layers * (m["decode_ticks"] - chunks["chunk_ticks"]) if kv_kernel else 0
    if launches["kvattn_paged"] != want_k5 or (kv_kernel and want_k5 <= 0):
        raise AssertionError(f"paged: K5 launches {launches} vs {m['decode_ticks']} decode "
                             f"ticks, {chunks['chunk_ticks']} chunk ticks")
    if launches["flash_fwd"] or launches["kvattn_dynlen"]:
        raise AssertionError(f"paged: dense-path kernels launched {launches}")
    tokens = sum(len(o) for o in outs.values())
    kv_row = cfg.n_kv_heads * 2 * (cfg.head_dim + 4) * cfg.n_layers  # int8 k+v, f32 scales
    row = {"phase": "serve_paged", "model": f"1b width, {cfg.n_layers} layers",
           "dtype": str(cfg.dtype).replace("torch.", ""), "kv_dtype": "int8",
           "kv_kernel": kv_kernel, "block_size": PAGED_BS, "num_blocks": pages.num_blocks,
           "prompts": n, "prompt_len": plen, "max_new": MAX_NEW, "slots": slots,
           "ticks_per_sync": ticks, "completions": len(outs), "tokens": tokens,
           "elapsed_s": elapsed, "tokens_per_s": tokens / elapsed,
           "committed": committed, "end_offsets": ends,
           "prefix_hits": cache["hits"], "prefix_misses": cache["misses"],
           "prefix_tokens_saved": cache["prefix_tokens_saved"],
           "prefill_tokens": cache["prefill_tokens"], "prefill_tokens_no_cache": n * plen,
           "decode_ticks": m["decode_ticks"], "chunk_ticks": chunks["chunk_ticks"],
           "chunk_summary": chunks, "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "tick_block_ms_p99": m["step_time"]["p99_ms"],
           "peak_allocated_blocks": peak_blocks[0], "peak_slot_blocks": peak_blocks[1],
           "dense_block_equivalents": slots * nblk,
           "pool_bytes_paged": pages.num_blocks * PAGED_BS * kv_row,
           "pool_bytes_dense_equivalent": slots * (plen + MAX_NEW) * kv_row,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return outs, row


def check_serve_paged(torch, cfg, params, name: str, exact: bool) -> tuple[dict, dict]:
    """The tenant stream through the block-table kernel (K5) and again
    through the gathered read: committed offsets and token 0 must be
    identical; ``exact`` (f32) requires every token identical."""
    import numpy as np

    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    outs_k, row_k = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=True)
    outs_g, row_g = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=False)
    if row_g["committed"] != row_k["committed"]:
        raise AssertionError(f"{name}: the gathered read committed other offsets")
    tok0_same = all(int(outs_g[k][0]) == int(outs_k[k][0]) for k in outs_k)
    agree = float(np.mean([np.mean(outs_g[k] == outs_k[k]) for k in outs_k]))
    for row in (row_k, row_g):
        row["phase"] = name
    row_g["token0_identical_to_kernel_run"] = tok0_same
    row_g["token_agreement_with_kernel_run"] = agree
    if not tok0_same:
        raise AssertionError(f"{name}: token 0 differs between the kernel and gathered reads")
    if exact and agree != 1.0:
        raise AssertionError(f"{name}: f32 tokens differ (agreement {agree})")
    return row_k, row_g


def serve_8b(torch, cfg, params, prompts, kv_kernel: bool, prof=None):
    """Scenario 7 at the 8b scale with an output topic (BASELINE config 5):
    ``prompts`` produced round-robin on two partitions, each keyed by its
    index, served by the port's StreamingGenerator over the dense int8
    pool, every completion published to "completions" keyed by its prompt
    and settled before its offset commits. Every kernel launch count is
    zeroed just before ``run`` and read just after. ``prof``: an optional
    profiler context wrapped around ``run``."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.zoo import params_nbytes
    from torchkafka_tpu_torch.ops import kvattn
    from torchkafka_tpu_torch.ops.flash import flash_fwd_bhsd
    from torchkafka_tpu_torch.ops.qmatmul import quantized_matmul
    from torchkafka_tpu_torch.serve import StreamingGenerator

    n, plen = prompts.shape
    broker = tk.InMemoryBroker()
    broker.create_topic("t7", partitions=2)
    broker.create_topic("completions", partitions=2)
    keys = [f"prompt-{i}".encode() for i in range(n)]
    for i in range(n):
        broker.produce("t7", prompts[i].tobytes(), key=keys[i], partition=i % 2)
    consumer = tk.MemoryConsumer(broker, "t7", group_id="s7")
    server = StreamingGenerator(
        consumer, params, cfg, slots=16, prompt_len=plen, max_new=MAX_NEW,
        commit_every=16, ticks_per_sync=MAX_NEW - 1, kv_dtype="int8",
        kv_kernel=kv_kernel, output_producer=tk.MemoryProducer(broker),
        output_topic="completions", device="cuda",
    )
    server.warmup()
    kernels = {"flash_fwd": flash_fwd_bhsd, "kvattn_dynlen": kvattn.int8_decode_attention_dynlen,
               "qmatmul": quantized_matmul, "kvattn_kmajor": kvattn.int8_decode_attention_kmajor,
               "kvattn_mmajor": kvattn.int8_decode_attention}
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    flash_fwd_bhsd.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {r.key: out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches["flash_fwd_tc"] = flash_fwd_bhsd.tc_launches
    consumer.close()
    tps = [tk.TopicPartition("t7", p) for p in (0, 1)]
    committed = [broker.committed("s7", tp) for tp in tps]
    ends = [broker.end_offset(tp) for tp in tps]
    reader = tk.MemoryConsumer(broker, "completions", group_id="check")
    published = []
    while batch := reader.poll(max_records=1000, timeout_ms=0):
        published.extend(batch)
    reader.close()
    m = server.metrics.summary()
    if len(outs) != n or any(len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"serve_8b: {len(outs)} completions, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if committed != ends:
        raise AssertionError(f"serve_8b: committed {committed} != end offsets {ends}")
    if any(int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size for o in outs.values()):
        raise AssertionError("serve_8b: token out of the vocabulary")
    pub = {r.key: np.frombuffer(r.value, np.int32) for r in published}
    if len(published) != n or sorted(pub) != sorted(keys):
        raise AssertionError(f"serve_8b: {len(published)} output records for {n} prompts")
    if any(not np.array_equal(pub[k], outs[k]) for k in keys):
        raise AssertionError("serve_8b: an output record differs from its completion")
    if any(tuple(r.headers) != (("mv", b"0"),) for r in published):
        raise AssertionError("serve_8b: an output record lacks its mv header")
    if m["output_flush_failures"] or m["output_send_failures"]:
        raise AssertionError(f"serve_8b: output failures {m['output_flush_failures']}, "
                             f"{m['output_send_failures']}")
    nl = cfg.n_layers
    tc = cfg.dtype == torch.bfloat16  # D=128: bf16 on the tensor cores, f32 on the CUDA cores
    want = {"flash_fwd": nl * m["prefills"], "flash_fwd_tc": nl * m["prefills"] if tc else 0,
            "kvattn_dynlen": nl * m["decode_ticks"] if kv_kernel else 0,
            "qmatmul": 0, "kvattn_kmajor": 0, "kvattn_mmajor": 0}
    if launches != want or m["prefills"] == 0 or m["decode_ticks"] == 0:
        raise AssertionError(f"serve_8b: launches {launches}, want {want}")
    kb = m["kv_backend"]
    if kb["kernel"] is not kv_kernel or kb["layout"] != "dense" or kb["kv_dtype"] != "int8":
        raise AssertionError(f"serve_8b: backend {kb}")
    tokens = sum(len(o) for o in outs.values())
    row = {"phase": "serve_8b", "model": f"8b width, {nl} layers",
           "dtype": str(cfg.dtype).replace("torch.", ""), "weights": "int8", "kv_dtype": "int8",
           "kv_kernel": kv_kernel, "kv_read": "K4, K-major" if kv_kernel else
           "plain scale-folded read, M-major", "params_nbytes": params_nbytes(params),
           "prompts": n, "prompt_len": plen, "max_new": MAX_NEW, "slots": 16,
           "completions": len(outs), "tokens": tokens, "elapsed_s": elapsed,
           "tokens_per_s": tokens / elapsed, "committed": committed, "end_offsets": ends,
           "output_records": len(published), "output_flush_failures": m["output_flush_failures"],
           "prefills": m["prefills"], "decode_ticks": m["decode_ticks"], "launches": launches,
           "tick_block_ms_p50": m["step_time"]["p50_ms"],
           "tick_block_ms_p99": m["step_time"]["p99_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return outs, row


def check_serve_8b(torch, cfg, name: str, exact: bool):
    """The 8b path twice, K4 then the plain M-major read: both runs must
    commit the same offsets and agree on token 0; ``exact`` (f32) requires
    every token identical. Returns (rows, params, prompts) for the
    optional profile."""
    import numpy as np

    from torchkafka_tpu_torch.models.zoo import random_serving_params

    t0 = time.perf_counter()
    params = random_serving_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, quantized=True, device="cuda"
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (48, 128),
                                                   dtype=np.int32)
    outs_k, row_k = serve_8b(torch, cfg, params, prompts, kv_kernel=True)
    outs_p, row_p = serve_8b(torch, cfg, params, prompts, kv_kernel=False)
    row_k["params_build_s"] = build_s
    for row in (row_k, row_p):
        row["phase"] = name
    if row_p["committed"] != row_k["committed"]:
        raise AssertionError(f"{name}: the plain read committed other offsets")
    tok0_same = all(int(outs_p[k][0]) == int(outs_k[k][0]) for k in outs_k)
    agree = float(np.mean([np.mean(outs_p[k] == outs_k[k]) for k in outs_k]))
    row_p["token0_identical_to_k4_run"] = tok0_same
    row_p["token_agreement_with_k4_run"] = agree
    if not tok0_same:
        raise AssertionError(f"{name}: token 0 differs between the K4 and plain reads")
    if exact and agree != 1.0:
        raise AssertionError(f"{name}: f32 tokens differ (agreement {agree})")
    return (row_k, row_p), params, prompts


def profile_serve_8b(torch, cfg, params, prompts, row_k) -> dict:
    """One wave of the 8b K4 run (16 prompts: one prefill and 63 decode
    ticks) under torch.profiler: device time by kernel against the
    profiled wall time and the unprofiled tick time."""
    prof = _profiler(torch)
    _, row = serve_8b(torch, cfg, params, prompts[:16], kv_kernel=True, prof=prof)
    return profile_summary(prof, "one 8b int8 wave (K4) under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "prefills": row["prefills"],
        "profiled_wall_ms": row["elapsed_s"] * 1e3,
        "unprofiled_tick_wall_ms": row_k["tick_block_ms_p50"] / (MAX_NEW - 1)})


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


PORT_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                "flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel",
                "kvattn_split_kernel_dense", "kvattn_split_kernel_paged",
                "kvattn_i8_convert_kernel", "kvattn_split_kernel_full",
                "qmm_decode_kernel", "qmm_tile_kernel", "qmm_tc_kernel",
                "qmm_i8_convert_kernel")


def profile_summary(prof, run: str, extra: dict) -> dict:
    """Device time by kernel name from a finished profiler: the total, the
    twelve busiest and every kernel of ``csrc/`` that ran. Device-side
    events only (kernels, copies, memsets): CPU ops also carry their
    children's device time and would count it twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)

    # User annotations (e.g. the optimizer's step range) also appear on the
    # device timeline; they span kernels already counted.
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith("Optimizer.")]
    top = sorted(evs, key=dev_us, reverse=True)[:12]
    ours = [e for e in evs if any(f"::{k}<" in e.key for k in PORT_KERNELS)]

    def row(e):
        return {"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3}

    return {"phase": "profile", "run": run,
            "device_ms_total": sum(dev_us(e) for e in evs) / 1e3, **extra,
            "top": [row(e) for e in top], "port_kernels": [row(e) for e in ours]}


def profile_serve(torch, cfg, params, prompts, row_q) -> dict:
    """The int8 serve run again under torch.profiler: device time per
    decode tick by kernel, against the unprofiled run's tick wall time
    (the profiler slows the host, so only its device times are used)."""
    prof = _profiler(torch)
    _, row = serve(torch, cfg, params, prompts, "int8", prof=prof)
    return profile_summary(prof, "int8 serve under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "prefills": row["prefills"],
        "unprofiled_tick_wall_ms": row_q["tick_block_ms_p50"] / (MAX_NEW - 1)})


def profile_paged(torch, cfg, params, row_p) -> dict:
    """The paged int8 serve run (K5 engaged) again under torch.profiler:
    device time by kernel against the profiled run's wall time (the
    profiler slows the host, so the idle share it implies is an upper
    bound) and the unprofiled run's tick-block time."""
    import numpy as np

    prompts, keys = tenant_prompts(np, cfg.vocab_size)
    prof = _profiler(torch)
    _, row = serve_paged(torch, cfg, params, prompts, keys, kv_kernel=True, prof=prof)
    return profile_summary(prof, "paged int8 serve (K5) under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "chunk_ticks": row["chunk_ticks"],
        "profiled_wall_ms": row["elapsed_s"] * 1e3,
        "unprofiled_tick_block_ms_p50": row_p["tick_block_ms_p50"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (a quick build check)")
    ap.add_argument("--profile", nargs="?", const="all",
                    choices=("all", "train", "serve", "paged", "serve8b"),
                    help="also trace one train step, the dense int8 serve run, "
                         "the paged int8 serve run and/or one wave of the 8b "
                         "int8 serve run under torch.profiler and print where "
                         "the device time goes (a serve trace takes minutes)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config
    from torchkafka_tpu_torch.ops import _native, flash, kvattn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": {"matmul": False, "cudnn": False}})

    t0 = time.perf_counter()
    _native.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"torchkafka_tpu_torch/csrc/{k}.cu" for k in _native.KERNELS],
          "flags": list(_native.NVCC_FLAGS)})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    k1 = check_flash(torch, F, flash, flush, gen)
    emit(k1)
    k23 = check_flash_bwd(torch, F, flash, flush, gen)
    emit(k23)
    k4 = check_kvattn(torch, kvattn, flush, gen)
    emit(k4)
    k5 = check_kvattn_paged(torch, kvattn, flush, gen)
    emit(k5)
    k6 = check_qmatmul(torch, kvattn, flush, gen)
    emit(k6)
    k78 = check_kvattn_full(torch, kvattn, flush, gen)
    emit(k78)
    if args.kernels_only:
        return 0
    del flush

    emit(check_train_grads(torch))
    torch.cuda.empty_cache()
    prof_t = _profiler(torch) if args.profile in ("all", "train") else None
    row_t = train(torch, prof=prof_t)
    emit(row_t)
    if prof_t is not None:
        emit(profile_summary(prof_t, "one 1b train step (B=8, S=512) under torch.profiler",
                             {"unprofiled_step_ms": row_t["step_ms_median_after_first"]}))
    torch.cuda.empty_cache()

    cfg = zoo_config("1b")
    params = random_serving_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda"
    )
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (32, 128), dtype=np.int32
    )
    outs_q, row_q = serve(torch, cfg, params, prompts, "int8")
    emit(row_q)
    outs_b, row_b = serve(torch, cfg, params, prompts, None)
    if row_b["committed"] != row_q["committed"]:
        raise AssertionError("bf16 run committed other offsets")
    tok0_same = all(int(outs_b[key][0]) == int(outs_q[key][0]) for key in outs_q)
    agree = float(np.mean([np.mean(outs_b[key] == outs_q[key]) for key in outs_q]))
    row_b["token0_identical_to_int8_run"] = tok0_same
    row_b["token_agreement_with_int8_run"] = agree
    emit(row_b)
    if not tok0_same:
        raise AssertionError("token 0 differs between the int8 and bf16 runs")

    if args.profile in ("all", "serve"):
        emit(profile_serve(torch, cfg, params, prompts, row_q))

    row_p, row_pg = check_serve_paged(torch, cfg, params, "serve_paged", exact=False)
    emit(row_p)
    emit(row_pg)
    if args.profile in ("all", "paged"):
        emit(profile_paged(torch, cfg, params, row_p))
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                                param_dtype=torch.float32)
    params32 = random_serving_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg32, device="cuda"
    )
    row_f, row_fg = check_serve_paged(torch, cfg32, params32, "serve_paged_f32",
                                      exact=True)
    emit(row_f)
    emit(row_fg)
    del params32
    torch.cuda.empty_cache()

    cfg8 = zoo_config("8b", max_seq_len=128 + MAX_NEW)
    rows_8b, params8, prompts8 = check_serve_8b(torch, cfg8, "serve_8b", exact=False)
    for row in rows_8b:
        emit(row)
    if args.profile in ("all", "serve8b"):
        emit(profile_serve_8b(torch, cfg8, params8, prompts8, rows_8b[0]))
    del params8
    torch.cuda.empty_cache()
    cfg8_32 = dataclasses.replace(cfg8, n_layers=2, dtype=torch.float32,
                                  param_dtype=torch.float32)
    rows_8b32, params8_32, _ = check_serve_8b(torch, cfg8_32, "serve_8b_f32", exact=True)
    for row in rows_8b32:
        emit(row)
    del params8_32
    torch.cuda.empty_cache()

    main_pool = k4["pools"]["192"]
    pool_8b = k4["reps"]["4"]
    k6_main = k6["cases"]["w_gate_m16_bfloat16"]
    k78_main = k78["pools"]["192"]
    main_view = k5["views"]["192"]

    def path_8b(kernel):
        return sum(row["launches"][kernel] for row in rows_8b)

    def full_split(which):
        """K7's or K8's split and span times at the 192 pool, and at 2048."""
        big = k78["pools"]["2048"]
        return {"n_split": k78_main["n_split"], "span": k78_main["L"],
                "one_span_ms": k78_main[which]["one_span_ms"],
                "span_ms": _spans(k78_main[which]),
                "pool_2048": {"n_split": big["n_split"], "span": big["L"],
                              "kernel_ms": big[which]["kernel_ms"],
                              "one_span_ms": big[which]["one_span_ms"],
                              "span_ms": _spans(big[which]),
                              "plain_ms": big[which]["plain_ms"], "bound_ms": big["bound_ms"]}}

    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:61",
         "launches": row_q["launches"]["flash_fwd"],
         "tc_launches": row_q["launches"]["flash_fwd_tc"],
         "kernel_route": k1["prefill"]["route"],
         "max_abs_err": k1["err_main"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "train_shape": {key: k1["train_shape"][key] for key in (
             "kernel_ms", "simt_bf16_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
         "train_launches": row_t["launches"]["flash_fwd"],
         "train_tc_launches": row_t["tc_launches"]["flash_fwd"]},
        {"name": "flash_dq", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:201",
         "launches": row_t["launches"]["flash_dq"],
         "tc_launches": row_t["tc_launches"]["flash_dq"],
         "max_abs_err": k23["max_abs_err"]["main_bf16"]["dq"],
         "ms": k23["dq"]["kernel_ms"], "plain_ms": k23["dq"]["plain_ms"],
         "bound_ms": k23["dq"]["bound_ms"], "bound_by": k23["dq"]["bound_by"],
         "library_ms": k23["library_ms_sdpa_bwd"]},
        {"name": "flash_dkv", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:252",
         "launches": row_t["launches"]["flash_dkv"],
         "tc_launches": row_t["tc_launches"]["flash_dkv"],
         "max_abs_err": max(k23["max_abs_err"]["main_bf16"][x] for x in ("dk", "dv")),
         "ms": k23["dkv"]["kernel_ms"], "plain_ms": k23["dkv"]["plain_ms"],
         "bound_ms": k23["dkv"]["bound_ms"], "bound_by": k23["dkv"]["bound_by"],
         "library_ms": k23["library_ms_sdpa_bwd"]},
        {"name": "kvattn_dynlen", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_dynlen.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:458",
         "launches": row_q["launches"]["kvattn_dynlen"],
         "max_abs_err": main_pool["max_abs_err"]["bf16"], "ms": main_pool["kernel_ms"],
         "plain_ms": main_pool["plain_ms"], "bound_ms": main_pool["bound_ms"],
         "bound_by": main_pool["bound_by"], "library_ms": None,
         "n_split": main_pool["n_split"], "span": main_pool["L"],
         "one_span_ms": main_pool["one_span_ms"], "span_ms": _spans(main_pool),
         "path_8b_launches": path_8b("kvattn_dynlen"),
         "pool_2048": {**{key: k4["pools"]["2048"][key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")},
                       "span_ms": _spans(k4["pools"]["2048"])},
         "shape_8b": {key: pool_8b[key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")}},
        {"name": "kvattn_paged", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_paged.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:755",
         "launches": row_p["launches"]["kvattn_paged"],
         "max_abs_err": main_view["max_abs_err"]["bf16"], "ms": main_view["kernel_ms"],
         "plain_ms": main_view["plain_ms"], "bound_ms": main_view["bound_ms"],
         "bound_by": main_view["bound_by"], "library_ms": None,
         "n_split": main_view["n_split"], "span": main_view["L"],
         "one_span_ms": main_view["one_span_ms"], "span_ms": _spans(main_view),
         "view_2048": {**{key: k5["views"]["2048"][key] for key in (
             "n_split", "kernel_ms", "one_span_ms", "plain_ms", "bound_ms")},
                       "span_ms": _spans(k5["views"]["2048"])}},
        # K6-K8 lie on no serving or training path, as in the JAX package:
        # "launches" counts the calls of their own phase, "path_launches"
        # those of the two full-depth 8b serve runs.
        {"name": "qmatmul", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/qmatmul.cu",
         "replaces": "torchkafka_tpu/ops/qmatmul.py:50",
         "launches": k6["launches"], "path_launches": path_8b("qmatmul"),
         "max_abs_err": k6_main["max_abs_err"], "ms": k6_main["kernel_ms"],
         "plain_ms": k6_main["plain_ms"], "bound_ms": k6_main["bound_ms"],
         "bound_by": k6_main["bound_by"], "library_ms": k6_main["library_ms"],
         "library": k6_main["library"], "tc_launches": k6["tc_launches"],
         "kernel_route": k6_main["route"], "simt_bf16_ms": k6_main["simt_bf16_ms"],
         "prefill_2048": {key: k6["cases"]["w_gate_m2048_bfloat16"][key] for key in (
             "route", "max_abs_err", "kernel_ms", "simt_bf16_ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by", "tflops")}},
        {"name": "kvattn_kmajor", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_full.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:169",
         "launches": k78["launches"]["kvattn_kmajor"],
         "path_launches": path_8b("kvattn_kmajor"),
         "max_abs_err": k78_main["max_abs_err"]["bf16"]["k7_vs_plain"],
         "ms": k78_main["k7_ms"], "plain_ms": k78_main["plain_kmajor_ms"],
         "bound_ms": k78_main["bound_ms"], "bound_by": k78_main["bound_by"],
         "library_ms": None, **full_split("k7")},
        {"name": "kvattn_mmajor", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_full.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:98",
         "launches": k78["launches"]["kvattn_mmajor"],
         "path_launches": path_8b("kvattn_mmajor"),
         "max_abs_err": k78_main["max_abs_err"]["bf16"]["k8_vs_plain"],
         "ms": k78_main["k8_ms"], "plain_ms": k78_main["plain_mmajor_ms"],
         "bound_ms": k78_main["bound_ms"], "bound_by": k78_main["bound_by"],
         "library_ms": None, **full_split("k8")},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
