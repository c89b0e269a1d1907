"""On-card smoke check of the PyTorch/CUDA port (``torchkafka_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: both CUDA kernels built from ``torchkafka_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together);
3. flash_fwd: the flash-attention kernel against its plain PyTorch version
   at the 1b prefill shape, plus a ragged and an offset case, and timings
   (CUDA events, median of 25, L2 flushed before each timed launch);
4. kvattn_dynlen: the int8 decode kernel against its plain version at the
   1b decode shape with pools of 192 and 2048 positions, and timings;
5. serve: the 1b model at full width and depth, random bf16 weights made on
   the card from a seed, 32 prompts of 128 tokens on two partitions served
   by ``StreamingGenerator`` with the int8 pool (the main path: every
   kernel launch count is zeroed just before it and read just after), then
   again with the bf16 pool;
6. kernels: one line for every ported kernel;
then the card's nvidia-smi line and, last, ``{"ok": true, "device": ...}``.

Float32 matmuls run in full precision (TF32 off for matmul and cuDNN).
Any failure raises and exits non-zero without the last line; so does a
machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
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
    """K1 against its plain version: bf16 at the 1b prefill shape, a ragged
    S, a k_offset case with fully masked rows, and f32 for a tight check."""
    B, S, H, K, D = 16, 128, 16, 8, 128
    tol = {"bf16_o": 4e-2, "lse": 1e-3, "f32_o": 1e-4}

    def make(s, dtype):
        mk = lambda n: torch.randn((n, s, D), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(B * H), mk(B * K), mk(B * K)

    cases = {
        "main_bf16": (S, torch.bfloat16, 0, 0),
        "ragged_s200_bf16": (200, torch.bfloat16, 0, 0),
        "k_offset64_bf16": (S, torch.bfloat16, 0, 64),
        "main_f32": (S, torch.float32, 0, 0),
    }
    errs = {}
    for name, (s, dtype, qo, ko) in cases.items():
        q, k, v = make(s, dtype)
        kw = dict(causal=True, q_offset=qo, k_offset=ko, n_q_heads=H, n_kv_heads=K)
        o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
        po, plse = flash.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        e_o, e_l = max_err(torch, o, po), max_err(torch, lse, plse)
        limit = tol["f32_o"] if dtype == torch.float32 else tol["bf16_o"]
        if not (e_o <= limit and e_l <= tol["lse"]):
            raise AssertionError(f"flash_fwd {name}: o err {e_o}, lse err {e_l}")
        if not (torch.isfinite(o.float()).all() and o.shape == po.shape):
            raise AssertionError(f"flash_fwd {name}: bad output")
        errs[name] = {"o": e_o, "lse": e_l}
    q, k, v = make(S, torch.bfloat16)
    kw = dict(causal=True, n_q_heads=H, n_kv_heads=K)
    ms = cuda_ms(torch, lambda: flash.flash_fwd_bhsd(q, k, v, **kw), flush)
    plain_ms = cuda_ms(torch, lambda: flash.flash_fwd_plain(q, k, v, **kw), flush)
    # The library yardstick, in its own [B, H, S, D] layout (copies made
    # outside the timed region); never called by the port.
    qs, ks, vs = (x.reshape(B, -1, S, D) for x in (q, k, v))
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), flush)
    pairs = S * (S + 1) // 2  # allowed (q, k) pairs per head, causal
    flops = 4.0 * D * pairs * B * H  # q·k and p·v multiply-adds
    nbytes = 2 * D * S * (2 * B * H + 2 * B * K) + 4 * B * H * S
    bms, by = bound(flops, nbytes)
    return {"phase": "flash_fwd", "shape": {"B": B, "S": S, "H": H, "K": K, "D": D},
            "tolerance": tol, "max_abs_err": errs, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "err_main": errs["main_bf16"]["o"]}


def check_kvattn(torch, kvattn, flush, gen) -> dict:
    """K4 against its plain version at the 1b decode shape (B=16, K=8,
    rep=2, Dh=128) with pools of 192 (the serve phase's) and 2048."""
    B, K, REP, DH = 16, 8, 2, 128
    tol = {"bf16": 3e-2, "f32": 1e-4}
    out = {"phase": "kvattn_dynlen", "shape": {"B": B, "K": K, "rep": REP, "Dh": DH},
           "tolerance": tol, "pools": {}}
    for M in (192, 2048):
        base = [0, 63, 64, 127, 128, M // 2 + 5, M - 2, M - 1]
        pos = torch.tensor((base * 2)[:B], dtype=torch.int32, device="cuda")
        kq, vq = (torch.randint(-127, 127, (B, K, M, DH), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((B, K, M), generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        row = {}
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(dtype)
            got = kvattn.int8_decode_attention_dynlen(q, kq, ks, vq, vs, pos)
            ref = kvattn.int8_decode_attention_plain(q, kq, ks, vq, vs, pos)
            torch.cuda.synchronize()
            err = max_err(torch, got, ref)
            lim = tol["f32"] if dtype == torch.float32 else tol["bf16"]
            if not (err <= lim and torch.isfinite(got.float()).all()):
                raise AssertionError(f"kvattn M={M} {dtype}: err {err}")
            row["f32" if dtype == torch.float32 else "bf16"] = err
        q = torch.randn((B, 1, K * REP, DH), generator=gen, device="cuda").to(torch.bfloat16)
        args = (q, kq, ks, vq, vs, pos)
        ms = cuda_ms(torch, lambda: kvattn.int8_decode_attention_dynlen(*args), flush)
        plain_ms = cuda_ms(torch, lambda: kvattn.int8_decode_attention_plain(*args), flush)
        n_read = int((pos.long() + 1).sum())  # positions this run's data needs
        nbytes = n_read * K * 2 * (DH + 4) + 2 * (2 * B * K * REP * DH) + 4 * B
        flops = 4.0 * n_read * K * REP * DH
        bms, by = bound(flops, nbytes)
        out["pools"][str(M)] = {"watermarks": pos.tolist(), "max_abs_err": row,
                                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                                "bound_by": by, "library_ms": None}
    return out


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
    flash_fwd_bhsd.launches = 0
    int8_decode_attention_dynlen.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        outs = {(r.partition, r.offset): out for r, out in server.run(max_records=n)}
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd_bhsd.launches,
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


def profile_serve(torch, cfg, params, prompts, row_q) -> dict:
    """The int8 serve run again under torch.profiler: device time per
    decode tick by kernel, against the unprofiled run's tick wall time
    (the profiler slows the host, so only its device times are used)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, row = serve(torch, cfg, params, prompts, "int8", prof=prof)

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0)

    # Device-side events only (kernels, copies, memsets): CPU ops also
    # carry their children's device time and would count it twice.
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in evs) / 1e3
    ticks = row["decode_ticks"]
    tick_wall_ms = row_q["tick_block_ms_p50"] / (MAX_NEW - 1)
    top = sorted(evs, key=dev_us, reverse=True)[:12]
    return {"phase": "profile", "run": "int8 serve under torch.profiler",
            "device_ms_total": total_ms, "decode_ticks": ticks,
            "prefills": row["prefills"],
            "unprofiled_tick_wall_ms": tick_wall_ms,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (a quick build check)")
    ap.add_argument("--profile", action="store_true",
                    help="also serve the int8 run once under torch.profiler "
                         "and print where the device time goes")
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
    k4 = check_kvattn(torch, kvattn, flush, gen)
    emit(k4)
    if args.kernels_only:
        return 0
    del flush

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

    if args.profile:
        emit(profile_serve(torch, cfg, params, prompts, row_q))

    main_pool = k4["pools"]["192"]
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:61",
         "launches": row_q["launches"]["flash_fwd"],
         "max_abs_err": k1["err_main"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "kvattn_dynlen", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/kvattn_dynlen.cu",
         "replaces": "torchkafka_tpu/ops/kvattn.py:458",
         "launches": row_q["launches"]["kvattn_dynlen"],
         "max_abs_err": main_pool["max_abs_err"]["bf16"], "ms": main_pool["kernel_ms"],
         "plain_ms": main_pool["plain_ms"], "bound_ms": main_pool["bound_ms"],
         "bound_by": main_pool["bound_by"], "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
