"""On-card smoke check of the PyTorch/CUDA port (``torchkafka_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every CUDA kernel built from ``torchkafka_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together);
3. flash_fwd: the flash-attention forward kernel (K1) against its plain
   PyTorch version at the 1b prefill shape, plus a ragged and an offset
   case, and timings (CUDA events, median of 25, L2 flushed before each
   timed launch);
4. flash_bwd: the backward kernels, dQ (K2) and dK/dV (K3), against their
   plain versions at the 1b training shape (B=8, S=512, 16 q / 8 kv heads,
   D=128, bf16), in f32, at a ragged S=200 and at a k_offset with fully
   masked rows (dq = 0 there, no NaN anywhere), and timings, with SDPA's
   backward as the pair's yardstick;
5. kvattn_dynlen: the int8 decode kernel (K4) against its plain version at
   the 1b decode shape with pools of 192 and 2048 positions, and timings;
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
   launched 24 × 6 times (the main path: the counts are zeroed just
   before the loop and read just after);
8. serve: the 1b model at full width and depth, random bf16 weights made on
   the card from a seed, 32 prompts of 128 tokens on two partitions served
   by ``StreamingGenerator`` with the int8 pool (a main path: every kernel
   launch count is zeroed just before it and read just after), then again
   with the bf16 pool;
9. kernels: one line for every ported kernel;
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


def check_flash_bwd(torch, F, flash, flush, gen) -> dict:
    """K2 (dQ) and K3 (dK/dV) against their plain versions at the 1b
    training shape, in f32, at a ragged S and with fully masked rows."""
    B, S, H, K, D = 8, 512, 16, 8, 128
    # Relative to the largest |plain value| of each output: bf16 about one
    # ulp (2^-7 = 7.8e-3) at the top of the range, f32 sums of 512 terms.
    tol = {"bf16_rel": 1e-2, "f32_rel": 1e-5}
    cases = {
        "main_bf16": (B, S, torch.bfloat16, 0, 0),
        "main_f32": (B, S, torch.float32, 0, 0),
        "ragged_s200_bf16": (2, 200, torch.bfloat16, 0, 0),
        "k_offset64_f32": (2, 256, torch.float32, 0, 64),
        "k_offset64_bf16": (2, 256, torch.bfloat16, 0, 64),
    }

    def make(b, s, dtype):
        mk = lambda n: torch.randn((n, s, D), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.float32).to(dtype)
        return mk(b * H), mk(b * K), mk(b * K), mk(b * H)

    errs = {}
    for name, (b, s, dtype, qo, ko) in cases.items():
        q, k, v, do = make(b, s, dtype)
        kw = dict(causal=True, q_offset=qo, k_offset=ko, n_q_heads=H, n_kv_heads=K)
        o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
        got = flash.flash_bwd_bhsd(q, k, v, o, lse, do, **kw)
        ref = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
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
    dq_ms = cuda_ms(torch, lambda: flash.flash_dq_bhsd(*args, **kw), flush)
    dkv_ms = cuda_ms(torch, lambda: flash.flash_dkv_bhsd(*args, **kw), flush)
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
    dq_bound = bound(6.0 * D * pairs, io + 2 * D * S * B * H)
    dkv_bound = bound(8.0 * D * pairs, io + 2 * 2 * D * S * B * K)
    return {"phase": "flash_bwd", "shape": {"B": B, "S": S, "H": H, "K": K, "D": D},
            "tolerance": tol, "max_abs_err": errs,
            "dq": {"kernel_ms": dq_ms, "plain_ms": dq_plain, "bound_ms": dq_bound[0],
                   "bound_by": dq_bound[1]},
            "dkv": {"kernel_ms": dkv_ms, "plain_ms": dkv_plain, "bound_ms": dkv_bound[0],
                    "bound_by": dkv_bound[1]},
            "library_ms_sdpa_bwd": lib_ms}


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
    → consumer.commit. K1/K2/K3 launch counts are zeroed just before the
    loop and read just after. ``prof``: an optional profiler context
    wrapped around one extra step after the run."""
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
    steady = statistics.median(step_ms[1:])
    return {"phase": "train", "model": "1b", "params": n_params,
            "param_dtype": "float32", "compute_dtype": "bfloat16",
            "batch": batch, "seq": seq, "steps": steps, "losses": losses,
            "step_ms": step_ms, "step_ms_median_after_first": steady,
            "host_step_wall_ms": wall_ms,
            "trained_tokens_per_s": batch * seq / (steady / 1e3),
            "records_per_s_loop": steps * batch / elapsed, "loop_s": elapsed,
            "committed": committed, "launches": launches, "peak_mem_gb": peak}


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


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile_summary(prof, run: str, extra: dict) -> dict:
    """Device time by kernel name from a finished profiler: the total and
    the twelve busiest. Device-side events only (kernels, copies, memsets):
    CPU ops also carry their children's device time and would count it
    twice."""
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
    return {"phase": "profile", "run": run,
            "device_ms_total": sum(dev_us(e) for e in evs) / 1e3, **extra,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in top]}


def profile_serve(torch, cfg, params, prompts, row_q) -> dict:
    """The int8 serve run again under torch.profiler: device time per
    decode tick by kernel, against the unprofiled run's tick wall time
    (the profiler slows the host, so only its device times are used)."""
    prof = _profiler(torch)
    _, row = serve(torch, cfg, params, prompts, "int8", prof=prof)
    return profile_summary(prof, "int8 serve under torch.profiler", {
        "decode_ticks": row["decode_ticks"], "prefills": row["prefills"],
        "unprofiled_tick_wall_ms": row_q["tick_block_ms_p50"] / (MAX_NEW - 1)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (a quick build check)")
    ap.add_argument("--profile", nargs="?", const="all", choices=("all", "train", "serve"),
                    help="also trace one train step and/or the int8 serve run "
                         "under torch.profiler and print where the device "
                         "time goes (the serve trace takes minutes)")
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

    main_pool = k4["pools"]["192"]
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:61",
         "launches": row_q["launches"]["flash_fwd"],
         "max_abs_err": k1["err_main"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "flash_dq", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:201",
         "launches": row_t["launches"]["flash_dq"],
         "max_abs_err": k23["max_abs_err"]["main_bf16"]["dq"],
         "ms": k23["dq"]["kernel_ms"], "plain_ms": k23["dq"]["plain_ms"],
         "bound_ms": k23["dq"]["bound_ms"], "bound_by": k23["dq"]["bound_by"],
         "library_ms": k23["library_ms_sdpa_bwd"]},
        {"name": "flash_dkv", "route": "cuda",
         "source": "torchkafka_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "torchkafka_tpu/ops/flash.py:252",
         "launches": row_t["launches"]["flash_dkv"],
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
         "bound_by": main_pool["bound_by"], "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
