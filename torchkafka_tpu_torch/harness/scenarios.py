"""The harness scenarios: port of ``torchkafka_tpu/harness/scenarios.py``.

| # | Scenario | Port |
|---|----------|------|
| 1 | single-process float records, batch 4, 1 partition | here (host-only) |
| 2 | JSON → tokenized int32, 8 partitions, threaded transform | here (batches to the device) |
| 5 | prompt topic → KV-cache generate → commit post-generation | here |
| 6 | scenario 1 at batch 256 | here (host-only) |
| 7 | continuous-batching serving (slot recycling, EOS) | here, with ``decode_roofline`` |
| 9 | ragged text → length-bucketed batches → per-width train steps | here, one device |
| 3, 20 | mesh training, sharded paged serving | queue A "Mesh and multi-process paths" |
| 4, 8 | PNG → ResNet-50, streaming DLRM | queue A "Secondary models" |
| 10-19, 21-25 | fleets, chaos, durability | queue A "Harness: fleet and durability scenarios" |

Every ported scenario runs the JAX package's loop (poll → transform →
batch → device → step → barrier → commit) with its sizes, seeds and
result keys, on ``device`` (``run_scenario(device=)``; CUDA unless the
caller names another device). Where the JAX package asks
``jax.default_backend() == "tpu"`` before a device measurement, the port
asks whether the scenario runs on CUDA; device times are CUDA events.
An unported scenario raises ``NotImplementedError`` naming its ROADMAP
queue A title.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from torchkafka_tpu_torch.utils.devices import resolve_device

_SIZES = ("tiny", "full")


def _result(name: str, rows: int, elapsed: float, stream, extra: dict | None = None) -> dict:
    out = {
        **stream.metrics.summary(),
        "scenario": name,
        "records": rows,
        "elapsed_s": round(elapsed, 3),
        "records_per_s": round(rows / elapsed, 1) if elapsed > 0 else None,
    }
    if extra:
        out.update(extra)
    return out


def _drain(
    stream, step: Callable[[Any], Any] | None, total: int,
    sync_commit: bool = False,
) -> tuple[int, float]:
    """Run the transactional loop until ``total`` rows are consumed; the
    last commit is durable inside the timed region. ``sync_commit`` commits
    inline instead of through the FIFO commit thread — pair it with a
    ``prefetch=0`` stream for latency-shaped loops (sub-ms batches), where
    a per-batch executor handoff costs more than the commit itself."""
    rows = 0
    fut = None
    t0 = time.perf_counter()
    for batch, token in stream:
        wait = step(batch) if step is not None else None
        if sync_commit:
            token.commit(wait_for=wait)
        else:
            fut = token.commit_async(wait_for=wait)
        rows += batch.valid_count
        if rows >= total:
            break
    if fut is not None:
        fut.result(timeout=600)
    return rows, time.perf_counter() - t0


_PAIR_GROUP_SEQ = iter(range(10**9))


def _paired_host_ratio(
    broker, topic: str, n_parts: int, ours_slice, ref_process, batch_size: int,
    n_slice: int, slices: int = 2,
) -> dict:
    """Alternating ours/reference-pattern slices over the SAME broker
    records: host-bound absolute numbers swing with the box's load, but
    adjacent slices sample the same conditions, so the per-pair ratio is
    the stable signal. Reports the median of per-pair ratios plus both
    sides' rates.

    ``ours_slice(group_id, n) -> (rows, elapsed)`` runs the framework path;
    ``ref_process(record) -> torch tensor/pytree`` defines the reference
    analog, executed through the copied compat stack (KafkaDataset
    subclass → DataLoader → auto_commit) with commit-per-batch, the
    reference's own cadence."""
    from torch.utils.data import DataLoader

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.compat import KafkaDataset, auto_commit

    def ref_slice(group_id: str, n: int) -> tuple[int, float]:
        class RefDataset(KafkaDataset):
            def _process(self, record):
                return ref_process(record)

            @classmethod
            def new_consumer(cls, *args, **kwargs):
                kwargs.pop("_is_placeholder", None)
                return tk.MemoryConsumer(
                    broker, *args,
                    assignment=tk.partitions_for_process(topic, n_parts, 0, 1),
                    consumer_timeout_ms=500, **kwargs,
                )

        dataset = RefDataset(topic, group_id=group_id)
        loader = DataLoader(dataset, batch_size=batch_size)
        rows = 0
        t0 = time.perf_counter()
        for batch in auto_commit(loader):
            first = batch[0] if isinstance(batch, (list, tuple)) else batch
            rows += int(first.shape[0])
            if rows >= n:
                break
        elapsed = time.perf_counter() - t0
        dataset.close()
        return rows, elapsed

    ratios, ours_rates, ref_rates = [], [], []
    for _ in range(slices):
        o_rows, o_t = ours_slice(f"pair-ours-{next(_PAIR_GROUP_SEQ)}", n_slice)
        r_rows, r_t = ref_slice(f"pair-ref-{next(_PAIR_GROUP_SEQ)}", n_slice)
        ours_rates.append(o_rows / o_t)
        ref_rates.append(r_rows / r_t)
        ratios.append(ours_rates[-1] / ref_rates[-1])
    return {
        "vs_reference_pattern": round(float(np.median(ratios)), 3),
        "pair_ratios": [round(r, 3) for r in ratios],
        "ours_rows_per_s": round(float(np.median(ours_rates)), 1),
        "reference_pattern_rows_per_s": round(float(np.median(ref_rates)), 1),
    }


# ------------------------------------------------------------------ ingest


def scenario_1(size: str = "tiny", batch_size: int = 4, name: str = "1:single-process",
               device=None) -> dict:
    """Single-process, 1 partition, batch 4: the reference's README flow —
    each record becomes a float32[8] row. Batch 4 is faithful to the
    reference's example and is iteration-bound by design; scenario 6
    reruns this flow at batch 256. Host-only, like the reference it mirrors
    (its DataLoader yields CPU tensors), so ``device`` is not used; the
    headline is the PAIRED ratio (``_paired_host_ratio``)."""
    import torchkafka_tpu_torch as tk

    n = 512 if size == "tiny" else 200_000
    broker = tk.InMemoryBroker()
    broker.create_topic("t1", partitions=1)
    rng = np.random.default_rng(0)
    broker.produce_many("t1", (rng.random(8).astype(np.float32).tobytes() for _ in range(n)))
    consumer = tk.MemoryConsumer(
        broker, "t1", group_id="s1", assignment=[tk.TopicPartition("t1", 0)]
    )
    # Batch 4 is latency-shaped: a per-batch thread handoff and a
    # commit-thread submit cost more than the 4-row batch itself, so small
    # batches take the stream's synchronous mode (prefetch=0, inline
    # commit), symmetric with the single-threaded reference pattern. Large
    # batches (scenario 6) keep the pipelined mode.
    latency_shaped = batch_size < 64
    stream_kw = dict(
        to_device=False, idle_timeout_ms=1000, owns_consumer=True,
        prefetch=0 if latency_shaped else 2,
    )
    with tk.KafkaStream(
        consumer, tk.fixed_width(8, np.float32), batch_size=batch_size, **stream_kw,
    ) as stream:
        rows, elapsed = _drain(
            stream, None, n // batch_size * batch_size,
            sync_commit=latency_shaped,
        )

    def ours_slice(group_id: str, n_s: int):
        c = tk.MemoryConsumer(
            broker, "t1", group_id=group_id,
            assignment=[tk.TopicPartition("t1", 0)],
        )
        with tk.KafkaStream(
            c, tk.fixed_width(8, np.float32), batch_size=batch_size, **stream_kw,
        ) as s:
            return _drain(s, None, n_s, sync_commit=latency_shaped)

    paired = _paired_host_ratio(
        broker, "t1", 1, ours_slice,
        lambda rec: torch.from_numpy(np.frombuffer(rec.value, dtype=np.float32).copy()),
        batch_size, (n // 2) // batch_size * batch_size,
    )
    return _result(name, rows, elapsed, stream, {"batch_size": batch_size, **paired})


def scenario_6(size: str = "tiny", device=None) -> dict:
    """Scenario 1 at a realistic batch size (256): same records, same
    host-only loop — isolates how much of scenario 1's number is the
    reference's example batch of 4."""
    return scenario_1(size, batch_size=256, name="6:single-process-b256")


def scenario_2(size: str = "tiny", device=None) -> dict:
    """JSON records → tokenized int32[seq], 8 partitions, chunked transform
    (the multiproc DataLoader analog). The measured run ships its batches
    to ``device``; the paired slices are host-only on both sides so the
    pair isolates the transform architecture."""
    import torchkafka_tpu_torch as tk

    dev = resolve_device(device)
    n, seq = (2048, 32) if size == "tiny" else (500_000, 128)
    broker = tk.InMemoryBroker()
    broker.create_topic("t2", partitions=8)
    rng = np.random.default_rng(0)
    words = ["stream", "kafka", "tpu", "offset", "commit", "batch", "mesh"]
    broker.produce_many(
        "t2",
        (json.dumps({"text": " ".join(rng.choice(words, 6))}).encode() for _ in range(n)),
    )
    consumer = tk.MemoryConsumer(
        broker, "t2", group_id="s2",
        assignment=tk.partitions_for_process("t2", 8, 0, 1),
    )
    with tk.KafkaStream(
        consumer, tk.json_tokens("text", seq), batch_size=256,
        to_device=True, idle_timeout_ms=1000, owns_consumer=True, device=dev,
    ) as stream:
        rows, elapsed = _drain(stream, None, n // 256 * 256)

    def ours_slice(group_id: str, n_s: int):
        c = tk.MemoryConsumer(
            broker, "t2", group_id=group_id,
            assignment=tk.partitions_for_process("t2", 8, 0, 1),
        )
        with tk.KafkaStream(
            c, tk.json_tokens("text", seq), batch_size=256,
            to_device=False, idle_timeout_ms=1000, owns_consumer=True,
        ) as s:
            return _drain(s, None, n_s)

    def ref_process(rec):
        text = json.loads(rec.value)["text"].encode()
        row = np.full((seq,), 0, np.int32)
        take = min(len(text), seq)
        row[:take] = np.frombuffer(text[:take], np.uint8)
        return torch.from_numpy(row)

    paired = _paired_host_ratio(
        broker, "t2", 8, ours_slice, ref_process, 256, (n // 2) // 256 * 256,
    )
    return _result("2:json-tokenize", rows, elapsed, stream, paired)


# ----------------------------------------------------------------- serving


def _cuda_ms(fn, repeats: int = 3) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn()`` on the current
    stream, in ms (one warm call first)."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _serving_model(size: str, model_scale: str | None, prompt_len: int,
                   max_new: int, quantized: bool | None = None, device=None):
    """(cfg, params, label) for the serving scenarios. ``model_scale`` None
    keeps the tiny/45m configs; '45m' | '1b' | '8b' draws from the model
    zoo (``random_serving_params``, on ``device``): '8b' in int8, the rest
    bf16 unless ``quantized``. ``quantized`` requires a model_scale, and
    '8b' cannot un-quantize (the JAX package's guards). The tiny weights
    come from ``init_params`` with a generator seeded 0 (the numbers differ
    from the JAX package's for the same seed)."""
    from torchkafka_tpu_torch.models.transformer import TransformerConfig, init_params
    from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config

    if quantized is not None and model_scale is None:
        raise ValueError(
            "quantized requires a model_scale (the tiny/default configs "
            "ignore dtype knobs; accepting it would silently serve bf16)"
        )
    dev = resolve_device(device)
    if model_scale is None:
        cfg = (
            TransformerConfig(vocab_size=512, d_model=64, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=128,
                              max_seq_len=prompt_len + max_new,
                              dtype=torch.float32)
            if size == "tiny"
            else TransformerConfig(max_seq_len=prompt_len + max_new)
        )
        gen = torch.Generator(device=dev).manual_seed(0)
        return cfg, init_params(gen, cfg, dev), "default"
    cfg = zoo_config(model_scale, max_seq_len=prompt_len + max_new)
    if quantized is None:
        quantized = model_scale == "8b"
    elif model_scale == "8b" and not quantized:
        raise ValueError(
            "8b serves int8 only: bf16 8B params are ~16 GB (and '8b' "
            "labels int8 in every published table)"
        )
    t0 = time.perf_counter()
    params = random_serving_params(
        torch.Generator(device=dev).manual_seed(0), cfg, quantized=quantized,
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    label = f"{model_scale}-int8" if quantized and model_scale != "8b" else model_scale
    print(f"[scale {label}] params materialised in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    return cfg, params, label


def scenario_5(
    size: str = "tiny", model_scale: str | None = None,
    quantized: bool | None = None, device=None,
) -> dict:
    """Prompt topic → KV-cache generation (``models.generate.generate``,
    lockstep) → commit offsets only after the whole generation retires.
    ``model_scale`` (45m | 1b | 8b) serves the zoo models at their true
    footprint and, on CUDA, adds the device split: prefill alone and the
    whole generate, each the median of 3 CUDA-event timings; decode tok/s
    and its roofline share come from the difference (``split_ok`` False
    when decode is under a quarter of the generate, the JAX package's
    rule). ``roofline_tok_s`` counts ``serve.decode_tick_bytes`` against
    the card's peak (``serve.H100_PEAK_HBM_GBS``). The port's result adds
    ``committed`` (the group's committed offsets, summed)."""
    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.generate import generate, prefill
    from torchkafka_tpu_torch.models.quant import quantized_nbytes

    dev = resolve_device(device)
    prompt_len, max_new = (16, 8) if size == "tiny" else (128, 64)
    n, batch = (64, 8) if size == "tiny" else (1024, 32)
    if model_scale == "1b":
        n, batch = 128, 16
    elif model_scale == "8b":
        n, batch = 48, 16
    cfg, params, label = _serving_model(
        size, model_scale, prompt_len, max_new, quantized, dev
    )
    broker = tk.InMemoryBroker()
    broker.create_topic("t5", partitions=2)
    rng = np.random.default_rng(0)
    broker.produce_many(
        "t5",
        (rng.integers(0, cfg.vocab_size, prompt_len, dtype=np.int32).tobytes()
         for _ in range(n)),
    )
    consumer = tk.MemoryConsumer(
        broker, "t5", group_id="s5",
        assignment=tk.partitions_for_process("t5", 2, 0, 1),
    )
    generate(params, cfg, torch.zeros((batch, prompt_len), dtype=torch.int32,
                                      device=dev), max_new)  # warm
    generated = []

    def step(b):
        out = generate(params, cfg, b.data, max_new)
        generated.append(out)
        return out

    with tk.KafkaStream(
        consumer, tk.fixed_width(prompt_len, np.int32), batch_size=batch,
        to_device=True, idle_timeout_ms=2000, owns_consumer=True, device=dev,
    ) as stream:
        rows, elapsed = _drain(stream, step, n)
    toks = rows * max_new
    extra = {
        "committed": sum(broker.committed("s5", tk.TopicPartition("t5", p)) or 0
                         for p in (0, 1)),
        "model_scale": label,
        "params_bytes_g": round(quantized_nbytes(params) / 1e9, 3),
        "generated_tokens": toks,
        "tokens_per_s": round(toks / elapsed, 1) if elapsed else None,
    }
    if model_scale is not None and dev.type == "cuda":
        from torchkafka_tpu_torch.serve import H100_PEAK_HBM_GBS, decode_tick_bytes

        toks_dev = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
            dtype=torch.int32, device=dev,
        )

        def pf():
            with torch.inference_mode():
                prefill(params, cfg, toks_dev, prompt_len + max_new)

        pf_ms = _cuda_ms(pf)
        gen_ms = _cuda_ms(lambda: generate(params, cfg, toks_dev, max_new))
        pf_s, gen_s = pf_ms / 1e3, gen_ms / 1e3
        w_bytes, kv_bytes = decode_tick_bytes(params, cfg, batch, prompt_len + max_new)
        roofline_tok_s = batch * H100_PEAK_HBM_GBS * 1e9 / (w_bytes + kv_bytes)
        extra.update({
            "device_prefill_ms": round(pf_ms, 1),
            "device_generate_ms": round(gen_ms, 1),
            "roofline_tok_s": round(roofline_tok_s, 1),
        })
        decode_s = gen_s - pf_s
        if decode_s <= 0.25 * gen_s:
            # The difference carries no information once the decode is a
            # small share of the generate's wall: flag, don't publish.
            extra.update({"split_ok": False, "device_decode_tok_s": None,
                          "hbm_roofline_pct": None})
        else:
            decode_tok_s = batch * max_new / decode_s
            extra.update({
                "split_ok": True,
                "device_decode_tok_s": round(decode_tok_s, 1),
                "hbm_roofline_pct": round(100 * decode_tok_s / roofline_tok_s, 1),
            })
    return _result("5:generate", rows, elapsed, stream, extra)


def scenario_7(
    size: str = "tiny", model_scale: str | None = None,
    serve_eos: bool = False, quantized: bool | None = None,
    kv_int8: bool = False, kv_kernel: bool | str = "auto",
    spec: bool = False, spec_k: int = 4,
    spec_draft_layers: int | None = None,
    temperature: float = 0.0, top_k: int | None = None,
    top_p: float | None = None, device=None,
) -> dict:
    """Continuous-batching serving (``serve.StreamingGenerator``): scenario
    5's prompt topic, but slots recycle as generations hit EOS — an EOS id
    picked from a probe generation (``models.generate.generate``) so a real
    fraction of prompts stops early. Reports completions/s and tokens/s;
    offsets commit per completion through the interval ledger.

    ``model_scale`` (45m | 1b | 8b): the zoo models at their true
    footprint, adding ``decode_roofline`` on CUDA (replays of a CUDA graph
    of the tick block against the device-memory bound). EOS is off at
    scale by default (every slot runs max_new, one tick block per
    generation); ``serve_eos`` turns it on with 8-tick blocks, the
    continuous-batching row (``readmissions``). ``spec``: serve through
    ``SpecStreamingGenerator`` (``spec_k`` proposals a round, self-draft of
    ``spec_draft_layers``, default half the target's); no roofline probe
    there, as in the JAX package (it would run live rounds into the
    acceptance counters). The port's result adds ``decode_ticks`` and
    ``prefills`` (the serving loop's eager decode ticks and prefill
    passes, what the kernels' launch counts follow)."""
    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.generate import generate
    from torchkafka_tpu_torch.serve import StreamingGenerator

    dev = resolve_device(device)
    prompt_len, max_new = (16, 8) if size == "tiny" else (128, 64)
    n, slots = (24, 8) if size == "tiny" else (512, 32)
    if model_scale == "1b":
        n, slots = 128, 16
    elif model_scale == "8b":
        n, slots = 48, 16
    cfg, params, label = _serving_model(
        size, model_scale, prompt_len, max_new, quantized, dev
    )
    broker = tk.InMemoryBroker()
    broker.create_topic("t7", partitions=2)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (n, prompt_len), dtype=np.int32)
    for i in range(n):
        broker.produce("t7", prompts[i].tobytes(), partition=i % 2)
    if model_scale is None or serve_eos:
        # The MODAL generated token of a few lockstep continuations is the
        # EOS: random-init models repeat attractor tokens, so it truncates
        # a real fraction of the stream (decode positions >= 1 only;
        # prefill's token 0 is emitted unconditionally, as the server does).
        probe = generate(params, cfg, torch.as_tensor(prompts[:8], device=dev),
                         max_new).cpu().numpy()
        toks, counts = np.unique(probe[:, 1:], return_counts=True)
        eos_id = int(toks[counts.argmax()])
    else:
        eos_id = None

    consumer = tk.MemoryConsumer(broker, "t7", group_id="s7")
    if spec:
        from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator

        # A round advances a slot by 1..spec_k+1 tokens: a full-accept
        # generation completes in ceil((max_new-1)/(k+1)) rounds.
        ticks_per_sync = max(1, -(-(max_new - 1) // (spec_k + 1)))
        server = SpecStreamingGenerator(
            consumer, params, cfg, slots=slots, prompt_len=prompt_len,
            max_new=max_new, eos_id=eos_id, commit_every=slots,
            k=spec_k, draft_layers=spec_draft_layers,
            ticks_per_sync=ticks_per_sync, device=dev,
        )
    else:
        # EOS off: one tick block per generation (max_new - 1 ticks: the
        # prefill emits token 0). EOS on: 8-tick blocks at scale bound how
        # long a finished slot idles before readmission; tiny sizes keep
        # half-generation blocks.
        ticks_per_sync = (
            max(1, max_new - 1) if eos_id is None
            else (8 if model_scale is not None else max(1, max_new // 2))
        )
        server = StreamingGenerator(
            consumer, params, cfg, slots=slots, prompt_len=prompt_len,
            max_new=max_new, eos_id=eos_id, commit_every=slots,
            kv_dtype="int8" if kv_int8 else None, kv_kernel=kv_kernel,
            temperature=temperature, top_k=top_k, top_p=top_p,
            ticks_per_sync=ticks_per_sync, device=dev,
        )
    t_w = time.perf_counter()
    server.warmup()
    if model_scale is not None:
        print(f"[scale {model_scale}] serve warmup in {time.perf_counter() - t_w:.1f}s",
              file=sys.stderr, flush=True)
    roofline = (
        server.decode_roofline()
        if model_scale is not None and not spec and dev.type == "cuda"
        else {}
    )
    if roofline:
        print(f"[scale {model_scale}] roofline: {roofline}", file=sys.stderr, flush=True)
    toks = 0
    done = 0
    truncated = 0
    t0 = time.perf_counter()
    for _rec, out in server.run(max_records=n):
        toks += int(out.shape[0])
        done += 1
        truncated += int(out.shape[0] < max_new)
    elapsed = time.perf_counter() - t0
    consumer.close()
    committed = sum(
        broker.committed("s7", tk.TopicPartition("t7", p)) or 0 for p in (0, 1)
    )
    sampled = temperature != 0.0 or top_k is not None or top_p is not None
    return {
        "scenario": "7:continuous-serve" + ("+spec" if spec else ""),
        "model_scale": label,
        **({"spec": server.spec_stats()} if spec else {}),
        "records": done,
        "elapsed_s": round(elapsed, 3),
        "records_per_s": round(done / elapsed, 1) if elapsed else None,
        "generated_tokens": toks,
        "tokens_per_s": round(toks / elapsed, 1) if elapsed else None,
        "truncated_by_eos": truncated,
        "readmissions": server.metrics.readmissions.count,
        "eos_mode": "on" if eos_id is not None else "off(one-dispatch)",
        **({"sampling": {"temperature": temperature, "top_k": top_k, "top_p": top_p}}
           if sampled else {}),
        "ticks_per_sync": ticks_per_sync,
        "kv_dtype": "int8" if kv_int8 else "compute",
        "kv_kernel": server._kv_backend.kernel,
        "slots": slots,
        "committed": committed,
        "commit_failures": server.metrics.commit_failures.count,
        "dropped": server.metrics.dropped.count,
        "commit": server.metrics.commit_latency.summary(),
        "decode_ticks": server.metrics.decode_ticks.count,
        "prefills": server.metrics.prefills.count,
        **roofline,
    }


# ---------------------------------------------------------------- training


def scenario_9(size: str = "tiny", device=None) -> dict:
    """Ragged text topic → length-bucketed batches → per-width train
    steps, commit-after-step: the static-shape answer to variable-length
    streams. PAIRED: the same records replay pad-to-max in the same
    invocation (every row padded to the top width, same model, same step),
    so ``vs_padmax`` is a measured end-to-end ratio beside the analytic
    ``bucket_efficiency``. One device (``make_train_step(cfg, None, ...)``;
    the JAX package's ``{"data": n_dev}`` mesh is queue A "Mesh and
    multi-process paths"), so ``mesh`` reports ``{"data": 1}``. On CUDA the
    per-width step cost comes from ``utils.timing.device_step_seconds``
    (CUDA events, two-point slope), weighted by the batches each pass ran
    (``vs_padmax_device``)."""
    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.transformer import TransformerConfig, make_train_step
    from torchkafka_tpu_torch.optim import adamw

    dev = resolve_device(device)
    n_dev = 1
    buckets = (16, 32, 64) if size == "tiny" else (64, 128, 256, 512)
    max_w = buckets[-1]
    cfg = (
        TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=max_w,
                          dtype=torch.float32)
        if size == "tiny"
        else TransformerConfig(max_seq_len=max_w)
    )
    n = 256 if size == "tiny" else 6144
    local_batch = 2 * n_dev if size == "tiny" else 8 * n_dev

    broker = tk.InMemoryBroker()
    parts = max(n_dev, 4)
    broker.create_topic("t9", partitions=parts)
    rng = np.random.default_rng(0)
    # Zipf-ish length mix: mostly short, a long tail — the shape that makes
    # pad-to-max wasteful and bucketing worthwhile.
    lengths = np.minimum((rng.pareto(1.2, n) * 0.15 * max_w + 5).astype(int), max_w)
    broker.produce_many(
        "t9",
        (rng.integers(0, cfg.vocab_size, k).astype(np.int32).tobytes() for k in lengths),
    )
    init_fn, step_fn = make_train_step(cfg, None, adamw(1e-3), device=dev)

    def padmax_processor(rec):
        row = np.frombuffer(rec.value, np.int32)
        out = np.zeros(max_w, np.int32)
        out[: row.shape[0]] = row
        return {"tokens": out, "length": np.int32(row.shape[0])}

    def run_pass(tag: str, bucketed: bool):
        """One full stream+train pass over the SAME topic (a fresh group
        re-reads from offset 0), from freshly initialised weights."""
        consumer = tk.MemoryConsumer(
            broker, "t9", group_id=f"s9-{tag}",
            assignment=tk.partitions_for_process("t9", parts, 0, 1),
        )
        params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(0))
        state = {"p": params, "o": opt_state, "losses": []}
        rows_by_width: dict[int, int] = {}
        batches_by_width: dict[int, int] = {}

        def step(batch):
            toks = torch.as_tensor(batch.data["tokens"], device=dev)
            w = toks.shape[1]
            rows_by_width[w] = rows_by_width.get(w, 0) + batch.valid_count
            batches_by_width[w] = batches_by_width.get(w, 0) + 1
            # Mask: real rows AND real (pre-pad) positions within each row.
            ln = torch.as_tensor(batch.data["length"]).cpu().numpy()
            mask = (np.arange(w)[None, :] < ln[:, None]) & batch.valid_mask()[:, None]
            state["p"], state["o"], loss = step_fn(
                state["p"], state["o"], toks,
                torch.as_tensor(mask.astype(np.int32), device=dev),
            )
            state["losses"].append(loss)
            return loss

        processor = (
            (lambda rec: np.frombuffer(rec.value, np.int32))
            if bucketed else padmax_processor
        )
        with tk.KafkaStream(
            consumer, processor, batch_size=local_batch, pad_policy="pad",
            idle_timeout_ms=2000, owns_consumer=True, device=dev,
            **({"buckets": buckets} if bucketed else {}),
        ) as stream:
            rows, elapsed = _drain(stream, step, n)
        losses = [float(x) for x in state["losses"]]
        return rows, elapsed, losses, rows_by_width, batches_by_width, stream

    # Warmup pass (first-contact kernel builds land here), then bucketed
    # and pad-to-max back to back, sampling the same minutes of the box.
    run_pass("warm", bucketed=True)
    rows, elapsed, losses, rows_by_width, batches_by_width, stream = run_pass(
        "bucketed", bucketed=True
    )
    p_rows, p_elapsed, p_losses, _pw, p_batches, _ = run_pass("padmax", bucketed=False)
    assert p_rows == rows, (p_rows, rows)
    bucketed_tokens = sum(w * r for w, r in rows_by_width.items())
    extra = {
        "mesh": {"data": n_dev},
        "buckets": list(buckets),
        "rows_per_width": {int(w): int(r) for w, r in sorted(rows_by_width.items())},
        "bucket_efficiency": round(bucketed_tokens / (rows * max_w), 3),
        "vs_padmax": round(p_elapsed / elapsed, 2) if elapsed else None,
        "padmax_records_per_s": round(p_rows / p_elapsed, 1) if p_elapsed else None,
        "first_loss": round(losses[0], 4),
        "last_loss": round(losses[-1], 4),
        "padmax_last_loss": round(p_losses[-1], 4),
    }
    if dev.type == "cuda":
        from torchkafka_tpu_torch.utils.timing import device_step_seconds

        dp, do = init_fn(torch.Generator(device=dev).manual_seed(1))
        rng2 = np.random.default_rng(5)
        step_s: dict[int, float] = {}
        # Two rounds a width, the min of the rounds whose slope held (a
        # degenerate round is discarded, never min'd in).
        for _ in range(2):
            for w in buckets:
                toks = torch.as_tensor(rng2.integers(0, cfg.vocab_size, (local_batch, w)),
                                       dtype=torch.int32, device=dev)
                msk = torch.ones((local_batch, w), dtype=torch.int32, device=dev)
                s, ok = device_step_seconds(step_fn, dp, do, toks, msk)
                if ok:
                    step_s[w] = min(step_s.get(w, float("inf")), s)
        slopes_ok = len(step_s) == len(buckets)
        extra.update({
            "device_step_ms_per_width": {
                int(w): round(s * 1e3, 2) for w, s in sorted(step_s.items())
            },
            "batches_per_width": {int(w): int(b) for w, b in sorted(batches_by_width.items())},
            "device_slopes_ok": slopes_ok,
        })
        if slopes_ok:
            bucketed_dev = sum(step_s[w] * b for w, b in batches_by_width.items())
            padmax_dev = step_s[max_w] * sum(p_batches.values())
            extra.update({
                "bucketed_device_step_s": round(bucketed_dev, 2),
                "padmax_device_step_s": round(padmax_dev, 2),
                "vs_padmax_device": (round(padmax_dev / bucketed_dev, 2)
                                     if bucketed_dev else None),
            })
        else:
            extra.update({"bucketed_device_step_s": None, "padmax_device_step_s": None,
                          "vs_padmax_device": None})
    return _result("9:ragged-bucketed-train", rows, elapsed, stream, extra)


# --------------------------------------------------------------- unported

# Each scenario the port does not run yet, by the title of the ROADMAP
# queue A item that ports it.
_DEFERRED_TITLES = {
    **{n: "Harness: fleet and durability scenarios"
       for n in (10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 22, 23, 24, 25)},
    3: "Mesh and multi-process paths",
    20: "Mesh and multi-process paths",
    4: "Secondary models",
    8: "Secondary models",
}


def _deferred(num: int) -> Callable[..., dict]:
    def scenario(size: str = "tiny", **_kw) -> dict:
        raise NotImplementedError(
            f"scenario {num} is not ported yet (ROADMAP queue A: "
            f"{_DEFERRED_TITLES[num]})"
        )

    scenario.__name__ = f"scenario_{num}"
    return scenario


_PORTED = {1: scenario_1, 2: scenario_2, 5: scenario_5, 6: scenario_6,
           7: scenario_7, 9: scenario_9}
PORTED = tuple(sorted(_PORTED))
SCENARIOS = {n: _PORTED.get(n) or _deferred(n) for n in range(1, 26)}


def run_scenario(
    num: int, size: str = "tiny", *, model_scale: str | None = None,
    serve_eos: bool = False, quantized: bool | None = None,
    kv_int8: bool = False, kv_kernel: bool | str = "auto",
    spec: bool = False, spec_k: int = 4,
    spec_draft_layers: int | None = None,
    temperature: float = 0.0, top_k: int | None = None,
    top_p: float | None = None, replicas: int = 2,
    prefill_chunk: int | None = None, device=None,
) -> dict:
    """The JAX package's ``run_scenario``, flag scoping and errors
    included, plus ``device`` (None = CUDA, raising without it) for the
    ported scenarios; an unported one raises ``NotImplementedError``."""
    if size not in _SIZES:
        raise ValueError(f"size must be one of {_SIZES}")
    if prefill_chunk is not None and num != 14:
        raise ValueError(
            "--prefill-chunk applies to scenario 14 (the chunked-prefill "
            "storm smoke)"
        )
    if num == 14:
        return SCENARIOS[14](size, prefill_chunk=prefill_chunk)
    if serve_eos and (num != 7 or model_scale is None):
        raise ValueError("--serve-eos applies to scenario 7 at a model scale")
    if quantized is not None and (model_scale is None or num not in (5, 7)):
        raise ValueError("--quantized applies to scenarios 5/7 at a model scale")
    if kv_int8 and num != 7:
        raise ValueError("--kv-int8 applies to scenario 7 (the slot pool)")
    if spec and num != 7:
        raise ValueError("--spec applies to scenario 7 (speculative serving)")
    if spec and kv_int8:
        raise ValueError(
            "--spec serves the compute-dtype pool (token-exactness is the "
            "contract); drop --kv-int8"
        )
    sampling = temperature != 0.0 or top_k is not None or top_p is not None
    if sampling and num != 7:
        raise ValueError(
            "--temperature/--top-k/--top-p apply to scenario 7 (the "
            "sampled serving path)"
        )
    if spec and sampling:
        raise ValueError(
            "--spec is greedy-only (the accept rule is the target's "
            "argmax); drop the sampling flags"
        )
    sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    spec_kw = dict(spec=spec, spec_k=spec_k, spec_draft_layers=spec_draft_layers)
    if num in (10, 11, 12, 13, 15, 16, 17, 18, 19, 20, 21, 23, 24, 25):
        return SCENARIOS[num](size, replicas=replicas)
    if num == 22:
        return SCENARIOS[22](size, replicas=1)
    if model_scale is not None:
        if num not in (5, 7):
            raise ValueError("model_scale applies to scenarios 5 and 7 only")
        if num == 7:
            return SCENARIOS[7](
                size, model_scale=model_scale, serve_eos=serve_eos,
                quantized=quantized, kv_int8=kv_int8, kv_kernel=kv_kernel,
                **spec_kw, **sample_kw, device=resolve_device(device),
            )
        return SCENARIOS[5](size, model_scale=model_scale, quantized=quantized,
                            device=resolve_device(device))
    if num not in _PORTED:
        return SCENARIOS[num](size)
    dev = resolve_device(device)
    if kv_int8:
        return SCENARIOS[7](size, kv_int8=True, kv_kernel=kv_kernel, **sample_kw,
                            device=dev)
    if spec:
        return SCENARIOS[7](size, **spec_kw, device=dev)
    if sampling:
        return SCENARIOS[7](size, **sample_kw, device=dev)
    return SCENARIOS[num](size, device=dev)
