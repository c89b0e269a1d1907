"""Continuous-batching generation server over the dense slot pool: port of
``torchkafka_tpu/serve.py``.

A fixed pool of decode slots serves a prompt topic: prompts are admitted
into free slots as earlier generations finish (EOS or ``max_new``), each
completion retires its record in the ``OffsetLedger``, and offsets commit
every ``commit_every`` completions plus once at the end, so a crash
re-delivers exactly the prompts whose generations never finished.

PyTorch idiom against the JAX package's:

- The KV pool is updated IN PLACE (``index_put_`` on per-layer views);
  the JAX package donates the pool to each jitted program and rebinds
  the result. Nothing else aliases the pool, so the two are equivalent.
- The tick block is a Python loop of ``ticks_per_sync`` ticks over the
  layers with the latched done mask of the JAX ``tick_block``; one host
  sync per block fetches done, n_out, pos and gen together.
- Every host array copied to the device is snapshotted first
  (``torch.from_numpy`` shares memory).
- Slot rows are recycled without clearing: a position is always written
  before the read that could see it (write-before-attend), so stale kv of
  a freed slot, and the writes inactive slots make at their frozen
  position, are never read.

Pools: ``kv_dtype=None`` keeps k/v in the compute dtype ([L, B, M, K, Dh],
read by ``models.generate._attend_cached``); ``kv_dtype="int8"`` stores
int8 payloads and per-(position, head) f32 scales K-major
([L, B, K, M, Dh] / [L, B, K, M]) and reads them through
``ops.kvattn.int8_decode_attention_dynlen``, the fill-bounded CUDA kernel.
Prefill attention runs through ``ops.flash``'s CUDA kernel on the card.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator

import numpy as np
import torch

from torchkafka_tpu_torch.commit.ledger import OffsetLedger
from torchkafka_tpu_torch.errors import (
    BrokerUnavailableError,
    CommitFailedError,
    ConsumerClosedError,
)
from torchkafka_tpu_torch.kvcache.backend import KVBackend, resolve_kv_backend
from torchkafka_tpu_torch.models.generate import (
    _attend_cached,
    _attn_tail,
    _project_qkv,
    prefill_capture,
    prefill_model,
)
from torchkafka_tpu_torch.models.quant import QTensor, embed_rows, quant_kv_groups
from torchkafka_tpu_torch.models.transformer import (
    TransformerConfig,
    _rms_norm,
    _rope,
    layer_at,
    matmul_f32,
)
from torchkafka_tpu_torch.ops.kvattn import int8_decode_attention_dynlen
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.records import Record
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.metrics import Gauge, LatencyHistogram, RateMeter

_logger = logging.getLogger(__name__)

# Arguments of the JAX package's server that this port does not serve yet,
# each with the ROADMAP item that ports it. Passing one (with a value other
# than None/False) raises NotImplementedError; none is silently ignored.
_DEFERRED = {
    "top_k": "1, sampled serving",
    "top_p": "1, sampled serving",
    "rng": "1, sampled serving",
    "output_producer": "2, output producer",
    "output_topic": "2, output producer",
    "encode_output": "2, output producer",
    "journal": "3, journal",
    "exactly_once": "4, exactly-once",
    "kv_pages": "5, paged pool + K5",
    "kv_tier": "5, paged pool + K5",
    "prefill_role": "5, paged pool + K5",
    "mesh": "6, mesh",
    "tracer": "9, tracing spans",
    "quarantine": "11, poison quarantine",
    "distill_topic": "11, draft distillation",
    "distill_producer": "11, draft distillation",
    "max_new_of": "11, per-record output budgets",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, serving follow-up {item})"
    )


def _slot_layer_step(x, layer, cache_k, cache_v, pos, rows, cfg):
    """One decode token through one layer with a different position per
    slot, over the compute-dtype pool. x: [B, 1, D]; caches [B, M, K, Dh]
    (one layer's views, written in place); pos: [B] int32."""
    q, k, v = _project_qkv(x, layer, cfg)
    q = _rope(q, pos[:, None], cfg.rope_theta)
    k = _rope(k, pos[:, None], cfg.rope_theta)
    p = pos.long()
    cache_k.index_put_((rows, p), k[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, p), v[:, 0].to(cache_v.dtype))
    m = torch.arange(cache_k.shape[1], device=x.device)
    valid = m[None, :] <= pos[:, None]  # [B, M]
    return _attend_cached(x, q, cache_k, cache_v, valid, layer, cfg)


def _slot_layer_step_q(x, layer, ck_q, ck_s, cv_q, cv_s, pos, rows, cfg):
    """The int8-pool variant: the fresh k/v are quantized into the shared
    per-(position, head) groups, scattered K-major at ``[b, :, pos[b]]``
    (payloads [B, K, M, Dh], scales [B, K, M]; one layer's views, written
    in place) and the pool is read through the fill-bounded kernel."""
    q, k, v = _project_qkv(x, layer, cfg)
    q = _rope(q, pos[:, None], cfg.rope_theta)
    k = _rope(k, pos[:, None], cfg.rope_theta)
    kq, ks = quant_kv_groups(k[:, 0])  # [B, K, Dh] int8, [B, K] f32
    vq, vs = quant_kv_groups(v[:, 0])
    kidx = torch.arange(ck_q.shape[1], device=x.device)[None, :]
    idx = (rows[:, None], kidx, pos.long()[:, None])
    ck_q.index_put_(idx, kq)
    ck_s.index_put_(idx, ks)
    cv_q.index_put_(idx, vq)
    cv_s.index_put_(idx, vs)
    attn = int8_decode_attention_dynlen(q, ck_q, ck_s, cv_q, cv_s, pos)
    return _attn_tail(x, attn, layer, cfg)


class ServeMetrics:
    """The serving loop's counters that the dense path touches (the JAX
    package's ``ServeMetrics`` names)."""

    def __init__(self) -> None:
        self.completions = RateMeter()
        self.tokens = RateMeter()
        self.truncated = RateMeter()  # stopped by EOS before max_new
        self.readmissions = RateMeter()  # slots refilled while others decode
        self.dropped = RateMeter()  # undecodable prompts retired
        self.commit_failures = RateMeter()
        self.commit_latency = LatencyHistogram()
        self.slot_occupancy = Gauge()  # active slots / pool size, last tick
        self.tick_time = LatencyHistogram()  # per tick block, host observed
        self.tokens_per_tick = Gauge()
        self.decoded_tokens = RateMeter()  # tokens produced by decode ticks
        self.prefills = RateMeter()  # admission prefill passes
        self.decode_ticks = RateMeter()  # decode ticks run (all layers each)
        self.kernel_engaged = Gauge()
        self._kv_backend: dict = {}

    def note_backend(self, backend: KVBackend) -> None:
        self._kv_backend = backend.describe()
        self.kernel_engaged.set(1.0 if backend.kernel else 0.0)

    def reset(self) -> None:
        """Zero the rate clocks (run() start), so warmup time does not
        dilute the rates."""
        for m in (
            self.completions, self.tokens, self.truncated,
            self.readmissions, self.dropped, self.commit_failures,
        ):
            m.reset()

    def summary(self) -> dict:
        return {
            "completions": self.completions.count,
            "completions_per_s": self.completions.rate(),
            "tokens": self.tokens.count,
            "tokens_per_s": self.tokens.rate(),
            "truncated_by_eos": self.truncated.count,
            "readmissions": self.readmissions.count,
            "dropped": self.dropped.count,
            "commit_failures": self.commit_failures.count,
            "commit": self.commit_latency.summary(),
            "slot_occupancy": round(self.slot_occupancy.value, 3),
            "ticks": self.tick_time.count,
            "step_time": self.tick_time.summary(),
            "tokens_per_tick": round(self.tokens_per_tick.value, 2),
            "decoded_tokens": self.decoded_tokens.count,
            "prefills": self.prefills.count,
            "decode_ticks": self.decode_ticks.count,
            "kv_backend": {
                **self._kv_backend,
                "kernel_engaged": int(self.kernel_engaged.value),
            },
        }


def _default_decode_prompt(prompt_len: int) -> Callable[[Record], np.ndarray]:
    def decode(record: Record) -> np.ndarray:
        toks = np.frombuffer(record.value, dtype=np.int32)[:prompt_len]
        if toks.shape[0] < prompt_len:
            toks = np.pad(toks, (0, prompt_len - toks.shape[0]))
        return toks

    return decode


def _params_to(params, device: torch.device):
    """The parameter tree on ``device`` (leaves already there are kept)."""
    if isinstance(params, QTensor):
        return QTensor(params.q.to(device), params.scale.to(device))
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return params.to(device)


class StreamingGenerator:
    """Continuous-batching server over a Kafka-semantics consumer.

    ``run()`` yields ``(record, tokens)`` in COMPLETION order; each
    completion retires its record in the ledger, and offsets commit every
    ``commit_every`` completions plus once at the end.

    ``ticks_per_sync``: decode ticks per host sync of the done mask.
    ``kv_dtype``: None = the compute dtype; "int8" = the int8 pool, read
    by the fill-bounded kernel (``kv_kernel`` True or "auto"; False is not
    ported). ``device``: where the model and the pool live; None = CUDA,
    raising when there is none (``utils.devices.resolve_device``).
    Greedy decoding only (``temperature=0``). The other arguments of the
    JAX package's server raise ``NotImplementedError`` (``_DEFERRED``)."""

    def __init__(
        self,
        consumer,
        params,
        cfg: TransformerConfig,
        *,
        slots: int = 8,
        prompt_len: int,
        max_new: int,
        eos_id: int | None = None,
        commit_every: int = 32,
        decode_prompt: Callable[[Record], np.ndarray] | None = None,
        max_poll_records: int = 512,
        ticks_per_sync: int = 4,
        temperature: float = 0.0,
        kv_dtype: str | None = None,
        kv_kernel: bool | str = "auto",
        device=None,
        **deferred,
    ) -> None:
        for name, value in deferred.items():
            if name not in _DEFERRED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value is not None and value is not False:
                raise _not_ported(f"{name}=", _DEFERRED[name])
        if temperature != 0.0:
            raise _not_ported(
                f"temperature={temperature}", "1, sampled serving"
            )
        if cfg.is_moe:
            raise _not_ported("an MoE config", "7, MoE serving")
        if prompt_len + max_new > cfg.max_seq_len:
            raise ValueError("prompt_len + max_new exceeds cfg.max_seq_len")
        if max_new < 2:
            raise ValueError("max_new must be >= 2 (prefill emits token 0)")
        if ticks_per_sync < 1:
            raise ValueError("ticks_per_sync must be >= 1")
        self._device = resolve_device(device)
        self._consumer = consumer
        self._params = _params_to(params, self._device)
        self._cfg = cfg
        self._slots = slots
        self._prompt_len = prompt_len
        self._max_new = max_new
        self._max_len = prompt_len + max_new
        self._eos_id = eos_id
        self._commit_every = commit_every
        self._decode_prompt = decode_prompt or _default_decode_prompt(prompt_len)
        self._max_poll = max_poll_records
        self._ticks_per_sync = ticks_per_sync
        self._kv_backend = resolve_kv_backend(
            cfg, kv_dtype=kv_dtype, kv_kernel=kv_kernel, max_len=self._max_len,
            device=self._device,
        )
        self._kv_int8 = self._kv_backend.int8
        self._ledger = OffsetLedger()
        self.metrics = ServeMetrics()
        self.metrics.note_backend(self._kv_backend)
        self._slot_rec: list[Record | None] = [None] * slots
        self._active = np.zeros((slots,), bool)
        self._slot_emitted = np.zeros((slots,), np.int64)
        self._uncommitted = 0
        self._closed = False
        self._build()

    def _build(self) -> None:
        cfg, dev = self._cfg, self._device
        B, M, max_new = self._slots, self._max_len, self._max_new
        nl, kh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self._model = prefill_model(cfg)
        self._layers = [layer_at(self._params["layers"], i) for i in range(nl)]
        self._rows = torch.arange(B, device=dev)
        if self._kv_int8:
            # K-major, the fill-bounded kernel's layout: each (slot, head)
            # row of M positions is contiguous.
            pay, sc = (nl, B, kh, M, dh), (nl, B, kh, M)
            self._caches = (
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
            )
        else:
            shape = (nl, B, M, kh, dh)
            self._caches = (
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
            )
        self._last_tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._gen = torch.zeros((B, max_new), dtype=torch.int32, device=dev)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Snapshot a host array, then copy it to the device: the tensor
        never aliases a buffer the host may reuse."""
        return torch.from_numpy(np.array(arr, copy=True)).to(self._device)

    # ------------------------------------------------------------ device

    def _admit(self, prompts: np.ndarray, admit_mask: np.ndarray) -> None:
        """Prefill the admitted rows and merge them into the slot state:
        cache rows [0, P) of each admitted slot, token 0, position P and a
        cleared output buffer. Positions >= P keep their stale contents;
        every one is rewritten by the tick that reaches it before it can be
        read."""
        cfg, P = self._cfg, self._prompt_len
        idx = np.nonzero(admit_mask)[0]
        rows = self._h2d(idx)
        toks = self._h2d(prompts[idx])
        logits, ks, vs = prefill_capture(self._params, cfg, toks, self._model)
        c = self._caches
        if self._kv_int8:
            kq, ksc = quant_kv_groups(ks)  # [L, n, P, K, Dh], [L, n, P, K]
            vq, vsc = quant_kv_groups(vs)
            c[0][:, rows, :, :P] = kq.transpose(2, 3)  # → [L, n, K, P, Dh]
            c[1][:, rows, :, :P] = ksc.transpose(2, 3)
            c[2][:, rows, :, :P] = vq.transpose(2, 3)
            c[3][:, rows, :, :P] = vsc.transpose(2, 3)
        else:
            c[0][:, rows, :P] = ks.to(c[0].dtype)
            c[1][:, rows, :P] = vs.to(c[1].dtype)
        self.metrics.prefills.add(1)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        self._last_tok[rows] = tok0
        self._pos[rows] = P
        self._gen[rows] = 0
        self._gen[rows, 0] = tok0

    def _decode_logits(self, last_tok, pos) -> torch.Tensor:
        """One token per slot through every layer → logits [B, V] f32."""
        cfg, p = self._cfg, self._params
        x = embed_rows(p["embed"], last_tok, cfg.dtype)[:, None, :]
        c = self._caches
        for i, layer in enumerate(self._layers):
            if self._kv_int8:
                x = _slot_layer_step_q(
                    x, layer, c[0][i], c[1][i], c[2][i], c[3][i], pos,
                    self._rows, cfg,
                )
            else:
                x = _slot_layer_step(
                    x, layer, c[0][i], c[1][i], pos, self._rows, cfg
                )
        x = _rms_norm(x, p["ln_f"])
        return matmul_f32(x[:, 0], p["lm_head"], cfg.dtype)

    def _tick_block(self, active: torch.Tensor):
        """``ticks_per_sync`` decode ticks with a LATCHED done mask: a slot
        that completes at inner tick j is masked out of the later ticks, so
        its output cannot be clobbered. Returns (done, n_out) [B]."""
        B, P, max_new = self._slots, self._prompt_len, self._max_new
        dev = self._device
        last_tok, pos, gen = self._last_tok, self._pos, self._gen
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        cols = torch.arange(max_new, device=dev)[None, :]
        for _ in range(self._ticks_per_sync):
            act = active & ~done
            tok = torch.argmax(self._decode_logits(last_tok, pos), dim=-1)
            tok = tok.to(torch.int32)
            t = pos - P  # decode ticks completed before this one
            idx = torch.clamp(t + 1, max=max_new - 1)
            onehot = cols == idx[:, None]
            gen = torch.where(onehot & act[:, None], tok[:, None], gen)
            if self._eos_id is not None:
                hit_eos = tok == self._eos_id
            else:
                hit_eos = torch.zeros_like(act)
            # Tokens after this tick = t + 2 (prefill's token 0 plus t+1
            # decode outputs); complete on EOS or a full buffer.
            done_now = act & (hit_eos | (t + 2 >= max_new))
            pos = torch.where(act & ~done_now, pos + 1, pos)
            last_tok = torch.where(act, tok, last_tok)
            n_out = torch.where(done_now, torch.clamp(t + 2, max=max_new), n_out)
            done = done | done_now
        self._last_tok, self._pos, self._gen = last_tok, pos, gen
        return done, n_out

    def warmup(self) -> None:
        """Load the kernels and warm the library handles before the first
        real admission: one prefill of a zero prompt (result discarded)
        and one tick block over an all-inactive pool, which leaves the
        slot state unchanged (inactive slots only write at their frozen
        positions)."""
        with torch.inference_mode():
            toks = torch.zeros(
                (1, self._prompt_len), dtype=torch.int32, device=self._device
            )
            prefill_capture(self._params, self._cfg, toks, self._model)
            none = torch.zeros((self._slots,), dtype=torch.bool, device=self._device)
            self._tick_block(none)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # ------------------------------------------ external admission surface

    def free_slots(self) -> int:
        return int((~self._active).sum())

    def has_active(self) -> bool:
        return bool(self._active.any())

    def note_fetched(self, records: list[Record]) -> None:
        """Register polled records with the ledger BEFORE queueing them, so
        the commit watermark can never pass a record still waiting for a
        slot."""
        crash_hook("post_poll")
        self._ledger.fetched_many(records)

    def _next_decodable(self, queue: list[Record]):
        """Pop ``queue`` until a record decodes → (record, tokens), or None.
        An undecodable record retires as dropped (it would re-deliver and
        fail forever otherwise)."""
        while queue:
            rec = queue.pop(0)
            try:
                return rec, self._decode_prompt(rec)
            except Exception:  # noqa: BLE001 - any decode failure drops
                _logger.exception(
                    "dropping undecodable prompt %s@%s:%s",
                    rec.topic, rec.partition, rec.offset,
                )
                self._ledger.dropped(rec)
                self.metrics.dropped.add(1)
        return None

    def admit_records(self, records: list[Record]) -> int:
        """Prefill-admit ``records`` into free slots; returns the number of
        slots filled. Records must already be ``note_fetched``; offer no
        more than ``free_slots()``."""
        free = [i for i in range(self._slots) if not self._active[i]]
        if len(records) > len(free):
            raise ValueError(
                f"offered {len(records)} records with {len(free)} free slots"
            )
        in_flight = self._slots - len(free)
        prompts = np.zeros((self._slots, self._prompt_len), np.int32)
        admit_mask = np.zeros((self._slots,), bool)
        queue = list(records)
        slot_iter = iter(free)
        while True:
            nxt = self._next_decodable(queue)
            if nxt is None:
                break
            rec, toks = nxt
            i = next(slot_iter)
            prompts[i] = toks
            self._slot_rec[i] = rec
            admit_mask[i] = True
            self._active[i] = True
            self._slot_emitted[i] = 0
        admitted = int(admit_mask.sum())
        if admitted:
            if in_flight > 0:
                self.metrics.readmissions.add(admitted)
            with torch.inference_mode():
                self._admit(prompts, admit_mask)
        return admitted

    def _retire_completion(self, rec: Record, out: np.ndarray,
                           completions: list) -> None:
        self.metrics.completions.add(1)
        self.metrics.tokens.add(len(out))
        if len(out) < self._max_new:
            self.metrics.truncated.add(1)
        self._ledger.emitted(rec)
        self._uncommitted += 1
        completions.append((rec, out))

    def step(self) -> list[tuple[Record, np.ndarray]]:
        """One decode tick block over the active slots; returns the
        completions it retired, in completion order. No-op on an idle
        pool."""
        completions: list[tuple[Record, np.ndarray]] = []
        if self._active.any():
            B, P = self._slots, self._prompt_len
            tick_t0 = time.perf_counter()
            with torch.inference_mode():
                done, n_out = self._tick_block(self._h2d(self._active))
                # ONE host sync per tick block: done/n_out/pos/gen together.
                packed = torch.cat([
                    done.to(torch.int32), n_out, self._pos, self._gen.reshape(-1)
                ]).cpu().numpy()
            done_h = packed[:B].astype(bool)
            n_out_h, pos_h = packed[B:2 * B], packed[2 * B:3 * B]
            gen_h = packed[3 * B:].reshape(B, self._max_new)
            self.metrics.tick_time.observe(time.perf_counter() - tick_t0)
            self.metrics.decode_ticks.add(self._ticks_per_sync)
            crash_hook("mid_tick")
            self.metrics.slot_occupancy.set(float(self._active.mean()))
            decoded = 0
            for i in np.nonzero(self._active)[0]:
                cnt = int(n_out_h[i] if done_h[i] else pos_h[i] - P + 1)
                decoded += cnt - int(self._slot_emitted[i])
                self._slot_emitted[i] = cnt
            if decoded > 0:
                self.metrics.decoded_tokens.add(decoded)
            self.metrics.tokens_per_tick.set(float(decoded))
            for i in np.nonzero(done_h)[0]:
                rec = self._slot_rec[i]
                assert rec is not None
                self._active[i] = False
                self._slot_rec[i] = None
                self._slot_emitted[i] = 0
                self._retire_completion(
                    rec, gen_h[i, : n_out_h[i]].copy(), completions
                )
        if (
            completions
            and self._uncommitted >= self._commit_every
            and self._commit()
        ):
            self._uncommitted = 0
        return completions

    def flush_commits(self) -> bool:
        """Commit anything emitted since the last commit. False = a
        survivable commit failure left work pending (retry later)."""
        if self._uncommitted:
            if self._commit():
                self._uncommitted = 0
                return True
            return False
        return True

    def committable_offsets(self) -> dict:
        """The ledger's committable next-read offsets right now."""
        return self._ledger.snapshot()

    def run(
        self, max_records: int | None = None, idle_timeout_ms: int = 2000
    ) -> Iterator[tuple[Record, np.ndarray]]:
        B = self._slots
        pending: list[Record] = []
        served = 0
        exhausted_at: float | None = None
        self.metrics.reset()
        while True:
            free = self.free_slots()
            in_flight = B - free
            budget = (
                max(0, max_records - served - in_flight)
                if max_records is not None
                else B
            )
            take_cap = max(0, min(free, budget))
            if take_cap and len(pending) < take_cap:
                # Never let an empty topic stall in-flight decode ticks.
                records = self._consumer.poll(
                    max_records=self._max_poll,
                    timeout_ms=0 if in_flight else 50,
                )
                if records:
                    self.note_fetched(records)
                    pending.extend(records)
                    exhausted_at = None
            if take_cap and pending:
                take = pending[:take_cap]
                del pending[: len(take)]
                self.admit_records(take)
            if not self.has_active():
                if max_records is not None and served >= max_records:
                    break
                if not pending:
                    if exhausted_at is None:
                        exhausted_at = time.monotonic()
                    elif (time.monotonic() - exhausted_at) * 1000 >= idle_timeout_ms:
                        break
                continue
            for rec, out in self.step():
                served += 1
                yield rec, out
            if max_records is not None and served >= max_records and not self.has_active():
                break
        self.flush_commits()

    def _commit(self) -> bool:
        """Commit the ledger watermark; True iff offsets were durably
        committed. A rebalance (``CommitFailedError``) or a broker outage
        is survivable: the snapshot stays pending and the next commit
        retries. Partitions this consumer no longer owns are dropped from
        the commit set (their records re-serve on the new owner)."""
        t0 = time.perf_counter()
        snapshot = self._ledger.snapshot()
        try:
            assigned = set(self._consumer.assignment())
        except Exception:  # noqa: BLE001 - transport hiccup: commit as-is
            assigned = None
        if assigned is not None:
            snapshot = {tp: off for tp, off in snapshot.items() if tp in assigned}
            if not snapshot:
                return True
        crash_hook("pre_commit")
        try:
            self._consumer.commit(snapshot)
            self.metrics.commit_latency.observe(time.perf_counter() - t0)
        except CommitFailedError:
            self.metrics.commit_failures.add(1)
            _logger.exception("offset commit failed; prompts will re-deliver")
            return False
        except BrokerUnavailableError:
            self.metrics.commit_failures.add(1)
            _logger.warning(
                "broker unavailable at commit; offsets stay pending and "
                "retry at the next flush"
            )
            return False
        return True

    def close(self) -> None:
        """Voluntary shutdown: commit the watermark for everything already
        completed; in-flight generations stay uncommitted and re-deliver.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._commit()
        except ConsumerClosedError:
            pass

    def __enter__(self) -> "StreamingGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
