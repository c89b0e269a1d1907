"""Continuous-batching generation server: port of ``torchkafka_tpu/serve.py``.

A fixed pool of decode slots serves a prompt topic: prompts are admitted
into free slots as earlier generations finish (EOS or ``max_new``), each
completion retires its record in the ``OffsetLedger``, and offsets commit
every ``commit_every`` completions plus once at the end, so a crash
re-delivers exactly the prompts whose generations never finished.

PyTorch idiom against the JAX package's:

- The KV pools are updated IN PLACE (``index_put_`` on per-layer views);
  the JAX package donates the pool to each jitted program and rebinds
  the result. Nothing else aliases a pool, so the two are equivalent.
- The tick block is a Python loop of ``ticks_per_sync`` ticks over the
  layers with the latched done mask of the JAX ``tick_block``; one host
  sync per block fetches done, n_out, pos and gen together.
- Every host array copied to the device is snapshotted first
  (``torch.from_numpy`` shares memory, and the block table is mutated in
  place by every admission and retirement).
- Slot rows are recycled without clearing: a position is always written
  before the read that could see it (write-before-attend), so stale kv of
  a freed slot, and the writes inactive slots make at their frozen
  position, are never read.

Dense pools: ``kv_dtype=None`` keeps k/v in the compute dtype
([L, B, M, K, Dh], read by ``models.generate._attend_cached``);
``kv_dtype="int8"`` stores int8 payloads and per-(position, head) f32
scales. With the kernel (``resolve_kv_backend``) they are K-major ([L, B,
K, M, Dh] / [L, B, K, M]) and read through
``ops.kvattn.int8_decode_attention_dynlen``, the fill-bounded CUDA kernel;
without it (``kv_kernel=False``, or "auto" on a shape the kernel does not
take) they are M-major ([L, B, M, K, Dh] / [L, B, M, K]) and read by the
scale-folded ``_attend_cached`` under a [B, M] valid mask — the JAX
package's XLA read, in plain code as there (the K8 kernel,
``ops.kvattn.int8_decode_attention``, computes the same read and is not
called here, as in the JAX package). Dense prefill attention runs through
``ops.flash``'s CUDA kernel. Weights may be int8 ``QTensor``s
(``models.quant.quantize_params`` or the zoo's
``random_serving_params(quantized=True)``, how the 8b scale serves): each
use dequantizes through ``models.quant.load_weight``.

Output topic (``output_producer`` + ``output_topic``, at-least-once):
each completion is sent as it retires, keyed by its prompt record's key,
with ``encode_output(record, tokens)`` as the value (default: the int32
tokens' bytes) and an ``("mv", model_version)`` header. Every offset
commit first flushes the producer and settles every send handle since the
last commit; a failed flush skips the commit (the prompts re-deliver), a
terminally failed handle raises ``OutputDeliveryError``. A synchronous
send failure leaves its record out of the ledger's emitted set, so the
watermark stalls at it while serving goes on; ``max_send_failure_streak``
consecutive failures stop the server with ``OutputDeliveryError``.

Paged pool (``kv_pages=PagedKVConfig(...)``): a shared block pool
([L, NB, bs, K, Dh], or K-major-per-block int8 [L, NB, K, bs, Dh] + f32
[L, NB, K, bs]) with per-slot block tables; a radix tree over prompt
blocks shares tenant prefixes across records, and only the uncached
suffix is prefilled. Chunked admission (``prefill_chunk`` None or >= 1)
reserves the slot and enqueues the suffix; every tick then carries a
bounded chunk of queued suffix tokens alongside the decode rows in one
layer sweep through the gathered view, and token 0 is merged in the same
tick. Decode-only ticks of the int8 pool read through
``ops.kvattn.int8_paged_decode_attention``, the block-table CUDA kernel,
when ``resolve_kv_backend`` engages it. ``prefill_chunk=0`` keeps the
legacy per-record admission (compute dtype only): one suffix prefill per
record. A pool too small for one slot's worst case falls back to the
dense pool (``cache_fallbacks``).

Still raising ``NotImplementedError`` with their ROADMAP item (``_DEFERRED``):
among others exactly-once output (``exactly_once``), the host-RAM KV tier
(``kv_tier``), disaggregated prefill (``prefill_role``), mesh, journal,
tracing and sampled serving.
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
    OutputDeliveryError,
)
from torchkafka_tpu_torch.kvcache.backend import KVBackend, resolve_kv_backend
from torchkafka_tpu_torch.kvcache.blocks import (
    SINK_BLOCK,
    BlockAllocator,
    PagedKVConfig,
)
from torchkafka_tpu_torch.kvcache.radix import RadixCache
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
from torchkafka_tpu_torch.ops.kvattn import (
    block_table_attention,
    block_table_attention_q8,
    int8_decode_attention_dynlen,
    int8_paged_decode_attention,
    paged_write_q8,
)
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
    "journal": "3, journal",
    "exactly_once": "4, exactly-once",
    "mesh": "6, mesh",
    "tracer": "9, tracing spans",
    "quarantine": "11, poison quarantine",
    "distill_topic": "11, draft distillation",
    "distill_producer": "11, draft distillation",
    "max_new_of": "11, per-record output budgets",
    "kv_tier": "13, host-RAM KV tier",
    "prefill_role": "14, disaggregated prefill",
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


def _slot_layer_step_q(x, layer, ck_q, ck_s, cv_q, cv_s, pos, rows, cfg, kernel):
    """The int8-pool variant: the fresh k/v are quantized into the shared
    per-(position, head) groups and scattered into one layer's views in
    place. ``kernel``: the K-major pool (payloads [B, K, M, Dh], scales
    [B, K, M]; written at ``[b, :, pos[b]]``) read through the
    fill-bounded kernel. Otherwise the M-major pool ([B, M, K, Dh] /
    [B, M, K]; written at ``[b, pos[b]]``) read by the scale-folded
    ``_attend_cached`` under the [B, M] mask ``m <= pos[b]``."""
    q, k, v = _project_qkv(x, layer, cfg)
    q = _rope(q, pos[:, None], cfg.rope_theta)
    k = _rope(k, pos[:, None], cfg.rope_theta)
    kq, ks = quant_kv_groups(k[:, 0])  # [B, K, Dh] int8, [B, K] f32
    vq, vs = quant_kv_groups(v[:, 0])
    p = pos.long()
    if kernel:
        kidx = torch.arange(ck_q.shape[1], device=x.device)[None, :]
        idx = (rows[:, None], kidx, p[:, None])
    else:
        idx = (rows, p)
    ck_q.index_put_(idx, kq)
    ck_s.index_put_(idx, ks)
    cv_q.index_put_(idx, vq)
    cv_s.index_put_(idx, vs)
    if kernel:
        attn = int8_decode_attention_dynlen(q, ck_q, ck_s, cv_q, cv_s, pos)
        return _attn_tail(x, attn, layer, cfg)
    valid = torch.arange(ck_q.shape[1], device=x.device)[None, :] <= pos[:, None]
    return _attend_cached(x, q, ck_q, cv_q, valid, layer, cfg,
                          k_scale=ck_s, v_scale=cv_s)


class ServeMetrics:
    """The serving loop's counters that the ported paths touch (the JAX
    package's ``ServeMetrics`` names). The paged prefix-cache and chunked-
    prefill counters stay zero on the dense path."""

    def __init__(self) -> None:
        self.completions = RateMeter()
        self.tokens = RateMeter()
        self.truncated = RateMeter()  # stopped by EOS before max_new
        self.readmissions = RateMeter()  # slots refilled while others decode
        self.dropped = RateMeter()  # undecodable prompts retired
        self.commit_failures = RateMeter()
        self.output_flush_failures = RateMeter()  # output topic not durable
        self.output_send_failures = RateMeter()  # sync send refusals (stall)
        self.commit_latency = LatencyHistogram()
        self.slot_occupancy = Gauge()  # active slots / pool size, last tick
        self.tick_time = LatencyHistogram()  # per tick block, host observed
        self.tokens_per_tick = Gauge()
        self.decoded_tokens = RateMeter()  # tokens produced by decode ticks
        self.prefills = RateMeter()  # dense admission prefill passes
        self.decode_ticks = RateMeter()  # decode ticks run (all layers each)
        # Paged prefix cache (kv_pages=).
        self.prefix_hits = RateMeter()  # admissions that reused cached blocks
        self.prefix_misses = RateMeter()  # admissions that prefilled in full
        self.prefix_tokens_saved = RateMeter()  # prompt tokens NOT re-prefilled
        self.prefill_tokens = RateMeter()  # prompt tokens actually prefilled
        self.cache_evictions = RateMeter()  # cached blocks LRU-evicted
        self.admission_deferrals = RateMeter()  # records deferred on pool
        # pressure (re-offered FIFO once blocks free)
        self.cache_fallbacks = RateMeter()  # paged → dense cache-off fallbacks
        self.cache_pool_occupancy = Gauge()  # allocated / usable blocks
        # Chunked prefill (kv_pages with prefill_chunk != 0).
        self.chunk_ticks = RateMeter()  # tick blocks that carried chunk rows
        self.admission_stall_ticks = RateMeter()  # extra ticks admissions
        # queued beyond the one-tick minimum
        self.admission_queue_tokens = Gauge()  # suffix tokens still queued
        self.chunk_utilization = Gauge()  # prefill tokens / (chunk ticks x
        # chunk width)
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

    def chunk_summary(self) -> dict:
        ticks = self.chunk_ticks.count
        return {
            "chunk_ticks": ticks,
            "prefill_tokens_per_tick": (
                round(self.prefill_tokens.count / ticks, 2) if ticks else None
            ),
            "stall_ticks": self.admission_stall_ticks.count,
            "queue_tokens": int(self.admission_queue_tokens.value),
            "utilization": round(self.chunk_utilization.value, 4),
        }

    def cache_summary(self) -> dict:
        hits, misses = self.prefix_hits.count, self.prefix_misses.count
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": (
                round(hits / (hits + misses), 4) if hits + misses else None
            ),
            "prefix_tokens_saved": self.prefix_tokens_saved.count,
            "prefill_tokens": self.prefill_tokens.count,
            "evictions": self.cache_evictions.count,
            "deferrals": self.admission_deferrals.count,
            "fallbacks": self.cache_fallbacks.count,
            "pool_occupancy": round(self.cache_pool_occupancy.value, 3),
        }

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
            "output_flush_failures": self.output_flush_failures.count,
            "output_send_failures": self.output_send_failures.count,
            "commit": self.commit_latency.summary(),
            "slot_occupancy": round(self.slot_occupancy.value, 3),
            "ticks": self.tick_time.count,
            "step_time": self.tick_time.summary(),
            "tokens_per_tick": round(self.tokens_per_tick.value, 2),
            "decoded_tokens": self.decoded_tokens.count,
            "prefills": self.prefills.count,
            "decode_ticks": self.decode_ticks.count,
            "prefix_cache": self.cache_summary(),
            "chunked_prefill": self.chunk_summary(),
            "kv_backend": {
                **self._kv_backend,
                "kernel_engaged": int(self.kernel_engaged.value),
            },
        }


class _PendingPrefill:
    """One admission's queued chunk-prefill work (paged chunked mode).

    The slot and its blocks are already reserved (table linked, radix
    inserted); ``seq`` is the UNCACHED suffix still to be written —
    ``seq[off:]`` remains — with ``seq[0]`` at logical position
    ``start``. ``enq_tick`` is the tick counter at admission."""

    __slots__ = ("slot", "rec", "seq", "off", "start", "enq_tick")

    def __init__(self, slot, rec, seq, start, enq_tick):
        self.slot = slot
        self.rec = rec
        self.seq = seq
        self.off = 0
        self.start = start
        self.enq_tick = enq_tick


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
    ``kv_dtype``: None = the compute dtype; "int8" = the int8 pool.
    ``kv_pages``: a ``kvcache.PagedKVConfig`` (or its dict) — the paged
    pool with radix prefix reuse (module docstring); None = the dense
    pool. ``kv_kernel``: how the int8 pool is read (True, "auto" or
    False; ``kvcache.resolve_kv_backend`` decides and records why).
    ``output_producer``/``output_topic`` (given together): publish each
    completion (module docstring), ``encode_output(record, tokens)`` its
    value, ``model_version`` its ``mv`` header; ``max_send_failure_streak``
    consecutive synchronous send failures stop the server.
    ``device``: where the model and the pool live; None = CUDA, raising
    when there is none (``utils.devices.resolve_device``). Greedy
    decoding only (``temperature=0``). The other arguments of the JAX
    package's server raise ``NotImplementedError`` (``_DEFERRED``)."""

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
        kv_pages: PagedKVConfig | dict | None = None,
        output_producer=None,
        output_topic: str | None = None,
        encode_output: Callable[[Record, np.ndarray], bytes] | None = None,
        max_send_failure_streak: int = 64,
        model_version: int = 0,
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
        if (output_producer is None) != (output_topic is None):
            raise ValueError(
                "output_producer and output_topic must be given together"
            )
        if max_send_failure_streak < 1:
            raise ValueError("max_send_failure_streak must be >= 1")
        if isinstance(kv_pages, dict):
            kv_pages = PagedKVConfig(**kv_pages)
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
        self._kv_dtype = kv_dtype
        self._kv_kernel_opt = kv_kernel
        self._output_producer = output_producer
        self._output_topic = output_topic
        self._encode_output = encode_output or (
            lambda rec, toks: np.asarray(toks, np.int32).tobytes()
        )
        self._pending_outputs: list = []  # send handles since the last commit
        self._max_send_failure_streak = max_send_failure_streak
        self._send_failure_streak = 0
        self._model_version = int(model_version)
        # Validates the whole combination eagerly (the exclusions raise);
        # _build re-resolves if a too-small paged pool falls back to dense.
        self._kv_backend = resolve_kv_backend(
            cfg, kv_dtype=kv_dtype, kv_kernel=kv_kernel, kv_pages=kv_pages,
            max_len=self._max_len, device=self._device,
        )
        self._kv_pages = kv_pages
        self._kv_int8 = self._kv_backend.int8
        self._ledger = OffsetLedger()
        self.metrics = ServeMetrics()
        self._slot_rec: list[Record | None] = [None] * slots
        self._active = np.zeros((slots,), bool)
        self._slot_emitted = np.zeros((slots,), np.int64)
        # Paged host state, defined unconditionally so free_slots,
        # has_active and step are mode-blind: a slot is BUSY while
        # reserved-and-prefilling just as while decoding.
        self._prefilling = np.zeros((slots,), bool)
        self._prefill_queue: list[_PendingPrefill] = []
        self._paged_deferred: list[Record] = []
        self._chunked = False
        self._tick_counter = 0
        self._uncommitted = 0
        self._closed = False
        self._build()
        self.metrics.note_backend(self._kv_backend)

    def _build(self) -> None:
        cfg, dev = self._cfg, self._device
        B, M, max_new = self._slots, self._max_len, self._max_new
        nl, kh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self._model = prefill_model(cfg)
        self._layers = [layer_at(self._params["layers"], i) for i in range(nl)]
        self._rows = torch.arange(B, device=dev)
        self._last_tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._gen = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
        if self._kv_pages is not None:
            if self._paged_setup():
                self._build_paged()
                return
            self._kv_backend = resolve_kv_backend(
                cfg, kv_dtype=self._kv_dtype, kv_kernel=self._kv_kernel_opt,
                max_len=M, device=dev,
            )
        if self._kv_int8:
            if self._kv_backend.kernel:
                # K-major, the fill-bounded kernel's layout: each (slot,
                # head) row of M positions is contiguous.
                pay, sc = (nl, B, kh, M, dh), (nl, B, kh, M)
            else:
                # M-major, the layout _attend_cached reads.
                pay, sc = (nl, B, M, kh, dh), (nl, B, M, kh)
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

    # ------------------------------------------------------ paged slot pool

    def _paged_setup(self) -> bool:
        """Host-side paging state; False = the pool is too small for even
        ONE slot's worst case → graceful cache-off fallback (dense build)."""
        pages = self._kv_pages
        nblk = pages.blocks_per_slot(self._max_len)
        if pages.num_blocks - 1 < nblk:
            _logger.warning(
                "kv_pages pool (%d usable blocks of %d tokens) cannot hold "
                "one slot's %d-token worst case (%d blocks); falling back "
                "to dense cache-off serving",
                pages.num_blocks - 1, pages.block_size, self._max_len, nblk,
            )
            self.metrics.cache_fallbacks.add(1)
            self._kv_pages = None
            return False
        self._blocks_per_slot = nblk
        self._kv_alloc = BlockAllocator(pages.num_blocks)
        self._kv_radix = RadixCache(self._kv_alloc, pages.block_size)
        self._table_np = np.zeros((self._slots, nblk), np.int32)  # all sink
        # The auto chunk width covers every admission one serving quantum
        # can offer (<= slots records of <= prompt_len uncached tokens),
        # capped at 256 rows: each chunk row gathers its slot's whole
        # logical view per layer, and a long-prompt storm is where bounded
        # per-tick prefill work is the point.
        self._chunked = pages.prefill_chunk != 0
        self._prefill_chunk = pages.prefill_chunk or min(
            self._slots * self._prompt_len, max(256, 2 * pages.block_size)
        )
        return True

    def _build_paged(self) -> None:
        cfg, dev = self._cfg, self._device
        bs, NB = self._kv_pages.block_size, self._kv_pages.num_blocks
        nl, kh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        if self._kv_int8:
            # K-major per block: each block's [K, bs, Dh] tile is the
            # block-table kernel's unit, each (block, head) run contiguous.
            pay, sc = (nl, NB, kh, bs, dh), (nl, NB, kh, bs)
            self._pools = (
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
            )
        else:
            shape = (nl, NB, bs, kh, dh)
            self._pools = (
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
            )
        self._table_dev = self._device_table()

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Snapshot a host array, then copy it to the device: the tensor
        never aliases a buffer the host may reuse."""
        return torch.from_numpy(np.array(arr, copy=True)).to(self._device)

    def _device_table(self) -> torch.Tensor:
        """The block table the decode rows read. In chunked mode the rows
        of reserved-but-still-prefilling slots are masked to the sink: an
        inactive decode row still writes its frozen position
        unconditionally, and that write must never land in the freshly
        linked blocks the chunk rows are filling (the chunk rows carry
        their real rows separately)."""
        t = self._table_np
        if self._chunked:
            t = np.where(self._active[:, None], t, SINK_BLOCK).astype(np.int32)
        return self._h2d(t)

    def _release_slot_blocks(self, i: int) -> None:
        """Drop a retired slot's references; its table row falls back to
        the sink so the tick's frozen-position write lands harmlessly."""
        row = [int(b) for b in self._table_np[i] if b != SINK_BLOCK]
        if row:
            self._kv_alloc.decref(row)
        self._table_np[i, :] = SINK_BLOCK

    def _paged_layers(self, x, positions, tables, *, kernel=False, pos_b=None):
        """All layers' write-then-attend over the paged pool for a batch of
        query rows. x: [R, S, D]; positions: [R, S]; tables: [R, nblk] PER-
        ROW block tables (decode rows carry the slot table, chunk rows
        their own freshly linked rows), so one call serves any mix.
        ``kernel``: S=1 rows read through the block-table kernel at
        watermarks ``pos_b`` (int8 pool only)."""
        cfg = self._cfg
        for i, layer in enumerate(self._layers):
            q, k, v = _project_qkv(x, layer, cfg)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            pools = [p[i] for p in self._pools]
            if kernel:
                paged_write_q8(*pools, tables, positions, k, v)
                attn = int8_paged_decode_attention(q, *pools, tables, pos_b)
                x = _attn_tail(x, attn, layer, cfg)
            elif self._kv_int8:
                x = block_table_attention_q8(
                    x, q, k, v, *pools, tables, positions, layer, cfg
                )
            else:
                x = block_table_attention(
                    x, q, k, v, *pools, tables, positions, layer, cfg
                )
        return x

    def _head(self, x_last) -> torch.Tensor:
        """Final norm + LM head on [R, D] rows → f32 logits [R, V]."""
        x = _rms_norm(x_last, self._params["ln_f"])
        return matmul_f32(x, self._params["lm_head"], self._cfg.dtype)

    def _embed(self, toks) -> torch.Tensor:
        return embed_rows(self._params["embed"], toks, self._cfg.dtype)

    def _suffix_prefill(self, table_row: np.ndarray, toks: np.ndarray,
                        start: int) -> torch.Tensor:
        """Legacy per-record admission: prefill ONE slot's uncached suffix
        ``toks`` at positions [start, start + S) through its table row,
        attending over the cached prefix plus itself, causally (a miss,
        start=0, is a full prefill). Returns the last position's logits
        [1, V]."""
        s = len(toks)
        x = self._embed(self._h2d(toks)[None, :])  # [1, S, D]
        positions = (start + torch.arange(s, device=self._device))[None, :]
        table = self._h2d(table_row)[None, :]
        x = self._paged_layers(x, positions.to(torch.int32), table)
        return self._head(x[:, -1])

    def _pack_chunk(self):
        """Fill the static chunk operands from the FIFO prefill queue: up
        to ``prefill_chunk`` suffix tokens, taken strictly in queue order
        (the ordering the radix-insert-at-admit safety argument stands
        on), each row carrying its token, logical position and its slot's
        REAL table row. Padding rows point at the sink. Returns (ctok,
        ctable, cpos, fin_mask, fin_row, packed, finishers) — finishers
        are (entry, last_row_index) for admissions whose suffix completes
        in this chunk; ``fin_mask``/``fin_row`` mark their slots so the
        tick merges token 0 in the same tick."""
        C, B, nblk = self._prefill_chunk, self._slots, self._blocks_per_slot
        ctok = np.zeros((C,), np.int32)
        cpos = np.zeros((C,), np.int32)
        ctable = np.full((C, nblk), SINK_BLOCK, np.int32)
        fin_mask = np.zeros((B,), bool)
        fin_row = np.zeros((B,), np.int64)
        finishers: list[tuple[_PendingPrefill, int]] = []
        packed = 0
        while packed < C and self._prefill_queue:
            e = self._prefill_queue[0]
            n = min(C - packed, len(e.seq) - e.off)
            ctok[packed:packed + n] = e.seq[e.off:e.off + n]
            cpos[packed:packed + n] = e.start + e.off + np.arange(n)
            ctable[packed:packed + n] = self._table_np[e.slot]
            e.off += n
            packed += n
            if e.off == len(e.seq):
                finishers.append((e, packed - 1))
                fin_mask[e.slot] = True
                fin_row[e.slot] = packed - 1
                self._prefill_queue.pop(0)
        return ctok, ctable, cpos, fin_mask, fin_row, packed, finishers

    def _activate_chunk_finishers(self, finishers) -> None:
        """Host bookkeeping for slots whose suffix prefill completed this
        tick: flip them active (their first decode tick is the NEXT tick
        block; token 0 was merged in this one) and push the device table
        so their rows unmask from the sink."""
        for e, _row in finishers:
            self._prefilling[e.slot] = False
            self._active[e.slot] = True
            # Extra ticks spent queued beyond the one-tick minimum — 0 when
            # the admission's whole suffix rode the first chunk.
            self.metrics.admission_stall_ticks.add(
                max(0, self._tick_counter - e.enq_tick - 1)
            )
        self._table_dev = self._device_table()

    @property
    def pending_admissions(self) -> int:
        """Records accepted by ``admit_records`` but deferred on block-pool
        pressure — they re-offer FIRST (per-partition FIFO) as blocks
        free. Callers subtract this from ``free_slots()`` when sizing new
        offers, and keep calling ``admit_records([])`` while it is nonzero
        so the backlog drains."""
        return len(self._paged_deferred)

    def _admit_records_paged(self, records: list[Record]) -> int:
        """Paged admission: per record — radix longest-prefix match, link
        the shared blocks, allocate private blocks (LRU-evicting
        unreferenced cached prefixes under pressure, DEFERRING when every
        free block is pinned), then hand the uncached suffix to prefill.
        Sequential per record, so a duplicate prompt inside one batch hits
        its predecessor's freshly inserted prefix.

        CHUNKED mode: the slot is reserved and the suffix ENQUEUED; the
        tick's fused layer sweep processes it a chunk at a time. The radix
        insert happens here, at reservation time: a later admission
        matching these still-being-filled blocks is safe because the chunk
        queue drains strictly FIFO, so the matched positions are written
        in an earlier (or the same, write-before-attend) tick than any
        query that attends over them.

        LEGACY mode (``prefill_chunk=0``): one suffix prefill per record,
        then the dense admit's token-0 merge."""
        phys_free = [
            i for i in range(self._slots)
            if not self._active[i] and not self._prefilling[i]
        ]
        if len(records) + len(self._paged_deferred) > len(phys_free):
            raise ValueError(
                f"offered {len(records)} records with "
                f"{len(phys_free) - len(self._paged_deferred)} admission "
                "slots (free slots minus deferred admissions)"
            )
        in_flight = self._slots - len(phys_free)
        was_deferred = len(self._paged_deferred)
        queue = self._paged_deferred + list(records)
        self._paged_deferred = []
        bs = self._kv_pages.block_size
        nblk = self._blocks_per_slot
        admitted: list[tuple[int, torch.Tensor]] = []  # legacy (slot, logits)
        reserved = 0
        slot_iter = iter(phys_free)
        while True:
            nxt = self._next_decodable(queue)
            if nxt is None:
                break
            rec, toks = nxt
            toks = np.asarray(toks, np.int32)
            i = next(slot_iter, None)
            if i is None:
                # Unreachable under the caller contract (records <= free
                # slots): fail loudly rather than drop a record.
                raise RuntimeError("paged admission ran out of free slots")
            matched = self._kv_radix.match(toks)
            needed = nblk - len(matched)
            short = needed - self._kv_alloc.available()
            if short > 0:
                evicted = self._kv_radix.evict(short)
                if evicted:
                    self.metrics.cache_evictions.add(evicted)
            priv = self._kv_alloc.alloc(needed)
            if priv is None:
                # Every free block is pinned by in-flight slots: DEFER.
                # Deferred records re-offer first, keeping per-partition
                # FIFO. One slot's worst case always fits (the fallback in
                # _paged_setup guards it), so this is pressure, never
                # deadlock.
                if matched:
                    self._kv_alloc.decref(matched)
                self._paged_deferred.append(rec)
                self._paged_deferred.extend(queue)
                queue = []
                break
            row = matched + priv
            self._table_np[i, :] = row
            start = len(matched) * bs
            # Register the prompt's matchable whole blocks for reuse
            # (existing nodes are the ones just matched; new nodes adopt
            # this slot's private blocks — in chunked mode still being
            # filled, safe by chunk-queue FIFO).
            cacheable = RadixCache.matchable_blocks(len(toks), bs)
            self._kv_radix.insert(toks, row[:cacheable])
            if matched:
                self.metrics.prefix_hits.add(1)
                self.metrics.prefix_tokens_saved.add(start)
            else:
                self.metrics.prefix_misses.add(1)
            self._slot_rec[i] = rec
            self._slot_emitted[i] = 0
            if self._chunked:
                self._prefilling[i] = True
                self._prefill_queue.append(_PendingPrefill(
                    i, rec, toks[start:].copy(), start, self._tick_counter,
                ))
                reserved += 1
                continue
            self.metrics.prefill_tokens.add(len(toks) - start)
            self._active[i] = True
            with torch.inference_mode():
                logits = self._suffix_prefill(
                    self._table_np[i], toks[start:], start
                )
            admitted.append((i, logits))
        if queue:  # defensive: slots exhausted with records left
            self._paged_deferred.extend(queue)
        # Count records ENTERING the deferred state, not retry spins.
        newly_deferred = len(self._paged_deferred) - was_deferred
        if newly_deferred > 0:
            self.metrics.admission_deferrals.add(newly_deferred)
        self.metrics.cache_pool_occupancy.set(self._kv_alloc.occupancy())
        filled = len(admitted) + reserved
        if filled and in_flight > 0:
            self.metrics.readmissions.add(filled)
        if admitted:
            # Chunked reservations push nothing: prefilling rows stay
            # masked to the sink until activation.
            self._table_dev = self._device_table()
            rows = self._h2d(np.asarray([i for i, _ in admitted], np.int64))
            logits = torch.cat([lg for _, lg in admitted])
            with torch.inference_mode():
                self._merge_token0(
                    rows, torch.argmax(logits, dim=-1).to(torch.int32)
                )
        return filled

    def _merge_token0(self, rows: torch.Tensor, tok0: torch.Tensor) -> None:
        """Activate admitted ``rows``: token 0, position P and a cleared
        output buffer."""
        self._last_tok[rows] = tok0
        self._pos[rows] = self._prompt_len
        self._gen[rows] = 0
        self._gen[rows, 0] = tok0

    # ------------------------------------------------------------ device

    def _admit(self, prompts: np.ndarray, admit_mask: np.ndarray) -> None:
        """Prefill the admitted rows of the dense pool and merge them into
        the slot state: cache rows [0, P) of each admitted slot, token 0,
        position P and a cleared output buffer. Positions >= P keep their
        stale contents; every one is rewritten by the tick that reaches it
        before it can be read."""
        cfg, P = self._cfg, self._prompt_len
        idx = np.nonzero(admit_mask)[0]
        rows = self._h2d(idx)
        toks = self._h2d(prompts[idx])
        logits, ks, vs = prefill_capture(self._params, cfg, toks, self._model)
        c = self._caches
        if self._kv_int8:
            kq, ksc = quant_kv_groups(ks)  # [L, n, P, K, Dh], [L, n, P, K]
            vq, vsc = quant_kv_groups(vs)
            if self._kv_backend.kernel:
                c[0][:, rows, :, :P] = kq.transpose(2, 3)  # → [L, n, K, P, Dh]
                c[1][:, rows, :, :P] = ksc.transpose(2, 3)
                c[2][:, rows, :, :P] = vq.transpose(2, 3)
                c[3][:, rows, :, :P] = vsc.transpose(2, 3)
            else:
                c[0][:, rows, :P] = kq
                c[1][:, rows, :P] = ksc
                c[2][:, rows, :P] = vq
                c[3][:, rows, :P] = vsc
        else:
            c[0][:, rows, :P] = ks.to(c[0].dtype)
            c[1][:, rows, :P] = vs.to(c[1].dtype)
        self.metrics.prefills.add(1)
        self._merge_token0(rows, torch.argmax(logits, dim=-1).to(torch.int32))

    def _decode_logits(self, last_tok, pos) -> torch.Tensor:
        """One token per slot through every layer → logits [B, V] f32."""
        cfg = self._cfg
        x = self._embed(last_tok)[:, None, :]
        if self._kv_pages is not None:
            x = self._paged_layers(
                x, pos[:, None], self._table_dev, kernel=self._kv_backend.kernel,
                pos_b=pos,
            )
            return self._head(x[:, 0])
        c = self._caches
        for i, layer in enumerate(self._layers):
            if self._kv_int8:
                x = _slot_layer_step_q(
                    x, layer, c[0][i], c[1][i], c[2][i], c[3][i], pos,
                    self._rows, cfg, self._kv_backend.kernel,
                )
            else:
                x = _slot_layer_step(
                    x, layer, c[0][i], c[1][i], pos, self._rows, cfg
                )
        return self._head(x[:, 0])

    def _bookkeep(self, logits, act, last_tok, pos, gen, done, n_out):
        """One tick's greedy pick, EOS/budget test and position advance
        over the rows ``act`` (the JAX tick body's tail)."""
        P, max_new = self._prompt_len, self._max_new
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        t = pos - P  # decode ticks completed before this one
        idx = torch.clamp(t + 1, max=max_new - 1)
        cols = torch.arange(max_new, device=self._device)[None, :]
        onehot = cols == idx[:, None]
        gen = torch.where(onehot & act[:, None], tok[:, None], gen)
        if self._eos_id is not None:
            hit_eos = tok == self._eos_id
        else:
            hit_eos = torch.zeros_like(act)
        # Tokens after this tick = t + 2 (prefill's token 0 plus t+1 decode
        # outputs); complete on EOS or a full buffer.
        done_now = act & (hit_eos | (t + 2 >= max_new))
        pos = torch.where(act & ~done_now, pos + 1, pos)
        last_tok = torch.where(act, tok, last_tok)
        n_out = torch.where(done_now, torch.clamp(t + 2, max=max_new), n_out)
        return last_tok, pos, gen, done | done_now, n_out

    def _tick_block(self, active: torch.Tensor, chunk=None):
        """``ticks_per_sync`` decode ticks with a LATCHED done mask: a slot
        that completes at inner tick j is masked out of the later ticks, so
        its output cannot be clobbered. Returns (done, n_out) [B].

        ``chunk`` (paged chunked mode): (ctok, ctable, cpos, fin_mask,
        fin_row) device operands. The FIRST inner tick then concatenates
        the B decode rows with the C chunk rows into one layer sweep over
        the gathered view (every weight read once for both; each chunk row
        writes its suffix token through its own table row and attends over
        [0, its position] of its slot's view), the remaining ticks are
        decode-only, and finally token 0 of every slot whose suffix
        completed (``fin_mask``; its last token at chunk row ``fin_row``)
        is merged in, ready to decode in the next tick block."""
        B, P = self._slots, self._prompt_len
        dev = self._device
        last_tok, pos, gen = self._last_tok, self._pos, self._gen
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        n_ticks = self._ticks_per_sync
        if chunk is not None:
            ctok, ctable, cpos, fin_mask, fin_row = chunk
            x = self._embed(torch.cat([last_tok, ctok]))[:, None, :]
            x = self._paged_layers(
                x, torch.cat([pos, cpos])[:, None],
                torch.cat([self._table_dev, ctable]),
            )
            logits = self._head(x[:, 0])  # [B + C, V]
            chunk_logits = logits[B:]
            last_tok, pos, gen, done, n_out = self._bookkeep(
                logits[:B], active, last_tok, pos, gen, done, n_out
            )
            n_ticks -= 1
        for _ in range(n_ticks):
            act = active & ~done
            logits = self._decode_logits(last_tok, pos)
            last_tok, pos, gen, done, n_out = self._bookkeep(
                logits, act, last_tok, pos, gen, done, n_out
            )
        if chunk is not None:
            tok0 = torch.argmax(chunk_logits[fin_row], dim=-1).to(torch.int32)
            last_tok = torch.where(fin_mask, tok0, last_tok)
            pos = torch.where(fin_mask, P, pos)
            col0 = torch.where(fin_mask, tok0, gen[:, 0])
            gen = torch.where(fin_mask[:, None], 0, gen)
            gen[:, 0] = col0
        self._last_tok, self._pos, self._gen = last_tok, pos, gen
        return done, n_out

    def warmup(self) -> None:
        """Load the kernels and warm the library handles before the first
        real admission, leaving the slot state unchanged: dense, one
        prefill of a zero prompt (result discarded); paged chunked, one
        fused tick with an all-padding chunk (its writes land in the
        sink); legacy paged, one suffix prefill through an all-sink table.
        Then one tick block over an all-inactive pool (inactive slots only
        write at their frozen positions)."""
        B, dev = self._slots, self._device
        none = torch.zeros((B,), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            if self._kv_pages is None:
                toks = torch.zeros(
                    (1, self._prompt_len), dtype=torch.int32, device=dev
                )
                prefill_capture(self._params, self._cfg, toks, self._model)
            elif self._chunked:
                C, nblk = self._prefill_chunk, self._blocks_per_slot
                zero = torch.zeros((C,), dtype=torch.int32, device=dev)
                sink = torch.full((C, nblk), SINK_BLOCK, dtype=torch.int32,
                                  device=dev)
                fin_row = torch.zeros((B,), dtype=torch.int64, device=dev)
                self._tick_block(none, (zero, sink, zero, none, fin_row))
            else:
                self._suffix_prefill(
                    np.full((self._blocks_per_slot,), SINK_BLOCK, np.int32),
                    np.zeros((self._prompt_len,), np.int32), 0,
                )
            self._tick_block(none)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------ external admission surface

    def free_slots(self) -> int:
        return int((~(self._active | self._prefilling)).sum())

    def has_active(self) -> bool:
        return bool(self._active.any() or self._prefilling.any())

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
        """Admit ``records`` into free slots; returns the number of slots
        filled. Records must already be ``note_fetched``; offer no more
        than ``free_slots()`` (minus ``pending_admissions`` on the paged
        pool, where pool pressure can also DEFER records — call with an
        empty list to re-offer the deferred backlog)."""
        if self._kv_pages is not None:
            return self._admit_records_paged(records)
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

    @property
    def model_version(self) -> int:
        """The version tag every published output carries (``mv``)."""
        return self._model_version

    def _retire_completion(self, rec: Record, out: np.ndarray,
                           completions: list) -> None:
        """The single completion exit: metrics, the output send (fail
        closed per record), ledger retirement."""
        self.metrics.completions.add(1)
        self.metrics.tokens.add(len(out))
        if len(out) < self._max_new:
            self.metrics.truncated.add(1)
        sent_ok = True
        if self._output_producer is not None:
            # Async send; durability is settled in _commit (flush + per-
            # handle get) BEFORE offsets commit. A SYNCHRONOUS failure
            # (buffer full, closed producer, missing topic) must neither
            # stop serving nor let the record commit: it is not marked
            # emitted, so the ledger watermark stalls at exactly this
            # record, which re-delivers and regenerates on restart.
            try:
                self._pending_outputs.append(self._output_producer.send(
                    self._output_topic,
                    self._encode_output(rec, out),
                    key=rec.key,
                    headers=(("mv", str(self._model_version).encode()),),
                ))
                self._send_failure_streak = 0
            except Exception:  # noqa: BLE001 - fail closed per record
                sent_ok = False
                self.metrics.output_send_failures.add(1)
                self._send_failure_streak += 1
                _logger.exception(
                    "output send failed for %s@%d:%d; leaving it "
                    "uncommitted to re-deliver",
                    rec.topic, rec.partition, rec.offset,
                )
            if self._send_failure_streak >= self._max_send_failure_streak:
                # The output path is down, not blinking: every further
                # completion would be replay work behind a stalled
                # watermark. Fail-stop, as the flush/get path does.
                raise OutputDeliveryError(
                    f"{self._send_failure_streak} consecutive output send "
                    "failures; failing stop so uncommitted prompts "
                    "re-deliver instead of serving into a stalled commit "
                    "watermark"
                )
        if sent_ok:
            self._ledger.emitted(rec)
            self._uncommitted += 1
        completions.append((rec, out))

    def step(self) -> list[tuple[Record, np.ndarray]]:
        """One decode tick block over the active slots (paged chunked mode:
        carrying the next chunk of queued suffix tokens); returns the
        completions it retired, in completion order. No-op on an idle
        pool with an empty chunk queue."""
        completions: list[tuple[Record, np.ndarray]] = []
        run_chunk = self._chunked and bool(self._prefill_queue)
        if self._active.any() or run_chunk:
            B, P = self._slots, self._prompt_len
            self._tick_counter += 1
            tick_t0 = time.perf_counter()
            finishers = None
            with torch.inference_mode():
                chunk = None
                if run_chunk:
                    *ops, packed, finishers = self._pack_chunk()
                    chunk = tuple(self._h2d(a) for a in ops)
                done, n_out = self._tick_block(self._h2d(self._active), chunk)
                # ONE host sync per tick block: done/n_out/pos/gen together.
                packed_h = torch.cat([
                    done.to(torch.int32), n_out, self._pos, self._gen.reshape(-1)
                ]).cpu().numpy()
            done_h = packed_h[:B].astype(bool)
            n_out_h, pos_h = packed_h[B:2 * B], packed_h[2 * B:3 * B]
            gen_h = packed_h[3 * B:].reshape(B, self._max_new)
            self.metrics.tick_time.observe(time.perf_counter() - tick_t0)
            self.metrics.decode_ticks.add(self._ticks_per_sync)
            if run_chunk:
                self.metrics.chunk_ticks.add(1)
                self.metrics.prefill_tokens.add(packed)
                self.metrics.chunk_utilization.set(
                    self.metrics.prefill_tokens.count
                    / (self.metrics.chunk_ticks.count * self._prefill_chunk)
                )
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
                if self._kv_pages is not None:
                    # Unpin the slot's blocks: uncached ones return to the
                    # free list, cached prefix blocks stay alive on the
                    # radix tree's own reference.
                    self._release_slot_blocks(i)
                self._retire_completion(
                    rec, gen_h[i, : n_out_h[i]].copy(), completions
                )
            if done_h.any() and self._kv_pages is not None:
                self._table_dev = self._device_table()
                self.metrics.cache_pool_occupancy.set(self._kv_alloc.occupancy())
            if finishers:
                # AFTER the done bookkeeping above (which must see the
                # pre-activation active set): completed prefills activate
                # for the NEXT tick block.
                self._activate_chunk_finishers(finishers)
            if run_chunk:
                self.metrics.admission_queue_tokens.set(float(sum(
                    len(e.seq) - e.off for e in self._prefill_queue
                )))
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
            # Paged deferred admissions hold their future slots and
            # re-offer first (FIFO); always 0 on the dense pool.
            deferred = self.pending_admissions
            take_cap = max(0, min(free - deferred, budget))
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
            if (take_cap and pending) or (free and deferred and budget):
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
        the commit set (their records re-serve on the new owner).

        With an output topic, output durability is settled FIRST: flush,
        then ``get()`` every send handle since the last commit (a flush
        need not re-raise a record's own failure). A failed flush skips the
        commit and keeps the handles for the next one; a terminally failed
        handle raises ``OutputDeliveryError`` rather than commit past lost
        output. ``commit_latency`` covers the whole path."""
        t0 = time.perf_counter()
        if self._output_producer is not None:
            try:
                self._output_producer.flush()
            except Exception:  # noqa: BLE001 - any flush failure fails closed
                self.metrics.output_flush_failures.add(1)
                _logger.exception(
                    "output flush failed; SKIPPING offset commit so the "
                    "affected prompts re-deliver and regenerate"
                )
                return False
            pending, self._pending_outputs = self._pending_outputs, []
            for handle in pending:
                try:
                    handle.get(30.0)
                except Exception as exc:
                    self.metrics.output_flush_failures.add(1)
                    raise OutputDeliveryError(
                        "an output record terminally failed delivery; "
                        "refusing to commit source offsets past lost "
                        "output (restart re-delivers and regenerates)"
                    ) from exc
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
