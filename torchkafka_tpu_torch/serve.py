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

MoE configs serve on both dense pools, plain or ``quantize_params`` int8
(the router stays in its dtype): the prefill routes through the config's
dispatch (a capacity config drops there, as in JAX), every decode tick
routes exactly (dense dispatch). Paged pools refuse MoE configs with the
JAX package's ``ValueError`` (``kvcache/backend.py``).

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

Sampling (``temperature`` > 0, ``top_k``, ``top_p``, ``rng``): each
admitted record derives a key from ``rng`` and its identity
(``_record_key_data``: ``fold_in`` of the topic's crc32, the partition and
the offset), kept per slot on the device; token i of the record draws
with ``fold_in(record_key, i)`` (``_pick_slots``). A record's tokens are
therefore the same in any slot, tick or process, and equal to the JAX
package's for the same logits. ``temperature=0`` is greedy argmax and
does no key work.

Poison prompts (``quarantine=resilience.PoisonQuarantine(...)``): a prompt
that ``decode_prompt`` rejects spends its retry budget in place, then is
dead-lettered with an acknowledged produce before its offset retires
(``metrics.quarantined``); a failed DLQ produce counts in
``metrics.dlq_delivery_failures`` and raises ``OutputDeliveryError``.
Without a quarantine the prompt retires as dropped.

Decode journal (``journal=journal.DecodeJournal(path, cadence)``): each
admitted record's resumable state (identity and payload CRC, sampling
settings, its record key, the tokens emitted so far) is journaled at
admission, every ``cadence`` tokens and at finish, and pruned once a
commit covers it. A new server given a dead one's entries
(``add_resume_hints(DecodeJournal.load(path))``) re-serves a finished
but uncommitted completion straight from the journal, and warm-resumes a
partial one: one prefill of ``prompt + emitted[:-1]`` into the slot's
rows (a chunk-queue suffix on the paged pool), then decoding from the
journaled position with the same record key, so at most one cadence of
tokens is decoded again. Partial hints need the compute-dtype pool; an
int8 pool replays them cold, as in the JAX package (``_take_hint``).

Exactly-once output (``exactly_once=True`` with a
``source.producer.TransactionalProducer`` as ``output_producer``): each
completion, and each DLQ copy of the quarantine (rebound onto
``_TxnOutboxProducer``), is staged in an outbox keyed by record identity;
every commit is one broker transaction that produces the staged records
whose offsets the ledger snapshot covers and commits those offsets with
them (``_commit_txn``). A read_committed consumer of the output topic
sees each completion once; a successor built with the same transactional
id fences this server and aborts its open transaction.

Record tracing (``tracer=obs.RecordTracer(...)``, ``trace_replica``): the
server emits each record's lifecycle events where the JAX server does
(polled, deferred, prefill_queued, chunk_scheduled, warm_resumed,
slot_active, journal_served, tokens, finished, quarantined, dropped,
dlq_failed, and ``note_commit`` after every successful commit), so a trace
of the same run equals the JAX package's event for event. The host loop's
phases open ``utils.tracing`` spans (admit, chunk_pack, tick, sync,
commit) on a ``torch.profiler`` timeline. ``metrics.render_prometheus()``
is the JAX package's exposition.

Per-record output budgets (``max_new_of(record) -> n | None``): after the
tick block's one host sync, a slot whose token count reaches
``max(1, min(n, max_new))`` is finished at exactly that count, like a
device ``done`` (``metrics.output_capped`` counts the slots the device had
not finished). The tick itself never changes.

Host-RAM KV tier (``kv_tier=kvcache.TierConfig(...)`` or its dict, with
``kv_pages``): the radix cache demotes an evicted block's payload to a
bounded host store (``kvcache.HostTier``, optional disk spill) instead of
freeing it, and a match that walks past the blocks in HBM promotes stored
payloads back into fresh blocks (``_tier_read_block``/
``_tier_write_block``: one host copy per pool at one block index). Bytes
round-trip exactly, so a promotion is the re-prefill it replaces.

Distill publisher (``distill_topic=``, ``distill_producer=``): each
completion is framed for the draft-distillation corpus
(``distill.wire.encode_completion``: prompt ids, tokens, tenant key,
model version) and staged by record identity; the frame is produced only
with the commit that covers its offset — inside the commit window's
transaction under ``exactly_once``, after the offset commit succeeds
otherwise (frames of revoked partitions pruned) — so the corpus holds
committed tokens only (``metrics.distill_published``).

Fleet surface (``fleet.ServingFleet`` drives it): ``note_partitions_revoked``
after a rebalance, ``swap_params`` (the rolling hot-swap's in-place weight
rebind) and the canary's ``spawn_shadow``/``shadow_decode``.

Disaggregated prefill (``prefill_role=True``; ``fleet/prefill.py`` owns
the transfer plane): a prefill worker runs the chunked prefill, draws token
0 in the chunk tick, and cuts each finished slot into a ``PrefillHandoff``
(record identity, payload CRC, sampling contract, record key, token 0 and
the prompt blocks of every pool, copied to the host) instead of decoding
it; the record retires in the worker's ledger only at
``note_handoff_published``. A decode server given handoffs
(``add_prefill_handoffs``) adopts one at admission: the payload is copied
into the slot's fresh blocks (radix-matched blocks already hold the same
bytes) and the slot resumes as after one emitted token, with no prompt
pass; a handoff that fails its checks counts ``resume_rejected`` and the
record prefills locally.

Sharded serving (``mesh=``, a ``parallel.make_mesh`` mesh over data,
fsdp, tp, ep and pp): the ranks of the mesh each build this server with the
same arguments and run the same host loop on the same records
(``parallel.lockstep``). The root (every coordinate 0) takes the consumer
and alone commits offsets, sends outputs, writes the journal,
dead-letters and publishes distill frames; the other ranks pass
``consumer=None`` (their producers, journal, quarantine and distill
arguments are not used), and the root's polls are broadcast to them. The
weights are laid out by ``models.generate.serving_shardings`` (a whole
tree on every rank, or ``shard_params``' ``DTensor``s) and the pools by
its placement records: a dense pool splits its slots over data (each data
rank computes its slots; after each tick block the done mask, counts,
positions and outputs are all-gathered over data so every host loop sees
the whole pool) and its kv heads over tp; a paged pool splits kv heads
over tp with the blocks, tables and per-slot state replicated over data
(the paged program runs alike on every data rank). Under pp every pool
holds the stage's layers only (layer-sharded storage): each sweep runs
the stages in turn, the residual handed on between them, and the last
stage's rows are broadcast before the head (``ServingShard.stages``), so
every rank picks the same tokens; a handoff's payload is gathered over
pp and tp and adoption takes the rank's part back. K1 runs on each
rank's rows, heads and layers, K4/K5 on its local pool
(``ops.kvattn.*_sharded``). A tick block under a mesh whose tick runs
collectives (tp, fsdp, ep or pp over 1; gloo stages through host memory
and cannot be captured) runs eagerly, by rule, and ``decode_roofline``
raises there. At f32 the
compute-dtype pools are token-exact against single-process serving; an
int8 pool under tp can part from it where a layer's k/v lands on an int8
rounding edge (the split sums round apart in the last bit).
"""

from __future__ import annotations

import dataclasses
import logging
import time
import zlib
from typing import Callable, Iterator

import numpy as np
import torch

from torchkafka_tpu_torch.commit.ledger import OffsetLedger
from torchkafka_tpu_torch.errors import (
    BrokerUnavailableError,
    CommitFailedError,
    ConsumerClosedError,
    OutputDeliveryError,
    ProducerFencedError,
)
from torchkafka_tpu_torch.journal import DecodeJournal, JournalEntry, value_crc
from torchkafka_tpu_torch.kvcache.backend import KVBackend, resolve_kv_backend
from torchkafka_tpu_torch.kvcache.blocks import (
    SINK_BLOCK,
    BlockAllocator,
    PagedKVConfig,
)
from torchkafka_tpu_torch.kvcache.radix import RadixCache
from torchkafka_tpu_torch.kvcache.tier import HostTier, TierConfig
from torchkafka_tpu_torch.models.generate import (
    ServingShard,
    _attend_cached,
    _attn_tail,
    _project_qkv,
    check_sampling_params,
    kv_kmajor_scale_sharding,
    kv_kmajor_sharding,
    kv_scale_sharding,
    kv_sharding,
    paged_pool_kmajor_sharding,
    paged_pool_sharding,
    paged_scale_kmajor_sharding,
    prefill_capture,
    prefill_model,
    sample_logits,
    staged,
)
from torchkafka_tpu_torch.models.quant import (
    QTensor,
    embed_rows,
    quant_kv_groups,
    quantized_nbytes,
)
from torchkafka_tpu_torch.models.transformer import (
    TransformerConfig,
    _rms_norm,
    _rope,
    matmul_f32,
    unstack_layers,
)
from torchkafka_tpu_torch.obs.trace import _default_tenant
from torchkafka_tpu_torch.ops.kvattn import (
    block_table_attention,
    block_table_attention_q8,
    int8_decode_attention_dynlen,
    int8_decode_attention_dynlen_sharded,
    int8_paged_decode_attention,
    int8_paged_decode_attention_sharded,
    paged_write_q8,
)
from torchkafka_tpu_torch.parallel.lockstep import MeshConsumer, agree
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.checkpoint_wire import _dtype_name, _host_leaf
from torchkafka_tpu_torch.source.producer import RecordMetadata, _ResolvedSend
from torchkafka_tpu_torch.source.records import Record, TopicPartition
from torchkafka_tpu_torch.utils import prng, tracing
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.metrics import (
    Gauge,
    LatencyHistogram,
    RateMeter,
    format_labels,
    render_exposition,
)

_logger = logging.getLogger(__name__)

# The card's device memory rate: decode is bandwidth-bound, so this is the
# denominator of the port's serving rooflines (``decode_roofline``, harness
# scenario 5), in place of the JAX package's ``V5E_PEAK_HBM_GBS``. The
# rate is the H100 SXM's (80 GB HBM3) data-sheet figure, the one
# ``chip_smoke.py`` bounds its kernels with.
H100_PEAK_HBM_GBS = 3350.0
PEAK_HBM_CARD = "NVIDIA H100 SXM 80GB (HBM3)"
# The same card's dense bf16 tensor-core peak: harness scenario 4's conv
# MFU denominator (the JAX package divides by the v5e's 197e12).
H100_PEAK_BF16_FLOPS = 989e12


def decode_tick_bytes(params, cfg: TransformerConfig, batch: int,
                      max_len: int, kv_int8: bool = False) -> tuple[int, int]:
    """(weight_bytes, kv_bytes) read from device memory per decode tick:
    the JAX package's accounting. Weights: every layer tensor and the
    lm_head in full, but the embedding as one row a slot (a gather). KV:
    both halves across all layers at the STATIC pool length ``max_len``;
    ``kv_int8`` counts the int8 pool as ``head_dim + 4`` bytes a (layer,
    slot, position, head) group (payload plus its f32 scale)."""
    total = quantized_nbytes(params)
    embed = quantized_nbytes(params["embed"])
    embed_rows_read = batch * (embed // max(cfg.vocab_size, 1))
    groups = 2 * cfg.n_layers * batch * max_len * cfg.n_kv_heads
    if kv_int8:
        kv = groups * (cfg.head_dim + 4)
    else:
        kv = groups * cfg.head_dim * torch.empty((), dtype=cfg.dtype).element_size()
    return total - embed + embed_rows_read, kv


def _sharding_label(kb: dict) -> str:
    """The ``kv_backend_info`` sharding label: the JAX package's
    ``data=D,tp=T``, with ``,pp=P`` on a layer-sharded mesh."""
    label = f"data={kb.get('data', 1)},tp={kb.get('tp', 1)}"
    return label + (f",pp={kb['pp']}" if kb.get("pp", 1) > 1 else "")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that shares no memory with it (numpy has
    no bfloat16: a bf16 tensor travels as its int16 bit patterns)."""
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _pick_slots(logits, key_data, idx, *, temperature, top_k, top_p):
    """Per-slot sampling with per-(record, token-index) keys. ``logits``
    [B, V]; ``key_data`` [B, 2]: each row its slot's RECORD key
    (``StreamingGenerator._record_key_data``); ``idx`` [B] int32: the
    output index of the token being drawn. Row b draws with
    ``fold_in(record_key_b, idx_b)``, so a record's token i is the same
    draw in any slot, tick or process. Greedy (temperature 0) ignores the
    keys."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    keys = prng.fold_in(key_data, idx)
    return sample_logits(
        logits, keys, temperature=temperature, top_k=top_k, top_p=top_p
    )


def _rng_words(rng) -> tuple[int, int]:
    """The base key's two 32-bit words from ``rng``: None (``prng.key(0)``),
    a [2] uint32 numpy array of raw key data, or a ``prng.key`` tensor."""
    if rng is None:
        return (0, 0)
    if isinstance(rng, np.ndarray) and rng.dtype == np.uint32 and rng.shape == (2,):
        return int(rng[0]), int(rng[1])
    if (isinstance(rng, torch.Tensor) and rng.shape == (2,)
            and rng.dtype == torch.int64):
        return tuple(int(w) & 0xFFFFFFFF for w in rng.tolist())
    raise TypeError(
        "rng must be None, a [2] uint32 numpy array of key data or a "
        f"prng.key tensor, got {type(rng).__name__}"
    )


def _slot_layer_step(x, layer, cache_k, cache_v, pos, rows, cfg, shard=None):
    """One decode token through one layer with a different position per
    slot, over the compute-dtype pool. x: [B, 1, D]; caches [B, M, K, Dh]
    (one layer's views, written in place); pos: [B] int32. ``shard``: the
    rank's ``ServingShard`` (its slots, heads and layer shards)."""
    q, k, v = _project_qkv(x, layer, cfg)
    q = _rope(q, pos[:, None], cfg.rope_theta)
    k = _rope(k, pos[:, None], cfg.rope_theta)
    p = pos.long()
    cache_k.index_put_((rows, p), k[:, 0].to(cache_k.dtype))
    cache_v.index_put_((rows, p), v[:, 0].to(cache_v.dtype))
    m = torch.arange(cache_k.shape[1], device=x.device)
    valid = m[None, :] <= pos[:, None]  # [B, M]
    return _attend_cached(x, q, cache_k, cache_v, valid, layer, cfg, shard=shard)


def _slot_layer_step_q(x, layer, ck_q, ck_s, cv_q, cv_s, pos, rows, cfg, kernel,
                       shard=None):
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
        if shard is None:
            attn = int8_decode_attention_dynlen(q, ck_q, ck_s, cv_q, cv_s, pos)
        else:
            attn = int8_decode_attention_dynlen_sharded(q, ck_q, ck_s, cv_q, cv_s,
                                                        pos, shard)
        return _attn_tail(x, attn, layer, cfg, shard)
    valid = torch.arange(ck_q.shape[1], device=x.device)[None, :] <= pos[:, None]
    return _attend_cached(x, q, ck_q, cv_q, valid, layer, cfg,
                          k_scale=ck_s, v_scale=cv_s, shard=shard)


def _paged_sweep(x, positions, tables, layers, pools, cfg, *, kernel=False,
                 pos_b=None, shard=None):
    """All layers' write-then-attend over a paged pool for a batch of query
    rows. x: [R, S, D]; positions: [R, S]; tables: [R, nblk] PER-ROW block
    tables (decode rows carry the slot table, chunk rows their own freshly
    linked rows), so one call serves any mix. ``layers``: one model's
    layer views; ``pools``: that model's pools, [L, NB, ...] each (two in
    the compute dtype, or the int8 pool's four). ``kernel``: S=1 rows read
    through the block-table kernel at watermarks ``pos_b`` (int8 pool
    only). ``shard``: the rank's ``ServingShard`` (the pools hold its kv
    heads of its stage's layers; the stages run in turn, ``staged``)."""
    int8 = pools[0].dtype == torch.int8

    def body(x):
        for i, layer in enumerate(layers):
            q, k, v = _project_qkv(x, layer, cfg)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            pl = [p[i] for p in pools]
            if kernel:
                paged_write_q8(*pl, tables, positions, k, v)
                if shard is None:
                    attn = int8_paged_decode_attention(q, *pl, tables, pos_b)
                else:
                    attn = int8_paged_decode_attention_sharded(q, *pl, tables, pos_b,
                                                               shard)
                x = _attn_tail(x, attn, layer, cfg, shard)
            elif int8:
                x = block_table_attention_q8(x, q, k, v, *pl, tables, positions, layer,
                                             cfg, shard)
            else:
                x = block_table_attention(x, q, k, v, *pl, tables, positions, layer,
                                          cfg, shard)
        return x

    return staged(shard, x, body)


class ServeMetrics:
    """Observability for the serving loop: the JAX package's
    ``ServeMetrics`` (same counters, ``summary()`` keys and Prometheus
    families), plus the port's ``decoded_tokens``, ``prefills`` and
    ``decode_ticks`` summary keys. The disaggregation counters move on a
    ``prefill_role`` server and on a decode server adopting its handoffs
    (``fleet/prefill.py``); ``distill_published`` counts the distill
    publisher's frames, and the trainer's counters move in the distill
    worker (``distill/worker.py``)."""

    def __init__(self) -> None:
        self.completions = RateMeter()
        self.tokens = RateMeter()
        self.truncated = RateMeter()  # stopped by EOS before max_new
        self.readmissions = RateMeter()  # slots refilled MID-STREAM (while
        # other generations were in flight) — continuous batching's defining
        # behavior; 0 in lockstep-equivalent runs
        self.dropped = RateMeter()  # undecodable prompts retired
        self.quarantined = RateMeter()  # poison prompts dead-lettered
        self.commit_failures = RateMeter()
        self.output_flush_failures = RateMeter()  # output topic not durable
        self.output_send_failures = RateMeter()  # sync send refusals (stall)
        self.dlq_delivery_failures = RateMeter()  # quarantine DLQ produces
        # that FAILED (the serve path fail-stops on them, but the count
        # outlives the crash on /metrics — a broken DLQ must page, not
        # only kill)
        # Exactly-once output (exactly_once=True): one transaction per
        # commit window. All zero in at-least-once mode.
        self.txn_commits = RateMeter()  # transactions committed (records
        # + offsets atomic)
        self.txn_aborts = RateMeter()  # transactions aborted (survivable
        # commit failure, send fault, or defensive abort)
        self.txn_held_outputs = Gauge()  # outbox entries a commit could
        # NOT yet publish: finished out of completion order, their
        # offsets above the in-order watermark — published by a later
        # window the moment the watermark passes them
        self.commit_latency = LatencyHistogram()  # full commit path: output
        # flush + durability waits + offset commit (see _commit docstring)
        self.slot_occupancy = Gauge()  # active slots / pool size, last tick
        # Per-tick serving step time (host-observed: chunk pack + device
        # dispatch + sync) and tokens surfaced per tick block — the
        # device-side "where did the tick go" companion to the obs
        # layer's host-side record spans.
        self.tick_time = LatencyHistogram()
        self.tokens_per_tick = Gauge()
        self.prefills = RateMeter()  # dense admission prefill passes
        self.decode_ticks = RateMeter()  # decode ticks run (all layers each)
        self.output_capped = RateMeter()  # slots force-finished by a
        # per-record output budget (max_new_of) at sync granularity
        # Paged prefix cache (kv_pages=, torchkafka_tpu/kvcache): all zero
        # on the dense path.
        self.prefix_hits = RateMeter()  # admissions that reused cached blocks
        self.prefix_misses = RateMeter()  # admissions that prefilled in full
        self.prefix_tokens_saved = RateMeter()  # prompt tokens NOT re-prefilled
        self.prefill_tokens = RateMeter()  # prompt tokens actually prefilled
        self.cache_evictions = RateMeter()  # cached blocks LRU-evicted
        self.admission_deferrals = RateMeter()  # admissions deferred on pool
        # pressure (records re-offered FIFO once blocks free)
        self.cache_fallbacks = RateMeter()  # paged → dense cache-off fallbacks
        self.cache_pool_occupancy = Gauge()  # allocated / usable blocks
        # Tiered radix cache (kv_tier=, kvcache/tier.py): cold prefix
        # blocks demoted to host RAM instead of freed, promoted back on
        # radix hit. All zero without a tier.
        self.radix_demotions = RateMeter()  # blocks demoted HBM → host tier
        self.radix_promotions = RateMeter()  # blocks promoted tier → HBM
        self.tier_hits = RateMeter()  # prefix walks extended by the tier
        self.tier_occupancy_bytes = Gauge()  # host-RAM tier payload bytes
        # Disaggregated prefill (fleet/prefill.py): records held for a
        # prefill-worker handoff and slots admitted by adopting one
        # (decode never ran the prompt pass). All zero in monolithic
        # serving.
        self.prefill_routed = RateMeter()  # records first held awaiting a
        # handoff (the admission-queue routing decision)
        self.adopted_slots = RateMeter()  # slots filled by handoff adoption
        self.handoffs_published = RateMeter()  # prefill-role only: filled-KV
        # handoffs published onto the transfer plane
        # Online draft distillation (torchkafka_tpu/distill): the serve →
        # distill-topic → trainer → checkpoint-topic → swap loop. All
        # zero without a distill topic / spec serving.
        self.distill_published = RateMeter()  # committed completions
        # framed onto the distill topic (txn: counted at commit)
        self.distill_steps = RateMeter()  # trainer train steps (trainer
        # role only)
        self.distill_records = RateMeter()  # corpus records consumed into
        # train batches (trainer role only)
        self.spec_alpha_window = Gauge()  # windowed live acceptance α the
        # DistillController gates refreshes on (NaN-free: 0 until the
        # first window closes)
        self.draft_version = Gauge()  # draft checkpoint version currently
        # proposing (0 = the built-in / construction-time draft)
        self._draft_refreshes: dict[str, RateMeter] = {}  # draft
        # hot-swaps by reason ("alpha_drop", "forced", ...)
        # Chunked prefill (kv_pages with prefill_chunk != 0): admission
        # enqueues uncached suffixes and every tick carries a bounded
        # chunk of them alongside decode. All zero in legacy/dense modes.
        self.chunk_ticks = RateMeter()  # ticks that carried prefill chunk rows
        self.admission_stall_ticks = RateMeter()  # EXTRA ticks admissions
        # queued beyond the one-tick minimum (0 when every admission's
        # suffix fits the chunk a single tick carries — the prompt-storm
        # regression bound)
        self.admission_queue_tokens = Gauge()  # uncached suffix tokens still
        # queued for chunk prefill, sampled after each tick
        self.chunk_utilization = Gauge()  # cumulative prefill tokens /
        # (chunk ticks x chunk width): how full the static chunk rides
        # Decode journal / warm failover (torchkafka_tpu/journal): all zero
        # without a journal or resume hints.
        self.decoded_tokens = RateMeter()  # tokens produced by decode ticks
        # (prefilled/journal-restored tokens excluded — the cold-vs-warm
        # replay differential reads exactly this)
        self.warm_resumes = RateMeter()  # redelivered prompts resumed from
        # a journal hint (prompt + emitted tokens prefilled in one dispatch)
        self.journal_tokens_restored = RateMeter()  # emitted tokens NOT
        # re-decoded thanks to warm resume
        self.journal_served = RateMeter()  # finished-but-uncommitted
        # completions re-served straight from the journal (zero re-decode)
        self.resume_rejected = RateMeter()  # hints discarded (payload CRC /
        # sampling-contract mismatch, or an unsupported pool mode)
        # Per-tenant prefix-cache counters (lazy label children, tenant =
        # record key): the "cache hit by tenant locality" observable the
        # traffic bench reads. Empty on the dense path.
        self._tenant_prefix_hits: dict[str, RateMeter] = {}
        self._tenant_prefix_misses: dict[str, RateMeter] = {}
        # The resolved KV backend (kvcache.resolve_kv_backend): which
        # pool layout/dtype actually serves, whether the Pallas read
        # engaged, and — when it did not — the machine-readable reason,
        # so the kv_kernel="auto" threshold decision is observable on
        # /metrics instead of silent.
        self.kernel_engaged = Gauge()
        self._kernel_disabled: dict[str, RateMeter] = {}
        self._kv_backend: dict = {}

    def note_backend(self, backend: "KVBackend") -> None:
        """Record the resolved backend (called once per build; a paged
        pool that falls back to dense re-notes the dense resolution)."""
        self._kv_backend = backend.describe()
        self.kernel_engaged.set(1.0 if backend.kernel else 0.0)
        reason = backend.kernel_disabled_reason
        if reason is not None:
            self._kernel_disabled.setdefault(reason, RateMeter()).add(1)

    def kernel_disabled_summary(self) -> dict:
        return {r: m.count for r, m in sorted(self._kernel_disabled.items())}

    def tenant_prefix_hits(self, tenant: str) -> RateMeter:
        return self._tenant_prefix_hits.setdefault(tenant, RateMeter())

    def draft_refreshes(self, reason: str) -> RateMeter:
        return self._draft_refreshes.setdefault(reason, RateMeter())

    def distill_summary(self) -> dict:
        return {
            "published": self.distill_published.count,
            "steps": self.distill_steps.count,
            "records": self.distill_records.count,
            "alpha_window": round(self.spec_alpha_window.value, 4),
            "draft_version": int(self.draft_version.value),
            "refreshes": {
                r: m.count for r, m in sorted(self._draft_refreshes.items())
            },
        }

    def tenant_prefix_misses(self, tenant: str) -> RateMeter:
        return self._tenant_prefix_misses.setdefault(tenant, RateMeter())

    def tenant_cache_summary(self) -> dict:
        out = {}
        for t in sorted(
            set(self._tenant_prefix_hits) | set(self._tenant_prefix_misses)
        ):
            hits = self.tenant_prefix_hits(t).count
            misses = self.tenant_prefix_misses(t).count
            out[t] = {
                "hits": hits,
                "misses": misses,
                "hit_rate": (
                    round(hits / (hits + misses), 4)
                    if hits + misses else None
                ),
            }
        return out

    def reset(self) -> None:
        """Zero the rate clocks — called at run() start so compile/warmup
        time (minutes on remote-compile transports) doesn't dilute rates."""
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
            "quarantined": self.quarantined.count,
            "commit_failures": self.commit_failures.count,
            "output_flush_failures": self.output_flush_failures.count,
            "output_send_failures": self.output_send_failures.count,
            "dlq_delivery_failures": self.dlq_delivery_failures.count,
            "txn": {
                "commits": self.txn_commits.count,
                "aborts": self.txn_aborts.count,
                "held_outputs": int(self.txn_held_outputs.value),
            },
            "commit": self.commit_latency.summary(),
            "slot_occupancy": round(self.slot_occupancy.value, 3),
            "ticks": self.tick_time.count,
            "step_time": self.tick_time.summary(),
            "tokens_per_tick": round(self.tokens_per_tick.value, 2),
            "decoded_tokens": self.decoded_tokens.count,
            "prefills": self.prefills.count,
            "decode_ticks": self.decode_ticks.count,
            "output_capped": self.output_capped.count,
            "prefix_cache": self.cache_summary(),
            "tenant_cache": self.tenant_cache_summary(),
            "disagg": self.disagg_summary(),
            "distill": self.distill_summary(),
            "chunked_prefill": self.chunk_summary(),
            "journal": self.journal_summary(),
            "kv_backend": {
                **self._kv_backend,
                "kernel_engaged": int(self.kernel_engaged.value),
                "kernel_disabled": self.kernel_disabled_summary(),
            },
        }

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

    def journal_summary(self) -> dict:
        return {
            "decoded_tokens": self.decoded_tokens.count,
            "warm_resumes": self.warm_resumes.count,
            "tokens_restored": self.journal_tokens_restored.count,
            "served_from_journal": self.journal_served.count,
            "resume_rejected": self.resume_rejected.count,
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
            "tier": {
                "demotions": self.radix_demotions.count,
                "promotions": self.radix_promotions.count,
                "hits": self.tier_hits.count,
                "occupancy_bytes": int(self.tier_occupancy_bytes.value),
            },
        }

    def disagg_summary(self) -> dict:
        return {
            "prefill_routed": self.prefill_routed.count,
            "adopted_slots": self.adopted_slots.count,
            "handoffs_published": self.handoffs_published.count,
        }

    def render_prometheus(self, prefix: str = "torchkafka_serve") -> str:
        """Prometheus text exposition — same conventions (and shared
        renderer) as StreamMetrics.render_prometheus."""
        s = self.summary()
        pc = s["prefix_cache"]
        jn = s["journal"]
        cp = s["chunked_prefill"]
        kb = s["kv_backend"]
        return render_exposition(prefix, [
            # The resolved KV backend as an info-style gauge (value 1,
            # identity in the labels) plus the kernel engagement pair —
            # the "which pool actually serves, and why not the kernel"
            # observables.
            ("kv_backend_info", "gauge", [
                (format_labels(
                    layout=str(kb.get("layout", "dense")),
                    kv_dtype=str(kb.get("kv_dtype", "compute")),
                    sharding=_sharding_label(kb),
                ), 1),
            ]),
            ("kv_kernel_engaged", "gauge", kb["kernel_engaged"]),
            ("kv_kernel_disabled_total", "counter", [
                (format_labels(reason=r), v)
                for r, v in kb["kernel_disabled"].items()
            ] or 0),
            ("chunk_ticks_total", "counter", cp["chunk_ticks"]),
            ("admission_stall_ticks_total", "counter", cp["stall_ticks"]),
            ("admission_queue_tokens", "gauge", cp["queue_tokens"]),
            ("chunk_utilization", "gauge", cp["utilization"]),
            ("prefill_tokens_per_chunk_tick", "gauge",
             cp["prefill_tokens_per_tick"] or 0.0),
            ("decoded_tokens_total", "counter", jn["decoded_tokens"]),
            ("warm_resumes_total", "counter", jn["warm_resumes"]),
            ("journal_tokens_restored_total", "counter", jn["tokens_restored"]),
            ("journal_served_total", "counter", jn["served_from_journal"]),
            ("resume_rejected_total", "counter", jn["resume_rejected"]),
            ("completions_total", "counter", s["completions"]),
            ("tokens_total", "counter", s["tokens"]),
            ("truncated_by_eos_total", "counter", s["truncated_by_eos"]),
            ("slot_readmissions_total", "counter", s["readmissions"]),
            ("dropped_prompts_total", "counter", s["dropped"]),
            ("quarantined_prompts_total", "counter", s["quarantined"]),
            ("commit_failures_total", "counter", s["commit_failures"]),
            ("output_flush_failures_total", "counter", s["output_flush_failures"]),
            ("output_send_failures_total", "counter", s["output_send_failures"]),
            ("dlq_delivery_failures_total", "counter", s["dlq_delivery_failures"]),
            ("txn_commits_total", "counter", s["txn"]["commits"]),
            ("txn_aborts_total", "counter", s["txn"]["aborts"]),
            ("txn_held_outputs", "gauge", s["txn"]["held_outputs"]),
            ("commit_latency_p50_milliseconds", "gauge", s["commit"]["p50_ms"]),
            ("commit_latency_p99_milliseconds", "gauge", s["commit"]["p99_ms"]),
            ("completions_per_second", "gauge", s["completions_per_s"]),
            ("tokens_per_second", "gauge", s["tokens_per_s"]),
            ("slot_occupancy", "gauge", s["slot_occupancy"]),
            ("serve_ticks_total", "counter", s["ticks"]),
            ("step_time_ms", "gauge", [
                ('percentile="p50"', s["step_time"]["p50_ms"]),
                ('percentile="p99"', s["step_time"]["p99_ms"]),
            ]),
            ("tokens_per_tick", "gauge", s["tokens_per_tick"]),
            ("output_capped_total", "counter", s["output_capped"]),
            ("tenant_prefix_cache_hits_total", "counter", [
                (format_labels(tenant=t), v["hits"])
                for t, v in s["tenant_cache"].items()
            ] or 0),
            ("tenant_prefix_cache_misses_total", "counter", [
                (format_labels(tenant=t), v["misses"])
                for t, v in s["tenant_cache"].items()
            ] or 0),
            ("prefix_cache_hits_total", "counter", pc["hits"]),
            ("prefix_cache_misses_total", "counter", pc["misses"]),
            ("prefix_tokens_saved_total", "counter", pc["prefix_tokens_saved"]),
            ("prefill_tokens_total", "counter", pc["prefill_tokens"]),
            ("kvcache_evictions_total", "counter", pc["evictions"]),
            ("admission_deferrals_total", "counter", pc["deferrals"]),
            ("kvcache_fallbacks_total", "counter", pc["fallbacks"]),
            ("prefix_cache_hit_rate", "gauge", pc["hit_rate"] or 0.0),
            ("kvcache_pool_occupancy", "gauge", pc["pool_occupancy"]),
            ("radix_demotions_total", "counter", pc["tier"]["demotions"]),
            ("radix_promotions_total", "counter", pc["tier"]["promotions"]),
            ("tier_hits_total", "counter", pc["tier"]["hits"]),
            ("tier_occupancy_bytes", "gauge", pc["tier"]["occupancy_bytes"]),
            ("prefill_routed_total", "counter", s["disagg"]["prefill_routed"]),
            ("adopted_slots_total", "counter", s["disagg"]["adopted_slots"]),
            ("prefill_handoffs_published_total", "counter",
             s["disagg"]["handoffs_published"]),
            ("distill_published_total", "counter",
             s["distill"]["published"]),
            ("distill_steps_total", "counter", s["distill"]["steps"]),
            ("distill_records_total", "counter", s["distill"]["records"]),
            ("spec_alpha_window", "gauge", s["distill"]["alpha_window"]),
            ("draft_version", "gauge", s["distill"]["draft_version"]),
            ("draft_refreshes_total", "counter", [
                (format_labels(reason=r), v)
                for r, v in s["distill"]["refreshes"].items()
            ] or 0),
        ])


class _PendingPrefill:
    """One admission's queued chunk-prefill work (paged chunked mode).

    The slot and its blocks are already reserved (table linked, radix
    inserted); ``seq`` is the UNCACHED suffix still to be written —
    ``seq[off:]`` remains — with ``seq[0]`` at logical position
    ``start``. ``resume`` carries a warm resume's emitted tokens (the
    activation restores them instead of sampling token 0), None for a cold
    admission. ``enq_tick`` is the tick counter at admission."""

    __slots__ = ("slot", "rec", "seq", "off", "start", "resume", "enq_tick")

    def __init__(self, slot, rec, seq, start, resume, enq_tick):
        self.slot = slot
        self.rec = rec
        self.seq = seq
        self.off = 0
        self.start = start
        self.resume = resume
        self.enq_tick = enq_tick


@dataclasses.dataclass
class PrefillHandoff:
    """One prompt's filled KV, from a prefill worker to a decode replica
    (disaggregated prefill).

    A prefill worker (``prefill_role=True``) fills a slot's prompt blocks
    through the chunked prefill, draws token 0 with the record's key, and
    cuts this unit: record identity and payload CRC (a handoff never adopts
    onto another record), the sampling contract, the record key, token 0,
    and the ``prompt_blocks`` blocks covering positions [0, prompt_len)
    of every pool. ``fleet/prefill.py`` owns its wire encoding. A decode
    replica adopts it: the payloads go into fresh blocks and the slot
    resumes as after one emitted token, with no prompt pass.

    ``pools``: one host array per pool tensor, sliced to the prompt's
    blocks on axis 1 — 2 on compute-dtype pools, 4 (payload and scale,
    k and v) on int8 pools; a bf16 pool's arrays are CPU bf16 tensors."""

    topic: str
    partition: int
    offset: int
    crc: int
    key_data: tuple
    temperature: float
    top_k: int | None
    top_p: float | None
    token0: int
    prompt_blocks: int
    pools: tuple

    @property
    def key(self) -> tuple[str, int, int]:
        return (self.topic, self.partition, self.offset)

    def payload_bytes(self) -> int:
        return sum(
            a.numel() * a.element_size() if isinstance(a, torch.Tensor)
            else a.nbytes
            for a in self.pools
        )


class _ShadowConsumer:
    """The canary shadow server's consumer-shaped null object: never a
    group member, never polls, owns no partitions, so the shadow's commit
    path is a no-op (an empty assignment drops every ledger partition from
    the snapshot) and nothing a shadow decodes can reach a broker. See
    ``StreamingGenerator.spawn_shadow``."""

    def poll(self, max_records: int = 1, timeout_ms: int = 0) -> list:
        return []

    def assignment(self):
        return frozenset()

    def commit(self, offsets) -> None:
        pass

    def heartbeat(self) -> None:
        pass

    def close(self) -> None:
        pass


class _TxnOutboxProducer:
    """The quarantine's producer in exactly-once mode: a dead-letter
    produce is STAGED in the server's outbox, keyed by the poison record's
    identity (from the ``dlq.*`` provenance headers the quarantine always
    writes), and produced inside the commit window's transaction, atomic
    with the offset that retires the record. The handle resolves at once:
    durability is the transaction commit, which gates every offset."""

    def __init__(self, server: "StreamingGenerator") -> None:
        self._server = server

    def send(self, topic, value, *, key=None, partition=None,
             timestamp_ms=None, headers=()):
        h = dict(headers)
        ident = (
            h["dlq.topic"].decode(),
            int(h["dlq.partition"]),
            int(h["dlq.offset"]),
        )
        self._server._txn_outbox[ident] = dict(
            topic=topic, value=value, key=key, headers=tuple(headers),
        )
        return _ResolvedSend(RecordMetadata(topic, -1, -1))

    def flush(self, timeout_s=None) -> None:
        pass  # staged sends settle at transaction commit

    def close(self) -> None:
        pass


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
    ``exactly_once``: the transactional output mode (module docstring);
    needs a transactional ``output_producer`` and, with a quarantine, one
    over that same producer (``ValueError`` otherwise, as in JAX).
    ``distill_topic``/``distill_producer``: the distill publisher (module
    docstring); at-least-once it needs ``distill_producer`` or
    ``output_producer`` (``ValueError`` otherwise, as in JAX).
    ``journal``: a ``journal.DecodeJournal`` this server writes;
    ``add_resume_hints`` feeds it a dead server's entries (module
    docstring).
    ``tracer``: an ``obs.RecordTracer`` given each record's lifecycle
    events, tagged with ``trace_replica`` (module docstring); None costs
    one ``is not None`` test per site. ``max_new_of``: the per-record
    output budget (module docstring). ``kv_tier``: a
    ``kvcache.TierConfig`` (or its dict) for the host-RAM tier under the
    paged pool's radix cache; it requires ``kv_pages`` (``ValueError``
    otherwise, as in JAX).
    ``temperature``: 0 = greedy; > 0 samples each slot from
    ``filter_logits`` under ``top_k``/``top_p`` with per-record keys
    derived from ``rng`` (module docstring). ``quarantine``: a
    ``resilience.PoisonQuarantine`` for prompts ``decode_prompt`` rejects
    (module docstring); None drops them.
    ``device``: where the model and the pool live; None = CUDA, raising
    when there is none (``utils.devices.resolve_device``).
    ``mesh``: sharded serving over a ``parallel.make_mesh`` mesh (module
    docstring): every rank of the mesh builds the server with the same
    arguments, except that only the root (every coordinate 0) passes a
    consumer (or a ``parallel.lockstep.MeshConsumer`` on every rank); the
    side-effect arguments are used on the root only. ``check_serving_mesh``
    validates it with the JAX package's errors; a pp axis raises
    ``NotImplementedError``."""

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
        top_k: int | None = None,
        top_p: float | None = None,
        rng=None,
        quarantine=None,
        kv_dtype: str | None = None,
        kv_kernel: bool | str = "auto",
        kv_pages: PagedKVConfig | dict | None = None,
        kv_tier: TierConfig | dict | None = None,
        output_producer=None,
        output_topic: str | None = None,
        exactly_once: bool = False,
        encode_output: Callable[[Record, np.ndarray], bytes] | None = None,
        max_send_failure_streak: int = 64,
        journal: DecodeJournal | None = None,
        model_version: int = 0,
        tracer=None,
        trace_replica: int | None = None,
        max_new_of: Callable[[Record], int | None] | None = None,
        distill_topic: str | None = None,
        distill_producer=None,
        prefill_role: bool = False,
        mesh=None,
        device=None,
    ) -> None:
        check_sampling_params(top_k, top_p)
        self._shard = None if mesh is None else ServingShard(cfg, mesh, batch=slots)
        if mesh is not None:
            consumer = (consumer if isinstance(consumer, MeshConsumer)
                        else MeshConsumer(consumer, mesh))
            if not consumer.root:
                # Side effects happen once, on the root: this rank's
                # server sends, journals, dead-letters and publishes nothing.
                output_producer = output_topic = distill_producer = None
                distill_topic = journal = quarantine = None
                exactly_once = False
        self._rng_words = _rng_words(rng)
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
        if exactly_once:
            if output_producer is None:
                raise ValueError(
                    "exactly_once requires output_producer/output_topic "
                    "(the transaction is the output path)"
                )
            missing = [
                m for m in ("begin", "send_offsets", "commit", "abort")
                if not callable(getattr(output_producer, m, None))
            ]
            if missing:
                raise ValueError(
                    "exactly_once requires a transactional producer "
                    "(source.producer.TransactionalProducer surface); "
                    f"output_producer lacks {missing}"
                )
            if quarantine is not None and (
                getattr(quarantine, "producer", None) is not output_producer
            ):
                raise ValueError(
                    "exactly_once requires the quarantine to share the "
                    "transactional output producer (its DLQ produce must "
                    "ride the same transaction as the offset that retires "
                    "the poison record); build PoisonQuarantine over the "
                    "same TransactionalProducer instance"
                )
        if distill_topic is not None and not exactly_once:
            if distill_producer is None and output_producer is None:
                raise ValueError(
                    "distill_topic requires a producer (distill_producer "
                    "or output_producer) in at-least-once mode"
                )
        if max_send_failure_streak < 1:
            raise ValueError("max_send_failure_streak must be >= 1")
        if isinstance(kv_pages, dict):
            kv_pages = PagedKVConfig(**kv_pages)
        if isinstance(kv_tier, dict):
            kv_tier = TierConfig(**kv_tier)
        if kv_tier is not None and kv_pages is None:
            raise ValueError("kv_tier requires kv_pages (it tiers the "
                             "paged radix cache)")
        # prefill_role: a disaggregated prefill worker (module docstring).
        # The handoff is cut from the chunked prefill, so it needs chunked
        # pages.
        if prefill_role and (kv_pages is None or kv_pages.prefill_chunk == 0):
            raise ValueError(
                "prefill_role requires kv_pages in chunked mode (the handoff "
                "is cut from the chunked-prefill machinery)"
            )
        self._prefill_role = bool(prefill_role)
        self._prefilled_ready: list[tuple[Record, PrefillHandoff]] = []
        # Decode side: handoffs installed by add_prefill_handoffs, taken at
        # admission.
        self._prefill_handoffs: dict[tuple[str, int, int], PrefillHandoff] = {}
        self._kv_tier_cfg = kv_tier
        self._kv_tier: HostTier | None = None
        self._tier_seen = [0, 0, 0]  # demotions/promotions/hits mirrored
        self._tracer = tracer
        self._trace_replica = trace_replica
        self._max_new_of = max_new_of
        self._device = resolve_device(device)
        self._tick_collectives = self._shard is not None and self._shard.tick_collectives
        self._consumer = consumer
        # The consumer offsets are committed through: the root's own (None
        # on the other ranks of a mesh, whose commits are no-ops).
        self._commit_consumer = (consumer.inner if isinstance(consumer, MeshConsumer)
                                 else consumer)
        self._params = self._place(params)
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
        self._temperature = float(temperature)
        self._top_k = top_k
        self._top_p = top_p
        self._quarantine = quarantine
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
        # Exactly-once: outputs and DLQ copies staged by record identity,
        # produced only inside the commit transaction that covers their
        # offsets (an eager-rebalance re-serve overwrites its own entry);
        # _txn_committed_wm is the high-water of offsets this server's
        # committed transactions cover, below which a staged entry is a
        # duplicate serve and is dropped.
        self._txn_mode = exactly_once
        self._txn_outbox: dict[tuple[str, int, int], dict] = {}
        self._txn_committed_wm: dict = {}
        if exactly_once and quarantine is not None:
            quarantine.rebind_producer(_TxnOutboxProducer(self))
        # Distill frames staged by record identity, produced only with the
        # commit that covers them (in its transaction, or after the offset
        # commit succeeds): the corpus never holds an uncommitted token.
        self._distill_topic = distill_topic
        self._distill_producer = distill_producer
        self._distill_outbox: dict[tuple[str, int, int], bytes] = {}
        if distill_topic is not None:
            from torchkafka_tpu_torch.distill.wire import encode_completion

            self._encode_distill = encode_completion
        else:
            self._encode_distill = None
        # Warm resume: the journal this server writes, the hints it may
        # resume from, finished completions re-served from a journal, and
        # each slot's token count at its last journal write.
        self._journal = journal
        if journal is not None:
            journal.set_model_version(self._model_version)
        self._resume_hints: dict[tuple[str, int, int], JournalEntry] = {}
        self._journal_ready: list[tuple[Record, np.ndarray]] = []
        self._slot_journaled = np.zeros((slots,), np.int64)
        # Validates the whole combination eagerly (the exclusions raise);
        # _build re-resolves if a too-small paged pool falls back to dense.
        self._kv_backend = resolve_kv_backend(
            cfg, kv_dtype=kv_dtype, kv_kernel=kv_kernel, kv_pages=kv_pages,
            max_len=self._max_len, device=self._device, mesh=mesh,
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

    def _place(self, params):
        """``params`` on this server's device: this rank's share under a
        mesh (``ServingShard.local_params``), else the whole tree (leaves
        already there are kept)."""
        if self._shard is not None:
            return self._shard.local_params(params, self._device)
        return _params_to(params, self._device)

    def _local_shape(self, shape: tuple, layout) -> tuple:
        """A pool's shape on this rank: ``shape`` under ``layout(mesh)``
        (the ``models.generate`` placement records) on a mesh, else
        ``shape``. A paged pool's data axis is replicated, so only its kv
        heads split."""
        if self._shard is None:
            return shape
        return layout(self._shard.mesh).local_shape(shape)

    def _build(self) -> None:
        cfg, dev = self._cfg, self._device
        B, M, max_new = self._slots, self._max_len, self._max_new
        nl, kh, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self._model = prefill_model(cfg, None if self._shard is None else self._shard.mesh)
        self._bind_params(self._params)
        paged = self._kv_pages is not None and self._paged_setup()
        if self._kv_pages is None and self._kv_backend.paged:
            if self._prefill_role:
                raise ValueError(
                    "prefill_role cannot fall back to dense serving — size "
                    "kv_pages to hold at least one slot"
                )
            self._kv_backend = resolve_kv_backend(
                cfg, kv_dtype=self._kv_dtype, kv_kernel=self._kv_kernel_opt,
                max_len=M, device=dev,
                mesh=None if self._shard is None else self._shard.mesh,
            )
        # This rank's slots: a dense pool splits them over data (the first
        # ``_slot_lo`` .. + ``_local_slots``); the paged program holds all.
        if self._shard is not None and not paged:
            self._slot_lo, bl = self._shard.row_range(B)
        else:
            self._slot_lo, bl = 0, B
        self._local_slots = bl
        self._rows = torch.arange(bl, device=dev)
        self._last_tok = torch.zeros((bl,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((bl,), dtype=torch.int32, device=dev)
        self._gen = torch.zeros((bl, max_new), dtype=torch.int32, device=dev)
        # Per-slot RECORD key data (sampled runs; merged at admission).
        self._slot_keys = torch.zeros((bl, 2), dtype=torch.int64, device=dev)
        if paged:
            self._build_paged()
            return
        if self._kv_int8:
            if self._kv_backend.kernel:
                # K-major, the fill-bounded kernel's layout: each (slot,
                # head) row of M positions is contiguous.
                pay = self._local_shape((nl, B, kh, M, dh), kv_kmajor_sharding)
                sc = self._local_shape((nl, B, kh, M), kv_kmajor_scale_sharding)
            else:
                # M-major, the layout _attend_cached reads.
                pay = self._local_shape((nl, B, M, kh, dh), kv_sharding)
                sc = self._local_shape((nl, B, M, kh), kv_scale_sharding)
            self._caches = (
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
            )
        else:
            shape = self._local_shape((nl, B, M, kh, dh), kv_sharding)
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
        if self._kv_tier_cfg is not None:
            self._kv_tier = HostTier(self._kv_tier_cfg)
        self._kv_radix = RadixCache(
            self._kv_alloc, pages.block_size, tier=self._kv_tier,
            read_block=self._tier_read_block, write_block=self._tier_write_block,
        )
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
            pay = self._local_shape((nl, NB, kh, bs, dh), paged_pool_kmajor_sharding)
            sc = self._local_shape((nl, NB, kh, bs), paged_scale_kmajor_sharding)
            self._pool_layouts = (paged_pool_kmajor_sharding,
                                  paged_scale_kmajor_sharding) * 2
            self._pools = (
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
                torch.zeros(pay, dtype=torch.int8, device=dev),
                torch.zeros(sc, dtype=torch.float32, device=dev),
            )
        else:
            shape = self._local_shape((nl, NB, bs, kh, dh), paged_pool_sharding)
            self._pool_layouts = (paged_pool_sharding,) * 2
            self._pools = (
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev),
            )
        self._table_dev = self._device_table()

    # The host-RAM tier's pool I/O (kv_tier=): the radix cache calls these
    # to DEMOTE an evicted block's payload to host memory and to PROMOTE a
    # stored payload back into a fresh block. One payload = each pool's
    # slice at one block index (2 on compute-dtype pools, 4 on int8).
    # Both copies are ordered on the current stream with the ticks: the
    # read's device-to-host copy waits for every write enqueued before it,
    # and the promotion's write is enqueued before the tick that reads the
    # block, so neither needs an event of its own.

    def _tier_read_block(self, block: int) -> tuple:
        return tuple(_host_copy(p[:, block]) for p in self._pools)

    def _tier_write_block(self, block: int, payload) -> None:
        for p, a in zip(self._pools, payload):
            src = self._h2d(a)  # a snapshot: the tier may hand ``a`` out again
            p[:, block] = src if src.dtype == p.dtype else src.view(p.dtype)

    def _sync_tier_metrics(self) -> None:
        """Mirror the radix/tier counters onto ``metrics`` (the radix cache
        owns them; deltas keep repeated syncs idempotent)."""
        if self._kv_tier is None:
            return
        r = self._kv_radix
        sd, sp, sh = self._tier_seen
        if r.demotions > sd:
            self.metrics.radix_demotions.add(r.demotions - sd)
        if r.promotions > sp:
            self.metrics.radix_promotions.add(r.promotions - sp)
        if r.tier_hits > sh:
            self.metrics.tier_hits.add(r.tier_hits - sh)
        self._tier_seen = [r.demotions, r.promotions, r.tier_hits]
        self.metrics.tier_occupancy_bytes.set(
            float(self._kv_tier.occupancy_bytes)
        )

    # ------------------------------------------------ disaggregated prefill
    #
    # Prefill side (prefill_role=True): a finished suffix prefill is cut
    # into a PrefillHandoff instead of decoding. Decode side: handoffs
    # installed by add_prefill_handoffs are adopted at admission.

    def _prompt_block_count(self) -> int:
        """Blocks covering positions [0, prompt_len), the straddling last
        block included (its tail past prompt_len is never read before the
        decode writes it)."""
        return (self._prompt_len - 1) // self._kv_pages.block_size + 1

    def _extract_prompt_blocks(self, slot: int) -> tuple[int, tuple]:
        """The slot's prompt blocks of every pool, on the host (bf16 as CPU
        tensors); ``index_select`` copies, so none shares the pool. Under a
        mesh the blocks hold this rank's kv heads of its stage's layers and
        are all-gathered over tp and pp (the pools' placement records): the
        payload is the whole pool's bytes, as on one device."""
        nb_p = self._prompt_block_count()
        ids = self._h2d(self._table_np[slot, :nb_p].astype(np.int64))
        blocks = [p.index_select(1, ids) for p in self._pools]
        if self._shard is not None:
            blocks = [self._shard.gather_layout(b, lay(self._shard.mesh))
                      for b, lay in zip(blocks, self._pool_layouts)]
        return nb_p, tuple(_host_leaf(b) for b in blocks)

    def _harvest_prefilled(self, finishers) -> None:
        """Prefill-role epilogue of a chunk tick: each slot whose suffix
        completed this tick (token 0 already drawn in the tick with the
        record's key) is cut into a handoff and released; nothing decodes
        here."""
        last = self._last_tok.cpu().numpy()
        released = False
        for e, _row in finishers:
            i = e.slot
            rec = self._slot_rec[i]
            if rec is None or not self._active[i]:
                continue
            nb_p, pools = self._extract_prompt_blocks(i)
            kd = self._record_key_data(rec)
            self._prefilled_ready.append((rec, PrefillHandoff(
                rec.topic, rec.partition, rec.offset, value_crc(rec.value),
                tuple(int(x) for x in kd.ravel()),
                self._temperature, self._top_k, self._top_p,
                int(last[i]), nb_p, pools,
            )))
            self._active[i] = False
            self._slot_rec[i] = None
            self._slot_emitted[i] = 0
            self._slot_journaled[i] = 0
            self._release_slot_blocks(i)
            released = True
        if released:
            self._table_dev = self._device_table()
            self.metrics.cache_pool_occupancy.set(self._kv_alloc.occupancy())

    def take_prefilled(self) -> list[tuple[Record, PrefillHandoff]]:
        """Pop the harvested handoffs (prefill role). The caller publishes
        each and then confirms with ``note_handoff_published``; only that
        retires the record here, so a death between harvest and publish
        re-delivers the prompt to the next prefill incarnation."""
        ready, self._prefilled_ready = self._prefilled_ready, []
        return ready

    def note_handoff_published(self, rec: Record, blocks: int = 0) -> None:
        """The handoff for ``rec`` is on the transfer plane: retire the
        record in the prefill group's ledger."""
        self.metrics.handoffs_published.add(1)
        if self._tracer is not None:
            self._tracer.prefill_handoff(rec, blocks, replica=self._trace_replica)
        self._ledger.emitted(rec)
        self._uncommitted += 1

    def add_prefill_handoffs(self, entries: dict) -> None:
        """Install decoded ``PrefillHandoff`` units keyed by (topic,
        partition, offset), taken when the record is next admitted. Each
        is checked at adoption, so a stale or foreign handoff falls back
        to a local prefill and never reaches a slot."""
        self._prefill_handoffs.update(entries)

    def has_prefill_handoff(self, key: tuple[str, int, int]) -> bool:
        """Routing probe (``fleet.prefill.PrefillRouter``): is a handoff
        ready for this record identity?"""
        return key in self._prefill_handoffs

    def _take_handoff(self, rec: Record) -> PrefillHandoff | None:
        """Pop and check ``rec``'s handoff; None = prefill locally. CRC,
        sampling contract, prompt-block count, array count, shapes and
        dtypes must match this server's pools; a mismatch counts
        ``resume_rejected``."""
        if self._kv_pages is None or not self._chunked:
            return None
        hand = self._prefill_handoffs.pop((rec.topic, rec.partition, rec.offset), None)
        if hand is None:
            return None
        nb_p = self._prompt_block_count()

        def whole(p, lay):  # the handoff's shape of pool p: every layer and kv head
            shape = (p.shape[0], nb_p, *p.shape[2:])
            return shape if self._shard is None else lay(self._shard.mesh).global_shape(shape)

        ok = (
            hand.crc == value_crc(rec.value)
            and hand.temperature == self._temperature
            and hand.top_k == self._top_k
            and hand.top_p == self._top_p
            and hand.prompt_blocks == nb_p
            and len(hand.pools) == len(self._pools)
        ) and all(
            tuple(a.shape) == whole(p, lay) and _dtype_name(a) == _dtype_name(p)
            for a, p, lay in zip(hand.pools, self._pools, self._pool_layouts)
        )
        if not ok:
            self.metrics.resume_rejected.add(1)
            return None
        return hand

    def _adopt_upload(self, block_ids: list[int], payloads: tuple) -> None:
        """Copy an adopted handoff's payload blocks into the pools: one
        indexed copy a pool. Each payload is snapshotted before its copy
        (the handoff's arrays may alias a message buffer). Under a mesh the
        payload holds every layer and kv head and this rank copies its part
        (its stage's layers, its tp chunk of the heads), the layout the
        pools were built under."""
        ids = self._h2d(np.asarray(block_ids, np.int64))
        for p, a, lay in zip(self._pools, payloads, self._pool_layouts):
            src = (a.to(self._device, copy=True) if isinstance(a, torch.Tensor)
                   else self._h2d(a))
            if self._shard is not None:
                src = self._shard.local_of_layout(src, lay(self._shard.mesh))
            p.index_copy_(1, ids, src)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Snapshot a host array, then copy it to the device: the tensor
        never aliases a buffer the host may reuse."""
        return torch.from_numpy(np.array(arr, copy=True)).to(self._device)

    def _h2d_local(self, arr: np.ndarray) -> torch.Tensor:
        """``_h2d`` of this rank's slots of a host array over every slot
        ([B, ...]): rows [_slot_lo, _slot_lo + _local_slots)."""
        return self._h2d(arr[self._slot_lo:self._slot_lo + self._local_slots])

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

    def _head(self, x_last) -> torch.Tensor:
        """Final norm + LM head on [R, D] rows → f32 logits [R, V] (under a
        mesh the columns of every tp rank, all-gathered)."""
        x = _rms_norm(x_last, self._params["ln_f"])
        if self._shard is not None:
            return self._shard.logits(x, self._params["lm_head"], self._cfg.dtype)
        return matmul_f32(x, self._params["lm_head"], self._cfg.dtype)

    def _embed(self, toks) -> torch.Tensor:
        """The token embeddings (under a mesh the vocab-parallel lookup)."""
        if self._shard is not None:
            return self._shard.embed(self._params["embed"], toks, self._cfg.dtype)
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
        x = _paged_sweep(x, positions.to(torch.int32), table, self._layers,
                         self._pools, self._cfg, shard=self._shard)
        return self._head(x[:, -1])

    def _pack_chunk(self):
        """Fill the static chunk operands from the FIFO prefill queue: up
        to ``prefill_chunk`` suffix tokens, taken strictly in queue order
        (the ordering the radix-insert-at-admit safety argument stands
        on), each row carrying its token, logical position and its slot's
        REAL table row. Padding rows point at the sink. Returns (ctok,
        ctable, cpos, fin_mask, fin_row, packed, finishers) — finishers
        are (entry, last_row_index) for admissions whose suffix completes
        in this chunk; ``fin_mask``/``fin_row`` mark the cold ones' slots
        so the tick merges token 0 in the same tick (a warm resume's state
        is restored on the host, ``_activate_chunk_finishers``)."""
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
            if e.off == 0 and self._tracer is not None:
                # The record's first suffix tokens ride this fused tick.
                self._tracer.chunk_scheduled(e.rec, replica=self._trace_replica)
            ctok[packed:packed + n] = e.seq[e.off:e.off + n]
            cpos[packed:packed + n] = e.start + e.off + np.arange(n)
            ctable[packed:packed + n] = self._table_np[e.slot]
            e.off += n
            packed += n
            if e.off == len(e.seq):
                finishers.append((e, packed - 1))
                if e.resume is None:
                    fin_mask[e.slot] = True
                    fin_row[e.slot] = packed - 1
                self._prefill_queue.pop(0)
        return ctok, ctable, cpos, fin_mask, fin_row, packed, finishers

    def _activate_chunk_finishers(self, finishers) -> None:
        """Host bookkeeping for slots whose suffix prefill completed this
        tick: flip them active (their first decode tick is the NEXT tick
        block; a cold admission's token 0 was merged in this one), restore
        a warm resume's state, and push the device table so their rows
        unmask from the sink."""
        resumed = []
        for e, _row in finishers:
            self._prefilling[e.slot] = False
            self._active[e.slot] = True
            if self._tracer is not None:
                # Token 0 was drawn in this tick (cold) or restored from
                # the journal (warm): time to first token closes here.
                self._tracer.slot_active(
                    e.rec, replica=self._trace_replica, warm=e.resume is not None
                )
            # Extra ticks spent queued beyond the one-tick minimum — 0 when
            # the admission's whole suffix rode the first chunk.
            self.metrics.admission_stall_ticks.add(
                max(0, self._tick_counter - e.enq_tick - 1)
            )
            if e.resume is not None:
                resumed.append((e.slot, e.resume))
        if resumed:
            self._restore_resumed(resumed)
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
        then the dense admit's token-0 merge.

        A record with a resume hint prefills ``prompt + emitted[:-1]``
        instead (its cached prompt prefix still matches) and its decode
        state is restored on the host, no token 0 drawn; a FINISHED hint
        takes no slot (the completion re-serves from the journal at the
        next step)."""
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
        resumed: list[tuple[int, np.ndarray]] = []  # legacy (slot, emitted)
        adopted: list[tuple[int, np.ndarray]] = []  # (slot, [token 0])
        keys_np = np.zeros((self._slots, 2), np.int64)
        key_mask = np.zeros((self._slots,), bool)
        reserved = 0
        journal_dirty = False
        slot_iter = iter(phys_free)
        while True:
            nxt = self._next_decodable(queue)
            if nxt is None:
                break
            rec, toks = nxt
            toks = np.asarray(toks, np.int32)
            kd = self._key_for_journal(rec)
            hint = self._take_hint(rec)
            hand = self._take_handoff(rec) if hint is None else None
            if hint is not None and hint.finished:
                journal_dirty |= self._serve_from_journal(rec, hint, kd)
                continue
            i = next(slot_iter, None)
            if i is None:
                # Unreachable under the caller contract (records <= free
                # slots, finished hints take none): fail loudly rather
                # than drop a record.
                raise RuntimeError("paged admission ran out of free slots")
            emitted = None if hint is None else np.asarray(hint.tokens, np.int32)
            seq = toks if emitted is None else np.concatenate([toks, emitted[:-1]])
            matched = self._kv_radix.match(seq)
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
                if hint is not None:  # back on the shelf with its record
                    self._resume_hints[(rec.topic, rec.partition, rec.offset)] = hint
                if hand is not None:  # the deferred re-offer re-adopts
                    self._prefill_handoffs[(rec.topic, rec.partition, rec.offset)] = hand
                if self._tracer is not None:
                    self._tracer.deferred(rec, replica=self._trace_replica)
                self._paged_deferred.append(rec)
                self._paged_deferred.extend(queue)
                queue = []
                break
            row = matched + priv
            self._table_np[i, :] = row
            if hand is not None:
                # ADOPTION: the prefill worker computed this prompt's KV.
                # Copy the unmatched blocks' payloads in (matched blocks
                # hold the same bytes) and activate with the handoff's
                # token 0, as a warm resume after one token: no prompt
                # pass runs here.
                nb_p = hand.prompt_blocks
                up = row[len(matched):nb_p]
                if up:
                    self._adopt_upload(up, tuple(
                        a[:, len(matched):nb_p] for a in hand.pools
                    ))
                # Payload copied, slot not active, record in no ledger
                # snapshot: a death here re-delivers and re-adopts (or
                # re-prefills) to the same bytes.
                crash_hook("decode_adopt_pre_activate")
                cacheable = RadixCache.matchable_blocks(len(toks), bs)
                self._kv_radix.insert(toks, row[:cacheable])
                self._slot_rec[i] = rec
                key_np = (np.asarray(hand.key_data, np.uint32)
                          if hand.key_data else kd)
                if self._sampled:
                    keys_np[i] = key_np
                    key_mask[i] = True
                self._active[i] = True
                self._slot_emitted[i] = 1
                self._slot_journaled[i] = 1
                adopted.append((i, np.asarray([hand.token0], np.int32)))
                self.metrics.adopted_slots.add(1)
                if self._tracer is not None:
                    self._tracer.adopted(rec, replica=self._trace_replica)
                if self._journal is not None:
                    self._journal_record(rec, key_np, (hand.token0,), False)
                    journal_dirty = True
                continue
            start = len(matched) * bs
            # Register the prompt's matchable whole blocks for reuse
            # (existing nodes are the ones just matched; new nodes adopt
            # this slot's private blocks — in chunked mode still being
            # filled, safe by chunk-queue FIFO).
            cacheable = RadixCache.matchable_blocks(len(toks), bs)
            self._kv_radix.insert(toks, row[:cacheable])
            tenant = _default_tenant(rec)
            if matched:
                self.metrics.prefix_hits.add(1)
                self.metrics.tenant_prefix_hits(tenant).add(1)
                self.metrics.prefix_tokens_saved.add(start)
            else:
                self.metrics.prefix_misses.add(1)
                self.metrics.tenant_prefix_misses(tenant).add(1)
            self._slot_rec[i] = rec
            key_np = self._hint_key(hint, kd)
            if self._sampled:
                keys_np[i] = key_np
                key_mask[i] = True
            if hint is None:
                self._slot_emitted[i] = 0
                self._slot_journaled[i] = 0
                if self._journal is not None:
                    self._journal_record(rec, kd, (), False)
                    journal_dirty = True
            else:
                self._note_resumed(i, rec, emitted, key_np)
                journal_dirty |= self._journal is not None
            if self._chunked:
                self._prefilling[i] = True
                self._prefill_queue.append(_PendingPrefill(
                    i, rec, seq[start:].copy(), start, emitted,
                    self._tick_counter,
                ))
                if self._tracer is not None:
                    self._tracer.prefill_queued(
                        rec, len(seq) - start, replica=self._trace_replica
                    )
                reserved += 1
                continue
            self.metrics.prefill_tokens.add(len(seq) - start)
            self._active[i] = True
            with torch.inference_mode(), tracing.span(tracing.SPAN_ADMIT):
                logits = self._suffix_prefill(
                    self._table_np[i], seq[start:], start
                )
            if hint is None:
                admitted.append((i, logits))
            else:
                resumed.append((i, emitted))
        if queue:  # defensive: slots exhausted with records left
            self._paged_deferred.extend(queue)
        # Count records ENTERING the deferred state, not retry spins.
        newly_deferred = len(self._paged_deferred) - was_deferred
        if newly_deferred > 0:
            self.metrics.admission_deferrals.add(newly_deferred)
        self.metrics.cache_pool_occupancy.set(self._kv_alloc.occupancy())
        self._sync_tier_metrics()
        filled = len(admitted) + len(resumed) + len(adopted) + reserved
        if filled and in_flight > 0:
            self.metrics.readmissions.add(filled)
        if filled:
            self._merge_keys(keys_np, key_mask)
        if admitted or resumed or adopted:
            # Chunked reservations push nothing: prefilling rows stay
            # masked to the sink until activation. Adopted slots activate
            # now, so their rows unmask with this push.
            self._table_dev = self._device_table()
        if admitted:
            rows = self._h2d(np.asarray([i for i, _ in admitted], np.int64))
            logits = torch.cat([lg for _, lg in admitted])
            with torch.inference_mode():
                self._merge_token0(rows, self._pick(logits, self._slot_keys[rows]))
            if self._tracer is not None:
                for i, _ in admitted:
                    self._tracer.slot_active(
                        self._slot_rec[i], replica=self._trace_replica
                    )
        if resumed or adopted:
            # An adoption restores one emitted token (the handoff's token
            # 0): the warm-resume state after g = 1.
            self._restore_resumed(resumed + adopted)
            if self._tracer is not None:
                for i, _ in resumed:
                    self._tracer.slot_active(
                        self._slot_rec[i], replica=self._trace_replica, warm=True
                    )
                for i, _ in adopted:
                    # The adopted record's first token exists now: time to
                    # first token closes here (not warm).
                    self._tracer.slot_active(
                        self._slot_rec[i], replica=self._trace_replica
                    )
        if journal_dirty:
            self._journal.flush()
        return filled

    @property
    def _sampled(self) -> bool:
        return self._temperature != 0.0

    def _record_key_data(self, rec: Record) -> np.ndarray:
        """The record's sampling key: ``rng`` folded with the record's
        topic (crc32), partition and offset, each masked to 31 bits, as
        the JAX package derives it: a pure function of (base key, record
        identity). Computed on the host in Python ints; → uint32 [2]."""
        k = prng.fold_in_host(
            self._rng_words, zlib.crc32(rec.topic.encode()) & 0x7FFFFFFF
        )
        k = prng.fold_in_host(k, rec.partition & 0x7FFFFFFF)
        k = prng.fold_in_host(k, rec.offset & 0x7FFFFFFF)
        return np.asarray(k, np.uint32)

    def _merge_keys(self, keys_np: np.ndarray, key_mask: np.ndarray) -> None:
        """Install the admitted slots' record keys (sampled runs only)."""
        if self._sampled and key_mask.any():
            self._slot_keys = torch.where(
                self._h2d_local(key_mask)[:, None], self._h2d_local(keys_np),
                self._slot_keys,
            )

    def _pick(self, logits: torch.Tensor, keys: torch.Tensor,
              idx: torch.Tensor | None = None) -> torch.Tensor:
        """Tokens for ``logits`` rows: greedy argmax, or ``_pick_slots``
        with the rows' record ``keys`` at output index ``idx`` (None = 0,
        token 0 of an admission)."""
        if not self._sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if idx is None:
            idx = torch.zeros(logits.shape[:1], dtype=torch.int32,
                              device=logits.device)
        return _pick_slots(
            logits, keys, idx, temperature=self._temperature,
            top_k=self._top_k, top_p=self._top_p,
        )

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
        lo, bl = self._slot_lo, self._local_slots
        idx = np.nonzero(admit_mask[lo:lo + bl])[0]  # this rank's rows
        if not len(idx):
            return  # every admitted slot is another data rank's
        rows = self._h2d(idx)
        toks = self._h2d(prompts[lo:lo + bl][idx])
        logits, ks, vs = prefill_capture(self._params, cfg, toks, self._model,
                                         self._shard)
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
        self._merge_token0(rows, self._pick(logits, self._slot_keys[rows]))

    def _decode_logits(self, last_tok, pos) -> torch.Tensor:
        """One token per slot through every layer → logits [B, V] f32."""
        cfg = self._cfg
        x = self._embed(last_tok)[:, None, :]
        if self._kv_pages is not None:
            x = _paged_sweep(
                x, pos[:, None], self._table_dev, self._layers, self._pools, cfg,
                kernel=self._kv_backend.kernel, pos_b=pos, shard=self._shard,
            )
            return self._head(x[:, 0])
        c = self._caches

        def body(x):
            for i, layer in enumerate(self._layers):
                if self._kv_int8:
                    x = _slot_layer_step_q(
                        x, layer, c[0][i], c[1][i], c[2][i], c[3][i], pos,
                        self._rows, cfg, self._kv_backend.kernel, self._shard,
                    )
                else:
                    x = _slot_layer_step(
                        x, layer, c[0][i], c[1][i], pos, self._rows, cfg, self._shard
                    )
            return x

        return self._head(staged(self._shard, x, body)[:, 0])

    def _bookkeep(self, logits, act, last_tok, pos, gen, done, n_out):
        """One tick's pick (output index ``pos - P + 1``), EOS/budget test
        and position advance over the rows ``act`` (the JAX tick body's
        tail)."""
        P, max_new = self._prompt_len, self._max_new
        t = pos - P  # decode ticks completed before this one
        t1 = t + 1  # the output index this tick writes (and draws at)
        tok = self._pick(logits, self._slot_keys, t1)
        idx = torch.clamp(t1, max=max_new - 1)
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
        B = self._local_slots
        dev = self._device
        last_tok, pos, gen = self._last_tok, self._pos, self._gen
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        n_ticks = self._ticks_per_sync
        if chunk is not None:
            ctok, ctable, cpos, fin_mask, fin_row = chunk
            x = self._embed(torch.cat([last_tok, ctok]))[:, None, :]
            x = _paged_sweep(
                x, torch.cat([pos, cpos])[:, None],
                torch.cat([self._table_dev, ctable]), self._layers, self._pools,
                self._cfg, shard=self._shard,
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
            last_tok, pos, gen = self._merge_chunk_token0(
                chunk_logits, fin_mask, fin_row, last_tok, pos, gen
            )
        self._last_tok, self._pos, self._gen = last_tok, pos, gen
        return done, n_out

    def _merge_chunk_token0(self, chunk_logits, fin_mask, fin_row, last_tok,
                            pos, gen):
        """Token 0 of every slot whose suffix completed in this tick's chunk
        (``fin_mask``; its last token at chunk row ``fin_row`` of
        ``chunk_logits`` [C, V]) merged into the slot state (last token,
        pos, gen), ready to decode in the next tick block."""
        tok0 = self._pick(chunk_logits[fin_row], self._slot_keys)
        last_tok = torch.where(fin_mask, tok0, last_tok)
        pos = torch.where(fin_mask, self._prompt_len, pos)
        col0 = torch.where(fin_mask, tok0, gen[:, 0])
        gen = torch.where(fin_mask[:, None], 0, gen)
        gen[:, 0] = col0
        return last_tok, pos, gen

    def warmup(self) -> None:
        """Load the kernels and warm the library handles before the first
        real admission, leaving the slot state unchanged: dense, one
        prefill of a zero prompt (result discarded); paged chunked, one
        fused tick with an all-padding chunk (its writes land in the
        sink); legacy paged, one suffix prefill through an all-sink table.
        Then one tick block over an all-inactive pool (inactive slots only
        write at their frozen positions)."""
        B, dev = self._local_slots, self._device
        none = torch.zeros((B,), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            if self._kv_pages is None:
                toks = torch.zeros(
                    (1, self._prompt_len), dtype=torch.int32, device=dev
                )
                prefill_capture(self._params, self._cfg, toks, self._model,
                                self._shard)
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

    def _serve_block(self, active: torch.Tensor, chunk=None):
        """The serving loop's tick block (``step``). A greedy server on a
        dense compute-dtype pool on CUDA replays a CUDA graph of
        ``_tick_block`` (captured at its first block, and again after its
        weights are rebound) in place of the block's model passes launched
        op by op: the graph runs the same kernels on the same pools and
        weights, so it emits the same tokens. The inputs (the active mask,
        the tick state) are copied into the graph's buffers before a replay
        and the state is bound to copies of its outputs after. Paged
        pools, chunk ticks, int8 pools (whose decode kernel counts its
        launches from Python), sampling and the CPU run the eager block,
        and so does a mesh whose tick runs collectives (tp, fsdp, ep or pp
        over 1: gloo stages them through host memory, which a graph cannot
        capture); a data-only mesh's tick runs none and replays."""
        if (chunk is not None or self._kv_pages is not None or self._kv_int8
                or self._sampled or self._device.type != "cuda"
                or self._tick_collectives):
            return self._tick_block(active, chunk)
        if self._block_graph is None:
            self._block_graph = self._capture_block()
        graph, s_active, s_state, outs = self._block_graph
        s_active.copy_(active)
        for buf, cur in zip(s_state, self._tick_state()):
            buf.copy_(cur)
        graph.replay()
        self._set_tick_state([t.clone() for t in outs[2:]])
        return outs[0].clone(), outs[1].clone()

    def _capture_block(self):
        """→ (graph, its active-mask buffer, its tick-state buffers, its
        outputs: done, n_out, then the tick state). A warm block runs first
        on the capture stream with every slot inactive: it leaves the tick
        state as it was and writes the pools only at positions a later
        write precedes any read of (``warmup``'s all-inactive block)."""
        dev = self._device
        live = self._tick_state()
        s_active = torch.zeros((self._local_slots,), dtype=torch.bool, device=dev)
        s_state = [t.clone() for t in live]

        def block():
            self._set_tick_state(list(s_state))
            done, n_out = self._tick_block(s_active)
            return [done, n_out, *self._tick_state()]

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            block()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: another thread's CUDA work (a stream's copy
            # thread, a commit) does not invalidate this capture.
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                outs = block()
        finally:
            self._set_tick_state(live)
        return graph, s_active, s_state, outs

    def _block_record(self) -> list[torch.Tensor]:
        """Extra int32 columns [local slots, n] that ride the tick block's
        sync (all-gathered with the slot rows over data); none here."""
        return []

    def _note_block_record(self, cols: np.ndarray) -> None:
        """The synced ``_block_record`` columns of every slot ([B, n])."""

    def _tick_state(self) -> list[torch.Tensor]:
        """The device state ``_tick_block`` rebinds (last token, position,
        output buffer), in a fixed order; ``_set_tick_state`` binds it."""
        return [self._last_tok, self._pos, self._gen]

    def _set_tick_state(self, state: list[torch.Tensor]) -> None:
        self._last_tok, self._pos, self._gen = state

    def decode_roofline(
        self, *, iters: int = 8, windows: int = 3,
        peak_hbm_gbs: float = H100_PEAK_HBM_GBS, fill: str = "mid",
    ) -> dict:
        """The device's decode speed against the device-memory roofline:
        the JAX package's ``decode_roofline``. The tick block of an
        all-active pool (decode only) is timed as the SLOPE between windows
        of ``iters`` and ``3 * iters`` blocks (``windows`` of each,
        interleaved, medians; ``utils.timing.two_point_slope``), and its
        bytes (``decode_tick_bytes``) over the tick time give the achieved
        rate against ``peak_hbm_gbs``.

        On a CUDA server each window replays ONE captured
        ``torch.cuda.CUDAGraph`` of the tick block, bracketed by CUDA
        events: an eager loop of ticks would time the host's launch rate,
        not the device. The block's state is
        copied into static buffers that each replay reads and writes back,
        so replays chain; with ``fill="mid"`` the graph re-pins the
        positions after each block. A capture that fails raises (there is
        no eager fallback on the card). On a CPU server the windows are
        eager blocks timed by the host's clock, as the JAX package's are
        off the TPU.

        ``fill``: "mid" pins every slot at ``prompt_len + max_new // 2``
        before each block (the fill-bounded reads K4/K5 take time by
        fill); "live" starts from the server's positions. The measured
        fill is the blocks' analytic mean; with the fill-bounded read on,
        the KV bytes a tick reads scale by it. ``_pos`` is restored
        afterwards; the probe still writes probe k/v and tokens through
        the real tick, so call it while no generation is in flight.

        Returns the JAX package's keys (numeric results None when the
        slope degenerates), plus the port's: ``timer`` ("cuda_graph" or
        "host"), ``graph_block_launches`` (the kernel launches captured in
        one block, by kernel), ``graph_replays`` (blocks replayed),
        ``probe_launches`` (what the probe added to the wrappers'
        counters: the warm block and the capture, which count their Python
        calls; replays add nothing) and ``peak_card``."""
        if fill not in ("mid", "live"):
            raise ValueError(f"fill must be 'mid' or 'live', got {fill!r}")
        if self._tick_collectives:
            raise ValueError(
                "decode_roofline times replays of a captured tick block; this "
                "mesh's tick runs collectives (tp, fsdp, ep or pp over 1), which "
                "gloo stages through host memory and a CUDA graph cannot "
                "capture, so there is no device tick to time"
            )
        from torchkafka_tpu_torch.fleet.proc import launch_counts
        from torchkafka_tpu_torch.utils.timing import two_point_slope

        B, K, dev = self._local_slots, self._ticks_per_sync, self._device
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        pos_saved = self._pos
        if fill == "mid":
            target = min(self._prompt_len + self._max_new // 2, self._max_len - 1)
            self._pos = torch.full((B,), target, dtype=torch.int32, device=dev)
        # The fill the windows measure: positions advance one a tick inside
        # a block (re-pinned only between blocks) until the done latch
        # freezes them at prompt + max_new - 2.
        cap = self._prompt_len + self._max_new - 2
        start = self._pos.cpu().numpy()
        per_tick = np.minimum(start[None, :] + np.arange(K)[:, None], cap)
        measured_fill = float((per_tick + 1).mean()) / self._max_len
        pos0 = self._pos.clone() if fill == "mid" else None
        launches0 = launch_counts()
        graph_info: dict = {}
        try:
            if dev.type == "cuda":
                shorts, longs, graph_info = self._roofline_graph(active, pos0, iters,
                                                                 windows)
            else:
                shorts, longs = self._roofline_host(active, pos0, iters, windows)
        finally:
            self._pos = pos_saved
        probe_launches = launch_counts(since=launches0)
        t_short, t_long = float(np.median(shorts)), float(np.median(longs))
        tick_s, overhead_s, slope_ok = two_point_slope(
            t_short, t_long, iters * K, 3 * iters * K
        )
        w_bytes, kv_bytes = decode_tick_bytes(
            self._params, self._cfg, B, self._max_len, kv_int8=self._kv_int8
        )
        # The fill-bounded reads (K4, K5) read [0, pos] of each slot, so the
        # KV bytes a tick reads scale with the measured fill; the plain
        # reads are pool-shaped.
        kernel = self._kv_backend.kernel
        kv_read = int(round(kv_bytes * measured_fill)) if kernel else kv_bytes
        bytes_per_tick = w_bytes + kv_read
        out = {
            "slope_ok": slope_ok,
            "fill": fill,
            "measured_fill_frac": round(measured_fill, 3),
            "dispatch_overhead_ms": round(overhead_s * 1e3, 1),
            "weight_bytes": w_bytes,
            "kv_pool_bytes": kv_bytes,
            "kv_read_bytes": kv_read,
            "weight_bytes_g": round(w_bytes / 1e9, 3),
            "kv_pool_bytes_g": round(kv_bytes / 1e9, 3),
            "peak_hbm_gbs": peak_hbm_gbs,
            "roofline_tok_s": round(B * peak_hbm_gbs * 1e9 / bytes_per_tick, 1),
            "timer": "cuda_graph" if dev.type == "cuda" else "host",
            "peak_card": PEAK_HBM_CARD,
            "probe_launches": probe_launches,
            **graph_info,
        }
        if not slope_ok:
            # The windows drifted more than the work separating them:
            # publishing the floored values would fabricate numbers.
            out.update({"device_tick_ms": None, "device_tok_s": None,
                        "achieved_hbm_gbs": None, "hbm_roofline_pct": None})
            return out
        achieved_gbs = bytes_per_tick / tick_s / 1e9
        out.update({
            "device_tick_ms": round(tick_s * 1e3, 6),
            "device_tok_s": round(B / tick_s, 1),
            "achieved_hbm_gbs": round(achieved_gbs, 1),
            "hbm_roofline_pct": round(100 * achieved_gbs / peak_hbm_gbs, 1),
        })
        return out

    def _roofline_host(self, active, pos0, iters: int, windows: int):
        """``decode_roofline``'s windows off the card: eager tick blocks
        timed by the host's clock → (short window seconds, long ones)."""

        def window(n: int) -> float:
            t0 = time.perf_counter()
            with torch.inference_mode():
                for _ in range(n):
                    self._tick_block(active)
                    if pos0 is not None:
                        self._pos = pos0
                int(self._last_tok[0])  # completion fence
            return time.perf_counter() - t0

        window(1)  # warm
        shorts, longs = [], []
        for _ in range(windows):  # interleaved: drift cannot flip the slope
            shorts.append(window(iters))
            longs.append(window(3 * iters))
        return shorts, longs

    def _roofline_graph(self, active, pos0, iters: int, windows: int):
        """``decode_roofline``'s windows on the card: one CUDA graph of the
        tick block, replayed ``n`` times a window between two CUDA events
        → (short window seconds, long ones, {the captured block's launches,
        the replay count}). The server's tick state ends bound to copies of
        the graph's static buffers."""
        from torchkafka_tpu_torch.fleet.proc import launch_counts
        from torchkafka_tpu_torch.ops import kvattn

        dev = self._device
        static = [t.clone() for t in self._tick_state()]

        def block() -> None:
            self._set_tick_state(list(static))
            self._tick_block(active)
            for buf, new in zip(static, self._tick_state()):
                buf.copy_(new)
            if pos0 is not None:
                static[1].copy_(pos0)

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # Warm on the capture stream: the kernels load, and the split reads'
        # merge counter for this stream is made outside the graph's pool.
        with torch.cuda.stream(stream), torch.inference_mode():
            block()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        counters = dict(kvattn._counters)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        info = {}
        try:
            with torch.inference_mode(), torch.cuda.graph(graph, stream=stream):
                block()
            info["graph_block_launches"] = launch_counts(since=before)
            replays = 0

            def window(n: int) -> float:
                nonlocal replays
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    graph.replay()
                end.record()
                end.synchronize()
                replays += n
                return start.elapsed_time(end) / 1e3

            window(1)  # warm: the graph's first launch uploads it
            shorts, longs = [], []
            for _ in range(windows):  # interleaved: drift cannot flip the slope
                shorts.append(window(iters))
                longs.append(window(3 * iters))
            info["graph_replays"] = replays
        finally:
            torch.cuda.synchronize(dev)
            # Bind the state to buffers outside the graph's pool, and drop
            # any merge counter the capture made or grew (it lives in the
            # pool, which goes with the graph).
            self._set_tick_state([t.clone() for t in static])
            for key, buf in list(kvattn._counters.items()):
                if counters.get(key) is not buf:
                    del kvattn._counters[key]
            del graph
        return shorts, longs, info

    # ------------------------------------------ external admission surface

    @property
    def slots(self) -> int:
        """Size of the decode slot pool."""
        return self._slots

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
        if self._tracer is not None:
            for r in records:
                self._tracer.polled(r, replica=self._trace_replica)

    def note_partitions_revoked(self, tps) -> None:
        """A rebalance took these partitions away: reset their ledger state
        and drop their deferred paged admissions. Without the reset, records
        fetched here but served by the new owner stay pending forever, and
        if a partition comes back (a scale-down returning a scale-up's
        range) the stale entries would hold the snapshot below the group's
        committed watermark and the next commit would regress it. Records
        already decoding in slots are left alone: their completions resolve
        against the dropped partition as no-ops, and a copy the new owner
        serves is the ordinary at-least-once duplicate."""
        tps = set(tps)
        if not tps:
            return
        self._ledger.drop(tps)
        if self._paged_deferred:
            kept = [r for r in self._paged_deferred if r.tp not in tps]
            dropped = len(self._paged_deferred) - len(kept)
            if dropped:
                self._paged_deferred = kept
                _logger.info(
                    "dropped %d deferred admission(s) for revoked "
                    "partitions", dropped,
                )

    def _next_decodable(self, queue: list[Record]):
        """Pop ``queue`` until a record decodes → (record, tokens), or None.
        Failures follow the poison policy: with a quarantine, each failure
        spends the record's retry budget (the SAME record re-attempts in
        place) and an exhausted budget dead-letters it (the record is
        resolved and its offset may retire; a failed DLQ produce raises
        ``OutputDeliveryError`` before any commit could cover it). Without
        one, the record retires as dropped (it would re-deliver and fail
        forever otherwise)."""
        while queue:
            rec = queue.pop(0)
            while True:
                try:
                    return rec, self._decode_prompt(rec)
                except Exception as exc:  # noqa: BLE001 - any decode failure
                    if self._quarantine is not None:
                        try:
                            resolved = self._quarantine.note_failure(rec, exc)
                        except OutputDeliveryError:
                            self.metrics.dlq_delivery_failures.add(1)
                            if self._tracer is not None:
                                self._tracer.dlq_failed(
                                    rec, replica=self._trace_replica
                                )
                            raise
                        if not resolved:
                            continue  # budget left: re-attempt in place
                        self.metrics.quarantined.add(1)
                        if self._tracer is not None:
                            self._tracer.quarantined(
                                rec, replica=self._trace_replica
                            )
                        # The DLQ copy is acknowledged; the offset has not
                        # retired yet (redelivery re-quarantines).
                        crash_hook("post_dlq_pre_retire")
                    else:
                        _logger.exception(
                            "dropping undecodable prompt %s@%s:%s",
                            rec.topic, rec.partition, rec.offset,
                        )
                        if self._tracer is not None:
                            self._tracer.dropped(rec, replica=self._trace_replica)
                    self._ledger.dropped(rec)
                    self.metrics.dropped.add(1)
                    break  # next record
        return None

    def admit_records(self, records: list[Record]) -> int:
        """Admit ``records`` into free slots; returns the number of slots
        filled (cold admissions and warm resumes; a FINISHED resume hint
        re-serves from the journal at the next step and takes no slot).
        Records must already be ``note_fetched``; offer no more than
        ``free_slots()`` (minus ``pending_admissions`` on the paged pool,
        where pool pressure can also DEFER records — call with an empty
        list to re-offer the deferred backlog)."""
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
        keys_np = np.zeros((self._slots, 2), np.int64)
        key_mask = np.zeros((self._slots,), bool)
        queue = list(records)
        slot_iter = iter(free)
        resumed = 0
        journal_dirty = False
        while True:
            nxt = self._next_decodable(queue)
            if nxt is None:
                break
            rec, toks = nxt
            kd = self._key_for_journal(rec)
            hint = self._take_hint(rec)
            if hint is not None and hint.finished:
                journal_dirty |= self._serve_from_journal(rec, hint, kd)
                continue
            i = next(slot_iter, None)
            if i is None:
                # Unreachable under the caller contract (records <= free
                # slots, finished hints take none).
                raise RuntimeError("admission ran out of free slots")
            key_np = self._hint_key(hint, kd)
            if self._sampled:
                keys_np[i] = key_np
                key_mask[i] = True
            if hint is not None:
                with torch.inference_mode():
                    self._resume_into_slot(i, rec, toks, hint, key_np)
                resumed += 1
                journal_dirty |= self._journal is not None
                continue
            prompts[i] = toks
            self._slot_rec[i] = rec
            admit_mask[i] = True
            self._active[i] = True
            self._slot_emitted[i] = 0
            self._slot_journaled[i] = 0
            if self._journal is not None:
                self._journal_record(rec, kd, (), False)
                journal_dirty = True
        admitted = int(admit_mask.sum())
        filled = admitted + resumed
        if filled:
            if in_flight > 0:
                self.metrics.readmissions.add(filled)
            self._merge_keys(keys_np, key_mask)
        if admitted:
            with torch.inference_mode(), tracing.span(tracing.SPAN_ADMIT):
                self._admit(prompts, admit_mask)
            if self._tracer is not None:
                for i in np.nonzero(admit_mask)[0]:
                    self._tracer.slot_active(
                        self._slot_rec[i], replica=self._trace_replica
                    )
        if journal_dirty:
            self._journal.flush()
        return filled

    # ------------------------------------------------ journal, warm resume

    def add_resume_hints(self, entries: dict) -> None:
        """Install journal entries (``DecodeJournal.load`` of a dead
        server's file) keyed by (topic, partition, offset). A hint is
        taken when its record is next offered for admission; an unmatched
        hint sits harmlessly (its payload CRC keeps it off any other
        record)."""
        self._resume_hints.update(entries)

    def _take_hint(self, rec: Record) -> JournalEntry | None:
        """Pop and validate ``rec``'s resume hint; None = admit cold. A
        hint is rejected (``resume_rejected``) on a payload CRC, sampling
        or model-version mismatch, a token count out of range, or a
        partial generation this pool cannot resume; a bare admit-time
        entry (no tokens) is no rejection."""
        hint = self._resume_hints.pop((rec.topic, rec.partition, rec.offset), None)
        if hint is None:
            return None
        g = len(hint.tokens)
        ok = (
            hint.crc == value_crc(rec.value)
            and hint.temperature == self._temperature
            and hint.top_k == self._top_k
            and hint.top_p == self._top_p
            and hint.model_version == self._model_version
            and 1 <= g <= self._max_new
            and (hint.finished or g < self._max_new)
            and (hint.finished or self._resume_supported())
        )
        if not ok:
            if g >= 1:
                self.metrics.resume_rejected.add(1)
            return None
        return hint

    def _resume_supported(self) -> bool:
        """Can a PARTIAL hint warm-resume here? Not on an int8 pool: it
        gives up the token-exactness warm resume exists to keep (the
        record replays cold, as in the JAX package). Under a mesh, as in
        the JAX package: the paged chunked pool resumes (its resume is a
        chunk-queue suffix, replicated over data), the dense pool only on a
        mesh without a data axis (its resume prefills one slot's rows)."""
        if self._kv_int8:
            return False
        if self._shard is None or (self._kv_pages is not None and self._chunked):
            return True
        return self._shard.data == 1

    def _key_for_journal(self, rec: Record):
        """``rec``'s record key where a journal entry or the sampler needs
        it, else None (greedy serving without a journal skips the host
        threefry)."""
        if self._sampled or self._journal is not None:
            return self._record_key_data(rec)
        return None

    @staticmethod
    def _hint_key(hint: JournalEntry | None, kd):
        """The key a (resumed) record samples with: the journaled one, so
        the continuation draws exactly as the dead server would have."""
        if hint is not None and hint.key_data is not None:
            return np.asarray(hint.key_data, np.uint32)
        return kd

    def _journal_record(self, rec, key_data, tokens, finished) -> None:
        self._journal.record(
            rec, key_data, tokens=tokens, finished=finished,
            temperature=self._temperature, top_k=self._top_k,
            top_p=self._top_p, model_version=self._model_version,
        )

    def _serve_from_journal(self, rec, hint, kd) -> bool:
        """Queue a FINISHED hint's tokens for the next step's retirement
        (no slot, no decode); True when this server's journal took the
        entry and needs a flush."""
        out = np.asarray(hint.tokens, np.int32)
        self._journal_ready.append((rec, out))
        self.metrics.journal_served.add(1)
        if self._tracer is not None:
            self._tracer.journal_served(rec, len(out), replica=self._trace_replica)
        if self._journal is None:
            return False
        self._journal_record(rec, hint.key_data or kd, out, True)
        return True

    def _note_resumed(self, i: int, rec: Record, emitted, key_np) -> None:
        """Slot ``i`` resumes ``rec`` after its ``emitted`` tokens."""
        g = len(emitted)
        self._slot_emitted[i] = g
        self._slot_journaled[i] = g
        self.metrics.warm_resumes.add(1)
        self.metrics.journal_tokens_restored.add(g)
        if self._tracer is not None:
            self._tracer.warm_resumed(rec, g, replica=self._trace_replica)
        if self._journal is not None:
            self._journal_record(rec, key_np, emitted, False)

    def _restore_resumed(self, resumed) -> None:
        """Set each warm-resumed slot's state to what the uncut run holds
        after its g emitted tokens: last token ``emitted[g-1]``, position
        P + g - 1 (the next tick writes that position's k/v itself) and
        the output buffer, zero-padded. ``resumed``: (slot, emitted)."""
        B, P = self._slots, self._prompt_len
        mask = np.zeros((B,), bool)
        last = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        gen = np.zeros((B, self._max_new), np.int32)
        for i, emitted in resumed:
            mask[i] = True
            last[i] = emitted[-1]
            pos[i] = P + len(emitted) - 1
            gen[i, :len(emitted)] = emitted
        m = self._h2d_local(mask)
        self._last_tok = torch.where(m, self._h2d_local(last), self._last_tok)
        self._pos = torch.where(m, self._h2d_local(pos), self._pos)
        self._gen = torch.where(m[:, None], self._h2d_local(gen), self._gen)

    def _resume_into_slot(self, i: int, rec: Record, prompt_toks,
                          hint: JournalEntry, key_np) -> None:
        """Dense warm resume: ONE prefill of ``prompt + emitted[:-1]`` (S =
        P + g - 1 positions) into slot ``i``'s rows of the compute-dtype
        pool, then the uncut run's state after g tokens. Rows past S keep
        stale contents; the tick that reaches each writes it first."""
        emitted = np.asarray(hint.tokens, np.int32)
        seq = np.concatenate([np.asarray(prompt_toks, np.int32), emitted[:-1]])
        _logits, ks, vs = prefill_capture(
            self._params, self._cfg, self._h2d(seq)[None, :], self._model, self._shard
        )
        s, c = len(seq), self._caches
        c[0][:, i, :s] = ks[:, 0].to(c[0].dtype)
        c[1][:, i, :s] = vs[:, 0].to(c[1].dtype)
        self._restore_resumed([(i, emitted)])
        self._slot_rec[i] = rec
        self._active[i] = True
        self._note_resumed(i, rec, emitted, key_np)
        if self._tracer is not None:
            self._tracer.slot_active(rec, replica=self._trace_replica, warm=True)

    @property
    def model_version(self) -> int:
        """The version tag every published output carries (``mv``)."""
        return self._model_version

    def swap_params(self, params, version: int) -> None:
        """Hot-swap the serving weights in place: the pools, slots,
        consumer and lease are untouched. The caller must have quiesced
        (no active or prefilling slot) and closed the commit window
        (``flush_commits``), so no window ever holds outputs of two model
        versions (``RuntimeError`` otherwise). The journal's model version
        is synced BEFORE the rebind: a kill at ``rollout_pre_swap`` leaves
        the old version durable, one at ``swap_mid_apply`` the new, never
        half of each. ``params`` is placed on this server's device (leaves
        already there are kept, not copied), then ``self._params`` and the
        per-layer views derived from it are rebound together, so nothing
        reads the old weights after this call."""
        if self.has_active():
            raise RuntimeError(
                "swap_params requires a quiesced server (drain in-flight "
                "generations first — the warm-drain discipline)"
            )
        if self._uncommitted or (self._txn_mode and self._txn_outbox):
            raise RuntimeError(
                "swap_params requires a closed commit window "
                "(flush_commits first) — a window must never span model "
                "versions"
            )
        version = int(version)
        crash_hook("rollout_pre_swap")
        if self._journal is not None:
            self._journal.set_model_version(version)
            self._journal.sync()
        crash_hook("swap_mid_apply")
        self._bind_params(self._place(params))
        self._model_version = version
        if self._tracer is not None:
            self._tracer.swapped(version, replica=self._trace_replica)

    def _bind_params(self, params) -> None:
        """Serve ``params`` (on this server's device, this rank's share
        under a mesh): the tree and the per-layer views every sweep reads,
        rebound together (a captured tick block reads the old ones: it is
        dropped). Under fsdp a layer's weights are gathered when it runs."""
        self._block_graph = None
        self._params = params
        self._layers = (unstack_layers(params["layers"]) if self._shard is None
                        else self._shard.layers(params["layers"]))

    def spawn_shadow(self, params, version: int) -> "StreamingGenerator":
        """A scratch server over CANDIDATE weights for canary shadow
        serving: this server's config, slot count, prompt decoding,
        sampling contract, record-key base, output budget and KV dtype and
        kernel, on the same device, so for any record its output is what
        the candidate would commit here; but no consumer group, producer or
        journal, so nothing a shadow decodes reaches the committed view.
        The dense pool serves regardless of paging (paged and dense serve
        the same tokens). The JAX package's shadow has one slot and the
        compute-dtype pool; the port keeps the incumbent's ``kv_dtype``/
        ``kv_kernel`` (an int8 pool does not serve the compute-dtype pool's
        tokens) and its slot count (in bf16 a decode row's GEMMs round
        apart at M = 1 and M = 8 on the card), so a canary of the
        incumbent's own weights compares like with like."""
        return StreamingGenerator(
            _ShadowConsumer(), params, self._cfg,
            slots=self._slots,
            prompt_len=self._prompt_len,
            max_new=self._max_new,
            eos_id=self._eos_id,
            commit_every=2**31 - 1,
            decode_prompt=self._decode_prompt,
            ticks_per_sync=1,
            temperature=self._temperature,
            top_k=self._top_k,
            top_p=self._top_p,
            rng=np.asarray(self._rng_words, np.uint32),
            kv_dtype=self._kv_dtype,
            kv_kernel=self._kv_kernel_opt,
            max_new_of=self._max_new_of,
            model_version=int(version),
            device=self._device,
        )

    def shadow_decode(self, rec: Record) -> np.ndarray | None:
        """Decode ``rec`` to completion on this server as a shadow pass
        (the canary calls it on a ``spawn_shadow`` server). Returns the
        tokens, or None for an undecodable record. The record is ledger-
        registered here but never committed anywhere."""
        self.note_fetched([rec])
        if self.admit_records([rec]) == 0 and not self._journal_ready:
            return None
        out: np.ndarray | None = None
        while self.has_active() or self._journal_ready:
            for done_rec, toks in self.step():
                if (done_rec.offset == rec.offset
                        and done_rec.topic == rec.topic
                        and done_rec.partition == rec.partition):
                    out = toks
        return out

    def _txn_abort(self) -> None:
        """Best-effort abort of an in-flight transaction (a dead broker
        leaves it to the next ``begin`` or the next incarnation's fence).
        The outbox is untouched: its entries re-send next window."""
        try:
            if self._output_producer.abort():
                self.metrics.txn_aborts.add(1)
        except Exception:  # noqa: BLE001 - the broker will abort it
            _logger.debug("defensive transaction abort failed", exc_info=True)

    def _retire_completion(self, rec: Record, out: np.ndarray,
                           completions: list) -> None:
        """The single completion exit, for tick completions and journal-
        served ones alike: metrics, the output send (fail closed per
        record) or, exactly-once, the outbox stage, ledger retirement."""
        self.metrics.completions.add(1)
        self.metrics.tokens.add(len(out))
        if len(out) < self._max_new:
            self.metrics.truncated.add(1)
        if self._tracer is not None:
            self._tracer.finished(rec, len(out), replica=self._trace_replica)
        if self._distill_topic is not None:
            # Framed now (tokens in hand), produced only with the commit
            # that covers the offset. Keyed by record identity: a re-serve
            # overwrites the identical frame.
            self._distill_outbox[(rec.topic, rec.partition, rec.offset)] = (
                self._encode_distill(
                    self._decode_prompt(rec), out,
                    tenant=rec.key, model_version=self._model_version,
                )
            )
        sent_ok = True
        if self._txn_mode:
            # STAGE, don't send: produced inside the commit window's
            # transaction once the in-order watermark covers this offset,
            # so output and offset are one broker decision. Keyed by
            # record identity: a re-serve overwrites its own entry.
            self._txn_outbox[(rec.topic, rec.partition, rec.offset)] = dict(
                topic=self._output_topic,
                value=self._encode_output(rec, out),
                key=rec.key,
                headers=(("mv", str(self._model_version).encode()),),
            )
        elif self._output_producer is not None:
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
        pool with an empty chunk queue and no journal backlog. Completions
        re-served from a journal come first."""
        completions: list[tuple[Record, np.ndarray]] = []
        if self._journal_ready:
            ready, self._journal_ready = self._journal_ready, []
            for rec, out in ready:
                self._retire_completion(rec, out, completions)
        run_chunk = self._chunked and bool(self._prefill_queue)
        if self._active.any() or run_chunk:
            B, P = self._slots, self._prompt_len
            self._tick_counter += 1
            tick_t0 = time.perf_counter()
            finishers = None
            with torch.inference_mode():
                if run_chunk:
                    with tracing.span(tracing.SPAN_CHUNK_PACK):
                        *ops, packed, finishers = self._pack_chunk()
                with tracing.span(tracing.SPAN_TICK):
                    chunk = tuple(self._h2d(a) for a in ops) if run_chunk else None
                    done, n_out = self._serve_block(self._h2d_local(self._active), chunk)
                # ONE host sync per tick block: done/n_out/pos/gen together
                # (every data rank's slots, all-gathered, under a mesh that
                # splits them).
                with tracing.span(tracing.SPAN_SYNC):
                    packed_t = torch.cat([
                        done.to(torch.int32)[:, None], n_out[:, None],
                        self._pos[:, None], self._gen, *self._block_record(),
                    ], dim=1)
                    if self._local_slots != B:
                        packed_t = self._shard.gather_rows(packed_t)
                    packed_h = packed_t.cpu().numpy()
            done_h = packed_h[:, 0].astype(bool)
            n_out_h, pos_h = packed_h[:, 1], packed_h[:, 2]
            gen_h = packed_h[:, 3:3 + self._max_new]
            self._note_block_record(packed_h[:, 3 + self._max_new:])
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
            # Counted BEFORE retirement, so a completing slot's final
            # tokens are journaled while its record is still attached.
            decoded = 0
            journal_dirty = False
            for i in np.nonzero(self._active)[0]:
                cnt = int(n_out_h[i] if done_h[i] else pos_h[i] - P + 1)
                if self._max_new_of is not None:
                    budget = self._max_new_of(self._slot_rec[i])
                    if budget is not None:
                        budget = max(1, min(int(budget), self._max_new))
                        if cnt >= budget:
                            # Budget reached (a tick block may overshoot it
                            # by up to ticks_per_sync - 1 tokens, which are
                            # cut): finish the slot like a device done.
                            cnt = budget
                            if not done_h[i]:
                                self.metrics.output_capped.add(1)
                            done_h[i] = True
                            n_out_h[i] = budget
                new_toks = cnt - int(self._slot_emitted[i])
                decoded += new_toks
                if self._tracer is not None and new_toks > 0:
                    self._tracer.tokens(
                        self._slot_rec[i], new_toks, replica=self._trace_replica
                    )
                self._slot_emitted[i] = cnt
                if self._journal is not None:
                    rec = self._slot_rec[i]
                    if done_h[i]:
                        self._journal.finish(rec, gen_h[i, :cnt])
                        journal_dirty = True
                    elif cnt - int(self._slot_journaled[i]) >= self._journal.cadence:
                        self._journal.progress(rec, gen_h[i, :cnt])
                        self._slot_journaled[i] = cnt
                        journal_dirty = True
            if decoded > 0:
                self.metrics.decoded_tokens.add(decoded)
            self.metrics.tokens_per_tick.set(float(decoded))
            if journal_dirty:
                # Synchronous at the cadence point: a kill one instruction
                # later finds these tokens on disk.
                self._journal.flush()
            for i in np.nonzero(done_h)[0]:
                rec = self._slot_rec[i]
                assert rec is not None
                self._active[i] = False
                self._slot_rec[i] = None
                self._slot_emitted[i] = 0
                self._slot_journaled[i] = 0
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
                if self._prefill_role:
                    # Disaggregated prefill: nothing decodes here. Cut the
                    # activated slots into handoffs and free them before
                    # any decode tick could run.
                    self._harvest_prefilled(finishers)
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
        """Commit anything emitted since the last commit (exactly-once:
        also a non-empty outbox, whose held outputs must still reach a
        committed transaction). False = a survivable commit failure left
        work pending (retry later)."""
        if self._uncommitted or (self._txn_mode and self._txn_outbox):
            if self._commit():
                self._uncommitted = 0
                return True
            return False
        return True

    @property
    def pending_commit(self) -> int:
        """Completions emitted since the last SUCCESSFUL commit — what a
        flush would cover."""
        return self._uncommitted

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
            if not self.has_active() and not self._journal_ready:
                if max_records is not None and served >= max_records:
                    break
                if not pending:
                    if exhausted_at is None:
                        exhausted_at = time.monotonic()
                    elif agree(
                        None if self._shard is None else self._shard.mesh,
                        (time.monotonic() - exhausted_at) * 1000 >= idle_timeout_ms,
                    ):  # the root's clock decides for every rank of a mesh
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
        output. ``commit_latency`` covers the whole path. With
        ``exactly_once`` the commit is one transaction (``_commit_txn``).
        A successful commit prunes the journal of what it covers."""
        t0 = time.perf_counter()
        if self._commit_consumer is None:
            return True  # a mesh rank other than the root: the root commits
        if self._txn_mode:
            return self._commit_txn(t0)
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
            assigned = set(self._commit_consumer.assignment())
        except Exception:  # noqa: BLE001 - transport hiccup: commit as-is
            assigned = None
        if assigned is not None:
            snapshot = {tp: off for tp, off in snapshot.items() if tp in assigned}
            if not snapshot:
                return True
        crash_hook("pre_commit")
        try:
            with tracing.span(tracing.SPAN_COMMIT):
                self._commit_consumer.commit(snapshot)
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
        if self._tracer is not None:
            # Durably committed: close every covered record's e2e span.
            self._tracer.note_commit(snapshot)
        if self._distill_topic is not None and self._distill_outbox:
            self._publish_distill(snapshot, assigned)
        self._prune_journal(snapshot)
        return True

    def _publish_distill(self, snapshot: dict, assigned) -> None:
        """At-least-once: produce the staged distill frames the commit that
        just SUCCEEDED covers (never before it: a crash before the commit
        publishes nothing, and the re-delivered records' regenerated
        completions frame the only copy). Frames of partitions this server
        no longer owns are dropped (their new owner frames them). A send
        fault keeps the frame for the next commit's retry."""
        prod = self._distill_producer or self._output_producer
        outbox = self._distill_outbox
        if assigned is not None:
            for ident in [i for i in outbox
                          if TopicPartition(i[0], i[1]) not in assigned]:
                del outbox[ident]
        covered = [i for i in outbox
                   if i[2] < snapshot.get(TopicPartition(i[0], i[1]), 0)]
        for ident in covered:
            try:
                prod.send(self._distill_topic, outbox[ident])
            except Exception:  # noqa: BLE001 - retry at the next commit
                _logger.warning(
                    "distill frame publish failed; retrying at the next "
                    "commit", exc_info=True,
                )
                break
            del outbox[ident]
            self.metrics.distill_published.add(1)

    def _prune_journal(self, snapshot: dict) -> None:
        """Drop the journal entries a successful commit covers: the file
        stays bounded by in-flight work."""
        if self._journal is not None:
            self._journal.prune(snapshot)
            self._journal.flush()

    def _commit_txn(self, t0: float) -> bool:
        """The exactly-once commit: ONE transaction per window — begin,
        produce every outbox entry the in-order ledger snapshot covers
        (outputs and DLQ copies alike), stage the snapshot's offsets with
        the consumer's current group metadata, commit. Entries above the
        watermark are HELD for a later window. ``CommitFailedError``
        (rebalance) aborts the window and returns False: the outbox
        re-sends next window. ``ProducerFencedError`` is terminal: a
        successor owns this transactional id. Other faults abort
        defensively and return False."""
        p = self._output_producer
        snapshot = self._ledger.snapshot()
        try:
            assigned = set(self._commit_consumer.assignment())
        except Exception:  # noqa: BLE001 - transport hiccup: commit as-is
            assigned = None
        outbox = self._txn_outbox

        def tp_of(ident):
            return TopicPartition(ident[0], ident[1])

        if assigned is not None:
            snapshot = {tp: off for tp, off in snapshot.items() if tp in assigned}
            # Entries of departed partitions are stale: their records
            # committed here already or re-serve on the new owner (whose
            # distill frame is then the only copy).
            for ident in [i for i in outbox if tp_of(i) not in assigned]:
                del outbox[ident]
                self._distill_outbox.pop(ident, None)
        # A re-serve of a record an earlier window already committed.
        for ident in [i for i in outbox
                      if i[2] < self._txn_committed_wm.get(tp_of(i), 0)]:
            del outbox[ident]
            self._distill_outbox.pop(ident, None)
        sendable = [i for i in outbox if i[2] < snapshot.get(tp_of(i), 0)]
        # Distill frames the snapshot covers ride the same transaction as
        # the outputs and offsets: an aborted window's frames are invisible.
        d_sendable = [
            i for i in self._distill_outbox if i[2] < snapshot.get(tp_of(i), 0)
        ] if self._distill_topic is not None else []
        if not snapshot and not p.in_transaction:
            return True  # nothing resolved, nothing dangling
        try:
            # begin() also aborts a transaction a lost ack left open.
            p.begin()
            for ident in sendable:
                kw = outbox[ident]
                p.send(kw["topic"], kw["value"], key=kw["key"],
                       headers=kw["headers"])
            for ident in d_sendable:
                p.send(self._distill_topic, self._distill_outbox[ident])
            if snapshot:
                p.send_offsets(
                    self._commit_consumer.group_id, snapshot,
                    member_id=getattr(self._commit_consumer, "member_id", None),
                    generation=getattr(self._commit_consumer, "generation", None),
                )
            p.commit()
        except ProducerFencedError:
            self.metrics.commit_failures.add(1)
            self.metrics.txn_aborts.add(1)
            _logger.exception(
                "transactional producer fenced; failing stop — the "
                "successor incarnation owns this server's outputs now"
            )
            raise
        except CommitFailedError:
            self.metrics.commit_failures.add(1)
            self.metrics.txn_aborts.add(1)
            self._txn_abort()  # send_offsets may refuse before commit
            _logger.exception(
                "transaction aborted on commit failure; the outbox "
                "re-sends next window"
            )
            return False
        except Exception:  # noqa: BLE001 - transport fault: retry later
            self.metrics.commit_failures.add(1)
            self._txn_abort()
            _logger.exception(
                "transaction commit failed in flight; aborted "
                "defensively — the outbox re-sends next flush"
            )
            return False
        for ident in sendable:
            del outbox[ident]
        for ident in d_sendable:
            self._distill_outbox.pop(ident, None)
        if d_sendable:
            self.metrics.distill_published.add(len(d_sendable))
        for tp, off in snapshot.items():
            if off > self._txn_committed_wm.get(tp, 0):
                self._txn_committed_wm[tp] = off
        self.metrics.txn_commits.add(1)
        self.metrics.txn_held_outputs.set(float(len(self._txn_outbox)))
        self.metrics.commit_latency.observe(time.perf_counter() - t0)
        if self._tracer is not None:
            self._tracer.note_commit(snapshot)
        self._prune_journal(snapshot)
        return True

    def sync_journal(self) -> None:
        """Flush and fsync the decode journal (no-op without one): what is
        in flight at exit stays warm-resumable by the next owner."""
        if self._journal is not None:
            self._journal.sync()

    def close(self) -> None:
        """Voluntary shutdown: commit the watermark for everything already
        completed; in-flight generations stay uncommitted and re-deliver
        (warm, from the synced journal). Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._commit()
        except ConsumerClosedError:
            pass
        finally:
            self.sync_journal()

    def __enter__(self) -> "StreamingGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
