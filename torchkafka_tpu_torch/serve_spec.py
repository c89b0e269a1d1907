"""Speculative continuous-batching serving: port of
``torchkafka_tpu/serve_spec.py``.

``SpecStreamingGenerator`` is ``serve.StreamingGenerator`` with one tick
block of speculative ROUNDS in place of decode ticks. The host loop
(``step``, ``run``, admission, commits, journal, tracer, budgets) is
inherited unchanged; the subclass overrides the device hooks: the pools
(``_build``), dense admission (``_admit``), the legacy paged suffix
prefill (``_suffix_prefill``), the dense warm resume
(``_resume_into_slot``) and the tick block (``_tick_block``; on a dense
pool on CUDA the inherited ``_serve_block`` replays it as one CUDA
graph). Per round and slot:

1. the draft proposes k greedy tokens in k+1 single-query steps (the
   last only ingests proposal k, so the draft cache stays contiguous
   across full-accept rounds; ``models.spec_decode``'s rule);
2. the target scores all k+1 positions in one multi-query verify at the
   slot's position;
3. the longest draft prefix matching the target's argmax is accepted and
   the target's correction/bonus token appended, emission stopping past
   the accepted length, past ``max_new`` or after an EOS.

Every emitted token is the target's greedy choice, so the server equals
the plain server (greedy) up to f32 reduction order, and the draft sets
only the speed. Commits are untouched by construction: completions
retire through the inherited ledger calls.

Both models' pools are written speculatively: rejected positions stay as
stale entries beyond the slot's watermark, written before any read that
could see them, so rollback is position bookkeeping. The verify writes
[pos, pos + k], so the pools hold ``prompt_len + max_new + k`` positions
(a paged slot's table covers that many from admission). On the paged
pool (``kv_pages``) both models' pools ``[L, NB, bs, K, Dh]`` live under
ONE block table, so a radix hit skips both models' prompt prefill, and
the host-RAM tier's payload of a block (``_tier_read_block``) carries all
four pools. Chunked ticks push the chunk rows through the target's pools,
then the draft's, in two sweeps (the verify's k+1 queries do not
concatenate with the S=1 chunk rows), then run the rounds.

Greedy only (the accept rule compares against the target's argmax) and
the compute-dtype pool only (an int8 pool gives up token-exactness, and
the int8 decode kernels read one query per slot, not k+1): both are
validated out with the JAX package's errors. The verify's multi-query
read is plain PyTorch (``_attend_cached``, ``block_table_attention``),
as it is plain XLA in the JAX package. ``spec_stats()`` reads the
device-side (rounds, proposed, accepted) counters; ``swap_draft_params``
hot-swaps the draft between ticks (the draft never changes committed
output, only the acceptance).

Under a mesh (``mesh=``, the base server's) the draft is sharded as the
target is (its own ``ServingShard``: its heads over tp, its slots over
data on a dense pool, its layers over pp by its own count, as the JAX
package re-places the draft: draft stage s takes the draft's layers
[s·d/P, (s+1)·d/P) from the whole tree, a copy, whichever target stage
holds them), and ``spec_stats()`` sums the data ranks' counters, a
collective every rank of the mesh calls together. A round counts once if
any slot of the whole batch is live in it, as in the JAX package: under a
data split each rank records its rounds' liveness for the tick block,
which rides the block's sync (``_block_record``), and the host ORs the
ranks' records.
"""

from __future__ import annotations

import numpy as np
import torch

from torchkafka_tpu_torch.models.generate import (
    KVCache,
    ServingShard,
    kv_sharding,
    paged_pool_sharding,
    prefill_capture,
    prefill_model,
)
from torchkafka_tpu_torch.models.quant import embed_rows
from torchkafka_tpu_torch.models.spec_decode import (
    _multi_step,
    accept,
    lm_logits,
    truncated_draft,
)
from torchkafka_tpu_torch.models.transformer import _mesh_axes, unstack_layers
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.serve import StreamingGenerator, _paged_sweep, _params_to
from torchkafka_tpu_torch.utils.devices import resolve_device
from torchkafka_tpu_torch.utils.tree import tree_flatten, tree_leaves


class SpecStreamingGenerator(StreamingGenerator):
    """Continuous-batching server that decodes speculatively per slot.

    ``draft_params``/``draft_cfg``: any same-vocab draft model (given
    together), or neither for the self-speculative layer-skip draft,
    ``truncated_draft(params, cfg, draft_layers)`` (``draft_layers``
    defaults to half the target's layers). ``k``: draft tokens proposed
    per verify. ``ticks_per_sync`` counts speculative ROUNDS per host
    sync (each advances an active slot by 1..k+1 tokens). The other
    arguments are ``StreamingGenerator``'s."""

    def __init__(
        self,
        consumer,
        params,
        cfg,
        *,
        draft_params=None,
        draft_cfg=None,
        draft_layers: int | None = None,
        k: int = 4,
        **kwargs,
    ) -> None:
        if kwargs.get("temperature", 0.0) != 0.0:
            raise ValueError(
                "speculative serving is greedy-only: the accept rule "
                "compares the draft against the target's argmax, which is "
                "what buys token-exactness vs plain serving (sampled "
                "speculation needs the rejection-sampling rule — not "
                "implemented)"
            )
        if kwargs.get("kv_dtype") is not None:
            raise ValueError(
                "speculative serving keeps the compute-dtype slot pool: "
                "int8 KV gives up token-exactness, the one contract "
                "speculation is built on"
            )
        if kwargs.get("kv_kernel", "auto") is True:
            raise ValueError(
                "kv_kernel=True cannot be honored: the int8 decode kernels "
                "read one query per slot, not the k+1-query verify"
            )
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError(
                "draft_params and draft_cfg must be given together "
                "(or neither, for the layer-truncated self-draft)"
            )
        dev = resolve_device(kwargs.get("device"))
        params = _params_to(params, dev)
        mesh = kwargs.get("mesh")
        if draft_params is None:
            if draft_layers is None:
                draft_layers = max(1, cfg.n_layers // 2)
            if mesh is not None and _mesh_axes(mesh).get("pp", 1) > 1:
                from torch.distributed.tensor import DTensor

                if any(isinstance(t, DTensor) for t in tree_leaves(params)):
                    # Draft stage s takes target layers another stage holds.
                    raise ValueError(
                        "the self-draft on a pp mesh is cut from the whole target "
                        "tree: pass whole params (or draft_params/draft_cfg), not "
                        "a pp-sharded tree"
                    )
            draft_params, draft_cfg = truncated_draft(params, cfg, draft_layers)
        elif draft_layers is not None:
            raise ValueError(
                "draft_layers applies to the self-truncated draft only — "
                "an explicit draft_params/draft_cfg pair already fixes "
                "the draft's depth"
            )
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft and target must share a vocab: "
                f"{draft_cfg.vocab_size} != {cfg.vocab_size}"
            )
        self._k = int(k)
        self._draft_params = _params_to(draft_params, dev)
        self._draft_cfg = draft_cfg
        self._draft_shard = (None if mesh is None else
                             ServingShard(draft_cfg, mesh, batch=kwargs.get("slots", 8)))
        # Live rounds of the whole batch, counted from each block's synced
        # liveness record (read by spec_stats under a data split).
        self._live_rounds = 0
        super().__init__(consumer, params, cfg, **kwargs)

    # ------------------------------------------------------------- build

    def _build(self) -> None:
        """The base build at the overshoot length, plus the draft's pools
        (the same layout in the draft's shape and dtype) and the three
        device counters. ``_max_len`` is set first, so a paged slot's
        blocks cover the verify's overshoot."""
        dcfg, dev = self._draft_cfg, self._device
        self._max_len = self._prompt_len + self._max_new + self._k
        super()._build()
        ds = self._draft_shard
        self._draft_model = prefill_model(dcfg, None if ds is None else ds.mesh)
        self._bind_draft(self._draft_params)
        dl, dkh, ddh = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
        if self._kv_pages is not None:
            pages = self._kv_pages
            shape = self._local_shape(
                (dl, pages.num_blocks, pages.block_size, dkh, ddh), paged_pool_sharding)
            self._pools += tuple(
                torch.zeros(shape, dtype=dcfg.dtype, device=dev) for _ in range(2)
            )
            self._pool_layouts += (paged_pool_sharding,) * 2
        else:
            shape = self._local_shape((dl, self._slots, self._max_len, dkh, ddh),
                                      kv_sharding)
            self._caches += tuple(
                torch.zeros(shape, dtype=dcfg.dtype, device=dev) for _ in range(2)
            )
        # accepted, proposed, rounds: read only by spec_stats().
        self._spec_counts = tuple(
            torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3)
        )
        # This rank's liveness of each round of the last tick block.
        self._live = torch.zeros((self._ticks_per_sync,), dtype=torch.bool, device=dev)

    def _bind_draft(self, draft_params) -> None:
        """Propose with ``draft_params`` (this rank's share under a mesh):
        the tree and its layer views, rebound together."""
        ds = self._draft_shard
        if ds is not None:
            draft_params = ds.local_params(draft_params, self._device)
        self._draft_params = draft_params
        self._draft_layers = (unstack_layers(draft_params["layers"]) if ds is None
                              else ds.layers(draft_params["layers"]))

    def _spec_model(self, draft: bool):
        """(params, cfg, layers, pools, shard) of the draft or the target;
        pools are the model's two of the dense or paged pool tuple."""
        pools = self._caches if self._kv_pages is None else self._pools
        if draft:
            return (self._draft_params, self._draft_cfg, self._draft_layers,
                    pools[2:4], self._draft_shard)
        return self._params, self._cfg, self._layers, pools[0:2], self._shard

    # --------------------------------------------------------- admission

    def _prefill_draft_rows(self, rows, toks) -> None:
        """Write the draft's cache rows [0, S) of dense slots ``rows`` from
        one prefill of ``toks`` [n, S]."""
        _logits, ks, vs = prefill_capture(
            self._draft_params, self._draft_cfg, toks, self._draft_model,
            self._draft_shard,
        )
        s = toks.shape[1]
        self._caches[2][:, rows, :s] = ks.to(self._caches[2].dtype)
        self._caches[3][:, rows, :s] = vs.to(self._caches[3].dtype)

    def _admit(self, prompts: np.ndarray, admit_mask: np.ndarray) -> None:
        """Both models' prefill of the admitted rows; token 0 is the
        target's argmax (the base admit)."""
        lo, bl = self._slot_lo, self._local_slots
        idx = np.nonzero(admit_mask[lo:lo + bl])[0]  # this rank's rows
        if len(idx):
            self._prefill_draft_rows(self._h2d(idx), self._h2d(prompts[lo:lo + bl][idx]))
        super()._admit(prompts, admit_mask)

    def _resume_into_slot(self, i: int, rec, prompt_toks, hint, key_np) -> None:
        """Dense warm resume: the draft's rows of slot ``i`` prefilled with
        ``prompt + emitted[:-1]`` too, then the base resume (the target's
        rows and the uncut run's state)."""
        emitted = np.asarray(hint.tokens, np.int32)
        seq = np.concatenate([np.asarray(prompt_toks, np.int32), emitted[:-1]])
        self._prefill_draft_rows(self._h2d(np.asarray([i])), self._h2d(seq)[None, :])
        super()._resume_into_slot(i, rec, prompt_toks, hint, key_np)

    def _paged_hidden(self, draft: bool, tokens, pos_b, table) -> torch.Tensor:
        """One model's S-query write-then-attend over its paged pools at
        per-row start positions ``pos_b`` [R] through ``table`` [R, nblk]
        → the last layer's output [R, S, D] (before the final norm)."""
        params, cfg, layers, pools, shard = self._spec_model(draft)
        s = tokens.shape[1]
        if shard is None:
            x = embed_rows(params["embed"], tokens, cfg.dtype)
        else:
            x = shard.embed(params["embed"], tokens, cfg.dtype)
        positions = pos_b[:, None] + torch.arange(
            s, dtype=torch.int32, device=tokens.device
        )[None, :]
        return _paged_sweep(x, positions, table, layers, pools, cfg, shard=shard)

    def _suffix_prefill(self, table_row: np.ndarray, toks: np.ndarray,
                        start: int) -> torch.Tensor:
        """Legacy paged admission: the uncached suffix ``toks`` at positions
        [start, start + S) through both models' pools; the target's last
        position's logits [1, V]."""
        table = self._h2d(table_row)[None, :]
        tok_t = self._h2d(toks)[None, :]
        pos0 = torch.full((1,), start, dtype=torch.int32, device=self._device)
        self._paged_hidden(True, tok_t, pos0, table)
        x = self._paged_hidden(False, tok_t, pos0, table)
        return lm_logits(self._params, self._cfg, x[:, -1], self._shard)

    # -------------------------------------------------------------- tick

    def _round_logits(self, draft: bool, tokens, pos_b) -> torch.Tensor:
        """One model's multi-query step over the slots → f32 logits [B, S,
        V]; the pools are written in place."""
        params, cfg, layers, pools, shard = self._spec_model(draft)
        if self._kv_pages is None:
            return _multi_step(params, cfg, KVCache(*pools), tokens, pos_b, layers,
                               shard)
        x = self._paged_hidden(draft, tokens, pos_b, self._table_dev)
        return lm_logits(params, cfg, x, shard)

    def _tick_block(self, active: torch.Tensor, chunk=None):
        """``ticks_per_sync`` speculative rounds with the latched done
        mask. Invariant per slot: ``pos`` is the position of ``last_tok``
        (whose k/v the next verify writes), and gen[0 .. pos - P] holds
        the emitted tokens. Returns (done, n_out) [B].

        ``chunk`` (paged chunked mode): (ctok, ctable, cpos, fin_mask,
        fin_row). Its rows (S=1, each through its own table row) go
        through the target's pools and then the draft's before the rounds;
        afterwards token 0 of every slot whose suffix completed is merged
        from the target's chunk logits."""
        B, P, k = self._local_slots, self._prompt_len, self._k
        max_new, eos_id, dev = self._max_new, self._eos_id, self._device
        if chunk is not None:
            ctok, ctable, cpos, fin_mask, fin_row = chunk
            x = self._paged_hidden(False, ctok[:, None], cpos, ctable)
            chunk_logits = lm_logits(self._params, self._cfg, x[:, 0], self._shard)
            self._paged_hidden(True, ctok[:, None], cpos, ctable)
        last_tok, pos, gen = self._last_tok, self._pos, self._gen
        acc, prop, rounds = self._spec_counts
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        cols = torch.arange(max_new, device=dev)[None, :]
        live = []
        for _ in range(self._ticks_per_sync):
            act = active & ~done
            # k+1 draft steps for k proposals (the last only ingests).
            tok, d_toks = last_tok, []
            for j in range(k + 1):
                logits = self._round_logits(True, tok[:, None], pos + j)
                tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
                d_toks.append(tok)
            d = torch.stack(d_toks[:k], dim=1)  # [B, k]
            v_in = torch.cat([last_tok[:, None], d], dim=1)  # [B, k+1]
            t_logits = self._round_logits(False, v_in, pos)
            n_acc, corr = accept(torch.argmax(t_logits, dim=-1).to(torch.int32), d)

            # Emit the accepted drafts then the correction/bonus: k+1
            # masked one-hot writes, stopping past the accepted length
            # (j > n_acc), past the buffer (j >= rem) or after an EOS
            # earlier in the round (alive). EOS counts on decode outputs
            # only (gen index >= 1 holds here) and is itself emitted.
            emitted_before = pos - P + 1
            rem = max_new - emitted_before
            alive = act
            n_emit = torch.zeros_like(pos)
            new_last = last_tok
            eos_hit = torch.zeros_like(act)
            for j in range(k + 1):
                tok_j = d[:, j] if j < k else corr
                tok_j = torch.where(j < n_acc, tok_j, corr)
                emit = alive & (j <= n_acc) & (j < rem)
                sel = (cols == (emitted_before + j)[:, None]) & emit[:, None]
                gen = torch.where(sel, tok_j[:, None], gen)
                n_emit = n_emit + emit.to(torch.int32)
                new_last = torch.where(emit, tok_j, new_last)
                if eos_id is not None:
                    hit = emit & (tok_j == eos_id)
                    eos_hit = eos_hit | hit
                    alive = alive & ~hit
            emitted_after = emitted_before + n_emit
            done_now = act & (eos_hit | (emitted_after >= max_new))
            n_out = torch.where(done_now, emitted_after, n_out)
            pos = torch.where(act & ~done_now, pos + n_emit, pos)
            last_tok = torch.where(act, new_last, last_tok)
            # Counted over live rounds only: warmup's all-inactive rounds
            # propose nothing.
            n_act = act.sum()
            acc = acc + torch.where(act, n_acc, 0).sum()
            prop = prop + k * n_act
            rounds = rounds + (n_act > 0)
            live.append(n_act > 0)
            done = done | done_now
        self._spec_counts = (acc, prop, rounds)
        self._live = torch.stack(live)
        if chunk is not None:
            last_tok, pos, gen = self._merge_chunk_token0(
                chunk_logits, fin_mask, fin_row, last_tok, pos, gen
            )
        self._last_tok, self._pos, self._gen = last_tok, pos, gen
        return done, n_out

    def _tick_state(self) -> list[torch.Tensor]:
        """The inherited tick state plus the speculation counters, which
        the rounds also rebind: ``decode_roofline`` (inherited, as in the
        JAX package, with target-only byte accounting) runs live rounds
        and so advances them, as the JAX server's probe does."""
        return super()._tick_state() + list(self._spec_counts) + [self._live]

    def _set_tick_state(self, state: list[torch.Tensor]) -> None:
        super()._set_tick_state(state[:3])
        self._spec_counts = tuple(state[3:6])
        self._live = state[6]

    def _block_record(self) -> list[torch.Tensor]:
        """This rank's liveness of the block's rounds, on each of its slot
        rows: [local slots, ticks_per_sync] int32."""
        return [self._live.to(torch.int32)[None, :].expand(self._local_slots, -1)]

    def _note_block_record(self, cols: np.ndarray) -> None:
        """A round is live if any slot of the whole batch is: the OR over
        every rank's rows."""
        self._live_rounds += int(cols.any(axis=0).sum())

    # ---------------------------------------------------------- lifecycle

    def swap_draft_params(self, draft_params, draft_cfg=None) -> None:
        """Hot-swap the DRAFT weights between ticks. The draft only
        proposes and the target's verify decides every committed token,
        so a swap changes the acceptance, never the output, and needs no
        quiescing. The draft must keep its structure: ``draft_cfg`` (when
        given) its n_layers, vocab and width, the tree its nested keys
        and leaf kinds (``ValueError`` otherwise)."""
        cur = self._draft_cfg
        if draft_cfg is not None and (
            draft_cfg.n_layers != cur.n_layers
            or draft_cfg.vocab_size != cur.vocab_size
            or draft_cfg.d_model != cur.d_model
        ):
            raise ValueError(
                "swap_draft_params requires a structurally identical "
                "draft (the pools are shaped for it); rebuild the "
                "generator for a different draft geometry"
            )
        old = tree_flatten(self._draft_params)[1]
        new = tree_flatten(draft_params)[1]
        if old != new:
            raise ValueError(f"draft tree structure mismatch: {new} != {old}")
        draft_params = _params_to(draft_params, self._device)
        # Death here (the candidate fetched and validated, not yet bound)
        # must be invisible in committed output: the incumbent draft still
        # proposes on restart, and either draft yields the target's tokens.
        crash_hook("draft_swap_pre_apply")
        self._bind_draft(draft_params)
        self._block_graph = None  # a captured block reads the old draft

    def spec_stats(self) -> dict:
        """The speculation counters since construction, read with one
        device-to-host copy. ``acceptance`` is the realized α =
        accepted / proposed (None before any proposal); warmup's
        all-inactive rounds count nothing. Under a mesh that splits the
        slots over data, the data ranks' proposals and acceptances are
        summed (a collective: every rank calls it together), and the rounds
        are those in which any slot of the whole batch was live (counted at
        each tick block's sync, ``_note_block_record``)."""
        counts = torch.stack(self._spec_counts)
        split = self._local_slots != self._slots
        if split:
            counts = self._shard.gather_rows(counts[None]).sum(0)  # [data, 3] summed
        acc, prop, rounds = (int(x) for x in counts.cpu())
        if split:
            rounds = self._live_rounds
        return {
            "rounds": rounds,
            "proposed": prop,
            "accepted": acc,
            "acceptance": round(acc / prop, 4) if prop else None,
            "k": self._k,
            "draft_layers": self._draft_cfg.n_layers,
        }
