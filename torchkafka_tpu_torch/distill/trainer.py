"""DistillTrainer — fine-tune the speculative draft on live committed
traffic. Port of ``torchkafka_tpu/distill/trainer.py``.

The repo's two halves fused: the TRAINING plane (KafkaStream +
make_train_step, the commit-after-step loop) pointed at the SERVING
plane's own output — the distill topic of committed (prompt, tokens)
frames the exactly-once publisher stages inside its commit windows. The
draft starts as the target's layer-truncated tree
(``models.spec_decode.truncated_draft`` — the same construction
SpecStreamingGenerator self-drafts with, so the trained tree swaps
straight into a serving fleet via ``swap_draft_params`` with zero
recompilation), trains with next-token CE on the committed sequences,
and every ``publish_every`` steps publishes a VERSIONED draft
checkpoint onto the checkpoint topic (``source.checkpoint_wire`` —
CRC'd manifest + chunks, so a torn publish is rejected fetch-side and
the fleet keeps its incumbent).

Determinism contract (the trainer-loop differential test): the stream
runs synchronous (``prefetch=0`` — no threads), the train step is the
port's ``make_train_step`` (AdamW with optax's weight decay of 1e-4),
and the draft init derives from the target — same target + same topic
contents ⇒ the same draft params, step for step. The trainer trains on
the device the target's params live on. At-least-once consumption is SAFE here (unlike serving): a
re-delivered corpus record is just one more gradient sample, so the
trainer commits its offsets after each step and resumes from its own
consumer group's offsets after a crash
(``crash_hook("distill_pre_publish")`` is the matrixed death point —
between a train step and the checkpoint publish, where the loss is
maximal and must still be zero committed-token impact).
"""

from __future__ import annotations

import logging

import torch

from torchkafka_tpu_torch.distill.wire import distill_processor
from torchkafka_tpu_torch.models.spec_decode import truncated_draft
from torchkafka_tpu_torch.models.transformer import make_train_step, shard_params
from torchkafka_tpu_torch.optim import adamw
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.checkpoint_wire import publish_checkpoint
from torchkafka_tpu_torch.utils.tree import tree_leaves, tree_map

_logger = logging.getLogger("torchkafka_tpu_torch.distill")


class DistillTrainer:
    """Consume the distill topic, train the draft, publish versions.

    ``params``/``cfg``: the TARGET model — the draft is derived as its
    ``draft_layers``-truncated tree unless an explicit
    ``draft_params``/``draft_cfg`` pair is given. Weight-sharing note:
    ``truncated_draft`` aliases embed/ln_f/lm_head BY REFERENCE and its
    layers are views of the target's, and the train step updates its
    params IN PLACE — so the trainer clones every draft leaf at init.
    Without the clone, the first step would rewrite the serving target's
    own weights under a live server. ``mesh``: train on a
    ``parallel.make_mesh`` mesh through ``make_train_step(draft_cfg,
    mesh)`` (K1 forward, K2/K3 backward on each rank's share): every rank
    of the mesh builds the trainer with the same arguments, the root alone
    with a consumer (the others pass None; ``parallel.lockstep``), and
    each rank trains on its rows of the root's batches. The root commits
    and publishes; the draft is gathered for a publish on every rank.

    ``publish_every`` > 0: every that-many steps, publish the current
    draft as version ``base_version + publishes-so-far + 1`` onto
    ``ckpt_topic`` (requires ``broker``). Versions are MONOTONIC per
    trainer; a fleet's DistillController refreshes only to versions
    newer than what it applied, so an at-least-once republish after a
    crash is harmless.
    """

    def __init__(
        self,
        consumer,
        params,
        cfg,
        *,
        seq_len: int,
        batch_size: int = 8,
        draft_layers: int | None = None,
        draft_params=None,
        draft_cfg=None,
        mesh=None,
        optimizer=None,
        learning_rate: float = 1e-3,
        broker=None,
        ckpt_topic: str | None = None,
        publish_every: int = 0,
        base_version: int = 0,
        metrics=None,
    ) -> None:
        if publish_every < 0:
            raise ValueError("publish_every must be >= 0")
        if publish_every and (broker is None or ckpt_topic is None):
            raise ValueError(
                "publish_every requires broker and ckpt_topic (the "
                "checkpoint plane the refreshed drafts ship on)"
            )
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError(
                "draft_params and draft_cfg must be given together"
            )
        if mesh is not None:
            from torchkafka_tpu_torch.parallel.lockstep import MeshConsumer

            consumer = (consumer if isinstance(consumer, MeshConsumer)
                        else MeshConsumer(consumer, mesh))
        self._mesh = mesh
        self._consumer = consumer
        self._seq_len = int(seq_len)
        self._batch_size = int(batch_size)
        if draft_params is None:
            n = draft_layers or max(1, cfg.n_layers // 2)
            draft_params, draft_cfg = truncated_draft(params, cfg, n)
        if seq_len > draft_cfg.max_seq_len:
            raise ValueError(
                f"seq_len {seq_len} exceeds draft max_seq_len "
                f"{draft_cfg.max_seq_len}"
            )
        self.draft_cfg = draft_cfg
        optimizer = optimizer or adamw(learning_rate)
        # The draft tree from truncated_draft matches init_params'
        # structure for draft_cfg, so the optimizer inits directly over
        # it — the trained tree stays swap-compatible with a serving
        # SpecStreamingGenerator built on the same geometry. The clone
        # (contiguous, no autograd history) severs the sharing with the
        # target before the first in-place update.
        self.draft_params = tree_map(
            lambda t: t.detach().clone(), draft_params
        )
        self._device = tree_leaves(self.draft_params)[0].device
        _init, self._step_fn = make_train_step(
            draft_cfg, mesh, optimizer=optimizer, device=self._device
        )
        if mesh is not None:
            # The mesh step's parameters: DTensors laid out per
            # param_specs, each rank holding its chunk.
            self.draft_params = shard_params(self.draft_params, draft_cfg, mesh)
        self._opt_state = optimizer.init(self.draft_params)
        self._broker = broker
        self._ckpt_topic = ckpt_topic
        self._publish_every = int(publish_every)
        self._base_version = int(base_version)
        self._metrics = metrics
        self.steps = 0
        self.records = 0
        self.published = 0
        self.last_loss: float | None = None

    @property
    def next_version(self) -> int:
        return self._base_version + self.published + 1

    def publish(self) -> int:
        """Publish the current draft as the next version; returns it.
        The crash point sits BETWEEN the trained state and the publish —
        death here loses at most ``publish_every`` steps of progress
        (the next incarnation re-trains from its committed offsets and
        publishes the same version number), never a committed token."""
        version = self.next_version
        crash_hook("distill_pre_publish")
        params = self.draft_params
        root = True
        if self._mesh is not None:
            from torchkafka_tpu_torch.parallel.lockstep import is_root
            from torchkafka_tpu_torch.parallel.mesh import full_tensor

            params = tree_map(full_tensor, params)  # a collective on every rank
            root = is_root(self._mesh)
        if root:
            publish_checkpoint(
                self._broker, self._ckpt_topic, version, params, kind="draft",
            )
        self.published += 1
        _logger.info(
            "published draft version %d after %d steps", version, self.steps
        )
        return version

    def run(
        self,
        max_steps: int | None = None,
        *,
        idle_timeout_ms: int = 500,
        shutdown=None,
    ) -> dict:
        """Train until the topic idles (``idle_timeout_ms`` with no new
        corpus records), ``max_steps`` land, or ``shutdown`` fires.
        Returns a report dict. Re-entrant: call again to resume on the
        same consumer group offsets — the loop commits after each step
        (commit-after-step, the training plane's standing contract)."""
        from torchkafka_tpu_torch.pipeline.stream import KafkaStream

        steps_in = self.steps
        stream = KafkaStream(
            self._consumer,
            distill_processor(self._seq_len),
            batch_size=self._batch_size,
            device=self._device,
            # Synchronous + padded: no prefetch thread (determinism by
            # construction) and a final ragged batch still trains.
            prefetch=0,
            pad_policy="pad",
            idle_timeout_ms=idle_timeout_ms,
            # An empty poll waits no longer than the idle timeout: the
            # stream's default 100 ms wait would hold a 1 ms pump (the
            # fleet's per-round call) 200 ms on an idle topic.
            poll_timeout_ms=min(100, idle_timeout_ms),
            owns_consumer=False,
            # On a mesh the commit barrier spans the mesh's ranks only (the
            # root commits for them all).
            **({} if self._mesh is None else {"barrier": self._mesh_barrier()}),
        )
        try:
            for batch, token in stream:
                if shutdown is not None and getattr(
                    shutdown, "requested", False
                ):
                    break
                tokens = batch.data["tokens"]
                # Row mask: frame-level positions AND batch padding rows.
                rows = torch.arange(tokens.shape[0], device=tokens.device)
                mask = batch.data["mask"] * (
                    rows < batch.valid_count
                ).to(batch.data["mask"].dtype)[:, None]
                if self._mesh is not None:
                    # Every rank holds the whole batch (the root's polls);
                    # the mesh step takes this rank's rows of it.
                    tokens, mask = self._rank_rows(tokens), self._rank_rows(mask)
                self.draft_params, self._opt_state, loss = self._step_fn(
                    self.draft_params, self._opt_state, tokens, mask
                )
                token.commit(wait_for=loss)
                self.steps += 1
                self.records += int(batch.valid_count)
                self.last_loss = float(loss)
                if self._metrics is not None:
                    self._metrics.distill_steps.add(1)
                    self._metrics.distill_records.add(int(batch.valid_count))
                if (
                    self._publish_every
                    and self.steps % self._publish_every == 0
                ):
                    self.publish()
                if max_steps is not None and (
                    self.steps - steps_in
                ) >= max_steps:
                    break
        finally:
            stream.close()
        return self.report()

    def _mesh_barrier(self):
        from torchkafka_tpu_torch.commit import CommitBarrier
        from torchkafka_tpu_torch.parallel.lockstep import mesh_barrier

        return CommitBarrier(sync=lambda: mesh_barrier(self._mesh))

    def _rank_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch: split over data x fsdp,
        data-major, as ``parallel.mesh.global_batch`` lays ranks out."""
        sizes = dict(zip(self._mesh.mesh_dim_names, self._mesh.mesh.shape))
        coords = dict(zip(self._mesh.mesh_dim_names, self._mesh.get_coordinate()))
        n, i = 1, 0
        for a in ("data", "fsdp"):
            if a in sizes:
                i, n = i * sizes[a] + coords[a], n * sizes[a]
        if t.shape[0] % n:
            raise ValueError(f"batch_size {t.shape[0]} does not split over the "
                             f"mesh's {n} batch ranks")
        b = t.shape[0] // n
        return t[i * b:(i + 1) * b]

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "records": self.records,
            "published": self.published,
            "next_version": self.next_version,
            "loss": self.last_loss,
            "draft_layers": self.draft_cfg.n_layers,
        }
