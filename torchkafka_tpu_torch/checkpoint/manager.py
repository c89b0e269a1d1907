"""Atomic (train-state, stream-offset) checkpointing.

Port of ``torchkafka_tpu/checkpoint/manager.py``. The state goes through
``torch.save`` (tensors moved to host memory first) instead of Orbax; the
offsets files are written by the same code as the JAX package's, so a
``stream_offsets*.json`` from either package reads in the other, byte for
byte. ``process_index``/``process_count`` come from an initialised
``torch.distributed`` group, else 0/1. Multi-process saves (a pod writing
one offsets file per process under barriers) are not ported yet and raise
``NotImplementedError``; restoring a pod checkpoint's merged watermark is.

What follows is the JAX package's design note, which holds for the port.

The reference's resume story is "committed Kafka offsets ARE the state"
(SURVEY.md §5 checkpoint row: restart with the same group_id ⇒ resume at the
last commit, /root/reference/README.md:92-96) — sufficient when the consumer
is stateless. A training consumer is not: its model/optimizer state must
advance in lockstep with the stream position, or a restart replays records
into a newer model (or skips records an older model never saw).

``StreamCheckpointer`` fixes the pairing the way SURVEY.md §5 prescribes:
every checkpoint atomically contains BOTH the train-state pytree (Orbax,
which writes tmp-then-rename, so a torn save is invisible) AND the offset
watermark of exactly the batches included in that state (the CommitToken's
offsets). ``restore`` hands both back; ``resume`` additionally seeks the
consumer so the stream continues from the checkpoint — even if the Kafka
group's committed offsets ran ahead (a later commit happened, then the host
died before saving) or behind (checkpoint saved, commit failed). Either way,
state and stream agree afterwards; with commits also barrier-gated, the loss
window is zero and the duplicate window is at most the batches between the
checkpoint and the crash (at-least-once, same contract as the reference).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Mapping

import shutil
import threading

import torch

from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.consumer import Consumer
from torchkafka_tpu_torch.source.records import TopicPartition
from torchkafka_tpu_torch.utils.tree import tree_map

logger = logging.getLogger(__name__)

_OFFSETS_FILE = "stream_offsets.json"
_STATE_FILE = "state.pt"


def _process() -> tuple[int, int]:
    """(process_index, process_count) of the torch.distributed group, or
    (0, 1) outside one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_host(state: Any) -> Any:
    """A snapshot of ``state`` in host memory: every tensor leaf copied
    (detached), so later in-place updates cannot tear the checkpoint."""
    return tree_map(
        lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x,
        state,
    )


def _pod_save_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "multi-process checkpoint saves are not ported yet (ROADMAP Queue A, "
        "slice 4: mesh and multi-process paths)"
    )


def _offsets_file(pid: int, multi: bool) -> str:
    """Single-process keeps the historical name; each pod process writes its
    own file (every host owns different partitions)."""
    return f"stream_offsets_{pid}.json" if multi else _OFFSETS_FILE


def _offsets_files(path: str) -> list[str]:
    """Every offsets file in a checkpoint dir — the single-process file
    and/or one per pod process. Restore merges ALL of them: partitions are
    disjoint across processes at save time, and the union is the pod-global
    watermark, which is what makes resuming at a DIFFERENT process count
    (elastic rescale) correct — a new process's assignment may include
    partitions a different old process checkpointed."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    return sorted(
        os.path.join(path, n)
        for n in names
        if n == _OFFSETS_FILE
        or (n.startswith("stream_offsets_") and n.endswith(".json"))
    )


def _read_offsets_metas(path: str) -> list[dict]:
    """Parse every offsets file in a checkpoint dir. A single corrupt or
    oddly-named file marks THIS dir damaged (it is excluded from
    auto-selection via ``_pod_complete``) instead of raising — ``steps()``
    scans every checkpoint, so one torn write must not brick discovery and
    GC of all the healthy ones (ADVICE r2)."""
    metas = []
    for offsets_path in _offsets_files(path):
        try:
            with open(offsets_path) as f:
                meta = json.load(f)
            if not isinstance(meta, dict):
                raise ValueError(f"offsets file is not a JSON object: {meta!r}")
            if "process_index" not in meta:
                # Pre-metadata files: recover the index from the filename.
                name = os.path.basename(offsets_path)
                if name != _OFFSETS_FILE:
                    meta["process_index"] = int(
                        name[len("stream_offsets_"):-len(".json")]
                    )
        except (OSError, ValueError) as exc:  # json.JSONDecodeError ⊂ ValueError
            logger.warning(
                "skipping damaged offsets file %s: %s", offsets_path, exc
            )
            return [{"damaged": True}]
        metas.append(meta)
    return metas


def _pod_complete(metas: list[dict]) -> bool:
    """A pod save of N processes is complete when all N distinct
    per-process files are present. File COUNT is not enough: a stale
    single-process file alongside N-1 per-process files would count to N
    while a partition's watermark is silently missing."""
    if any(m.get("damaged") for m in metas):
        return False
    pod = [m for m in metas if int(m.get("process_count", 1)) > 1]
    if not pod:
        return bool(metas)
    saved_count = max(int(m["process_count"]) for m in pod)
    indexes = {int(m["process_index"]) for m in pod if "process_index" in m}
    return len(indexes) >= saved_count


def _encode_offsets(offsets: Mapping[TopicPartition, int]) -> dict[str, int]:
    return {f"{tp.topic}\x00{tp.partition}": int(off) for tp, off in offsets.items()}


def _decode_offsets(raw: Mapping[str, int]) -> dict[TopicPartition, int]:
    out: dict[TopicPartition, int] = {}
    for key, off in raw.items():
        topic, _, part = key.rpartition("\x00")
        out[TopicPartition(topic, int(part))] = int(off)
    return out


class StreamCheckpointer:
    """Checkpoints of (state pytree, offset watermark).

    Layout: ``<root>/<step>/state.pt`` (``torch.save`` of the state with
    every tensor in host memory) + ``<root>/<step>/stream_offsets.json``,
    committed by a final atomic rename of the step directory — a crash
    mid-save leaves only a ``.tmp`` directory that ``latest_step`` ignores.
    The state is any tree of dicts, lists, tuples, tensors and plain
    values (e.g. ``{"params": params, "opt": opt_state.optimizer.state_dict()}``).
    """

    def __init__(self, root: str | os.PathLike, *, keep: int = 3) -> None:
        self._root = os.path.abspath(os.fspath(root))
        os.makedirs(self._root, exist_ok=True)
        self._keep = keep
        self._pending = None  # in-flight save_async writer thread
        self._pending_error: BaseException | None = None

    # ------------------------------------------------------------------ save

    def save(
        self,
        step: int,
        state: Any,
        offsets: Mapping[TopicPartition, int],
    ) -> str:
        """Persist ``state`` + ``offsets`` as checkpoint ``step``.

        ``offsets`` is normally ``token.offsets`` of the LAST batch folded
        into ``state`` — i.e. commit watermark and weights describe the same
        records.
        """
        # The caller has typically just committed the offsets this save
        # pairs with: death between that commit and this save means the
        # checkpoint on disk is OLDER than the commit log — resume must
        # seek back to the checkpoint's watermark (re-consuming, never
        # losing). The crash matrix kills here to pin that.
        crash_hook("post_commit_pre_checkpoint")
        self.wait_until_finished()  # serialize after any async save
        pid, count = _process()
        if count > 1:
            raise _pod_save_not_ported()
        final = os.path.join(self._root, str(step))
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._write_state(tmp, _to_host(state))
        self._write_offsets(tmp, pid, False, step, offsets)
        # Payload and offsets written, the atomic rename NOT yet done:
        # death here leaves a ``.tmp`` step that steps()/restore must
        # never see (restore(step=None) falls back to the newest
        # COMPLETE step).
        crash_hook("checkpoint_mid_write")
        self._commit_rename(tmp, final)
        logger.info("checkpoint %d saved (%d partitions)", step, len(offsets))
        return final

    def save_async(
        self,
        step: int,
        state: Any,
        offsets: Mapping[TopicPartition, int],
    ) -> None:
        """Non-blocking ``save``: snapshot the state to host memory, then
        return; a writer thread writes the files and performs the atomic
        rename. The training loop keeps stepping while the checkpoint
        drains; the snapshot is a copy, so later parameter updates cannot
        tear it.

        Serialization: a second ``save_async`` (or ``save``) first waits
        for the previous one, so checkpoints commit in step order. Call
        ``wait_until_finished()`` before reading ``steps()``/``restore()``
        if you need the async save visible. On a pod this falls back to
        the synchronous path in the JAX package; multi-process saves are
        not ported yet and raise."""
        if _process()[1] > 1:
            raise _pod_save_not_ported()
        self.wait_until_finished()
        final = os.path.join(self._root, str(step))
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        # The host snapshot is taken HERE, before returning: the caller's
        # next in-place update cannot tear the checkpoint. Only the file
        # writes and the rename run on the writer thread.
        host_state = _to_host(state)

        def _write() -> None:
            try:
                self._write_state(tmp, host_state)
                self._write_offsets(tmp, 0, False, step, offsets)
                # Same torn window as the sync path: everything written,
                # rename pending.
                crash_hook("checkpoint_mid_write")
                self._commit_rename(tmp, final)
                logger.info("async checkpoint %d committed", step)
            except BaseException as e:  # noqa: BLE001 - re-raised on join
                self._pending_error = e

        self._pending = threading.Thread(
            target=_write, name=f"ckpt-write-{step}", daemon=True
        )
        self._pending.start()

    def wait_until_finished(self) -> None:
        """Block until any in-flight ``save_async`` has fully committed.
        Re-raises the finalizer's failure — a checkpoint that failed to
        commit must not look durable."""
        pending = getattr(self, "_pending", None)
        if pending is not None:
            pending.join()
            self._pending = None
        err = getattr(self, "_pending_error", None)
        if err is not None:
            self._pending_error = None
            raise RuntimeError("async checkpoint failed to commit") from err

    @staticmethod
    def _write_state(tmp: str, host_state: Any) -> None:
        os.makedirs(tmp, exist_ok=True)
        path = os.path.join(tmp, _STATE_FILE)
        with open(path, "wb") as f:
            torch.save(host_state, f)
            f.flush()
            os.fsync(f.fileno())

    def _write_offsets(
        self,
        tmp: str,
        pid: int,
        multi: bool,
        step: int,
        offsets: Mapping[TopicPartition, int],
    ) -> None:
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, _offsets_file(pid, multi)), "w") as f:
            json.dump(
                {
                    "step": step,
                    "process_index": pid,
                    "process_count": _process()[1],
                    "offsets": _encode_offsets(offsets),
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())

    def _commit_rename(self, tmp: str, final: str) -> None:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic commit point
        self._gc()

    def _gc(self) -> None:
        """Prune every checkpoint dir older than the keep-th newest COMPLETE
        step — including damaged/incomplete dirs (excluded from ``steps()``,
        they would otherwise leak their state payloads forever). A
        damaged dir NEWER than the kept floor survives for forensics until
        newer complete saves age it out. Deleting an aged-out damaged dir is
        the same retention policy as for healthy ones: had its offsets file
        been intact, age-based GC would prune the dir at this point anyway,
        and ``keep`` newer complete checkpoints exist by construction —
        GC runs ONLY once that many complete steps exist (ADVICE r3: the
        early regime used the oldest complete step as the floor, pruning
        forensic dirs sooner than this docstring promised)."""
        if not self._keep:
            return
        steps = self.steps()
        if len(steps) < self._keep:
            return
        keep_floor = steps[-self._keep]
        for name in os.listdir(self._root):
            if name.isdigit() and int(name) < keep_floor:
                shutil.rmtree(os.path.join(self._root, name), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def steps(self) -> list[int]:
        """Steps with COMPLETE offsets state. An incomplete pod checkpoint
        (a per-process file lost in a copy/prune) is excluded, so
        auto-selection (``restore(step=None)``) falls back to the newest
        restorable checkpoint instead of bricking resume; restoring an
        incomplete step EXPLICITLY still fails loudly in ``restore``."""
        out = []
        for name in os.listdir(self._root):
            if name.isdigit() and _pod_complete(
                _read_offsets_metas(os.path.join(self._root, name))
            ):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self, step: int | None = None, *, template: Any | None = None
    ) -> tuple[Any, dict[TopicPartition, int], int]:
        """→ (state, offsets, step). ``template``: a tree of the same
        structure whose tensor leaves give each restored tensor its device
        and dtype (e.g. the live parameters); without one the state comes
        back in host memory.

        ``offsets`` is the POD-GLOBAL watermark: the union of every
        process's offsets file in the checkpoint. Partitions are disjoint
        across processes at save time, so the union is exact; merging (not
        picking the caller's own file) is what makes restoring at a
        different process count — elastic rescale — correct, since the new
        assignment need not match the old one. On the off chance two files
        overlap on a partition (a save written twice across a topology
        change), the SMALLER watermark wins: seeking too far forward would
        skip records, while re-delivery is the at-least-once contract."""
        self.wait_until_finished()  # make any in-flight async save visible
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._root}")
        path = os.path.join(self._root, str(step))
        # Validate the offsets state BEFORE the (potentially minutes-long)
        # state restore, and distinguish torn files from lost ones so
        # the operator chases the right failure.
        metas = _read_offsets_metas(path)
        if not metas:
            raise FileNotFoundError(f"no offsets file in {path}")
        if any(m.get("damaged") for m in metas):
            raise FileNotFoundError(
                f"damaged checkpoint in {path}: an offsets file exists but "
                "failed to parse (torn write?) — see the logged warning"
            )
        if not _pod_complete(metas):
            # An incomplete pod checkpoint (a per-process file lost in a
            # copy/prune) would restore a PARTIAL watermark: the missing
            # partitions silently fall back to the group's committed
            # offsets, which may be ahead — skipping records the restored
            # state never saw. Fail loudly instead.
            raise FileNotFoundError(
                f"incomplete pod checkpoint in {path}: missing per-process "
                "offsets files for the recorded process_count"
            )
        with open(os.path.join(path, _STATE_FILE), "rb") as f:
            state = torch.load(f, map_location="cpu", weights_only=True)
        if template is not None:
            state = tree_map(
                lambda x, ref: x.to(ref.device, ref.dtype)
                if isinstance(ref, torch.Tensor) else x,
                state, template,
            )
        merged: dict[TopicPartition, int] = {}
        for meta in metas:
            for tp, off in _decode_offsets(meta["offsets"]).items():
                merged[tp] = min(off, merged.get(tp, off))
        return state, merged, step

    def resume(
        self,
        consumer: Consumer,
        step: int | None = None,
        *,
        template: Any | None = None,
    ) -> tuple[Any, int]:
        """Restore AND align the consumer: seek every checkpointed partition
        this process is assigned to its saved watermark, so the next poll
        continues exactly where the restored state left off (regardless of
        the group's committed offsets). → (state, step).

        The restored watermark is pod-global (see ``restore``), so this
        works across rescales: each process of the NEW topology seeks the
        subset of partitions it now owns, whichever old process saved them.
        Partitions owned by peers are skipped silently on a pod; on a
        single process they are real orphans and warn."""
        state, offsets, step = self.restore(step, template=template)
        assigned = set(consumer.assignment())
        elsewhere = 0
        for tp, off in offsets.items():
            if tp in assigned:
                consumer.seek(tp, off)
            elif _process()[1] > 1:
                elsewhere += 1
            else:
                logger.warning(
                    "checkpointed partition %s not in current assignment; "
                    "its owner must resume it", tp,
                )
        if elsewhere:
            logger.info(
                "%d checkpointed partitions assigned to peer processes", elsewhere
            )
        return state, step
