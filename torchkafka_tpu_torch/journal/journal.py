"""Decode journal: the minimal resumable state of in-flight generations.

The fleet's failover story before this module was COLD: a killed
replica's uncommitted prompts redeliver and their decodes restart from
token 0 — correct (at-least-once) but wasteful, and the waste grows with
completion length. The journal records, per in-flight slot, just enough
to WARM-resume a generation on another replica (or a restarted process):

- the prompt record's identity (topic/partition/offset) plus a CRC of its
  payload (so a hint is never applied to a different record that happens
  to share an offset after topic recreation);
- the sampling contract (temperature/top_k/top_p) and the per-record RNG
  key the server derived at admit time — serve.py's per-(record, token)
  key discipline is what makes a resumed continuation token-exact;
- the tokens emitted so far (refreshed every ``cadence`` tokens, and
  always at admit and at finish).

On redelivery the resuming server prefills ``prompt + emitted_tokens`` in
ONE dispatch (a radix-cache hit when ``kv_pages`` is on, a plain longer
prefill when off) and continues decoding from the journaled position —
so the tokens re-decoded after a death are bounded by the journal cadence
instead of the whole completion, and a FINISHED-but-uncommitted entry is
served straight from the journal with zero re-decode.

Durability discipline: every flush writes the ENTIRE live-entry set
tmp → fsync → rename, so a torn write leaves the previous complete
journal visible and a partial tmp that recovery never reads
(``journal_mid_write`` in the crash matrix kills inside the tmp write to
pin exactly this). Entries for records covered by a successful offset
commit are pruned at commit flush, so the file is bounded by in-flight
work — never by history.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from dataclasses import dataclass, field

from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.records import Record, TopicPartition

_logger = logging.getLogger(__name__)

_VERSION = 1


def value_crc(value: bytes | None) -> int:
    return zlib.crc32(value or b"") & 0xFFFFFFFF


@dataclass
class JournalEntry:
    """One in-flight (or finished-uncommitted) generation's resumable
    state. ``tokens`` includes token 0 (the admit sample) onward; an
    admit-time entry has ``tokens == ()`` — resumable only as a cold
    admission, but its presence still proves the record was in flight."""

    topic: str
    partition: int
    offset: int
    crc: int
    key_data: tuple[int, ...] | None
    temperature: float
    top_k: int | None
    top_p: float | None
    tokens: tuple[int, ...] = ()
    finished: bool = False
    # Which model version produced the journaled tokens. A warm resume
    # only applies a hint when the server's live version matches — a
    # token prefix decoded under v0 continued under v1 would NOT be
    # byte-identical to either reference, so version-mismatched hints
    # fall back to a cold (still exactly-once) replay.
    model_version: int = 0

    @property
    def key(self) -> tuple[str, int, int]:
        return (self.topic, self.partition, self.offset)

    def to_json(self) -> dict:
        return {
            "t": self.topic,
            "p": self.partition,
            "o": self.offset,
            "crc": self.crc,
            "rng": list(self.key_data) if self.key_data is not None else None,
            "temp": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "toks": list(self.tokens),
            "fin": self.finished,
            "mv": self.model_version,
        }

    @classmethod
    def from_json(cls, d: dict) -> "JournalEntry":
        return cls(
            topic=str(d["t"]),
            partition=int(d["p"]),
            offset=int(d["o"]),
            crc=int(d["crc"]),
            key_data=(
                tuple(int(x) for x in d["rng"])
                if d.get("rng") is not None else None
            ),
            temperature=float(d["temp"]),
            top_k=None if d.get("top_k") is None else int(d["top_k"]),
            top_p=None if d.get("top_p") is None else float(d["top_p"]),
            tokens=tuple(int(x) for x in d.get("toks", ())),
            finished=bool(d.get("fin", False)),
            model_version=int(d.get("mv", 0)),
        )


@dataclass
class _Stats:
    writes: int = 0
    pruned: int = 0
    bytes_last_write: int = 0


class DecodeJournal:
    """Tmp-fsync-rename journal of live generation entries.

    ``cadence``: tokens between progress refreshes per slot (the server
    owns the counting; the journal just stores the knob so the fleet can
    construct replicas uniformly). ``fsync=False`` trades the torn-write
    guarantee for speed — benchmarks only, never correctness runs."""

    def __init__(self, path: str | os.PathLike, *, cadence: int = 8,
                 fsync: bool = True, lock: bool = True) -> None:
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1 token, got {cadence}")
        self._path = os.fspath(path)
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        self.cadence = cadence
        self._fsync = fsync
        self._entries: dict[tuple[str, int, int], JournalEntry] = {}
        self._dirty = False
        self._closed = False
        # The model version this incarnation serves — journal-level meta
        # written in every flush. The swap protocol writes the NEW
        # version (durably, while the entry set is empty) BEFORE the
        # in-memory rebind, so a recovery after SIGKILL-mid-swap reads
        # load_meta() and restores exactly the weights whose outputs the
        # committed view already attributes to this member.
        self.model_version = 0
        self.stats = _Stats()
        # Single-writer discipline across PROCESSES: a journal file is one
        # replica incarnation's private state; two live writers would
        # interleave tmp-renames and hand survivors a chimera. The lock
        # file carries the owner pid — a dead owner's lock (SIGKILL never
        # cleans up) or our own is stale and silently stolen.
        self._lock_held = False
        if lock:
            self._acquire_lock()

    def _acquire_lock(self) -> None:
        from torchkafka_tpu_torch.errors import JournalLockedError

        lock_path = self._path + ".lock"
        my_pid = os.getpid()
        for _ in range(2):
            try:
                fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(str(my_pid))
                self._lock_held = True
                return
            except FileExistsError:
                try:
                    with open(lock_path) as f:
                        owner = int(f.read().strip() or "0")
                except (OSError, ValueError):
                    owner = 0
                stale = owner == 0 or owner == my_pid
                if not stale:
                    try:
                        os.kill(owner, 0)  # signal 0: existence probe only
                    except ProcessLookupError:
                        stale = True
                    except PermissionError:
                        pass  # alive, different uid: definitely not ours
                if not stale:
                    raise JournalLockedError(
                        f"decode journal {self._path!r} is owned by live "
                        f"process {owner}; journals are single-writer — "
                        "give each replica incarnation its own path"
                    )
                try:
                    os.unlink(lock_path)
                except FileNotFoundError:
                    pass
        raise JournalLockedError(
            f"could not acquire journal lock {lock_path!r} (contended)"
        )

    def _release_lock(self) -> None:
        if not self._lock_held:
            return
        self._lock_held = False
        try:
            os.unlink(self._path + ".lock")
        except OSError:
            pass

    @property
    def path(self) -> str:
        return self._path

    # ------------------------------------------------------------- recording

    def record(
        self,
        record: Record,
        key_data,
        *,
        tokens=(),
        finished: bool = False,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        model_version: int = 0,
    ) -> None:
        """Upsert the entry for ``record`` (admit / progress / adoption
        after a warm resume). Marks the journal dirty; the caller flushes
        at its cadence points."""
        entry = JournalEntry(
            topic=record.topic,
            partition=record.partition,
            offset=record.offset,
            crc=value_crc(record.value),
            key_data=(
                tuple(int(x) for x in key_data)
                if key_data is not None else None
            ),
            temperature=float(temperature),
            top_k=top_k,
            top_p=top_p,
            tokens=tuple(int(t) for t in tokens),
            finished=finished,
            model_version=int(model_version),
        )
        self._entries[entry.key] = entry
        self._dirty = True

    def progress(self, record: Record, tokens) -> None:
        """Refresh an existing entry's emitted tokens (cadence append)."""
        key = (record.topic, record.partition, record.offset)
        entry = self._entries.get(key)
        if entry is None:
            return  # admitted before the journal was attached: nothing to do
        entry.tokens = tuple(int(t) for t in tokens)
        self._dirty = True

    def finish(self, record: Record, tokens) -> None:
        """Mark the record's generation complete with its final tokens —
        always journaled, so a finished-but-uncommitted completion can be
        re-served from the journal with zero re-decode."""
        key = (record.topic, record.partition, record.offset)
        entry = self._entries.get(key)
        if entry is None:
            return
        entry.tokens = tuple(int(t) for t in tokens)
        entry.finished = True
        self._dirty = True

    def prune(self, watermarks: dict[TopicPartition, int]) -> int:
        """Drop entries covered by a successful commit: every entry whose
        offset sits below its partition's committed next-read offset is
        durable history, not in-flight work. Called at commit flush —
        this is what bounds the file by live work (marks dirty only if
        something was actually dropped)."""
        wm = {(tp.topic, tp.partition): off for tp, off in watermarks.items()}
        drop = [
            k for k, e in self._entries.items()
            if e.offset < wm.get((e.topic, e.partition), -1)
        ]
        for k in drop:
            del self._entries[k]
        if drop:
            self._dirty = True
            self.stats.pruned += len(drop)
        return len(drop)

    def set_model_version(self, version: int) -> None:
        """Record the serving model version as journal-level meta. The
        swap protocol calls this (then ``sync()``) while the entry set is
        empty and the commit window is closed — the durable version flip
        IS the swap's commit point: recovery before it restarts on the
        old weights, recovery after it restarts on the new."""
        version = int(version)
        if version != self.model_version:
            self.model_version = version
            self._dirty = True

    # ----------------------------------------------------------- persistence

    def flush(self) -> None:
        """Write the live-entry set if anything changed: full payload to
        ``<path>.tmp``, fsync, atomic rename. A death anywhere inside
        leaves the PREVIOUS journal intact (the crash matrix kills at
        ``journal_mid_write`` to prove it)."""
        if not self._dirty:
            return
        payload = json.dumps({
            "version": _VERSION,
            "cadence": self.cadence,
            "model_version": self.model_version,
            "entries": [e.to_json() for e in self._entries.values()],
        }).encode()
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            # Two-part write around the crash hook: a kill here leaves a
            # torn tmp on disk — exactly the artifact recovery must never
            # read (load() only ever opens the renamed path).
            half = len(payload) // 2
            f.write(payload[:half])
            crash_hook("journal_mid_write")
            f.write(payload[half:])
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._path)
        self._dirty = False
        self.stats.writes += 1
        self.stats.bytes_last_write = len(payload)

    def sync(self) -> None:
        """Unconditional durability point (the SIGTERM drain path): flush
        pending state even if the dirty flag is unset-but-stale-on-disk
        is impossible by construction, so this is flush() plus tolerance
        for being called on a closed journal."""
        if self._closed:
            return
        self.flush()

    def close(self) -> None:
        """Idempotent: the drain path may hit this twice (second signal)."""
        if self._closed:
            return
        try:
            self.flush()
        finally:
            self._closed = True
            self._release_lock()

    # -------------------------------------------------------------- querying

    def live_entries(self) -> dict[tuple[str, int, int], JournalEntry]:
        """The IN-MEMORY entry set (may be ahead of disk by < cadence
        tokens). Failover consults ``load()`` — the disk truth a crash
        leaves behind — not this."""
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def scan_dir(
        journal_dir: str | os.PathLike,
        exclude: tuple[str, ...] = (),
    ) -> dict[tuple[str, int, int], JournalEntry]:
        """Cross-process journal discovery: load EVERY journal file in
        ``journal_dir`` except the caller's own (``exclude`` paths) and
        merge their live entries — what a survivor (or a freshly spawned
        replacement) consults after a peer's death, and what a restarting
        fleet consults for every previous incarnation at once. Entries
        for the same record across files keep the FRESHEST copy
        (finished beats in-flight, more emitted tokens beat fewer) — a
        record that migrated between incarnations leaves a stale shadow
        in the older file. Deterministic: files visited in sorted order,
        and hints are CRC-gated at apply time, so a stale or foreign
        entry can never corrupt a resume. The ``journal_handoff_pre_load``
        crash point pins the window where a loader dies mid-scan: the
        files are read-only here, so the next scan sees identical state."""
        crash_hook("journal_handoff_pre_load")
        journal_dir = os.fspath(journal_dir)
        excluded = {os.path.abspath(os.fspath(p)) for p in exclude}
        merged: dict[tuple[str, int, int], JournalEntry] = {}
        try:
            names = sorted(os.listdir(journal_dir))
        except FileNotFoundError:
            return {}
        for name in names:
            if not name.endswith(".json"):
                continue  # .tmp (torn writes) and .lock files are not journals
            path = os.path.join(journal_dir, name)
            if os.path.abspath(path) in excluded:
                continue
            for key, entry in DecodeJournal.load(path).items():
                old = merged.get(key)
                if old is None or (
                    (entry.finished, len(entry.tokens))
                    > (old.finished, len(old.tokens))
                ):
                    merged[key] = entry
        return merged

    @staticmethod
    def load_meta(path: str | os.PathLike) -> dict:
        """Read a journal file's top-level metadata (notably
        ``model_version``) without materializing entries — what a
        restarting incarnation consults FIRST, so it rebuilds the weights
        its previous life durably committed to before touching any hint.
        Missing or corrupt file → ``{}`` (boot on the spec's version)."""
        path = os.fspath(path)
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            if not isinstance(doc, dict):
                return {}
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as exc:
            _logger.warning(
                "ignoring unreadable decode journal meta %s (%s)", path, exc,
            )
            return {}
        return {k: v for k, v in doc.items() if k != "entries"}

    @staticmethod
    def load(path: str | os.PathLike) -> dict[tuple[str, int, int], JournalEntry]:
        """Read a journal file as a dead process's survivors see it.
        Missing file → no entries (the replica never journaled); a
        corrupt file warns and yields nothing (fail to cold replay,
        never crash recovery) — though corruption is unreachable through
        this module's own writes (rename is atomic)."""
        path = os.fspath(path)
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            entries = [JournalEntry.from_json(d) for d in doc["entries"]]
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, KeyError, TypeError) as exc:
            _logger.warning(
                "ignoring unreadable decode journal %s (%s); affected "
                "prompts will cold-replay", path, exc,
            )
            return {}
        return {e.key: e for e in entries}
