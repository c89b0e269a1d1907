"""Decode journal: per-replica resumable generation state for warm
failover (see journal.py's module docstring for the full design).
``DecodeJournal.scan_dir`` is the cross-process discovery path: a
survivor of a peer's death (or a freshly spawned replacement) merges
every journal file in the shared directory into warm-resume hints."""

from torchkafka_tpu_torch.journal.journal import (
    DecodeJournal,
    JournalEntry,
    value_crc,
)

__all__ = ["DecodeJournal", "JournalEntry", "value_crc"]
