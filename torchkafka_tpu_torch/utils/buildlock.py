"""One build at a time across processes.

Ranks of a job, or worker processes started together, all load the same
libraries at first use. Each loader takes ``build_lock(directory)`` before
it builds, and checks again under the lock whether the library is there:
the first process builds, the others wait and then load that file. The
lock is ``fcntl.flock`` on the directory itself (no lock file is left in
it), which the kernel releases when its holder exits, however it exits,
so a killed build leaves no stale lock behind.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def build_lock(directory: Path) -> Iterator[None]:
    """Hold the exclusive build lock of ``directory`` (created if needed)."""
    directory.mkdir(parents=True, exist_ok=True)
    fd = os.open(directory, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
