"""Cooperative preemption drain: SIGTERM → finish the step, commit, exit.

Copy of ``torchkafka_tpu/utils/shutdown.py``, imports re-rooted.

The zero-loss story on host preemption never depended on this module: an
uncommitted batch simply re-delivers (the reference's core contract,
/root/reference/src/kafka_dataset.py:89 — never commit on teardown). What
a hard kill costs is DUPLICATE work: everything since the last commit
replays. TPU preemption notices (maintenance events, spot reclaims) arrive
as SIGTERM with a grace window, so a training loop that drains
cooperatively — finish the in-flight step, commit its offsets, checkpoint
— resumes with zero replay instead of a commit-cadence's worth.

Usage::

    with ShutdownSignal() as stop:
        for batch, token in stream:
            ...step...
            token.commit(wait_for=loss)
            if stop.requested:          # SIGTERM arrived mid-step
                ckpt.save(step, state, token.offsets)
                break                   # clean exit; nothing replays

The handler only sets a flag — all draining happens at the loop's own
safe point, the same deferred-commit discipline the reference used for
its worker signals (/root/reference/src/kafka_dataset.py:93-118, where
the handler also only sets ``_commit_required``). A SECOND signal while
draining re-raises the default behavior (so a stuck drain can still be
killed, and the at-least-once contract covers the replay).
"""

from __future__ import annotations

import logging
import signal as _signal
import threading
from types import FrameType

logger = logging.getLogger(__name__)


class ShutdownSignal:
    """Context manager installing set-a-flag handlers for ``signals``.

    Main-thread only (CPython restricts ``signal.signal`` to the main
    thread); entering from another thread raises. Re-entrant installs are
    rejected — nesting would silently drop the outer drain."""

    def __init__(self, signals=(_signal.SIGTERM, _signal.SIGINT)) -> None:
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._saved: dict[int, object] = {}
        self._received: int | None = None

    @property
    def requested(self) -> bool:
        """True once any registered signal has arrived."""
        return self._event.is_set()

    @property
    def received_signal(self) -> int | None:
        return self._received

    def _handle(self, signum: int, frame: FrameType | None) -> None:
        if self._event.is_set():
            # Second signal while draining: restore default and re-raise
            # so a wedged drain is still killable. Nothing was committed
            # for unfinished work, so the replay contract covers it.
            logger.warning(
                "second signal %d during drain; restoring default handler",
                signum,
            )
            # UNCONDITIONALLY the default action — restoring a saved
            # SIG_IGN (background jobs inherit SIGINT=SIG_IGN) would make
            # the re-raise a no-op and the "kill a stuck drain" promise
            # silently fail. __exit__ still restores the saved handler on
            # the normal path.
            _signal.signal(signum, _signal.SIG_DFL)
            _signal.raise_signal(signum)
            return
        self._received = signum
        self._event.set()
        logger.info(
            "signal %d received; draining at the next loop safe point "
            "(commit-then-exit — a second signal kills immediately)",
            signum,
        )

    def __enter__(self) -> "ShutdownSignal":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("ShutdownSignal must be entered on the main thread")
        if self._saved:
            raise RuntimeError("ShutdownSignal is not re-entrant")
        # Fresh state per with-block: a reused instance must not report a
        # PREVIOUS run's signal as an immediate drain request.
        self._event.clear()
        self._received = None
        try:
            for s in self._signals:
                self._saved[s] = _signal.getsignal(s)
                _signal.signal(s, self._handle)
        except BaseException:
            # Partial install (an invalid signal later in the tuple) must
            # not leak handlers pointing at an orphaned instance — roll
            # back what was installed, leave the instance reusable.
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._saved.items():
            # None = handler installed by non-Python code; SIG_DFL is the
            # closest restorable behavior (signal.signal rejects None).
            _signal.signal(s, old or _signal.SIG_DFL)  # type: ignore[arg-type]
        self._saved.clear()
