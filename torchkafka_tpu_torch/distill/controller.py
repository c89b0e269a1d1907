"""DistillController — the closed loop's verdict: when does a refreshed
draft actually roll? Port of ``torchkafka_tpu/distill/controller.py``:
``InProcessDistillDriver`` rebuilds a fetched draft onto the serving
device in its dtypes (``source.checkpoint_wire.rebuild_tree``).

The spec servers already count acceptance on-device (accepted /
proposed, ``spec_stats``); the controller turns those CUMULATIVE
counters into a WINDOWED live-α gauge and gates draft refreshes on it:
refresh when (a) a newer draft version than the one applied is
available on the checkpoint plane, (b) the refresh cooldown has elapsed
(hysteresis — a refresh storm cannot thrash the fleet), and (c) either
the windowed α has degraded below ``drop_frac`` of the best window seen
since the last refresh (the drift signal) or ``refresh_on_publish``
says every new version rolls. Decisions are typed on the trace stream
(``draft_refresh``) and the clock is INJECTABLE — under a
``resilience.ManualClock`` the whole loop replays byte-identically,
which is what the hysteresis unit test pins.

Safety is by construction, not policy: ``swap_draft_params`` refreshes
only the PROPOSER — the target's verification commits tokens — so a
mid-serve refresh (no quiesce) can change α, never committed output.
The refresh-under-chaos differential asserts exactly that.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from torchkafka_tpu_torch.errors import CheckpointWireError

_logger = logging.getLogger("torchkafka_tpu_torch.distill")


@dataclasses.dataclass(frozen=True)
class DistillPolicy:
    """Refresh gating knobs.

    ``window_rounds``: serve rounds folded into one α window.
    ``min_proposed``: proposals a window needs before its α counts (a
    near-idle window's α is noise, not signal).
    ``drop_frac``: refresh when α_window < drop_frac × α_best-since-
    last-refresh. 1.0 ⇒ any degradation triggers (given a new version).
    ``cooldown_s``: minimum seconds between APPLIED refreshes — the
    hysteresis floor.
    ``refresh_on_publish``: roll every newer published version once the
    cooldown allows, without requiring an α drop (the "always track the
    trainer" mode the closed-loop demo uses).
    """

    window_rounds: int = 32
    min_proposed: int = 64
    drop_frac: float = 0.8
    cooldown_s: float = 5.0
    refresh_on_publish: bool = False

    def __post_init__(self) -> None:
        if self.window_rounds < 1:
            raise ValueError("window_rounds must be >= 1")
        if self.min_proposed < 1:
            raise ValueError("min_proposed must be >= 1")
        if not 0.0 < self.drop_frac <= 1.0:
            raise ValueError("drop_frac must be in (0, 1]")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")


class DistillController:
    """Windowed α tracking + hysteretic refresh decisions.

    Feed ``note_round`` the fleet's CUMULATIVE accepted/proposed sums
    once per serve round and ``note_version`` each published draft
    version; poll ``maybe_refresh`` for a directive. The caller applies
    the swap and confirms with ``note_applied`` (or ``note_rejected``
    when the fetch-side CRC refused the checkpoint — that version is
    then skipped forever; a clean republish arrives as a NEW version).
    """

    def __init__(
        self,
        policy: DistillPolicy | None = None,
        *,
        applied_version: int = 0,
        clock: Callable[[], float] = time.monotonic,
        tracer=None,
        metrics=None,
    ) -> None:
        self.policy = policy or DistillPolicy()
        self._clock = clock
        self._tracer = tracer
        self._metrics = metrics
        self.applied_version = int(applied_version)
        self.available_version = int(applied_version)
        self.alpha_window: float | None = None  # last CLOSED window's α
        self.alpha_best: float | None = None  # best window since refresh
        self._rounds = 0
        self._win_acc0 = 0  # cumulative counters at the window's open
        self._win_prop0 = 0
        self._last_acc = 0
        self._last_prop = 0
        self._last_refresh_t: float | None = None
        self._rejected: set[int] = set()
        self.refreshes = 0

    # ------------------------------------------------------------ inputs

    def note_round(self, accepted: int, proposed: int) -> None:
        """One serve round's CUMULATIVE fleet counters. Every
        ``window_rounds`` rounds the window closes: if it saw at least
        ``min_proposed`` proposals its α becomes the live gauge (and
        lifts α_best); a sparser window is discarded unmeasured."""
        self._last_acc, self._last_prop = int(accepted), int(proposed)
        self._rounds += 1
        if self._rounds % self.policy.window_rounds:
            return
        d_acc = self._last_acc - self._win_acc0
        d_prop = self._last_prop - self._win_prop0
        self._win_acc0, self._win_prop0 = self._last_acc, self._last_prop
        if d_prop < self.policy.min_proposed:
            return
        self.alpha_window = d_acc / d_prop
        if self.alpha_best is None or self.alpha_window > self.alpha_best:
            self.alpha_best = self.alpha_window
        if self._metrics is not None:
            self._metrics.spec_alpha_window.set(self.alpha_window)

    def note_version(self, version: int) -> None:
        """A draft checkpoint version is available on the plane."""
        if int(version) > self.available_version:
            self.available_version = int(version)

    # ---------------------------------------------------------- verdicts

    def _cooled_down(self) -> bool:
        if self._last_refresh_t is None:
            return True
        return (
            self._clock() - self._last_refresh_t >= self.policy.cooldown_s
        )

    def maybe_refresh(self) -> dict | None:
        """A refresh directive (``{"version", "reason", "alpha"}``) or
        None. Never fires twice for one version, never inside the
        cooldown, never for a CRC-rejected version."""
        v = self.available_version
        if v <= self.applied_version or v in self._rejected:
            return None
        if not self._cooled_down():
            return None
        if self.policy.refresh_on_publish:
            reason = "published"
        else:
            if (
                self.alpha_window is None
                or self.alpha_best is None
                or self.alpha_window
                >= self.policy.drop_frac * self.alpha_best
            ):
                return None
            reason = "alpha_drop"
        return {"version": v, "reason": reason, "alpha": self.alpha_window}

    def note_applied(self, version: int, reason: str = "alpha_drop") -> None:
        """The fleet rebound its drafts to ``version``: stamp the
        cooldown clock and RESET the α baseline — the post-refresh
        windows build a fresh best, so the old draft's peak can't hold
        the new one hostage."""
        self.applied_version = int(version)
        self._last_refresh_t = self._clock()
        self.alpha_best = None
        self.refreshes += 1
        if self._tracer is not None:
            self._tracer.draft_refresh(
                reason, int(version), alpha=self.alpha_window
            )
        if self._metrics is not None:
            self._metrics.draft_refreshes(reason).add(1)
            self._metrics.draft_version.set(float(version))
        _logger.info(
            "draft refreshed to version %d (%s, alpha_window=%s)",
            version, reason, self.alpha_window,
        )

    def note_rejected(self, version: int) -> None:
        """Fetch-side validation refused ``version`` (torn frames, CRC,
        tree drift): skip it permanently — a clean republish is a new
        version — and keep serving the incumbent draft."""
        self._rejected.add(int(version))
        if self._tracer is not None:
            self._tracer.draft_refresh("checkpoint_rejected", int(version))
        if self._metrics is not None:
            self._metrics.draft_refreshes("checkpoint_rejected").add(1)
        _logger.warning(
            "draft version %d rejected by checkpoint validation; "
            "keeping the incumbent", version,
        )


class InProcessDistillDriver:
    """Close the loop against an in-process ``ServingFleet``: per serve
    round, fold every replica's ``spec_stats`` into the controller's
    windowed α, and apply refresh directives by fetching the version
    from the checkpoint topic (CRC-validated against the incumbent
    draft's tree) and ``swap_draft_params``-ing every runnable replica
    between ticks — no quiesce, committed tokens invariant by the
    spec-decode contract.

    Plug ``on_round`` into ``fleet.serve(on_round=...)`` (compose it
    with a workload driver's hook by calling both). Version discovery
    is push-based: the trainer owner calls ``note_version`` (directly
    or via the controller) when a publish lands — the driver adds no
    polling of its own, so a no-trainer run costs two counter reads per
    round.
    """

    def __init__(
        self,
        fleet,
        controller: DistillController,
        *,
        broker=None,
        ckpt_topic: str | None = None,
        versions: dict | None = None,
    ) -> None:
        if (broker is None or ckpt_topic is None) and versions is None:
            raise ValueError(
                "need broker+ckpt_topic (wire delivery) or a versions "
                "dict (in-process delivery)"
            )
        self._fleet = fleet
        self._ctl = controller
        self._broker = broker
        self._ckpt_topic = ckpt_topic
        self._versions = versions

    @property
    def controller(self) -> DistillController:
        return self._ctl

    def note_version(self, version: int) -> None:
        self._ctl.note_version(version)

    def on_round(self, fleet, served: int) -> None:
        acc = prop = 0
        for rep in fleet.replicas:
            if not rep.runnable:
                continue
            stats = rep.gen.spec_stats()
            acc += stats["accepted"]
            prop += stats["proposed"]
        self._ctl.note_round(acc, prop)
        directive = self._ctl.maybe_refresh()
        if directive is not None:
            self._apply(directive)

    def _apply(self, directive: dict) -> None:
        version = directive["version"]
        live = [r for r in self._fleet.replicas if r.runnable]
        if not live:
            return
        try:
            if self._versions is not None:
                draft = self._versions[version]
            else:
                from torchkafka_tpu_torch.source.checkpoint_wire import (
                    fetch_checkpoint,
                    rebuild_tree,
                )

                flat, _manifest = fetch_checkpoint(
                    self._broker, self._ckpt_topic, version
                )
                # The incumbent draft tree is the schema: shape/dtype
                # drift or missing arrays reject BEFORE any swap.
                draft = rebuild_tree(live[0].gen._draft_params, flat)
        except (CheckpointWireError, KeyError):
            self._ctl.note_rejected(version)
            return
        for rep in live:
            rep.gen.swap_draft_params(draft)
            if self._fleet.tracer is not None:
                self._fleet.tracer.draft_swapped(
                    version, member=f"replica-{rep.id}", replica=rep.id
                )
            rep.gen.metrics.draft_version.set(float(version))
            self._fleet.metrics.replica_draft_version(
                f"replica-{rep.id}"
            ).set(float(version))
        self._ctl.note_applied(version, directive["reason"])
