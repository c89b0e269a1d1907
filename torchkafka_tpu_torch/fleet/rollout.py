"""Rolling weight hot-swap: canary shadow-serving, drain-swap, rollback.
Port of ``torchkafka_tpu/fleet/rollout.py``; a fetched checkpoint is
rebuilt by ``source.checkpoint_wire.rebuild_tree`` onto the incumbent's
device in its dtypes, so ``swap_params`` receives device tensors.

The live model lifecycle plane. A new model version travels as a
versioned checkpoint on a broker topic (source/checkpoint_wire.py — the
same CRC'd, chunked, pickle-free wire discipline as the prefill
handoff), and a ``RolloutController`` walks the fleet through it:

    pending → canary → rolling → complete
                  ↘        ↘
                   rolled_back

- **canary**: ONE replica shadow-serves a deterministic slice of its
  own live traffic under the candidate weights (``spawn_shadow`` /
  ``shadow_decode`` — the shadow has no producer, no journal, and a
  structurally empty consumer assignment, so nothing it does can reach
  a broker) and token-diffs the shadow's outputs against the incumbent's.
  Divergence beyond the gate triggers AUTOMATIC rollback: the candidate
  never reaches a second replica, by construction — no swap directive
  is issued until the canary verdict is in.
- **rolling**: replicas drain-swap ONE AT A TIME behind the existing
  lease protocol. The swap is the fleet's warm-drain mechanism turned
  inward: ``pause_admission`` (finish in-flight WITHOUT leaving the
  group — a weight swap must not cost a rebalance), close the commit
  window (``maybe_flush(force=True)``), then ``swap_params`` rebinds
  the server's params in place — no pool is rebuilt. The
  journal records the new version BEFORE the rebind, so a SIGKILL at
  either swap crash point restarts on an unambiguous version.
- **rolled_back**: swapped replicas drain-swap BACK to the incumbent,
  newest first; the controller is done when the last swap-back acks.

Every phase transition is typed on the trace stream
(``rollout_phase`` / ``canary_started`` / ``swapped`` /
``rolled_back``) and gauged on FleetMetrics, so an operator — or the
differential test — can replay the lifecycle from either surface.

Two transports share the one state machine:

- ``BrokerRolloutDriver`` + ``RolloutWorker``: directives and acks are
  JSON records on a 1-partition control topic — the real-process fleet
  (fleet/proc.py workers poll the control cursor every pump). After
  completion the driver FENCES any live group member still on a stale
  version, exactly like a stale-generation commit: a zombie that missed
  the rollout cannot write old-version outputs into the committed view.
- ``InProcessRolloutDriver``: drives a ``ServingFleet`` from serve()'s
  ``on_round`` hook on the calling thread — every interleaving stays
  deterministic under the cooperative scheduler, which is what the
  differential tests replay.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from torchkafka_tpu_torch.errors import CheckpointWireError
from torchkafka_tpu_torch.resilience.crashpoint import crash_hook
from torchkafka_tpu_torch.source.checkpoint_wire import fetch_checkpoint, rebuild_tree
from torchkafka_tpu_torch.source.records import TopicPartition

_logger = logging.getLogger(__name__)

PENDING = "pending"
CANARY = "canary"
ROLLING = "rolling"
COMPLETE = "complete"
ROLLED_BACK = "rolled_back"

# Numeric phase encoding for the ``rollout_phase`` gauge (a Prometheus
# gauge holds one float; the mapping is part of the exposition contract).
PHASE_CODES = {PENDING: 0, CANARY: 1, ROLLING: 2, COMPLETE: 3, ROLLED_BACK: 4}


class RolloutController:
    """The rollout state machine, transport-agnostic.

    Members are opaque ids (replica ints in-process, member-id strings
    for the real-process fleet). Every method that advances the machine
    returns the list of DIRECTIVES the transport must deliver next —
    the controller never touches a broker or a replica itself, which is
    why one machine serves both fleets and why its unit tests need
    neither.

    ``max_canary_diffs`` is the divergence gate: a canary report with
    more mismatched completions than this rolls the fleet back. The
    default 0 encodes the paper's determinism contract — a weights-only
    refresh of the same architecture must be token-identical on the
    greedy path, so ANY diff is a bad checkpoint.
    """

    def __init__(
        self,
        members,
        version: int,
        *,
        canary_member=None,
        canary_slice: int = 8,
        max_canary_diffs: int = 0,
        incumbent_version: int = 0,
        tracer=None,
        metrics=None,
        trace_acks: bool = True,
    ) -> None:
        self.members = list(members)
        if not self.members:
            raise ValueError("a rollout needs at least one member")
        self.version = int(version)
        self.incumbent_version = int(incumbent_version)
        if self.version == self.incumbent_version:
            raise ValueError(
                f"target version {self.version} is already the incumbent"
            )
        self.canary_member = (
            canary_member if canary_member is not None else self.members[0]
        )
        if self.canary_member not in self.members:
            raise ValueError(f"canary {self.canary_member!r} not in members")
        self.canary_slice = int(canary_slice)
        self.max_canary_diffs = int(max_canary_diffs)
        self._tracer = tracer
        self._metrics = metrics
        self._trace_acks = trace_acks
        self.phase = PENDING
        self.rollback_reason: str | None = None
        # Everyone serves the incumbent until their swap acks.
        self.member_versions = {
            m: self.incumbent_version for m in self.members
        }
        self.swapped: list = []  # acked the TARGET version, in swap order
        self._queue: list = []  # members awaiting a swap directive
        self._awaiting = None  # member directed but not yet acked

    # ------------------------------------------------------------- phases

    def _set_phase(self, phase: str) -> None:
        self.phase = phase
        if self._tracer is not None:
            self._tracer.rollout_phase(phase, self.version)
        if self._metrics is not None:
            self._metrics.rollout_phase.set(PHASE_CODES[phase])

    def begin(self) -> list[dict]:
        """pending → canary: direct the canary member to shadow-serve
        ``canary_slice`` completions under the candidate version."""
        if self.phase != PENDING:
            raise RuntimeError(f"begin() in phase {self.phase!r}")
        if self._metrics is not None:
            self._metrics.rollout_target_version.set(self.version)
            for m in self.members:
                self._metrics.replica_model_version(str(m)).set(
                    self.member_versions[m]
                )
        self._set_phase(CANARY)
        if self._tracer is not None:
            self._tracer.canary_started(
                str(self.canary_member), self.version,
                slice_n=self.canary_slice,
            )
        return [{
            "t": "canary", "member": self.canary_member,
            "version": self.version, "n": self.canary_slice,
        }]

    def note_canary_report(self, member, diffs: int, compared: int,
                           version: int | None = None) -> list[dict]:
        """The canary verdict: token-clean → start rolling (canary
        member swaps first — it already validated the weights); any
        divergence past the gate → automatic rollback. Off-phase,
        off-member, or off-VERSION reports are ignored — the control
        topic outlives individual rollouts, so a report from a previous
        rollout's canary must never gate this one."""
        if self.phase != CANARY or member != self.canary_member:
            return []
        if version is not None and int(version) != self.version:
            return []
        if self._metrics is not None:
            self._metrics.canary_token_diffs.add(int(diffs))
        if diffs > self.max_canary_diffs:
            _logger.warning(
                "canary %s diverged: %d/%d completions mismatched under "
                "version %d — rolling back", member, diffs, compared,
                self.version,
            )
            return self.rollback("canary_divergence")
        self._set_phase(ROLLING)
        self._queue = [self.canary_member] + [
            m for m in self.members if m != self.canary_member
        ]
        return self._next()

    def note_ack(self, member, version: int) -> list[dict]:
        """A member finished its drain-swap. One at a time: the NEXT
        directive is only issued once this ack lands, so a wedged swap
        can never leave two replicas quiesced at once."""
        if member != self._awaiting:
            return []
        expect = (
            self.incumbent_version if self.phase == ROLLED_BACK
            else self.version
        )
        if int(version) != expect:
            return []
        self.member_versions[member] = int(version)
        if self._metrics is not None:
            self._metrics.replica_model_version(str(member)).set(int(version))
        if self._trace_acks and self._tracer is not None:
            self._tracer.swapped(int(version), member=str(member))
        if self.phase == ROLLING:
            self.swapped.append(member)
        elif self.phase == ROLLED_BACK and member in self.swapped:
            self.swapped.remove(member)
        self._awaiting = None
        return self._next()

    def note_reject(self, member, version: int, reason: str) -> list[dict]:
        """A member could not apply the checkpoint (torn frames, CRC
        mismatch, tree drift). The member keeps serving the incumbent —
        graceful degradation locally — and the ROLLOUT rolls back: a
        checkpoint one replica rejects must not half-apply across the
        fleet. A reject for any version other than the current target
        is stale control-topic traffic and is ignored."""
        if self.phase in (PENDING, COMPLETE, ROLLED_BACK):
            return []
        if int(version) != self.version:
            return []
        return self.rollback(str(reason))

    def rollback(self, reason: str) -> list[dict]:
        """Halt the rollout and drain-swap every already-swapped member
        back to the incumbent, newest swap first (unwind order)."""
        if self.phase in (COMPLETE, ROLLED_BACK):
            return []
        self.rollback_reason = str(reason)
        if self._tracer is not None:
            self._tracer.rolled_back(self.rollback_reason, self.version)
        if self._metrics is not None:
            self._metrics.rollback(self.rollback_reason).add(1)
        self._set_phase(ROLLED_BACK)
        self._queue = list(reversed(self.swapped))
        self._awaiting = None
        return self._next()

    def _next(self) -> list[dict]:
        if self._awaiting is not None:
            return []
        if self._queue:
            m = self._queue.pop(0)
            self._awaiting = m
            version = (
                self.incumbent_version if self.phase == ROLLED_BACK
                else self.version
            )
            return [{"t": "swap", "member": m, "version": version}]
        if self.phase == ROLLING:
            self._set_phase(COMPLETE)
        return []

    @property
    def done(self) -> bool:
        """Terminal AND settled: complete, or rolled back with every
        swap-back acked (a rollback is only over once no replica is
        left on the candidate version)."""
        if self.phase == COMPLETE:
            return True
        return (
            self.phase == ROLLED_BACK
            and not self.swapped
            and self._awaiting is None
            and not self._queue
        )


class BrokerRolloutDriver:
    """Controller-side transport over the control topic (real-process
    fleets). Directives go out as JSON records; worker acks/reports/
    rejects come back on the SAME topic — the driver's cursor reads
    everything and dispatches by message type, ignoring its own
    directives. After completion, any live group member still on a
    stale version is FENCED (``group`` given): the zombie's lease dies
    and its stale-generation commits are already rejected, so an
    old-version output can never enter the committed view.
    """

    def __init__(self, broker, topic: str, controller: RolloutController,
                 *, group: str | None = None) -> None:
        self._broker = broker
        self._topic = topic
        self._tp = TopicPartition(topic, 0)
        self._ctl = controller
        self._group = group
        # Cursor starts at the CURRENT end of the control topic: the
        # topic outlives individual rollouts, and a fresh driver must
        # never replay a previous rollout's acks/reports into this
        # controller (the version gates below are the second line of
        # defence; this is the first).
        self._cursor = int(broker.end_offset(self._tp))
        self._started = False
        self._fenced_stale = False

    @property
    def controller(self) -> RolloutController:
        return self._ctl

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._publish(self._ctl.begin())

    def pump(self) -> None:
        """One control-plane sweep: deliver worker messages to the
        state machine, publish whatever directives fall out."""
        if not self._started:
            self.start()
        while True:
            recs = self._broker.fetch(self._tp, self._cursor, 256)
            if not recs:
                break
            self._cursor = recs[-1].offset + 1
            for rec in recs:
                msg = _decode_control(rec.value)
                if msg is None:
                    continue
                t = msg.get("t")
                if t == "ack":
                    self._publish(self._ctl.note_ack(
                        msg.get("member"), int(msg.get("version", -1)),
                    ))
                elif t == "canary_report":
                    self._publish(self._ctl.note_canary_report(
                        msg.get("member"), int(msg.get("diffs", 0)),
                        int(msg.get("compared", 0)),
                        version=msg.get("version"),
                    ))
                elif t == "reject":
                    self._publish(self._ctl.note_reject(
                        msg.get("member"), int(msg.get("version", -1)),
                        str(msg.get("reason", "reject")),
                    ))
                # "canary"/"swap" are our own directives echoing back.
        if self._ctl.phase == COMPLETE and not self._fenced_stale:
            self._fence_stale()

    def _fence_stale(self) -> None:
        """Post-completion zombie sweep: a member the broker still lists
        live but that never acked the target version is serving stale
        weights — fence it, exactly like an expired lease."""
        self._fenced_stale = True
        if self._group is None:
            return
        live = self._broker.membership(self._group).get("members", [])
        for m in live:
            if self._ctl.member_versions.get(m) != self._ctl.version:
                _logger.warning(
                    "fencing stale-version member %s (serving %s, fleet "
                    "completed rollout to %d)", m,
                    self._ctl.member_versions.get(m), self._ctl.version,
                )
                self._broker.fence(self._group, m)

    @property
    def done(self) -> bool:
        return self._ctl.done

    def _publish(self, directives: list[dict]) -> None:
        for d in directives:
            self._broker.produce(
                self._topic, json.dumps(d).encode(), partition=0,
            )


class RolloutWorker:
    """Worker-side rollout plane for one real-process replica
    (fleet/proc.py hooks ``pump(completions)`` into its pump loop).

    Keeps a raw fetch cursor on the control topic (partition 0, from
    offset 0 — directives published before this worker booted still
    apply: that is how a crash-restarted worker rejoins a rollout
    mid-flight). Checkpoints are fetched lazily per version and cached
    AS TREES keyed by version — the incumbent's boot weights are seeded
    into the cache, so a rollback swap-back never needs the wire.

    A checkpoint that fails wire validation (``CheckpointWireError``:
    torn manifest, truncated chunk, CRC flip, tree drift) is REJECTED —
    counted on /metrics, reported to the controller — and the worker
    keeps serving the incumbent untouched. Graceful degradation, never
    a crash: the next rollout attempt re-fetches from scratch.
    """

    def __init__(
        self,
        broker,
        topic: str,
        ckpt_topic: str,
        member: str,
        rep,
        *,
        boot_params,
        boot_version: int = 0,
        metrics=None,
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._tp = TopicPartition(topic, 0)
        self._ckpt_topic = ckpt_topic
        self._member = member
        self._rep = rep
        self._metrics = metrics
        self._cursor = 0
        self._params_by_version = {int(boot_version): boot_params}
        # Canary state: (version, n, shadow generator, diffs, compared).
        self._canary = None
        self._pending_swap: int | None = None
        # Prefills the canary shadows ran: a dense shadow's prefill is one
        # flash-forward launch a layer that the replica's metrics miss.
        self.shadow_prefills = 0

    @property
    def model_version(self) -> int:
        return self._rep.gen.model_version

    def cache(self, version: int, params) -> None:
        """Pre-seed the version cache (e.g. a restored incarnation's
        rebuilt tree — a rollback to it must not re-fetch)."""
        self._params_by_version[int(version)] = params

    def pump(self, completions) -> None:
        """One rollout sweep, called every worker pump with that pump's
        completions (the canary's comparison stream)."""
        self._poll_directives()
        if self._canary is not None:
            self._run_canary(completions)
        if self._pending_swap is not None:
            self._try_swap()

    # ----------------------------------------------------------- directives

    def _poll_directives(self) -> None:
        while True:
            recs = self._broker.fetch(self._tp, self._cursor, 256)
            if not recs:
                break
            self._cursor = recs[-1].offset + 1
            for rec in recs:
                msg = _decode_control(rec.value)
                if msg is None or msg.get("member") != self._member:
                    continue
                t = msg.get("t")
                if t == "canary":
                    self._start_canary(
                        int(msg.get("version", -1)), int(msg.get("n", 1)),
                    )
                elif t == "swap":
                    self._pending_swap = int(msg.get("version", -1))
                    self._rep.pause_admission()

    def _start_canary(self, version: int, n: int) -> None:
        params = self._resolve(version)
        if params is None:
            return  # rejected; incumbent keeps serving
        shadow = self._rep.gen.spawn_shadow(params, version)
        self._canary = [version, max(1, n), shadow, 0, 0]

    def _run_canary(self, completions) -> None:
        version, n, shadow, diffs, compared = self._canary
        for rec, toks in completions:
            if compared >= n:
                break
            before = shadow.metrics.prefills.count
            got = shadow.shadow_decode(rec)
            self.shadow_prefills += shadow.metrics.prefills.count - before
            if got is None or not np.array_equal(
                np.asarray(got), np.asarray(toks)
            ):
                diffs += 1
                if self._metrics is not None:
                    self._metrics.canary_token_diffs.add(1)
            compared += 1
        self._canary[3], self._canary[4] = diffs, compared
        if compared >= n:
            # The verdict is about to become durable on the control
            # topic — a SIGKILL here must leave the incumbent serving
            # and the controller free to retry or roll back.
            crash_hook("canary_pre_verdict")
            self._send({
                "t": "canary_report", "member": self._member,
                "version": version, "diffs": diffs, "compared": compared,
            })
            self._canary = None

    def _try_swap(self) -> None:
        """Complete a pending drain-swap once quiesced: close the commit
        window, rebind params (journal flips first inside swap_params),
        resume admission, ack. Retries every pump until the replica
        actually quiesces and the flush actually lands."""
        version = self._pending_swap
        if not self._rep.quiesced:
            return  # in-flight generations still retiring
        params = self._resolve(version)
        if params is None:
            # Torn checkpoint: abandon the swap, keep the incumbent.
            self._pending_swap = None
            self._rep.resume_admission()
            return
        self._rep.maybe_flush(force=True)
        try:
            self._rep.gen.swap_params(params, version)
        except RuntimeError:
            return  # commit window not closed yet (flush retrying)
        self._pending_swap = None
        self._rep.resume_admission()
        self._send({"t": "ack", "member": self._member, "version": version})

    # ----------------------------------------------------------- checkpoint

    def _resolve(self, version: int):
        """Version → params tree, from cache or the checkpoint topic.
        Wire failure → reject (counted, reported), return None."""
        cached = self._params_by_version.get(version)
        if cached is not None:
            return cached
        try:
            flat, _manifest = fetch_checkpoint(
                self._broker, self._ckpt_topic, version,
            )
            # The incumbent tree is the schema: a checkpoint that does
            # not match it array-for-array is rejected here, before any
            # weight is touched.
            params = rebuild_tree(self._rep.gen._params, flat)
        except CheckpointWireError as e:
            _logger.warning(
                "member %s rejecting checkpoint v%d: %s",
                self._member, version, e,
            )
            if self._metrics is not None:
                self._metrics.checkpoint_reject("wire").add(1)
            self._send({
                "t": "reject", "member": self._member,
                "version": version, "reason": str(e)[:200],
            })
            return None
        self._params_by_version[version] = params
        return params

    def _send(self, msg: dict) -> None:
        self._broker.produce(
            self._topic, json.dumps(msg).encode(), partition=0,
        )


class InProcessRolloutDriver:
    """Drive a rollout against a ``ServingFleet`` on the calling thread.

    Plug ``on_round`` into ``fleet.serve(on_round=...)`` and feed every
    yielded completion to ``observe`` — the same cooperative loop the
    differential tests already replay, so a rollout interleaving is as
    deterministic as any other fleet schedule. ``versions`` maps version
    ints to params trees (the in-process twin of the checkpoint topic;
    the incumbent's entry is what rollback swaps back to).
    """

    def __init__(self, fleet, controller: RolloutController,
                 versions: dict) -> None:
        self._fleet = fleet
        self._ctl = controller
        self._versions = dict(versions)
        self._started = False
        self._canary = None  # [rid, version, n, shadow, diffs, compared]
        self._pending_swap = None  # (rid, version)

    @property
    def controller(self) -> RolloutController:
        return self._ctl

    @property
    def done(self) -> bool:
        return self._ctl.done

    def on_round(self, fleet, served: int) -> None:
        if not self._started:
            self._started = True
            self._dispatch(self._ctl.begin())
        if self._canary is not None and self._canary[5] >= self._canary[2]:
            rid, version, _n, _shadow, diffs, compared = self._canary
            crash_hook("canary_pre_verdict")
            self._canary = None
            self._dispatch(
                self._ctl.note_canary_report(rid, diffs, compared)
            )
        if self._pending_swap is not None:
            self._try_swap()

    def observe(self, rid: int, rec, tokens) -> None:
        """Per-completion hook: during the canary phase, shadow-decode
        the canary replica's completions under the candidate and count
        token diffs."""
        if self._canary is None or rid != self._canary[0]:
            return
        if self._canary[5] >= self._canary[2]:
            return
        shadow = self._canary[3]
        got = shadow.shadow_decode(rec)
        if got is None or not np.array_equal(
            np.asarray(got), np.asarray(tokens)
        ):
            self._canary[4] += 1
        self._canary[5] += 1

    def _dispatch(self, directives: list[dict]) -> None:
        for d in directives:
            rid = d["member"]
            rep = self._fleet.replicas[rid]
            if d["t"] == "canary":
                version = d["version"]
                shadow = rep.gen.spawn_shadow(
                    self._versions[version], version,
                )
                self._canary = [rid, version, d["n"], shadow, 0, 0]
            elif d["t"] == "swap":
                rep.pause_admission()
                self._pending_swap = (rid, d["version"])

    def _try_swap(self) -> None:
        rid, version = self._pending_swap
        rep = self._fleet.replicas[rid]
        if not rep.quiesced:
            return
        rep.maybe_flush(force=True)
        try:
            rep.gen.swap_params(self._versions[version], version)
        except RuntimeError:
            return  # flush still retrying; next round
        self._pending_swap = None
        rep.resume_admission()
        self._dispatch(self._ctl.note_ack(rid, version))


def _decode_control(value: bytes) -> dict | None:
    """Control-topic records are small JSON objects; anything else on
    the topic (a stray produce, a torn frame) is skipped, never fatal —
    the control plane shares the broker's at-least-once floor, so the
    machine must tolerate garbage between directives."""
    try:
        msg = json.loads(value)
    except (ValueError, UnicodeDecodeError):
        return None
    return msg if isinstance(msg, dict) else None
