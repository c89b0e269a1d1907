"""Named crash-point injection: deterministic process death at chosen
fault windows.

The resilience layer's chaos tools so far (source/chaos.py's seeded
consumer/producer faults, fleet.ReplicaChaos's cooperative "kill") inject
faults at the TRANSPORT and SCHEDULER level. What they cannot express is
arbitrary *process death at a specific instruction boundary* — the window
between a poll and its ledger registration, between an output flush and
the offset commit it gates, mid-way through a journal or checkpoint
write. Those windows are exactly where at-least-once arguments live or
die, so each one is a NAMED crash point:

========================== =================================================
point                      window it pins
========================== =================================================
post_poll                  records fetched, nothing registered/committed —
                           death here must redeliver them verbatim
pre_commit                 outputs durable, offsets NOT yet committed —
                           death here replays (duplicates), never loses
post_commit_pre_checkpoint offsets committed, the paired checkpoint not yet
                           saved — resume must seek BACK to the checkpoint
mid_tick                   a decode tick block landed, completions not yet
                           retired — in-flight state dies with the process
post_dlq_pre_retire        a poison record's DLQ copy is durable but its
                           offset not yet retired — redelivery must
                           re-quarantine idempotently, never double-count
journal_mid_write          death inside the decode journal's tmp write —
                           the torn tmp must be invisible to recovery
checkpoint_mid_write       death after the checkpoint payload, before the
                           atomic rename — the torn step must be invisible
heartbeat_pre_send         a replica made decode progress but dies before
                           the lease renewal that would prove it alive —
                           the lease expires, survivors absorb its
                           partitions, its uncommitted work re-delivers
lease_expired_pre_fence    a supervisor OBSERVED an expired lease but dies
                           before fencing — the zombie stays a member, yet
                           its next commit self-fences (commit-time reap),
                           so the watermark never merges zombie work
journal_handoff_pre_load   a replica (or recovery incarnation) dies inside
                           the peer-journal scan, before hints load — the
                           journals on disk stay intact; the next scan
                           warm-resumes exactly the same entries
txn_begin_post             a transaction is open on the broker, nothing
                           produced in it — the next incarnation's
                           init_producer_id fences the epoch and aborts it;
                           recovery must leave NO trace in the committed view
txn_produce_mid            some of a commit window's outputs are in the open
                           transaction, the rest never will be — none may
                           surface committed; recovery re-serves the whole
                           window exactly once
txn_pre_commit             records + offsets staged, commit_txn not yet
                           issued — the exactly-once twin of pre_commit:
                           death aborts, recovery's committed view holds
                           each output ONCE (vs at-least-once's duplicates)
txn_post_commit_pre_ack    the transaction committed ON the broker but the
                           producer dies before observing the ack — offsets
                           moved atomically with the records, so recovery
                           re-serves NOTHING; the committed view already
                           holds the single copy
wal_append_mid             the BROKER dies between the two halves of a WAL
                           frame's body — the torn tail. The event was never
                           acknowledged; recovery must CRC-detect the frame,
                           truncate it away, and never replay it
wal_pre_fsync              a WAL frame is fully written but not yet fsynced —
                           process death keeps it (page cache), machine death
                           may not; either outcome must satisfy the same
                           invariants (the event was unacknowledged)
txn_marker_pre_append      a transaction's offsets validated, the commit
                           marker NOT yet in the WAL — broker death here
                           means recovery finds a begun-but-unsettled
                           transaction and ABORTS it; nothing surfaces
                           committed
txn_marker_post_append_pre_ack  the commit marker is durably in the WAL but
                           the broker dies before flipping memory state /
                           acking — recovery REPLAYS the marker (records +
                           offsets commit atomically) and the producer's
                           retry is answered idempotently
recovery_mid_replay        the recovering broker dies mid-way through its
                           own WAL replay — replay is read-only until it
                           completes, so a second recovery must reproduce
                           the identical state
prefill_handoff_pre_publish a disaggregated PREFILL worker filled a
                           prompt's KV blocks but dies before publishing
                           the handoff — no decode replica ever sees it;
                           the prompt must fall back to a local prefill
                           (at-least-once; exactly-once mode: committed
                           duplicates stay 0) and the prefill group's
                           offset must re-deliver to the next incarnation
decode_adopt_pre_activate  a decode replica uploaded an adopted handoff's
                           KV payload into its pool but dies before
                           activating the slot — the record was never
                           emitted to the ledger, so it re-delivers and
                           re-adopts (or re-prefills) byte-identically
scale_up_pre_spawn         the SUPERVISOR decided a scale-up target and
                           chose the new member's replica-index slot but
                           dies before spawning it — no half-born member
                           exists, the group is untouched; a recovery
                           supervisor re-applies the controller target and
                           the fleet converges with zero lost
scale_down_mid_drain       the SUPERVISOR SIGTERMed a scale-down victim
                           but dies before recording the drain — the
                           victim's own drain discipline (finish, commit,
                           leave) still holds whatever the broker's fate
                           allows; nothing uncommitted is lost, and a
                           recovery supervisor converges to the target
repl_frame_pre_ship        the LEADER appended a frame to its own WAL but
                           dies before shipping it to any follower — the
                           mutation was never quorum-acked, so the client
                           retries against the promoted follower; the
                           leader-local-only frame must never surface in
                           the cell's committed view as a duplicate
repl_frame_post_majority_pre_ack  a majority of replicas hold the frame
                           but the leader dies before acking the client —
                           the mutation IS durable cell-wide; promotion
                           replays it and the client's retry is answered
                           idempotently (the exactly-once twin of
                           txn_marker_post_append_pre_ack, one layer up)
election_pre_promote       an election chose the winning follower but the
                           process dies before the promotion replay /
                           port takeover — the cell stays leaderless; a
                           re-run election (epoch bumped again) must
                           converge on the same durable prefix
rollout_pre_swap           a replica quiesced for a weight swap (in-flight
                           drained, window committed) but dies BEFORE the
                           journal records the new version — recovery
                           restarts on the OLD weights, the rollout
                           directive still stands, and the re-swap
                           converges to the controller target
swap_mid_apply             the journal durably records the NEW version but
                           the process dies before the in-memory param
                           rebind — the journal is EMPTY here (quiesced),
                           so recovery fetches and serves the new version;
                           no output was ever produced by mixed weights
canary_pre_verdict         the canary replica finished its shadow slice
                           but dies before publishing the verdict — no
                           swap happened anywhere; recovery re-runs the
                           canary deterministically and the rollout
                           proceeds (or rolls back) on the same evidence
distill_pre_publish        the distill trainer finished a train step but
                           dies before publishing the refreshed draft
                           checkpoint — no complete version ever appears
                           on the checkpoint topic (a torn frame set is
                           rejected by the fetch-side CRC path), the
                           trainer's own consumer offsets re-deliver its
                           uncommitted corpus at-least-once, and the
                           serving fleet's committed tokens are untouched
                           (the trainer is off the serving path)
draft_swap_pre_apply       a speculative server fetched and validated a
                           refreshed draft but dies before rebinding it —
                           the draft only PROPOSES and verification
                           commits, so the committed view at death is a
                           prefix of the no-refresh reference; recovery
                           serves byte-identical tokens on either draft
========================== =================================================

Sites call ``crash_hook("<name>")``; production cost is one global ``is
None`` check. Tests arm a point with ``arm()`` (in-process, ``mode=
"raise"``) or via the ``TORCHKAFKA_CRASHPOINT`` environment variable in a
subprocess (``mode="kill"`` → SIGKILL, a real unclean death). Injection
is DETERMINISTIC: the Nth arrival at the armed point fires, every other
arrival is free — so a crash matrix can replay the same death precisely.

The registry is closed: ``crash_hook`` rejects unregistered names, so a
typo'd site cannot silently never fire, and the crash-matrix test can
assert REGISTERED_CRASH_POINTS ⊆ points-actually-killed-at (a registered
point the matrix does not cover fails the suite).
"""

from __future__ import annotations

import os
import signal
import threading

from torchkafka_tpu_torch.errors import TpuKafkaError

# The closed set of instrumented crash windows. Adding a site means adding
# its name HERE first — and the crash matrix (tests/test_crash_matrix.py)
# fails until the new point is exercised by a real subprocess kill.
REGISTERED_CRASH_POINTS: tuple[str, ...] = (
    "post_poll",
    "pre_commit",
    "post_commit_pre_checkpoint",
    "mid_tick",
    "post_dlq_pre_retire",
    "journal_mid_write",
    "checkpoint_mid_write",
    "heartbeat_pre_send",
    "lease_expired_pre_fence",
    "journal_handoff_pre_load",
    "txn_begin_post",
    "txn_produce_mid",
    "txn_pre_commit",
    "txn_post_commit_pre_ack",
    "wal_append_mid",
    "wal_pre_fsync",
    "txn_marker_pre_append",
    "txn_marker_post_append_pre_ack",
    "recovery_mid_replay",
    "prefill_handoff_pre_publish",
    "decode_adopt_pre_activate",
    "scale_up_pre_spawn",
    "scale_down_mid_drain",
    "repl_frame_pre_ship",
    "repl_frame_post_majority_pre_ack",
    "election_pre_promote",
    "rollout_pre_swap",
    "swap_mid_apply",
    "canary_pre_verdict",
    "distill_pre_publish",
    "draft_swap_pre_apply",
)

ENV_VAR = "TORCHKAFKA_CRASHPOINT"


class CrashPointInjected(TpuKafkaError):
    """Raised by an armed crash point in ``mode="raise"`` — the in-process
    stand-in for death, used where a test wants the stack intact (torn
    checkpoint writes) rather than a subprocess. Terminal by definition:
    retrying the crashed operation is the recovery path's job."""


class _Armed:
    __slots__ = ("point", "at", "mode", "marker", "count", "lock")

    def __init__(self, point: str, at: int, mode: str, marker: str | None):
        self.point = point
        self.at = at
        self.mode = mode
        self.marker = marker
        self.count = 0
        self.lock = threading.Lock()


_armed: _Armed | None = None


def arm(
    point: str, *, at: int = 1, mode: str = "raise",
    marker: str | None = None,
) -> None:
    """Arm ``point`` to fire at its ``at``-th arrival.

    ``mode="raise"`` raises ``CrashPointInjected`` (in-process tests);
    ``mode="kill"`` SIGKILLs the process — no handlers, no atexit, no
    flushes, the honest crash. ``marker``: a file path written atomically
    just before firing, so a parent process can prove the point was
    actually reached (a SIGKILL'd child cannot report anything after)."""
    global _armed
    if point not in REGISTERED_CRASH_POINTS:
        raise ValueError(
            f"unknown crash point {point!r}; registered: "
            f"{REGISTERED_CRASH_POINTS}"
        )
    if at < 1:
        raise ValueError(f"at must be >= 1, got {at}")
    if mode not in ("raise", "kill"):
        raise ValueError(f"mode must be 'raise' or 'kill', got {mode!r}")
    _armed = _Armed(point, at, mode, marker)


def disarm() -> None:
    global _armed
    _armed = None


def armed_point() -> str | None:
    return _armed.point if _armed is not None else None


def arm_from_env(environ=os.environ) -> bool:
    """Arm from ``TORCHKAFKA_CRASHPOINT=point:at:mode[:marker_path]`` —
    the subprocess side of the crash matrix. Returns True if armed."""
    spec = environ.get(ENV_VAR)
    if not spec:
        return False
    parts = spec.split(":", 3)
    if len(parts) < 3:
        raise ValueError(
            f"{ENV_VAR} must be 'point:at:mode[:marker]', got {spec!r}"
        )
    point, at, mode = parts[0], int(parts[1]), parts[2]
    marker = parts[3] if len(parts) > 3 else None
    arm(point, at=at, mode=mode, marker=marker)
    return True


def _write_marker(path: str, point: str, count: int) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{point}:{count}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def crash_hook(point: str) -> None:
    """The site-side call. Free when nothing is armed (one global load);
    rejects unregistered names so sites cannot drift out of the registry."""
    armed = _armed
    if armed is None:
        if point not in REGISTERED_CRASH_POINTS:
            raise ValueError(
                f"crash_hook called with unregistered point {point!r}"
            )
        return
    if point not in REGISTERED_CRASH_POINTS:
        raise ValueError(
            f"crash_hook called with unregistered point {point!r}"
        )
    if point != armed.point:
        return
    with armed.lock:
        armed.count += 1
        fire = armed.count == armed.at
    if not fire:
        return
    if armed.marker:
        _write_marker(armed.marker, point, armed.at)
    if armed.mode == "kill":
        # SIGKILL over os._exit: nothing in this process may run another
        # instruction — no finally blocks, no daemon-thread flushes. This
        # is the crash the at-least-once contract is sworn against.
        os.kill(os.getpid(), signal.SIGKILL)
    raise CrashPointInjected(
        f"crash point {point!r} fired at arrival {armed.at}"
    )
