"""The port's multi-process pod tests: tests/test_pod.py's cases over
``torch.distributed`` (gloo on the CPU) and tests/_torch_multiproc_worker.py.

The workers are real processes in one process group, so
``CommitBarrier``'s multi-process branch (a barrier on the group
``parallel.multihost.initialize`` made for it) executes for real: the
cross-process commit, all ranks or none, fail-closed on a member's death,
re-delivery of everything uncommitted. The parent checks what the workers
wrote, with the reference's assertions.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

import torchkafka_tpu_torch as tk
from torchkafka_tpu_torch.source.records import TopicPartition

from tests._torch_multiproc_worker import (
    BATCH,
    ELASTIC_PARTITIONS,
    ELASTIC_RECORDS_PER_PARTITION,
    RECORDS_PER_PROCESS,
    build_broker,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_pod(nproc: int, outdir: str, mode: str, port: int | None = None) -> list:
    """Start ``nproc`` workers; ``port`` is the process group's store
    (fresh by default) or, in the elastic modes, the parent's broker."""
    port = _free_port() if port is None else port
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for pid in range(nproc):
        # File-backed output: PIPE + wait() deadlocks once a worker writes
        # more than the pipe buffer.
        with open(os.path.join(outdir, f"worker_{pid}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(pid), str(nproc), str(port), outdir, mode],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def diagnose(procs: list, outdir: str) -> str:
    parts = []
    for i, p in enumerate(procs):
        try:
            with open(os.path.join(outdir, f"worker_{i}.log"), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
        except OSError:
            tail = "<no log>"
        parts.append(f"--- worker {i} (rc={p.returncode}) ---\n{tail}")
    return "\n".join(parts)


def wait_all(procs: list, outdir: str, timeout_s: float) -> list[int]:
    deadline = time.monotonic() + timeout_s
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        # Reap the WHOLE pod: a survivor blocked on a dead peer must not
        # leak past the test.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        pytest.fail(f"pod worker wedged (>{timeout_s}s):\n{diagnose(procs, outdir)}")
    return codes


def read(outdir: str, name: str, pid: int):
    path = os.path.join(outdir, f"{name}_{pid}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class TestPodCommit:
    @pytest.mark.parametrize("nproc", [2, 4])
    def test_pod_stream_step_barrier_commit(self, tmp_path, nproc):
        """Happy path: N processes, 4 global batches each wrapped by
        ``global_batch`` (a DTensor over the data axis), a cross-process
        reduction, and a barrier-backed commit per batch through the
        default watchdog."""
        procs = spawn_pod(nproc, str(tmp_path), "happy")
        codes = wait_all(procs, str(tmp_path), timeout_s=180)
        assert codes == [0] * nproc, diagnose(procs, str(tmp_path))

        dones = [read(str(tmp_path), "done", pid) for pid in range(nproc)]
        assert all(dones)
        assert all(d["batches"] == 4 for d in dones)
        assert all(d["barrier"] == "BarrierWatchdog" for d in dones)
        # The sum ran over the GLOBAL batch: every process sees identical
        # losses, and their total is the global sum over every rank's
        # records (rows carry pid*1000 + idx, so a rank summing only its
        # local rows produces a number this equation rejects).
        assert all(d["losses"] == dones[0]["losses"] for d in dones)
        assert len(dones[0]["losses"]) == 4
        expected_total = 8.0 * sum(
            pid * 1000 + i for pid in range(nproc) for i in range(RECORDS_PER_PROCESS))
        assert sum(dones[0]["losses"]) == expected_total

        # Commits are durable and cover exactly the emitted batches.
        for pid in range(nproc):
            committed = read(str(tmp_path), "committed", pid)["batches"]
            assert len(committed) == 4
            final = {TopicPartition(t, p): off for t, p, off in committed[-1]}
            assert sum(final.values()) == 4 * BATCH  # 64 rows committed

    def test_pod_serving(self, tmp_path):
        """Each rank serves its own prompt topic through the
        continuous-batching server under a live process group, with exact
        per-rank commit accounting."""
        procs = spawn_pod(2, str(tmp_path), "serve")
        codes = wait_all(procs, str(tmp_path), timeout_s=180)
        assert codes == [0, 0], diagnose(procs, str(tmp_path))
        ranks = []
        for pid in (0, 1):
            served = read(str(tmp_path), "served", pid)
            assert served["served"] == 8 and served["committed"] == 8, served
            assert served["world"] == 2
            ranks.append(served["rank"])
        assert ranks == [0, 1]

    def test_pod_checkpoint_roundtrip(self, tmp_path):
        """Multi-process checkpoint: the sharded tensor gathered and written
        whole, per-process offsets files, process 0's atomic rename
        between barriers; every process restores the identical global
        state and the MERGED pod-global watermark."""
        import torch

        # The reverse direction's checkpoint, saved by this one process.
        tk.StreamCheckpointer(str(tmp_path / "ck1")).save(
            5, {"w": torch.arange(4, dtype=torch.float32)[:, None].repeat(1, 4) * 10},
            {TopicPartition("t", 0): 3, TopicPartition("t", 1): 6})
        procs = spawn_pod(2, str(tmp_path), "ckpt")
        codes = wait_all(procs, str(tmp_path), timeout_s=180)
        assert codes == [0, 0], diagnose(procs, str(tmp_path))
        merged = {f"TopicPartition(topic='t', partition={p})": 100 + p for p in (0, 1)}
        for pid in (0, 1):
            ok = read(str(tmp_path), "ckpt_ok", pid)
            assert ok is not None
            assert ok["total"] == 4.0 * sum(range(4))
            assert ok["offsets"] == merged
            assert ok["reverse_position"] == (3, 6)[pid]
        # The files a one-process resume reads: both offsets files, with
        # their process index and count, and the full state.
        step_dir = tmp_path / "ck" / "3"
        names = sorted(os.listdir(step_dir))
        assert names == ["state.pt", "stream_offsets_0.json", "stream_offsets_1.json"]
        for pid in (0, 1):
            meta = json.loads((step_dir / f"stream_offsets_{pid}.json").read_text())
            assert (meta["process_index"], meta["process_count"], meta["step"]) == (pid, 2, 3)
        state, offsets, step = tk.StreamCheckpointer(str(tmp_path / "ck")).restore()
        assert step == 3 and tuple(state["w"].shape) == (4, 4)
        assert offsets == {TopicPartition("t", p): 100 + p for p in (0, 1)}

    def test_elastic_resume_merges_pod_offsets(self, tmp_path):
        """tests/test_checkpoint.py's rescale-down case over the port: a
        checkpoint of a 4-process pod (four per-process offsets files over
        disjoint partitions) restores on ONE process as the merged
        watermark, and resume seeks every partition the consumer owns."""
        import torch

        broker = tk.InMemoryBroker()
        broker.create_topic("t", partitions=4)
        for p in range(4):
            for i in range(8):
                broker.produce("t", bytes([i]), partition=p)
        ck = tk.StreamCheckpointer(str(tmp_path / "ck"))
        ck.save(7, {"w": torch.ones(2)}, {TopicPartition("t", 0): 3})
        os.remove(tmp_path / "ck" / "7" / "stream_offsets.json")
        for pid in range(4):
            (tmp_path / "ck" / "7" / f"stream_offsets_{pid}.json").write_text(json.dumps(
                {"step": 7, "process_index": pid, "process_count": 4,
                 "offsets": {f"t\x00{pid}": 3 + pid}}))
        _, offsets, step = ck.restore()
        assert step == 7
        assert offsets == {TopicPartition("t", p): 3 + p for p in range(4)}
        consumer = tk.MemoryConsumer(broker, "t", group_id="g",
                                     assignment=[TopicPartition("t", p) for p in range(4)])
        ck.resume(consumer)
        for p in range(4):
            assert consumer.position(TopicPartition("t", p)) == 3 + p
        # One per-process file lost: explicit restore fails loudly, and
        # auto-selection skips the incomplete step.
        os.remove(tmp_path / "ck" / "7" / "stream_offsets_2.json")
        with pytest.raises(FileNotFoundError, match="incomplete pod checkpoint"):
            ck.restore(7)
        assert ck.steps() == []

    def test_member_death_fails_closed_and_redelivers(self, tmp_path):
        """Kill process 1 before it commits batch 3: process 0's barrier
        must fail CLOSED (watchdog exit 42 or BarrierError exit 43; in both
        cases batch 3 is never committed), and replaying the durable state
        re-delivers exactly the records batches 1-2 did not cover."""
        procs = spawn_pod(2, str(tmp_path), "die")
        codes = wait_all(procs, str(tmp_path), timeout_s=120)
        assert codes[1] == 1, diagnose(procs, str(tmp_path))  # the deliberate death
        assert codes[0] in (42, 43), diagnose(procs, str(tmp_path))  # fail-closed

        assert read(str(tmp_path), "died_before_commit", 1) is not None
        assert read(str(tmp_path), "attempting", 0) is not None
        assert (read(str(tmp_path), "watchdog_fired", 0) is not None
                or read(str(tmp_path), "barrier_error", 0) is not None)

        # The survivor committed batches 1-2 only: batch 3 must be absent.
        committed = read(str(tmp_path), "committed", 0)["batches"]
        assert len(committed) == 2, committed

        broker = build_broker(tk, pid=0)
        consumer = tk.MemoryConsumer(broker, "t", group_id="g")
        offsets = {TopicPartition(t, p): off for t, p, off in committed[-1]}
        for tp, off in offsets.items():
            consumer.seek(tp, off)
        redelivered = []
        while True:
            records = consumer.poll(max_records=256, timeout_ms=50)
            if not records:
                break
            redelivered.extend(records)
        consumer.close()
        committed_count = sum(offsets.values())
        assert committed_count == 2 * BATCH
        assert len(redelivered) == RECORDS_PER_PROCESS - committed_count
        per_part: dict[int, list[int]] = {0: [], 1: []}
        for r in redelivered:
            per_part[r.partition].append(r.offset)
        for tp, off in offsets.items():
            lo = min(per_part[tp.partition], default=None)
            assert lo is None or lo == off, (tp, off, lo)

    def test_elastic_group_rebalance_on_member_leave(self, tmp_path):
        """Elastic group mode across real processes: three group-managed
        members of one socket broker; member 2 commits one batch, abandons
        the second and leaves; the survivors absorb its partitions,
        re-deliver exactly the uncommitted batch and drain the topic."""
        nproc = 3
        broker = tk.InMemoryBroker()
        broker.create_topic("t", partitions=ELASTIC_PARTITIONS)
        for p in range(ELASTIC_PARTITIONS):
            for i in range(ELASTIC_RECORDS_PER_PARTITION):
                broker.produce("t", i.to_bytes(4, "little"), partition=p)
        with tk.BrokerServer(broker) as server:
            procs = spawn_pod(nproc, str(tmp_path), "elastic", port=server.port)
            codes = wait_all(procs, str(tmp_path), timeout_s=180)
            assert codes == [0] * nproc, diagnose(procs, str(tmp_path))
            leaver = read(str(tmp_path), "leaver", nproc - 1)
            survivors = [read(str(tmp_path), "survivor", pid) for pid in range(nproc - 1)]
            assert leaver is not None and all(survivors)
            final_parts = {p for s in survivors for _, p in s["assignment"]}
            assert final_parts == set(range(ELASTIC_PARTITIONS)), final_parts
            survivor_consumed = {tuple(r) for s in survivors for r in s["consumed"]}
            uncommitted = {tuple(r) for r in leaver["uncommitted"]}
            committed_by_leaver = {tuple(r) for r in leaver["committed"]}
            assert uncommitted, "the leaver must have abandoned a batch"
            assert uncommitted <= survivor_consumed, uncommitted - survivor_consumed
            assert not (committed_by_leaver & survivor_consumed)
            everyone = survivor_consumed | committed_by_leaver | uncommitted
            assert everyone == {(p, o) for p in range(ELASTIC_PARTITIONS)
                                for o in range(ELASTIC_RECORDS_PER_PARTITION)}
            for p in range(ELASTIC_PARTITIONS):
                assert broker.committed("g", TopicPartition("t", p)) == \
                    ELASTIC_RECORDS_PER_PARTITION, p

    def test_elastic_group_scale_up_on_member_join(self, tmp_path):
        """Scale-up: two members make committed progress, a third joins
        the live group; it gets partitions, never sees a committed record,
        and the group drains the topic with nothing lost."""
        nproc = 3
        broker = tk.InMemoryBroker()
        broker.create_topic("t", partitions=ELASTIC_PARTITIONS)
        for p in range(ELASTIC_PARTITIONS):
            for i in range(ELASTIC_RECORDS_PER_PARTITION):
                broker.produce("t", i.to_bytes(4, "little"), partition=p)
        with tk.BrokerServer(broker) as server:
            procs = spawn_pod(nproc, str(tmp_path), "elastic_join", port=server.port)
            codes = wait_all(procs, str(tmp_path), timeout_s=180)
            assert codes == [0] * nproc, diagnose(procs, str(tmp_path))
            joiner = read(str(tmp_path), "joiner", nproc - 1)
            early = [read(str(tmp_path), "early", pid) for pid in range(nproc - 1)]
            assert joiner is not None and all(early)
            joiner_parts = {p for _, p in joiner["assignment"]}
            assert joiner_parts, "joiner must own partitions post-rebalance"
            assert {p for e in early for _, p in e["pre_join"]} == set(range(ELASTIC_PARTITIONS))
            post_parts = joiner_parts | {p for e in early for _, p in e["assignment"]}
            assert post_parts == set(range(ELASTIC_PARTITIONS)), post_parts
            joiner_consumed = {tuple(r) for r in joiner["consumed"]}
            assert joiner_consumed, "joiner must consume rebalanced records"
            early_committed = {tuple(r) for e in early for r in e["committed"]}
            assert not (joiner_consumed & early_committed)
            everyone = joiner_consumed | {tuple(r) for e in early for r in e["consumed"]}
            expected = {(p, o) for p in range(ELASTIC_PARTITIONS)
                        for o in range(ELASTIC_RECORDS_PER_PARTITION)}
            assert everyone == expected, expected - everyone
            for p in range(ELASTIC_PARTITIONS):
                assert broker.committed("g", TopicPartition("t", p)) == \
                    ELASTIC_RECORDS_PER_PARTITION, p
