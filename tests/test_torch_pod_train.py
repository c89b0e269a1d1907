"""Harness scenario 3 (mesh-sharded global batches → the data-parallel
train step → commit) and ``examples/pod_train_torch.py`` on the CPU: in one
process, and across gloo processes started by ``torch.distributed.run``
and by the example's ``--spawn``."""

import json
import os
import socket
import subprocess
import sys

import pytest

from torchkafka_tpu_torch.harness import run_scenario
from torchkafka_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_group(monkeypatch):
    """A test process outside any torch.distributed run; the one-process
    group a mesh starts is torn down after."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    multihost.shutdown()
    yield
    multihost.shutdown()


def test_scenario_3_runs_reports_and_trains(no_group):
    """tests/test_harness.py's scenario 3 cases, one process: n = 1."""
    out = run_scenario(3, "tiny", device="cpu")
    assert out["records"] > 0 and out["records_per_s"] > 0
    assert out["commit_failures"] == 0 and out["commit"]["count"] > 0
    assert out["dropped"] == 0
    assert out["last_loss"] < out["first_loss"]
    assert out["mesh"] == {"data": 1} and out["process_count"] == 1
    assert out["committed"] == {p: 4 for p in range(4)}  # every partition's end


def test_scenario_3_without_cuda_or_device_raises(no_group, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(3, "tiny")


def test_scenario_3_under_torch_distributed_run():
    """Two ranks through the CLI: each consumes its own partitions, every
    rank returns the same global loss, and each commits its rows."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         "-m", "torchkafka_tpu_torch.harness", "--scenario", "3", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = sorted((json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith("{")), key=lambda r: r["process_index"])
    assert [r["process_index"] for r in rows] == [0, 1]
    for r in rows:
        assert r["scenario"] == "3:mesh-train" and r["mesh"] == {"data": 2}
        assert r["records"] == 16 and r["commit"]["count"] == 8 and r["commit_failures"] == 0
        assert r["rules"]["backend"] == "gloo" and r["rules"]["device"] == "cpu"
        assert sum(r["committed"].values()) == 16
    assert {p for r in rows for p in r["committed"]} == {"0", "1", "2", "3"}
    assert rows[0]["first_loss"] == rows[1]["first_loss"]
    assert rows[0]["last_loss"] == rows[1]["last_loss"] < rows[0]["first_loss"]


def test_pod_train_example_spawns_a_pod():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "pod_train_torch.py"),
         "--spawn", "2", "--steps", "4", "--batch", "4", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "pod of 2 processes completed cleanly" in out
    for rank in (0, 1):
        assert f"rank {rank}: 4 steps, offsets: committed=16 end=2048" in out
    assert "'backend': 'gloo'" in out
