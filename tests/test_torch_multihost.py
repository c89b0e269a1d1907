"""The port's multi-process wiring: tests/test_multihost.py re-rooted onto
``torchkafka_tpu_torch.parallel`` (pod consumers, assignment disjointness,
the watchdog), ``make_mesh``'s errors against the JAX package's on the same
dicts, the device and backend rules, and the kernel build shared by
processes that load at once."""

import functools
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import pytest
import torch

import torchkafka_tpu_torch as tk
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchkafka_tpu_torch.errors import BarrierError
from torchkafka_tpu_torch.parallel import (
    BarrierWatchdog,
    initialize,
    multihost,
    pod_consumer,
    pod_partitions,
)
from torchkafka_tpu_torch.parallel.mesh import _mesh_sizes
from torchkafka_tpu_torch.source.assignment import partitions_for_process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def broker():
    return tk.InMemoryBroker()


class TestInit:
    def test_single_host_noop(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        idx, count = initialize()
        assert (idx, count) == (0, 1)
        assert not torch.distributed.is_initialized()

    def test_one_process_world_from_the_environment_is_a_noop(self, monkeypatch):
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
        assert initialize(device="cpu") == (0, 1)
        assert not torch.distributed.is_initialized()


class TestAssignment:
    def test_pod_partitions_single_host_owns_all(self):
        assert len(pod_partitions("t", 16)) == 16

    @pytest.mark.parametrize("hosts,parts", [(4, 16), (4, 18), (8, 8), (3, 7)])
    def test_disjoint_and_complete_across_hosts(self, hosts, parts):
        """Every partition owned by exactly one process."""
        seen = {}
        for h in range(hosts):
            for tp in partitions_for_process("t", parts, h, hosts):
                assert tp not in seen, f"{tp} owned by {seen[tp]} and {h}"
                seen[tp] = h
        assert len(seen) == parts

    def test_pod_consumer_with_memory_transport(self, broker):
        broker.create_topic("t", partitions=4)
        consumer = pod_consumer(
            "t", 4, "g", transport=functools.partial(tk.MemoryConsumer, broker)
        )
        assert len(consumer.assignment()) == 4
        consumer.close()


class TestWatchdog:
    def test_normal_path_no_fire(self):
        wd = BarrierWatchdog(tk.LocalBarrier(), timeout_s=5.0)
        wd(None)
        assert not wd.timed_out

    def test_timeout_fires_callback(self):
        fired = []

        class SlowBarrier(tk.LocalBarrier):
            def __call__(self, wait_for=None):
                time.sleep(0.25)

        wd = BarrierWatchdog(SlowBarrier(), timeout_s=0.05, first_grace_s=0.05,
                             on_timeout=lambda: fired.append(1))
        wd(None)
        assert wd.timed_out and fired == [1]

    def test_first_barrier_gets_startup_grace(self):
        """The first barrier call legitimately includes start-up skew; the
        steady-state timeout must not exit a healthy pod there."""
        fired = []

        class SlowBarrier(tk.LocalBarrier):
            def __call__(self, wait_for=None):
                time.sleep(0.2)

        wd = BarrierWatchdog(SlowBarrier(), timeout_s=0.05, first_grace_s=5.0,
                             on_timeout=lambda: fired.append(1))
        wd(None)  # 0.2 s > timeout but < grace: must NOT fire
        assert not wd.timed_out and not fired
        wd(None)  # steady state: 0.2 s > 0.05 s → fires
        assert wd.timed_out and fired == [1]

    def test_barrier_error_propagates_and_timer_cancelled(self):
        class FailBarrier(tk.LocalBarrier):
            def __call__(self, wait_for=None):
                raise BarrierError("boom")

        wd = BarrierWatchdog(FailBarrier(), timeout_s=0.05)
        with pytest.raises(BarrierError):
            wd(None)
        time.sleep(0.1)
        assert not wd.timed_out  # timer was cancelled on exit

    def test_default_grace_and_fence(self):
        wd = BarrierWatchdog(tk.LocalBarrier(), timeout_s=10.0)
        assert wd._first_grace_s == 1800.0
        assert BarrierWatchdog(timeout_s=400.0)._first_grace_s == 2400.0
        fence = wd.fence(torch.ones(2))
        assert fence.first is not None and fence.events == []


# make_mesh's axis arithmetic against the JAX package's on the same dicts:
# (axes, device count).
MESH_CASES = [
    ({"data": -1, "tp": -1}, 8),
    ({"data": -1, "tp": 3}, 8),
    ({"data": 3, "tp": 2}, 8),
    ({"data": 2, "fsdp": 2}, 8),
    ({"data": -1, "fsdp": 2}, 8),
    ({"data": 4}, 4),
    (None, 8),
]


@pytest.mark.parametrize("axes,n", MESH_CASES,
                         ids=["two_inferred", "indivisible", "wrong_product", "too_few",
                              "inferred", "exact", "default"])
def test_make_mesh_sizes_and_errors_match_jax(axes, n):
    """The same ValueError, message for message, or the same sizes."""
    try:
        ref = jax_make_mesh(axes, devices=jax.devices()[:n])
        want = (list(ref.axis_names), [ref.shape[a] for a in ref.axis_names])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _mesh_sizes(axes, n)
        assert str(got.value) == str(e)
        return
    assert list(_mesh_sizes(axes, n)) == [list(x) for x in want]


def test_make_mesh_and_global_batch_on_one_process():
    """A one-process mesh on an in-process store: every rank (one) on
    data; a global batch wraps the local rows without copying them."""
    from torch.distributed.tensor import Replicate, Shard

    multihost.shutdown()
    try:
        mesh = tk.make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data",) and tuple(mesh.mesh.shape) == (1,)
        local = torch.arange(12.0).reshape(3, 4)
        g = tk.global_batch({"x": local}, mesh)["x"]
        assert tuple(g.shape) == (3, 4) and list(g.placements) == [Shard(0)]
        assert g.to_local().data_ptr() == local.data_ptr()
        mesh2 = tk.make_mesh({"data": 1, "tp": 1}, device="cpu")
        assert tk.batch_sharding(mesh2, ("data",)) == [Shard(0), Replicate()]
        with pytest.raises(ValueError, match="not axes of the mesh"):
            tk.batch_sharding(mesh2, "fsdp")
        assert multihost.rules()["backend"] == "gloo"
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("count,local_rank,want", [
    (1, 0, "cuda:0"), (1, 1, "cuda:0"), (2, 1, "cuda:1"), (2, 3, "cuda:1"), (4, 2, "cuda:2"),
], ids=["own", "shared", "own_second", "wraps", "own_third"])
def test_device_rule(monkeypatch, count, local_rank, want):
    """Local rank r takes cuda:r below the device count and the cards in
    turn beyond it; ``device="cpu"`` takes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert str(multihost.device_for_rank(local_rank)) == want
    assert str(multihost.device_for_rank(local_rank, "cpu")) == "cpu"


@pytest.mark.parametrize("dev,local_world,count,want", [
    ("cuda:0", 2, 1, "gloo"), ("cuda:0", 2, 2, "nccl"), ("cuda:0", 4, 2, "gloo"),
    ("cpu", 2, 0, "gloo"), ("cuda:0", 1, 1, "gloo"),
], ids=["shared_card", "own_cards", "more_ranks_than_cards", "cpu", "one_process"])
def test_backend_rule(monkeypatch, dev, local_world, count, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert multihost.backend_for(torch.device(dev), local_world) == want


def test_device_rule_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.device_for_rank(0)


_BUILD_RACE = textwrap.dedent("""
    import json, sys, time
    from pathlib import Path
    from torchkafka_tpu_torch.ops import _native
    build, fake, start = Path(sys.argv[1]), sys.argv[2], float(sys.argv[3])
    _native.BUILD = build
    _native._nvcc = lambda: fake
    while time.time() < start:
        time.sleep(0.001)
    _native.build_all(("flash_fwd",))
    print(json.dumps(str(_native._target("flash_fwd"))))
""")

_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({count!r}, "a") as f:
        f.write("build\\n")
    time.sleep(1.0)
    open(out, "wb").write(b"library")
""")


def test_processes_loading_at_once_build_once(tmp_path):
    """Two processes that load the kernel library at once: one builds (the
    cross-process lock), the other waits and finds it; both end with the
    same library path. A stand-in compiler counts its runs."""
    count = tmp_path / "nvcc_runs"
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC.format(python=sys.executable, count=str(count)))
    fake.chmod(0o755)
    build = tmp_path / "build"
    start = time.time() + 1.5
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_RACE, str(build), str(fake), repr(start)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert paths[0] == paths[1] and os.path.exists(paths[0])
    assert count.read_text().splitlines() == ["build"]
    assert sorted(p.name for p in build.iterdir()) == [os.path.basename(paths[0])]


def test_decoder_loaders_at_once_share_one_library(tmp_path):
    """The record decoders' g++ build under the same lock: two processes
    loading into a fresh build directory at once both load one file."""
    code = textwrap.dedent("""
        import json, sys, time
        from pathlib import Path
        import torchkafka_tpu_torch.native as native
        native._BUILD = Path(sys.argv[1])
        start = float(sys.argv[2])
        while time.time() < start:
            time.sleep(0.001)
        print(json.dumps([native.available(), str(native._target())]))
    """)
    start = time.time() + 1.5
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), repr(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert got[0] == got[1] and got[0][0] is True
    libs = [p for p in tmp_path.iterdir() if p.name.startswith("_tk_native")]
    assert [p.name for p in libs] == [os.path.basename(got[0][1])]
