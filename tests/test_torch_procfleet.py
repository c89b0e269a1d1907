"""The port's process fleet (``fleet/supervisor.py`` + ``fleet/proc.py``)
against the JAX package's.

- ``test_procfleet.py`` runs over the port (its source re-rooted): the
  supervisor units (lease sweeps, journal discovery, the journal lock)
  and the broker-restart units, and its three real-process cases —
  SIGKILL mid-storm with respawn and warm failover, scale up then drain
  down, a SIGSTOPped zombie fenced — on port worker processes serving
  on the CPU (``ProcessFleet(device="cpu")``), every wait bounded at
  60 s. Their reference is the port's in-process server on the weights
  the workers build (``build_model``: the same CPU ``torch.Generator``
  draw as the shim's ``init_params``).
- In-process worker differentials: ``run_replica_worker`` and
  ``run_prefill_worker`` of both packages over an ``InMemoryBroker``,
  each package's ``fleet.proc.build_model`` patched to return the same
  numpy parameters (``params_from_numpy`` for the port): equal outputs
  (keys, tokens, member headers), committed offsets and metrics dumps
  (the timing fields aside); the prefill workers publish equal handoff
  headers.
- The supervisor launches ``python -m torchkafka_tpu_torch.fleet.proc``,
  and a worker whose device cannot be had dies with its error in its
  log instead of serving elsewhere.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from _torch_fleet_common import one_thread_workers  # noqa: F401 - autouse fixture
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu_torch.fleet import ProcessFleet
from torchkafka_tpu_torch.models import transformer as pt

_mod = load_rerooted("test_procfleet", replace=[
    ("@pytest.mark.slow\nclass TestProcessFleet:", "class TestProcessFleet:"),
    ("timeout_s=300", "timeout_s=60"),
    ("timeout_s=240", "timeout_s=60"),
    ("timeout_s=120", "timeout_s=60"),
    ("deadline = time.monotonic() + 240", "deadline = time.monotonic() + 60"),
    ("    import jax\n    import jax.numpy as jnp\n\n    from torchkafka_tpu.models",
     "    from torchkafka_tpu.models"),
    ('params = init_params(jax.random.key(MODEL["seed"]), cfg)',
     'params = init_params(jax.random.key(MODEL["seed"]), cfg, "cpu")'),
    ("StreamingGenerator(c, params, cfg, slots=2,",
     'StreamingGenerator(c, params, cfg, device="cpu", slots=2,'),
])
_mod.ProcessFleet = functools.partial(ProcessFleet, device="cpu")

TestSupervisorUnits = _mod.TestSupervisorUnits
TestBrokerRestartUnits = _mod.TestBrokerRestartUnits
TestProcessFleet = _mod.TestProcessFleet
MODEL = _mod.MODEL


def test_supervisor_launches_the_port_worker(tmp_path):
    """The child command line names the port's worker module, and a
    worker asked for a CUDA device it cannot get (none here; no ordinal
    99 anywhere) dies visibly: nonzero exit, its error in the log
    ``diagnose()`` shows, no readiness marker."""
    fleet = ProcessFleet(
        MODEL, topic="t", prompt_len=_mod.P, max_new=_mod.MAX_NEW,
        workdir=tmp_path, replicas=1, partitions=2, respawn=False,
        group="g", device="cuda:99",
    )
    try:
        fleet.start()
        inc = fleet.incarnations[0]
        assert inc.proc.args[1:3] == ["-m", "torchkafka_tpu_torch.fleet.proc"]
        with open(inc.spec_path, encoding="utf-8") as f:
            assert json.load(f)["device"] == "cuda:99"
        with pytest.raises(RuntimeError, match="died before ready"):
            fleet.wait_ready(timeout_s=60)
        assert inc.proc.returncode not in (0, None)
        assert "Traceback" in fleet.diagnose()
    finally:
        fleet.close()


# ------------------------------------------- in-process worker differentials

P, MAX_NEW, VOCAB, SLOTS = 8, 8, 64, 2
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
PAGES = {"block_size": 4, "num_blocks": 24}
TIMING = ("step_p50_ms", "step_p99_ms")


@pytest.fixture(scope="module")
def shared_params():
    """One numpy parameter tree (JAX's f32 init) for both packages."""
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.key(5), jcfg))


def _patch_build_model(monkeypatch, tree):
    def jax_build(model_spec):
        cfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32)
        return cfg, jax.tree_util.tree_map(jnp.asarray, tree)

    def port_build(model_spec, device=None):
        cfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32,
                                   param_dtype=torch.float32)
        return cfg, pt.params_from_numpy(tree, cfg, device=device)

    monkeypatch.setattr("torchkafka_tpu.fleet.proc.build_model", jax_build)
    monkeypatch.setattr("torchkafka_tpu_torch.fleet.proc.build_model", port_build)


def _broker(mod, n=10, parts=2, shared=4):
    broker = mod.InMemoryBroker()
    broker.create_topic("t", partitions=parts)
    broker.create_topic("out", partitions=1)
    broker.create_topic("ho", partitions=1)
    rng = np.random.default_rng(41)
    prompts = rng.integers(0, VOCAB, (n, P), dtype=np.int32)
    prompts[:, :shared] = np.arange(shared, dtype=np.int32)
    for i in range(n):
        broker.produce("t", prompts[i].tobytes(), partition=i % parts,
                       key=str(i).encode())
    return broker


def _spec(tmp, pkg, **kw):
    spec = {
        "member_id": "m0", "replica_index": 0, "topic": "t", "group": "g",
        "out_topic": "out", "ready_topic": None,
        "journal_dir": os.path.join(tmp, pkg, "journals"),
        "journal_cadence": 2, "model": {"seed": 0}, "prompt_len": P,
        "max_new": MAX_NEW, "slots": SLOTS, "commit_every": 2,
        "ticks_per_sync": 1, "max_poll_records": SLOTS,
        "heartbeat_interval_s": None, "idle_exit_ms": 300,
        "metrics_path": os.path.join(tmp, pkg, "m0.metrics.json"),
    }
    if pkg == "port":
        spec["device"] = "cpu"
    os.makedirs(spec["journal_dir"], exist_ok=True)
    return {**spec, **kw}


def _outputs(mod, broker, topic="out"):
    tp = mod.TopicPartition(topic, 0)
    return [(r.key, dict(r.headers).get("member"), r.value)
            for r in broker.fetch(tp, 0, broker.end_offset(tp))]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_replica_worker_matches_jax(tmp_path, monkeypatch, shared_params, sampled):
    """The same worker incarnation of both packages, in process, over the
    same broker content: equal outputs, commits and metrics dumps."""
    from torchkafka_tpu.fleet.proc import run_replica_worker as jrun
    from torchkafka_tpu_torch.fleet.proc import run_replica_worker as prun

    _patch_build_model(monkeypatch, shared_params)
    extra = {"temperature": 0.8, "top_k": 8, "sampling_seed": 3} if sampled else {}
    runs = {}
    for pkg, mod, run in (("jax", tk, jrun), ("port", ptk, prun)):
        broker = _broker(mod)
        spec = _spec(str(tmp_path), pkg, **extra)
        assert run(spec, broker=broker) == 0
        with open(spec["metrics_path"], encoding="utf-8") as f:
            dump = json.load(f)
        committed = [broker.committed("g", mod.TopicPartition("t", p)) for p in (0, 1)]
        runs[pkg] = (_outputs(mod, broker), committed, dump)
    (jo, jc, jdump), (po, pc, pdump) = runs["jax"], runs["port"]
    assert po == jo and len(po) == 10
    assert pc == jc == [5, 5]
    for key in jdump:
        if key not in TIMING:
            assert pdump[key] == jdump[key], key
    # The port's own fields: the structure behind its launch counts.
    assert pdump["device"] == "cpu" and pdump["prefills"] >= 1
    assert set(pdump["launches"]) >= {"flash_fwd", "kvattn_paged"}


def test_prefill_and_decode_workers_match_jax(tmp_path, monkeypatch, shared_params):
    """A prefill worker and a disaggregated decode worker of each package,
    in process: the prefill worker publishes one handoff per prompt with
    JAX's headers; the decode worker then adopts every one and serves
    JAX's outputs, commits and dump."""
    from torchkafka_tpu.fleet.prefill import run_prefill_worker as jpre
    from torchkafka_tpu.fleet.proc import run_replica_worker as jrun
    from torchkafka_tpu_torch.fleet.prefill import run_prefill_worker as ppre
    from torchkafka_tpu_torch.fleet.proc import run_replica_worker as prun

    _patch_build_model(monkeypatch, shared_params)
    runs = {}
    for pkg, mod, pre, run in (("jax", tk, jpre, jrun), ("port", ptk, ppre, prun)):
        broker = _broker(mod)
        kw = dict(kv_pages=PAGES, handoff_topic="ho", route_patience=64)
        pspec = _spec(str(tmp_path), pkg, member_id="q0", **kw)
        pspec["metrics_path"] = os.path.join(str(tmp_path), pkg, "q0.metrics.json")
        assert pre(pspec, broker=broker) == 0
        tp = mod.TopicPartition("ho", 0)
        headers = []
        for r in broker.fetch(tp, 0, broker.end_offset(tp)):
            n = int.from_bytes(r.value[:4], "big")
            headers.append(json.loads(r.value[4:4 + n]))
        with open(pspec["metrics_path"], encoding="utf-8") as f:
            pdump = json.load(f)
        dspec = _spec(str(tmp_path), pkg, **kw)
        assert run(dspec, broker=broker) == 0
        with open(dspec["metrics_path"], encoding="utf-8") as f:
            ddump = json.load(f)
        committed = [broker.committed("g", mod.TopicPartition("t", p)) for p in (0, 1)]
        runs[pkg] = (headers, pdump, _outputs(mod, broker), committed, ddump)
    jh, jp, jo, jc, jd = runs["jax"]
    ph, pp, po, pc, pd = runs["port"]
    assert ph == jh and len(ph) == 10
    assert {k: pp[k] for k in jp} == jp
    assert po == jo and pc == jc == [5, 5]
    assert {k: pd[k] for k in jd if k not in TIMING} == {
        k: v for k, v in jd.items() if k not in TIMING}
    assert pd["adopted_slots"] == 10 and pd["prefill_tokens"] == 0


def test_idle_replica_commits_its_tail(tmp_path, monkeypatch, shared_params):
    """A replica whose last completions fall short of ``commit_every``
    commits them once it goes idle, while it keeps running: 3 prompts,
    commit_every 2 and 2 slots leave one completion past the cadence. The
    worker loop of both packages used to hold it until the drain, so a
    supervisor waiting on ``fully_committed`` before draining stalled (the
    port's 60 s bound of ``test_torch_crash_fleet.py``'s scale cases, and
    the reference's 300 s, under load)."""
    import threading
    import time

    from torchkafka_tpu_torch.fleet.proc import run_replica_worker

    _patch_build_model(monkeypatch, shared_params)
    broker = _broker(ptk, n=3, parts=1)
    spec = _spec(str(tmp_path), "port", idle_exit_ms=None)
    stop = type("Stop", (), {"requested": False})()
    rc = []
    worker = threading.Thread(
        target=lambda: rc.append(run_replica_worker(spec, broker=broker, shutdown=stop)))
    worker.start()
    tp = ptk.TopicPartition("t", 0)
    try:
        deadline = time.monotonic() + 60
        while (broker.committed("g", tp) or 0) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert worker.is_alive()  # committed while serving, not by the drain
        assert broker.committed("g", tp) == 3
        assert len(_outputs(ptk, broker)) == 3
    finally:
        stop.requested = True
        worker.join(timeout=60)
    assert rc == [0]
