"""Crash-matrix cases of the port's process fleet, disaggregated prefill,
rollout and distillation: a real subprocess running the port is
SIGKILLed at a named crash point, and the invariants of
``test_crash_matrix.py`` are held at the moment of death and after an
in-process recovery incarnation.

- ``prefill_handoff_pre_publish`` (a prefill worker between harvest and
  publish) and ``decode_adopt_pre_activate`` (an exactly-once decode
  replica between an adopted payload's copy and the slot's activation);
- ``scale_up_pre_spawn`` and ``scale_down_mid_drain`` (the supervisor,
  hosting a WAL-backed ``ProcessFleet`` of port worker grandchildren,
  killed inside ``scale()``; marked slow, as in the reference);
- ``lease_expired_pre_fence`` (a lease sweep between observing an
  expired lease and fencing it);
- ``distill_pre_publish`` (the trainer between a trained step and its
  first checkpoint publish);
- ``rollout_pre_swap`` and ``swap_mid_apply`` (an exactly-once replica
  inside the rolling hot-swap, either side of the journal's durable
  version flip).

The worker logic is ``_crash_worker.py``'s, re-rooted onto the port (its
model loaded from the parameters the parent writes, every server on the
CPU); the audits and recovery runs are ``test_crash_matrix.py``'s case
functions, re-rooted the same way. The reference completions come from
the JAX package's crash worker in process on the same parameters, except
for the scale cases, whose worker grandchildren build their weights with
the port's ``fleet.proc.build_model``: their reference is the port's
in-process server on those weights. Run as ``python
tests/test_torch_crash_fleet.py <mode> <host> <port> <workdir>``, this
file is the child: it imports only torch, numpy and the port.
"""

import functools
import os
import pathlib
import subprocess
import sys
import types

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
PARAMS_ENV = "TORCHKAFKA_TEST_PARAMS"
# point -> (worker mode, Nth arrival to die at): test_crash_matrix.py's.
MATRIX = {
    "prefill_handoff_pre_publish": ("dgpre", 2),
    "decode_adopt_pre_activate": ("dgdec", 2),
    "scale_up_pre_spawn": ("scaleup", 1),
    "scale_down_mid_drain": ("scaledown", 1),
    "lease_expired_pre_fence": ("sweep", 1),
    "distill_pre_publish": ("distill", 1),
    "rollout_pre_swap": ("rollout", 1),
    "swap_mid_apply": ("rollout", 1),
}


def _npz_model(seed: int):
    """The port's model from the parameters the parent wrote for ``seed``
    (the JAX crash worker's shape, f32, on the CPU)."""
    import torch

    from torchkafka_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                               n_kv_heads=1, d_ff=64, max_seq_len=16,
                               dtype=torch.float32, param_dtype=torch.float32)
    tree: dict = {}
    with np.load(os.path.join(os.environ[PARAMS_ENV], f"params_{seed}.npz")) as z:
        for name in z.files:
            *path, leaf = name.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[name]
    return cfg, pt.params_from_numpy(tree, cfg, device="cpu")


def _on_cpu(module: str, name: str):
    import importlib

    cls = getattr(importlib.import_module(f"torchkafka_tpu_torch.{module}"), name)
    return functools.partial(cls, device="cpu")


def port_worker() -> types.ModuleType:
    """``_crash_worker.py`` with the package re-rooted onto the port: its
    model read from the parent's parameters (``build_model`` and, by
    seed, ``fleet.proc.build_model``), its servers, specs and supervisor
    on the CPU."""
    src = (HERE / "_crash_worker.py").read_text()
    for old, new in [
        ("def build_model():\n    import jax\n    import jax.numpy as jnp\n\n"
         "    from torchkafka_tpu.models.transformer import (\n"
         "        TransformerConfig,\n        init_params,\n    )\n\n"
         "    cfg = TransformerConfig(\n"
         "        vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,\n"
         "        d_ff=64, max_seq_len=P + MAX_NEW, dtype=jnp.float32,\n    )\n"
         "    return cfg, init_params(jax.random.key(0), cfg)\n",
         "def build_model():\n    return _npz_model(0)\n"),
        ("from torchkafka_tpu.serve import StreamingGenerator\n",
         'StreamingGenerator = _on_cpu("serve", "StreamingGenerator")\n'),
        ("from torchkafka_tpu.serve_spec import SpecStreamingGenerator\n",
         'SpecStreamingGenerator = _on_cpu("serve_spec", "SpecStreamingGenerator")\n'),
        ('"idle_exit_ms": 600,\n    }', '"idle_exit_ms": 600,\n        "device": "cpu",\n    }'),
        ('        wal_durability="commit",\n    )',
         '        wal_durability="commit", device="cpu",\n    )'),
        ("    import jax\n    import numpy as np\n\n    from torchkafka_tpu.distill",
         "    from torchkafka_tpu.distill"),
        ("    schema = jax.tree_util.tree_map(np.asarray, gen._draft_params)\n",
         "    schema = gen._draft_params\n"),
    ]:
        assert old in src, old
        src = src.replace(old, new)
    mod = types.ModuleType("_port_crash_worker")
    mod.__file__ = str(HERE / "_crash_worker.py")
    mod._npz_model = _npz_model
    mod._on_cpu = _on_cpu
    exec(compile(src.replace("torchkafka_tpu", "torchkafka_tpu_torch"),
                 mod.__file__, "exec"), mod.__dict__)
    return mod


def _npz_build_model(model_spec, device=None):
    return _npz_model(int(model_spec.get("seed", 0)))


def main() -> int:
    mode, host, port, workdir = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    from torchkafka_tpu_torch.fleet import proc
    from torchkafka_tpu_torch.resilience.crashpoint import arm_from_env

    w = port_worker()
    arm_from_env()
    if mode in ("scaleup", "scaledown"):
        return w.run_scale(workdir, "up" if mode == "scaleup" else "down")
    proc.build_model = _npz_build_model  # the rollout's boot and v1 weights
    import torchkafka_tpu_torch as ptk

    client = ptk.BrokerClient(host, port)
    try:
        {"dgpre": w.run_dg_prefill, "dgdec": w.run_dg_decode,
         "rollout": w.run_rollout, "distill": w.run_distill,
         "sweep": lambda b, _wd: w.run_sweep(b)}[mode](client, workdir)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())


# ------------------------------------------------------------ the parent

import pytest  # noqa: E402

import torchkafka_tpu as tk  # noqa: E402
from _torch_fleet_common import load_rerooted  # noqa: E402
from _torch_fleet_common import one_torch_thread  # noqa: E402,F401 - autouse fixture
from tests import _crash_worker as JW  # noqa: E402
from torchkafka_tpu_torch.fleet.proc import build_model as port_build_model  # noqa: E402


@pytest.fixture(scope="module")
def params_dir(tmp_path_factory):
    """The JAX crash worker's parameters (``build_model``, and
    ``fleet.proc.build_model`` at seeds 0 and 1), one ``.npz`` a seed."""
    import jax

    from torchkafka_tpu.fleet.proc import build_model

    d = tmp_path_factory.mktemp("params")
    trees = {0: JW.build_model()[1], 1: build_model(JW.ro_model_spec(seed=1))[1]}
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(trees[0]),
        jax.tree_util.tree_leaves(build_model(JW.ro_model_spec(seed=0))[1])))
    for seed, tree in trees.items():
        flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
        np.savez(str(d / f"params_{seed}.npz"), **flat)
    return str(d)


@pytest.fixture(autouse=True)
def port_env(params_dir, monkeypatch):
    """Children and the in-process recovery read the parameters from
    ``params_dir``; worker processes run one intra-op thread each; the
    port's ``fleet.proc.build_model`` returns the JAX worker's weights."""
    from torchkafka_tpu_torch.fleet import proc

    monkeypatch.setenv(PARAMS_ENV, params_dir)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(proc, "build_model", _npz_build_model)


def _spawn(mode: str, port: int, workdir: str, point: str, at: int):
    env = dict(os.environ)
    repo_root = str(HERE.parent)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    marker = os.path.join(workdir, "marker")
    env["TORCHKAFKA_CRASHPOINT"] = f"{point}:{at}:kill:{marker}"
    with open(os.path.join(workdir, "child.log"), "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, "localhost",
             str(port), workdir],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
    return proc, marker


_cases = load_rerooted("test_crash_matrix", replace=[
    ("        out_topic=W.SC_OUT, broker=recovered,\n",
     '        out_topic=W.SC_OUT, broker=recovered, device="cpu",\n'),
    # Every wait of a case bounded at 60 s.
    ("timeout_s=300", "timeout_s=60"),
    ("timeout_s=120", "timeout_s=60"),
    ("proc.wait(timeout=420)", "proc.wait(timeout=60)"),
    ("proc.wait(timeout=180)", "proc.wait(timeout=60)"),
    ("proc.wait(timeout=120)", "proc.wait(timeout=60)"),
])
_cases.W = port_worker()
_cases._spawn = _spawn


def _committed_view(broker, topic) -> dict:
    """key → tokens of the committed (read_committed) view of ``topic``."""
    recs, _ = broker.fetch_stable(tk.TopicPartition(topic, 0), 0, 100000)
    return {r.key: np.frombuffer(r.value, dtype=np.int32) for r in recs}


def _jax_serve(cfg, params, prompts, parts):
    """The JAX server's greedy completions of ``prompts`` (key i on
    partition i % parts): key → tokens."""
    from torchkafka_tpu.serve import StreamingGenerator

    broker = tk.InMemoryBroker()
    broker.create_topic("ref", partitions=parts)
    for i in range(len(prompts)):
        broker.produce("ref", prompts[i].tobytes(), partition=i % parts,
                       key=str(i).encode())
    c = tk.MemoryConsumer(broker, "ref", group_id="ref")
    gen = StreamingGenerator(c, params, cfg, slots=JW.SLOTS, prompt_len=JW.P,
                             max_new=JW.MAX_NEW, commit_every=2, ticks_per_sync=1)
    ref = {rec.key: toks for rec, toks in gen.run(idle_timeout_ms=400)}
    c.close()
    return ref


@pytest.fixture(scope="module")
def dg_reference(tmp_path_factory):
    """The JAX crash worker's no-kill disaggregated run in process."""
    broker = tk.InMemoryBroker()
    JW.prime_dg_topics(broker)
    wd = str(tmp_path_factory.mktemp("dg-ref"))
    JW.run_dg_prefill(broker, wd)
    JW.run_dg_decode(broker, wd)
    ref = _committed_view(broker, JW.DG_OUT)
    assert set(ref) == {str(i).encode() for i in range(JW.DG_PROMPTS)}
    return ref


@pytest.fixture(scope="module")
def ro_reference():
    from torchkafka_tpu.fleet.proc import build_model

    return {v: _jax_serve(*build_model(JW.ro_model_spec(seed=v)), JW.ro_prompts(),
                          JW.RO_PARTS) for v in (0, 1)}


@pytest.fixture(scope="module")
def dl_reference():
    return _jax_serve(*JW.build_model(), JW.dl_prompts(), JW.DL_PARTS)


@pytest.fixture(scope="module")
def sc_reference():
    """The port's in-process server on the weights its worker processes
    build from the scale matrix's model spec."""
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.serve import StreamingGenerator

    w = _cases.W
    cfg, params = port_build_model(w.sc_model_spec(), "cpu")
    prompts = w.sc_prompts()
    broker = ptk.InMemoryBroker()
    broker.create_topic("ref", partitions=w.SC_PARTS)
    for i in range(w.SC_PROMPTS):
        broker.produce("ref", prompts[i].tobytes(), partition=i % w.SC_PARTS,
                       key=str(i).encode())
    c = ptk.MemoryConsumer(broker, "ref", group_id="ref")
    gen = StreamingGenerator(c, params, cfg, slots=w.SLOTS, prompt_len=w.P,
                             max_new=w.MAX_NEW, commit_every=2, ticks_per_sync=1,
                             device="cpu")
    ref = {rec.key: toks for rec, toks in gen.run(idle_timeout_ms=400)}
    c.close()
    return ref


def test_matrix_names_registered_points():
    from torchkafka_tpu_torch.resilience.crashpoint import REGISTERED_CRASH_POINTS

    assert set(MATRIX) <= set(REGISTERED_CRASH_POINTS)
    assert all(_cases.MATRIX[p] == MATRIX[p] for p in MATRIX)


# The supervisor's own deaths host a fleet of worker grandchildren and then
# converge a fresh supervisor's fleet over the recovered broker: slow, as
# the reference's whole matrix is.
SLOW = ("scale_up_pre_spawn", "scale_down_mid_drain")


@pytest.mark.parametrize("point", [
    pytest.param(p, marks=pytest.mark.slow) if p in SLOW else p for p in MATRIX])
def test_port_crash_point(tmp_path, request, point):
    _cases._dispatch_case(tmp_path, request, point)
