"""The port's ``gpipe`` (torchkafka_tpu_torch/ops/pipeline.py) against the
JAX package's at f32: JAX's ``gpipe`` on its 8-device virtual CPU mesh,
the port's on 8 gloo processes (tests/_torch_pp_ep_cases.py, mode
``pipeline``), from the same numpy inputs, over
``tests/test_pipeline_parallel.py`` ``TestGpipe``'s grid ((pp, M) = (2,
2), (4, 4), (4, 8), (2, 16) on ``{"data": 8 // pp, "pp": pp}``): the
output, and the gradients of its sum with respect to the stacked weights
and x, within 1e-5; the gradients also on ``{"data": 2, "pp": 4}`` at the
default M. Each stage runs its layers (L/P)·M times, never on a warm-up or
drain tick, and every rank makes the same M + P - 2 hops each way. Also:
pp = 1 is the plain loop, an indivisible M raises the JAX ``ValueError``,
and the collectives the pipeline adds (``broadcast``, the Megatron pair
over a tuple of groups).

One group of 8 processes runs every case once.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torchkafka_tpu.ops.pipeline import gpipe as jax_gpipe
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchkafka_tpu_torch.ops.pipeline import gpipe

from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

NPROC = 8
L, D = 8, 32
GRID = [(2, 2), (4, 4), (4, 8), (2, 16)]
TOL = 1e-5  # f32 sums in another order (torch against XLA)
# (name, pp, microbatches, x): the grid at B=16, then TestGpipe's gradient
# case at B=8 and the default M.
CASES = [(f"pp{pp}_m{m}", pp, m, "x16") for pp, m in GRID] + [("grad_pp4", 4, None, "x8")]


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(L, D, D)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(L, D)) * 0.1).astype(np.float32),
            "x16": rng.normal(size=(16, D)).astype(np.float32),
            "x8": rng.normal(size=(8, D)).astype(np.float32)}


def _jax_layer(a, layer):
    return jnp.tanh(a @ layer["w"] + layer["b"])


def _jax_ref(data, pp, m, x):
    """JAX's gpipe output and the gradients of its sum (weights and x)."""
    mesh = jax_make_mesh({"data": 8 // pp, "pp": pp}, devices=jax.devices()[:8])
    params = {n: jax.device_put(jnp.asarray(data[n]), NamedSharding(mesh, P("pp")))
              for n in ("w", "b")}

    def f(p, x):
        return jax_gpipe(_jax_layer, p, x, mesh=mesh, microbatches=m)

    out = jax.jit(f)(params, jnp.asarray(data[x]))
    gp, gx = jax.jit(jax.grad(lambda p, x: f(p, x).sum(), argnums=(0, 1)))(
        params, jnp.asarray(data[x]))
    return {"out": np.asarray(out), "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"]),
            "dx": np.asarray(gx)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("pipeline")
    data = _inputs()
    np.savez(outdir / "pipeline_in.npz", **data)
    cases = [{"name": name, "fn": "gpipe", "axes": {"data": 8 // pp, "pp": pp}, "m": m, "x": x}
             for name, pp, m, x in CASES]
    cases.append({"name": "pair", "fn": "pair", "axes": {"a": 2, "b": 4}})
    (outdir / "pipeline_cases.json").write_text(json.dumps(cases))
    procs = spawn_pod(NPROC, str(outdir), "pipeline")
    refs = {name: _jax_ref(data, pp, m, x) for name, pp, m, x in CASES}  # while the ranks run
    codes = wait_all(procs, str(outdir), timeout_s=300)
    assert codes == [0] * NPROC, diagnose(procs, str(outdir))
    infos = [read(str(outdir), "pipeline", pid) for pid in range(NPROC)]
    arrays = [dict(np.load(outdir / f"pipeline_out_{pid}.npz")) for pid in range(NPROC)]
    return {"refs": refs, "infos": infos, "arrays": arrays}


def _stages(run, name):
    """[(info, arrays)] of the data-0 ranks of case ``name``, by stage."""
    got = [(i[name], a) for i, a in zip(run["infos"], run["arrays"])
           if i[name]["coords"]["data"] == 0]
    return sorted(got, key=lambda r: r[0]["coords"]["pp"])


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name", IDS)
def test_output_matches_jax_on_every_rank(run, name):
    ref = run["refs"][name]["out"]
    for info, arrs in zip(run["infos"], run["arrays"]):
        np.testing.assert_allclose(arrs[f"{name}_out"], ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", IDS)
def test_weight_gradients_match_jax(run, name):
    """Each stage's gradients of its own layers, put together over pp."""
    stages = _stages(run, name)
    for g in ("dw", "db"):
        got = np.concatenate([a[f"{name}_{g}"] for _, a in stages])
        np.testing.assert_allclose(got, run["refs"][name][g], atol=TOL, rtol=0, err_msg=g)


@pytest.mark.parametrize("name", IDS)
def test_input_gradient_matches_jax_on_every_stage(run, name):
    """The input's gradient is non-zero on stage 0 alone; summed over pp,
    every stage holds it (the JAX package's psum)."""
    ref = run["refs"][name]["dx"]
    for arrs in run["arrays"]:
        np.testing.assert_allclose(arrs[f"{name}_dx"], ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", IDS)
def test_stages_skip_warmup_and_drain(run, name):
    """A stage runs its L/P layers once per microbatch, (L/P)·M calls; the
    JAX schedule computes every stage on all M + P - 1 ticks."""
    _, pp, m, x = CASES[IDS.index(name)]
    m = pp if m is None else m
    for info in run["infos"]:
        assert info[name]["layer_calls"] == (L // pp) * m


@pytest.mark.parametrize("name", IDS)
def test_every_rank_makes_the_same_hops(run, name):
    """M + P - 2 hops forward (the last tick hands nothing on) and the
    broadcast of the output; the same hops backward and the input
    gradient's sum over pp. The same count on every stage, or gloo waits."""
    _, pp, m, _ = CASES[IDS.index(name)]
    m = pp if m is None else m
    for info in run["infos"]:
        assert info[name]["forward_collectives"] == m + pp - 2 + 1
        assert info[name]["collectives"] == 2 * (m + pp - 2) + 2


def test_broadcast_and_the_pair_over_two_groups(run):
    """``broadcast`` from group rank 3: every rank gets the source's
    values; backward, the source keeps its own gradient and the others get
    zeros. ``copy_to_tp``/``reduce_from_tp`` over (a, b): a sum over all 8
    ranks in the backward or the forward respectively."""
    infos = [i["pair"] for i in run["infos"]]
    assert len(infos) == NPROC
    total = sum(i["me"] + 1 for i in infos)
    for i in infos:
        src = i["coords"]["a"] * 4 + 3
        assert i["broadcast_forward"] == [float(src)] * 5
        want = float(i["me"] + 1) if i["coords"]["b"] == 3 else 0.0
        assert i["broadcast_grad"] == [want] * 5
        assert i["copy_forward"] == i["me"] + 1 and i["copy_grad"] == total
        assert i["reduce_forward"] == total and i["reduce_grad"] == i["me"] + 1


class _FakeMesh:
    def __init__(self, axes: dict) -> None:
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))


def _torch_layer(a, layer):
    return torch.tanh(a @ layer["w"] + layer["b"])


def test_pp1_is_the_sequential_loop():
    """With pp = 1, gpipe is the loop over the layers, bit for bit; and it
    matches JAX's sequential scan."""
    data = _inputs()
    params = {n: torch.from_numpy(data[n]) for n in ("w", "b")}
    x = torch.from_numpy(data["x8"])
    want = x
    for i in range(L):
        want = _torch_layer(want, {"w": params["w"][i], "b": params["b"][i]})
    got = gpipe(_torch_layer, params, x, mesh=_FakeMesh({"data": 8, "pp": 1}))
    assert torch.equal(got, want)
    ref = jax.lax.scan(lambda a, layer: (_jax_layer(a, layer), None), jnp.asarray(data["x8"]),
                       {n: jnp.asarray(data[n]) for n in ("w", "b")})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_indivisible_microbatches_rejected():
    data = _inputs()
    params = {n: torch.from_numpy(data[n][:2]) for n in ("w", "b")}
    with pytest.raises(ValueError, match="divisible"):
        gpipe(_torch_layer, params, torch.zeros(10, D), mesh=_FakeMesh({"data": 2, "pp": 4}),
              microbatches=4)
