"""The port's ring and Ulysses attention and the collectives under them,
against the JAX package at f32: ``tests/test_ops.py``'s ``TestRing``,
``TestRingFlash`` (JAX's Pallas kernels in interpret mode, the port's
kernels' plain versions) and ``TestUlysses``, case by case.

One gloo group of 4 processes runs every case once
(tests/_torch_tp_sp_cases.py, mode ``sp_ops``), each rank on its chunk of
the same seeded global tensors, while this process computes JAX's answer
on its 8-device virtual mesh laid out alike; the tests read both. Also
the collectives themselves: ``ppermute`` both ways with separate send and
receive staging buffers, ``all_to_all`` and its backward, Megatron's tp
pair, and the counts they add.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from torchkafka_tpu.ops.attention import ring_attention, ulysses_attention
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh

from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

NPROC = 4
# (name, fn, axes, (b, s, h, kv_heads, d), causal, use_flash, dtype)
CASES = [
    ("ring_sp4", "ring", {"sp": 4}, (4, 32, 2, 2, 8), True, None, "float32"),
    ("ring_data2_sp2", "ring", {"data": 2, "sp": 2}, (4, 32, 2, 2, 8), True, None, "float32"),
    ("ring_data4_sp1", "ring", {"data": 4, "sp": 1}, (4, 32, 2, 2, 8), True, None, "float32"),
    ("ringflash_data2_sp2", "ring", {"data": 2, "sp": 2}, (2, 256, 2, 2, 32), True, True,
     "float32"),
    ("ringflash_sp4", "ring", {"sp": 4}, (1, 512, 2, 2, 32), True, True, "float32"),
    ("ringflash_noncausal", "ring", {"data": 2, "sp": 2}, (2, 256, 2, 2, 32), False, True,
     "float32"),
    ("ringflash_bf16", "ring", {"data": 2, "sp": 2}, (2, 256, 2, 2, 32), True, True,
     "bfloat16"),
    ("uly_sp4", "ulysses", {"sp": 4}, (4, 32, 8, 8, 8), True, None, "float32"),
    ("uly_data2_sp2", "ulysses", {"data": 2, "sp": 2}, (4, 32, 8, 8, 8), True, None, "float32"),
    ("uly_data4_sp1", "ulysses", {"data": 4, "sp": 1}, (4, 32, 8, 8, 8), True, None, "float32"),
    ("uly_noncausal", "ulysses", {"data": 2, "sp": 2}, (4, 32, 4, 4, 8), False, None,
     "float32"),
    ("uly_gqa_unrepeated", "ulysses", {"sp": 4}, (2, 32, 8, 4, 8), True, None, "float32"),
    ("ulyflash_sp4", "ulysses", {"sp": 4}, (1, 256, 4, 4, 16), True, True, "float32"),
    ("uly_indivisible", "ulysses", {"sp": 4}, (4, 32, 2, 2, 8), True, None, "float32"),
]
RAISES = ("uly_indivisible",)
# The collectives' own cases: one group of 4, and 2 pairs (data x sp).
COLLECTIVES = {"collectives_sp4": {"sp": NPROC}, "collectives_pairs": {"data": 2, "sp": 2}}
# f32: sums in another order (XLA against torch, chunks merged across
# processes); bf16: the reference's own bound (tests/test_ops.py
# TestRingFlash.test_bf16_matches_dense).
TOL = {"float32": 1e-5, "bfloat16": 0.04}


def _inputs(name, shape, dtype):
    b, s, h, kh, d = shape
    rng = np.random.default_rng(sum(map(ord, name)))
    arrs = {"q": rng.normal(size=(b, s, h, d)), "k": rng.normal(size=(b, s, kh, d)),
            "v": rng.normal(size=(b, s, kh, d)), "dout": rng.normal(size=(b, s, h, d))}
    if dtype == "bfloat16":  # the same bf16 values in both packages
        return {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                for k, v in arrs.items()}
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _jax_case(fn, axes, causal, use_flash, dtype, x):
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    spec = P("data" if "data" in axes else None, "sp")
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, dout = (jax.device_put(jnp.asarray(x[n_], dt), NamedSharding(mesh, spec))
                     for n_ in ("q", "k", "v", "dout"))
    f = ring_attention if fn == "ring" else ulysses_attention
    out, vjp = jax.vjp(jax.jit(lambda a, b, c: f(a, b, c, mesh=mesh, causal=causal,
                                                   use_flash=use_flash)), q, k, v)
    grads = vjp(dout)
    return {"out": np.asarray(out.astype(jnp.float32)),
            **{g: np.asarray(t.astype(jnp.float32)) for g, t in zip(("dq", "dk", "dv"), grads)}}


def _assemble(per_rank, infos, name, what, shape):
    """The global array from each rank's chunk, placed by its coordinates."""
    b, s, h, kh, d = shape
    full = np.full((b, s, kh if what in ("dk", "dv") else h, d), np.nan, np.float32)
    for arrs, info in zip(per_rank, infos):
        coords = info[name]["coords"]
        part = arrs[f"{name}_{what}"]
        bl, sl = part.shape[:2]
        i, sp = coords.get("data", 0), coords.get("sp", 0)
        full[i * bl:(i + 1) * bl, sp * sl:(sp + 1) * sl] = part
    return full


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("sp_ops")
    inputs = {}
    for name, _, _, shape, _, _, dtype in CASES:
        for k, v in _inputs(name, shape, dtype).items():
            inputs[f"{name}_{k}"] = v
    np.savez(outdir / "sp_ops_in.npz", **inputs)
    cases = [{"name": name, "fn": fn, "axes": axes, "causal": causal, "use_flash": uf,
              "dtype": dtype} for name, fn, axes, _, causal, uf, dtype in CASES]
    cases += [{"name": name, "fn": "collectives", "axes": axes, "axis": "sp"}
              for name, axes in COLLECTIVES.items()]
    (outdir / "sp_ops_cases.json").write_text(json.dumps(cases))
    procs = spawn_pod(NPROC, str(outdir), "sp_ops")
    # JAX's answers while the ranks run.
    refs, raised = {}, {}
    for name, fn, axes, shape, causal, uf, dtype in CASES:
        x = {k: inputs[f"{name}_{k}"] for k in ("q", "k", "v", "dout")}
        try:
            refs[name] = _jax_case(fn, axes, causal, uf, dtype, x)
        except ValueError as e:
            raised[name] = str(e)
    codes = wait_all(procs, str(outdir), timeout_s=300)
    assert codes == [0] * NPROC, diagnose(procs, str(outdir))
    infos = [read(str(outdir), "sp_ops", pid) for pid in range(NPROC)]
    per_rank = [dict(np.load(outdir / f"sp_ops_out_{pid}.npz")) for pid in range(NPROC)]
    return {"refs": refs, "raised": raised, "infos": infos, "arrays": per_rank}


ATTN = [c for c in CASES if c[0] not in RAISES]


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_attention_matches_jax(run, case, what):
    """Output and the gradient of q, k, v (through ``dout``) of this
    case, all ranks' chunks put together, against JAX's on its mesh."""
    name, _, _, shape, _, _, dtype = case
    got = _assemble(run["arrays"], run["infos"], name, what, shape)
    ref = run["refs"][name][what]
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


def test_ulysses_indivisible_heads_raise_as_jax(run):
    """2 heads over sp=4: the JAX package's ValueError, word for word, on
    every rank."""
    want = run["raised"]["uly_indivisible"]
    assert "divisible" in want
    assert [i["uly_indivisible"]["raised"] for i in run["infos"]] == [want] * NPROC


def _coll(run, case):
    """Each group of the case's rows, in group-rank order."""
    rows = [i[case] for i in run["infos"]]
    groups: dict = {}
    for r in rows:
        groups.setdefault(r["coords"].get("data", 0), []).append(r)
    return [sorted(g, key=lambda r: r["rank"]) for g in groups.values()]


def _arrays(run, case, group):
    """The case's arrays of each rank of ``group``, in group-rank order."""
    by_rank = {}
    for arrs, info in zip(run["arrays"], run["infos"]):
        r = info[case]
        if r["coords"].get("data", 0) == group[0]["coords"].get("data", 0):
            by_rank[r["rank"]] = {k[len(case) + 1:]: v for k, v in arrs.items()
                                  if k.startswith(case + "_")}
    return [by_rank[i] for i in sorted(by_rank)]


CASES_C = list(COLLECTIVES)


@pytest.mark.parametrize("case", CASES_C)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [1, -1, 2])
def test_ppermute_moves_data_and_gradients(run, case, dtype, shift):
    """Each rank gets the value of rank (me - shift) mod n; the gradient
    comes back from rank (me + shift) mod n."""
    for group in _coll(run, case):
        for r in group:
            me, n = r["rank"], r["n"]
            value, uniform = r[f"ppermute_{dtype}_{shift}"]
            assert uniform and value == (me - shift) % n
            assert r[f"ppermute_grad_{dtype}_{shift}"] == (me + shift) % n + 1


@pytest.mark.parametrize("case", CASES_C)
def test_ppermute_stages_send_and_receive_apart(run, case):
    """Under gloo the bytes sent and the bytes received sit in separate
    staging buffers, and a run of large exchanges never hands a rank its
    own data back (in a group of 4, and between the 2 ranks of a pair,
    where each rank sends to and receives from the same peer)."""
    for group in _coll(run, case):
        for r in group:
            assert r["separate_buffers_float32"] and r["separate_buffers_bfloat16"]
            assert r["wrong_exchanges"] == 0


@pytest.mark.parametrize("case", CASES_C)
def test_all_to_all_and_its_backward(run, case):
    """``all_to_all(t, 1, 0)``: chunk j of dim 1 goes to rank j, the
    pieces concatenate along dim 0 in rank order (``lax.all_to_all``
    tiled); the backward is the inverse exchange of the gradient."""
    for group in _coll(run, case):
        arrays = _arrays(run, case, group)
        ins = [a["a2a_in"] for a in arrays]
        n = len(ins)
        for j in range(n):
            want = np.concatenate([np.split(ins[r], n, axis=1)[j] for r in range(n)], axis=0)
            np.testing.assert_array_equal(arrays[j]["a2a_out"], want)
            grad = np.concatenate([np.split(arrays[r]["a2a_w"], n, axis=0)[j]
                                   for r in range(n)], axis=1)
            np.testing.assert_array_equal(arrays[j]["a2a_grad"], grad)


@pytest.mark.parametrize("case", CASES_C)
def test_tp_pair_forward_and_backward(run, case):
    """copy_to_tp: identity forward, gradient summed over the group;
    reduce_from_tp: summed forward, identity backward."""
    for group in _coll(run, case):
        total = sum(range(1, len(group) + 1))
        for r in group:
            assert r["copy_to_tp_forward"] == r["rank"] + 1
            assert r["copy_to_tp_grad"] == total
            assert r["reduce_from_tp_forward"] == total
            assert r["reduce_from_tp_grad"] == r["rank"] + 1


@pytest.mark.parametrize("case", CASES_C)
def test_new_collectives_are_counted(run, case):
    """Every exchange adds to ``collectives.COUNTS``: a ppermute each way
    for each dtype and shift that moves data (a shift of 2 in a pair is
    the identity and sends nothing), 8 large ones, an all-to-all each way,
    2 all-reduces."""
    for group in _coll(run, case):
        for r in group:
            moving = sum(1 for shift in (1, -1, 2) if shift % r["n"])
            assert r["counted_calls"] == 2 * moving * 2 + 8 + 2 + 2
            assert r["counted_bytes"] > 8 * (1 << 18) * 4
