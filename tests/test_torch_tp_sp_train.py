"""The port's tensor- and sequence-parallel train step against the JAX
package at f32: JAX's ``make_train_step(cfg, mesh, adamw)`` on its
8-device virtual CPU mesh, the port's on gloo processes
(tests/_torch_tp_sp_cases.py, mode ``tp_sp_train``), from the same
parameters and the same global batches, 3 steps, on ``{"tp": 2}``,
``{"sp": 2}`` (ring and Ulysses), ``{"data": 2, "tp": 2, "sp": 2}`` (ring
and Ulysses; its 2 kv heads split over tp leave one a rank, which Ulysses
repeats before its exchange) and ``{"data": 2, "fsdp": 2, "tp": 2}``
(``tests/test_models.py`` ``TestTraining``'s meshes). Also the first
step's gradients against the single-process step's (no sum over tp: a
replicated parameter's gradient is not counted twice), the targets at a
chunk boundary under sp, ``flash_attention_sharded`` over tp and the
Transformer's flash dispatch on a tp mesh (``tests/test_flash.py``
``TestShardedFlash``).

One group of 8 processes runs every case once; the 2-rank meshes lie on
disjoint ranks and run at the same time.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.ops.flash import flash_attention_sharded as jax_flash_sharded
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh

from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

NPROC = 8
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
           max_seq_len=16)
LR = 1e-2
STEPS, GLOBAL_B, SEQ = 3, 8, 16
# tests/test_torch_mesh_train.py's tolerances: f32 sums in another order.
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-4
GRAD_REL = 1e-5
# (name, axes, ranks, attn_impl)
TRAIN = [
    ("tp2", {"tp": 2}, [0, 1], "auto"),
    ("sp2_ring", {"sp": 2}, [2, 3], "ring"),
    ("sp2_ulysses", {"sp": 2}, [4, 5], "ulysses"),
    ("data2_tp2_sp2_ring", {"data": 2, "tp": 2, "sp": 2}, None, "auto"),
    ("data2_tp2_sp2_ulysses", {"data": 2, "tp": 2, "sp": 2}, None, "ulysses"),
    ("data2_fsdp2_tp2", {"data": 2, "fsdp": 2, "tp": 2}, None, "auto"),
]
FLASH_MESH = {"data": 2, "fsdp": 2, "tp": 2}
DISPATCH_CFG = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    d_ff=128, max_seq_len=128)


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


def _jax_init():
    """JAX's initial parameters (every mesh's init_fn draws the same ones)
    and the global batches, as numpy."""
    cfg = jt.TransformerConfig(**CFG, dtype=jnp.float32, param_dtype=jnp.float32)
    init = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0), cfg)
    tokens = np.random.default_rng(1).integers(
        0, CFG["vocab_size"], (STEPS, GLOBAL_B, SEQ)).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, init), tokens


def _jax_train(axes, impl, init, tokens):
    """JAX's mesh train step from ``init``, 3 steps; and the dense model's
    loss on the first batch."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    cfg = jt.TransformerConfig(**CFG, attn_impl=impl, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    _, step_fn = jt.make_train_step(cfg, mesh, optax.adamw(LR))
    params = jax.device_put(init, jt.shardings_for_mesh(mesh, jt.param_specs(cfg)))
    opt = optax.adamw(LR).init(params)
    mask = jnp.ones((GLOBAL_B, SEQ), jnp.int32)
    losses = []
    for s in range(STEPS):
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens[s]), mask)
        losses.append(float(loss))
    return {"losses": losses, "final": jax.tree_util.tree_map(np.asarray, params)}


def _jax_dense_loss(init, tokens):
    """The dense model's loss on the first batch (no mesh)."""
    cfg = jt.TransformerConfig(**CFG, attn_impl="dense", dtype=jnp.float32,
                               param_dtype=jnp.float32)
    mask = jnp.ones((GLOBAL_B, SEQ), jnp.int32)
    return float(jt.Transformer(cfg).loss(init, jnp.asarray(tokens[0]), mask))


def _flash_inputs():
    rng = np.random.default_rng(3)
    shapes = {"q": (4, 128, 4, 32), "k": (4, 128, 2, 32), "v": (4, 128, 2, 32),
              "dout": (4, 128, 4, 32)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _jax_flash(x):
    mesh = jax_make_mesh(FLASH_MESH, devices=jax.devices()[:8])
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_sharded(q, k, v, mesh, True, interpret=True),
                       *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    grads = vjp(jnp.asarray(x["dout"]))
    return {"out": np.asarray(out), **{g: np.asarray(t) for g, t in
                                       zip(("dq", "dk", "dv"), grads)}}


def _jax_dispatch():
    cfg = jt.TransformerConfig(**DISPATCH_CFG, dtype=jnp.float32, attn_impl="dense")
    params = jt.init_params(jax.random.key(0), cfg)
    toks = np.random.default_rng(0).integers(0, 512, (8, 128)).astype(np.int32)
    logits = np.asarray(jax.jit(lambda p, t: jt.Transformer(cfg)(p, t))(params, toks))
    return jax.tree_util.tree_map(np.asarray, params), toks, logits


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("tp_sp_train")
    init, tokens = _jax_init()
    arrays = {}
    for name, *_ in TRAIN:
        arrays.update({f"{name}/init/{k}": v for k, v in _flat(init).items()})
        arrays[f"{name}/tokens"] = tokens
    flash_in = _flash_inputs()
    arrays.update({f"flash_{k}": v for k, v in flash_in.items()})
    d_params, d_toks, d_logits = _jax_dispatch()
    arrays.update({f"dispatch/{k}": v for k, v in _flat(d_params).items()})
    arrays["dispatch_tokens"] = d_toks
    np.savez(outdir / "tp_sp_train_in.npz", **arrays)
    cases = [{"name": name, "fn": "train", "axes": axes, "ranks": ranks, "lr": LR,
              "cfg": {**CFG, "attn_impl": impl}} for name, axes, ranks, impl in TRAIN]
    cases.insert(3, {"name": "boundary", "fn": "boundary", "axes": {"sp": 2},
                     "ranks": [6, 7], "cfg": CFG})
    cases += [{"name": "flash", "fn": "flash_sharded", "axes": FLASH_MESH},
              {"name": "dispatch", "fn": "dispatch", "axes": FLASH_MESH,
               "cfg": DISPATCH_CFG}]
    (outdir / "tp_sp_train_cases.json").write_text(json.dumps(cases))
    procs = spawn_pod(NPROC, str(outdir), "tp_sp_train")
    # JAX's answers while the ranks run.
    refs = {name: _jax_train(axes, impl, init, tokens) for name, axes, _, impl in TRAIN}
    flash_ref = _jax_flash(flash_in)
    dense_loss = _jax_dense_loss(init, tokens)
    codes = wait_all(procs, str(outdir), timeout_s=300)
    assert codes == [0] * NPROC, diagnose(procs, str(outdir))
    infos = [read(str(outdir), "tp_sp_train", pid) for pid in range(NPROC)]
    per_rank = [dict(np.load(outdir / f"tp_sp_train_out_{pid}.npz")) for pid in range(NPROC)]
    return {"refs": refs, "dense_loss": dense_loss, "flash_ref": flash_ref,
            "dispatch_logits": d_logits,
            "infos": infos, "arrays": per_rank}


def _ranks(run, name):
    return [i[name] for i in run["infos"] if name in i]


IDS = [c[0] for c in TRAIN]


@pytest.mark.parametrize("name", IDS)
def test_losses_match_jax(run, name):
    """Every rank returns the global loss of each of the 3 steps."""
    want = run["refs"][name]["losses"]
    ranks = _ranks(run, name)
    assert len(ranks) == (2 if len(TRAIN[IDS.index(name)][1]) == 1 else NPROC)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("name", IDS)
def test_parameters_match_jax_after_3_steps(run, name):
    got = {k[len(name) + 1:]: v for a in run["arrays"] for k, v in a.items()
           if k.startswith(name + "/")}
    want = _flat(run["refs"][name]["final"])
    assert set(got) == set(want)
    for k, ref in want.items():
        np.testing.assert_allclose(got[k], ref, atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", IDS)
def test_first_step_gradients_match_the_single_process_step(run, name):
    """Each parameter's gradient after the mesh step's collectives (put
    together from every rank's shard) against the single-process step's on
    the same parameters and global batch. A sum over tp would double the
    replicated ``ln1``/``ln2``/``ln_f`` (relative error 1)."""
    for r in _ranks(run, name):
        rel = r["grads_rel"]
        assert len(rel) == 12
        bad = {k: v for k, v in rel.items() if not v <= GRAD_REL}
        assert not bad, bad


@pytest.mark.parametrize("name", ["data2_tp2_sp2_ring", "data2_tp2_sp2_ulysses", "sp2_ring",
                                  "sp2_ulysses"])
def test_sp_mesh_loss_matches_dense_loss(run, name):
    """``tests/test_models.py``'s ring and Ulysses cases: the first step's
    loss (before any update) equals the dense model's on the same batch."""
    for r in _ranks(run, name):
        assert abs(r["losses"][0] - run["dense_loss"]) < LOSS_ATOL


def test_tp_shards_are_local(run):
    """Under tp=2 each rank keeps half the heads, half the d_ff columns
    and half the vocabulary of ``embed``/``lm_head``."""
    for r in _ranks(run, "tp2"):
        s = r["local_shapes"]
        assert s["wq"] == [2, 32, 2, 8] and s["wk"] == [2, 32, 1, 8]
        assert s["wo"] == [2, 2, 8, 32] and s["w_down"] == [2, 32, 32]
        assert s["w_gate"] == [2, 32, 32] and s["ln1"] == [2, 32]
        assert s["embed"] == [32, 32] and s["lm_head"] == [32, 32]


def test_tp_step_moves_no_gradient_sums(run):
    """On {"tp": 2} alone no gradient is summed: each step's collectives
    are the 2 vocab gathers and the layers' tp all-reduces, 4 a layer."""
    for r in _ranks(run, "tp2"):
        assert [s["calls"] for s in r["stats"]] == [2 + 4 * CFG["n_layers"]] * STEPS


def test_sp_targets_cross_the_chunk_boundary(run):
    """Under sp the shift is taken on the full rows: chunk 0's last
    position predicts chunk 1's first token; the last chunk's last
    position is masked, as are padded positions."""
    ranks = sorted(_ranks(run, "boundary"), key=lambda r: r["coords"]["sp"])
    assert len(ranks) == 2
    full = np.arange(32).reshape(2, 16)
    for r in ranks:
        i = r["coords"]["sp"]
        np.testing.assert_array_equal(r["chunk"], full[:, 8 * i:8 * (i + 1)])
        np.testing.assert_array_equal(np.array(r["targets"])[:, :7], full[:, 8 * i + 1:8 * i + 8])
    assert [row[-1] for row in ranks[0]["targets"]] == [8, 24]
    assert ranks[0]["mask"][0] == [1.0] * 8
    assert ranks[1]["mask"][0][-1] == 0.0 and ranks[1]["mask"][0][:7] == [1.0] * 7
    assert ranks[1]["mask"][1] == [1.0] * 3 + [0.0] * 5  # padded from position 12


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_flash_attention_sharded_over_tp_matches_jax(run, what):
    """Each rank's K1 (and K2/K3 in the backward) on its own rows and
    heads of a {"data": 2, "fsdp": 2, "tp": 2} mesh, against JAX's
    shard_map'd Pallas kernel in interpret mode on the same global
    tensors."""
    ref = run["flash_ref"][what]
    got = np.full(ref.shape, np.nan, np.float32)
    for arrs, info in zip(run["arrays"], run["infos"]):
        c = info["flash"]["coords"]
        part = arrs[f"flash_{what}"]
        row = c["data"] * 2 + c["fsdp"]
        hl = part.shape[2]
        got[row:row + 1, :, c["tp"] * hl:(c["tp"] + 1) * hl] = part
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_transformer_flash_dispatch_on_a_tp_mesh(run):
    """attn_impl="flash" on {"data": 2, "fsdp": 2, "tp": 2} engages
    ``flash_attention_sharded``; the forward on each rank's rows and heads
    gives the dense JAX model's logits (tests/test_flash.py's bound)."""
    ref = run["dispatch_logits"]
    for arrs, info in zip(run["arrays"], run["infos"]):
        c = info["dispatch"]["coords"]
        assert info["dispatch"]["flash_shard_mesh"]
        row = (c["data"] * 2 + c["fsdp"]) * 2
        np.testing.assert_allclose(arrs["dispatch_logits"], ref[row:row + 2], atol=2e-4)
