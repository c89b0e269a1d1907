"""The port's pipeline- and expert-parallel train steps against the JAX
package at f32: JAX's ``make_train_step(cfg, mesh, adamw)`` on its
8-device virtual CPU mesh, the port's on 8 gloo processes
(tests/_torch_pp_ep_cases.py, mode ``pp_ep_train``), from the same
parameters and global batches, 3 steps, on
``tests/test_pipeline_parallel.py`` ``TestTransformerPP``'s meshes
(``{"data": 2, "pp": 4}``, ``{"pp": 2, "sp": 2, "data": 2}`` with ring
and with Ulysses), ``{"data": 2, "pp": 2, "tp": 2}``, and
``tests/test_moe.py``'s (``{"data": 2, "ep": 2, "tp": 2}`` and
``{"data": 2, "ep": 2, "sp": 2}`` dense, ``{"data": 2, "ep": 2, "tp":
2}`` capacity at factors 2.0, 4.0 and 0.5, the last with drops), and MoE
on ``{"data": 2, "pp": 2, "ep": 2}``. Also: the first step's gradients
against the single-process step's (no sum over pp, ep or tp); the
capacity drop sets (the kept (token, choice) pairs) equal to JAX's; the
router aux of ``Transformer(cfg, mesh)`` on ``{"data": 4, "pp": 2}`` and
``{"data": 2, "pp": 2, "ep": 2}`` within 1e-5 of JAX's; and the DLRM step
on ``tests/test_recsys.py``'s meshes (``{"data": 8}``, ``{"data": 2,
"tp": 4}``, ``{"data": 4, "fsdp": 2}``) against JAX's. The refusals the
port keeps from the JAX package, and the capacity groups it cannot place,
raise ``ValueError`` (on fake meshes, in this process).

One group of 8 processes runs every case once.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchkafka_tpu.models import recsys as jr
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchkafka_tpu_torch.models import transformer as pt

from tests._torch_pp_ep_cases import kept_pairs, record_capacity
from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

NPROC = 8
# tests/test_pipeline_parallel.py's and tests/test_moe.py's configurations.
CFG_PP = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=64,
              max_seq_len=16)
MOE = dict(CFG_PP, n_layers=2, n_experts=4, expert_top_k=2)
LR = 1e-2
STEPS, GLOBAL_B, SEQ = 3, 8, 16
# tests/test_torch_tp_sp_train.py's tolerances: f32 sums in another order.
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-4
GRAD_REL = 1e-5
AUX_RTOL = 1e-5
CAP = dict(MOE, moe_dispatch="capacity")
# (name, axes, cfg)
TRAIN = [
    ("data2_pp4", {"data": 2, "pp": 4}, CFG_PP),
    ("pp2_sp2_data2_ring", {"pp": 2, "sp": 2, "data": 2}, CFG_PP),
    ("pp2_sp2_data2_ulysses", {"pp": 2, "sp": 2, "data": 2}, dict(CFG_PP, attn_impl="ulysses")),
    ("data2_pp2_tp2", {"data": 2, "pp": 2, "tp": 2}, CFG_PP),
    ("moe_data2_ep2_tp2", {"data": 2, "ep": 2, "tp": 2}, MOE),
    ("moe_data2_ep2_sp2", {"data": 2, "ep": 2, "sp": 2}, MOE),
    ("cap2_data2_ep2_tp2", {"data": 2, "ep": 2, "tp": 2}, dict(CAP, capacity_factor=2.0)),
    ("cap4_data2_ep2_tp2", {"data": 2, "ep": 2, "tp": 2}, dict(CAP, capacity_factor=4.0)),
    ("cap05_data2_ep2_tp2", {"data": 2, "ep": 2, "tp": 2}, dict(CAP, capacity_factor=0.5)),
    ("moe_data2_pp2_ep2", {"data": 2, "pp": 2, "ep": 2}, MOE),
]
CAPACITY = [name for name, _, cfg in TRAIN if cfg.get("moe_dispatch") == "capacity"]
# tests/test_pipeline_parallel.py's aux test: its 4-layer MoE at an ample
# capacity factor. Capacity at the default M=2 on these batch-sharded meshes
# is refused (test_capacity_groups_the_port_cannot_place_raise); with one
# microbatch the groups are the global batch's, as in JAX.
AUX_CFG = dict(CFG_PP, n_experts=4, expert_top_k=2)
AUX = [
    ("aux_data4_pp2_dense", {"data": 4, "pp": 2}, AUX_CFG),
    ("aux_data4_pp2_capacity", {"data": 4, "pp": 2},
     dict(AUX_CFG, moe_dispatch="capacity", capacity_factor=4.0, pp_microbatches=1)),
    ("aux_data2_pp2_ep2_dense", {"data": 2, "pp": 2, "ep": 2}, AUX_CFG),
    ("aux_data2_pp2_ep2_capacity", {"data": 2, "pp": 2, "ep": 2},
     dict(AUX_CFG, moe_dispatch="capacity", capacity_factor=4.0, pp_microbatches=1)),
]
DLRM_CFG = dict(dense_dim=4, vocab_sizes=[64, 32, 128], embed_dim=8, bottom_mlp=[16, 8],
                top_mlp=[32, 1])  # tests/test_recsys.py's
DLRM_STEPS, DLRM_B, DLRM_LR = 2, 32, 1e-2
DLRM = [("dlrm_data8", {"data": 8}), ("dlrm_data2_tp4", {"data": 2, "tp": 4}),
        ("dlrm_data4_fsdp2", {"data": 4, "fsdp": 2})]


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


def _jcfg(cfg: dict):
    return jt.TransformerConfig(**cfg, dtype=jnp.float32, param_dtype=jnp.float32)


def _tokens():
    return np.random.default_rng(1).integers(
        0, CFG_PP["vocab_size"], (STEPS, GLOBAL_B, SEQ)).astype(np.int32)


def _jax_init(cfg: dict):
    params = jax.jit(jt.init_params, static_argnums=1)(jax.random.key(0), _jcfg(cfg))
    return jax.tree_util.tree_map(np.asarray, params)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _jax_train(axes, cfg, init, tokens):
    mesh = _mesh(axes)
    jcfg = _jcfg(cfg)
    _, step_fn = jt.make_train_step(jcfg, mesh, optax.adamw(LR))
    params = jax.device_put(init, jt.shardings_for_mesh(mesh, jt.param_specs(jcfg)))
    opt = optax.adamw(LR).init(params)
    mask = jnp.ones((GLOBAL_B, SEQ), jnp.int32)
    losses = []
    for s in range(STEPS):
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens[s]), mask)
        losses.append(float(loss))
    return {"losses": losses, "final": jax.tree_util.tree_map(np.asarray, params)}


def _jax_kept(cfg, init, tokens):
    """JAX's capacity drop set on the first batch, layer by layer through
    the unsharded model (its groups are the global batch's, as on the
    mesh): each jitted layer returns the slot positions its capacity
    dispatch gave ``jax.nn.one_hot``."""
    from torchkafka_tpu.models.quant import embed_rows

    jcfg = _jcfg(cfg)
    model = jt.Transformer(jcfg)

    @jax.jit
    def layer(x, weights):
        with record_capacity(jax.nn, "one_hot") as found:
            x, _ = model._layer(x, weights)
        (idx_g, pos, _), = found
        return x, idx_g, pos

    x = embed_rows(init["embed"], jnp.asarray(tokens[0]), jcfg.dtype)
    found = []
    cap = jt.moe_capacity(jcfg, min(jcfg.moe_group_size, GLOBAL_B * SEQ))
    for i in range(jcfg.n_layers):
        x, idx_g, pos = layer(x, {k: v[i] for k, v in init["layers"].items()})
        found.append((idx_g, pos, cap))
    return kept_pairs(found, GLOBAL_B * SEQ, cfg["expert_top_k"])


def _jax_aux(axes, cfg, init, tokens):
    mesh = _mesh(axes)
    jcfg = _jcfg(cfg)
    _, aux = jax.jit(lambda p, t: jt.Transformer(jcfg, mesh)(p, t, return_aux=True))(
        init, jnp.asarray(tokens[0]))
    _, aux_seq = jt.Transformer(jcfg)(init, jnp.asarray(tokens[0]), return_aux=True)
    return float(aux), float(aux_seq)


def _dlrm_data():
    rng = np.random.default_rng(2)
    highs = np.asarray(DLRM_CFG["vocab_sizes"])
    return {"dense": rng.normal(size=(DLRM_B, DLRM_CFG["dense_dim"])).astype(np.float32),
            "cats": rng.integers(0, highs, (DLRM_B, len(highs))).astype(np.int32),
            "labels": rng.integers(0, 2, DLRM_B).astype(np.float32),
            "mask": np.ones(DLRM_B, np.float32)}


def _dlrm_jcfg():
    return jr.DLRMConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in DLRM_CFG.items()},
                         dtype=jnp.float32, param_dtype=jnp.float32)


def _jax_dlrm(axes, batch, init):
    """JAX's DLRM mesh step from ``init`` (the draws of its init_fn), 2
    steps."""
    mesh = _mesh(axes)
    cfg = _dlrm_jcfg()
    _, step_fn = jr.make_dlrm_train_step(cfg, mesh, optax.adam(DLRM_LR))
    params = jax.device_put(init, jt.shardings_for_mesh(mesh, jr.param_specs(cfg)))
    opt = optax.adam(DLRM_LR).init(params)
    losses = []
    for _ in range(DLRM_STEPS):
        params, opt, loss = step_fn(params, opt, *(jnp.asarray(batch[n]) for n in (
            "dense", "cats", "labels", "mask")))
        losses.append(float(loss))
    return {"losses": losses, "final": [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("pp_ep_train")
    tokens = _tokens()
    inits = {json.dumps(cfg, sort_keys=True): None for _, _, cfg in TRAIN + AUX}
    for key in inits:
        cfg = {k: v for k, v in json.loads(key).items()
               if k not in ("attn_impl", "moe_dispatch", "capacity_factor", "pp_microbatches")}
        inits[key] = _jax_init(cfg)  # the same draws for every dispatch and impl

    def init_of(cfg):
        return inits[json.dumps(cfg, sort_keys=True)]

    arrays = {}
    for name, _, cfg in TRAIN + AUX:
        arrays.update({f"{name}/init/{k}": v for k, v in _flat(init_of(cfg)).items()})
        arrays[f"{name}/tokens"] = tokens if name in IDS else tokens[0]
    batch = _dlrm_data()
    d_init = jax.tree_util.tree_map(np.asarray, jax.jit(jr.init_params, static_argnums=1)(
        jax.random.key(0), _dlrm_jcfg()))
    for name, _ in DLRM:
        arrays.update({f"{name}/{k}": v for k, v in batch.items()})
        for i in range(len(DLRM_CFG["vocab_sizes"])):
            arrays[f"{name}/t{i}"] = d_init["tables"][f"t{i}"]
        for part in ("bottom", "top"):
            for i, (w, b) in enumerate(d_init[part]):
                arrays[f"{name}/{part}{i}_w"], arrays[f"{name}/{part}{i}_b"] = w, b
    np.savez(outdir / "pp_ep_train_in.npz", **arrays)
    cases = [{"name": n, "fn": "train", "axes": a, "lr": LR, "cfg": c} for n, a, c in TRAIN]
    cases += [{"name": n, "fn": "aux", "axes": a, "cfg": c} for n, a, c in AUX]
    cases += [{"name": n, "fn": "dlrm", "axes": a, "cfg": DLRM_CFG, "lr": DLRM_LR,
               "steps": DLRM_STEPS} for n, a in DLRM]
    (outdir / "pp_ep_train_cases.json").write_text(json.dumps(cases))
    procs = spawn_pod(NPROC, str(outdir), "pp_ep_train")
    # JAX's answers while the ranks run; the train steps compile in
    # threads (XLA compiles and runs outside the GIL). The drop sets are
    # recorded alone: their spy on jax.nn.one_hot is process-wide.
    with ThreadPoolExecutor(4) as pool:
        jobs = {n: pool.submit(_jax_train, a, c, init_of(c), tokens) for n, a, c in TRAIN}
        jobs.update({n: pool.submit(_jax_dlrm, a, batch, d_init) for n, a in DLRM})
        refs = {n: j.result() for n, j in jobs.items()}
    kept = {n: _jax_kept(c, init_of(c), tokens) for n, _, c in TRAIN if n in CAPACITY}
    aux = {n: _jax_aux(a, c, init_of(c), tokens) for n, a, c in AUX}
    codes = wait_all(procs, str(outdir), timeout_s=400)
    assert codes == [0] * NPROC, diagnose(procs, str(outdir))
    infos = [read(str(outdir), "pp_ep_train", pid) for pid in range(NPROC)]
    per_rank = [dict(np.load(outdir / f"pp_ep_train_out_{pid}.npz")) for pid in range(NPROC)]
    return {"refs": refs, "kept": kept, "aux": aux, "infos": infos, "arrays": per_rank}


def _ranks(run, name):
    return [i[name] for i in run["infos"] if name in i]


IDS = [c[0] for c in TRAIN]


@pytest.mark.parametrize("name", IDS)
def test_losses_match_jax(run, name):
    """Every rank returns the global loss of each of the 3 steps (the
    router aux counted once)."""
    want = run["refs"][name]["losses"]
    ranks = _ranks(run, name)
    assert len(ranks) == NPROC
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
    together from every rank's shard) against the single-process step's.
    A sum over pp would multiply the embedding's and the head's gradients
    by the stages, one over ep or tp the router's and the norms'."""
    cfg = TRAIN[IDS.index(name)][2]
    for r in _ranks(run, name):
        rel = r["grads_rel"]
        assert len(rel) == (13 if cfg.get("n_experts") else 12)
        bad = {k: v for k, v in rel.items() if not v <= GRAD_REL}
        assert not bad, bad


@pytest.mark.parametrize("name", CAPACITY)
def test_capacity_drop_set_matches_jax(run, name):
    """The (global token, choice) pairs that got an expert slot in each
    layer on the first step, put together over the data ranks, equal the
    JAX package's: the global batch's 128 tokens form one group over the
    two data ranks, so each rank's slots start after the lower rank's."""
    want = [set(map(tuple, layer)) for layer in run["kept"][name]]
    got = [set() for _ in want]
    for r in _ranks(run, name):
        assert len(r["kept"]) == len(want)
        for i, layer in enumerate(r["kept"]):
            got[i] |= set(map(tuple, layer))
    assert got == want
    n_pairs = GLOBAL_B * SEQ * MOE["expert_top_k"]
    if name.startswith("cap05"):  # capacity 32 a group: pairs drop
        assert all(len(layer) < n_pairs for layer in want)


def test_pipeline_and_expert_shards_are_local(run):
    """Under pp each rank keeps its stage's layers; under ep its experts,
    each one's d_ff columns split over tp."""
    for r in _ranks(run, "data2_pp4"):
        assert r["local_shapes"]["wq"] == [1, 32, 4, 8]
    for r in _ranks(run, "moe_data2_ep2_tp2"):
        s = r["local_shapes"]
        assert s["w_gate"] == [2, 2, 32, 32] and s["w_down"] == [2, 2, 32, 32]
        assert s["router"] == [2, 32, 4]
    for r in _ranks(run, "moe_data2_pp2_ep2"):
        assert r["local_shapes"]["w_up"] == [1, 2, 32, 64]


@pytest.mark.parametrize("name", [a[0] for a in AUX])
def test_router_aux_matches_jax(run, name):
    """``Transformer(cfg, mesh)(..., return_aux=True)``: the statistics
    summed over the microbatches, the stages and the data ranks give the
    global batch's aux on every rank (JAX's mesh aux and its unsharded
    one)."""
    want, want_seq = run["aux"][name]
    ranks = _ranks(run, name)
    assert len(ranks) == NPROC and want > 0
    for r in ranks:
        assert r["logits_finite"]
        np.testing.assert_allclose(r["aux"], want, rtol=AUX_RTOL)
        np.testing.assert_allclose(r["aux"], want_seq, rtol=AUX_RTOL)


@pytest.mark.parametrize("name", [d[0] for d in DLRM])
def test_dlrm_losses_match_jax(run, name):
    want = run["refs"][name]["losses"]
    for r in _ranks(run, name):
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("name", [d[0] for d in DLRM])
def test_dlrm_parameters_match_jax(run, name):
    """From the same initial parameters, after 2 steps each leaf (tables
    put together over tp) equals JAX's."""
    leaves = {k: a for arrs in run["arrays"] for k, a in arrs.items()
              if k.startswith(name + "/leaf")}
    got = [leaves[f"{name}/leaf{i}"] for i in range(len(leaves))]
    want = run["refs"][name]["final"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0)


def test_dlrm_tables_are_row_sharded_over_tp(run):
    """On {"data": 2, "tp": 4} each rank keeps a quarter of every table's
    rows; the lookup's sum over tp is the step's only collective beside
    the gradient and loss sums over data (never over tp)."""
    for r in _ranks(run, "dlrm_data2_tp4"):
        assert r["table_rows"] == [16, 8, 32]
        n_leaves = 3 + 2 * 2 + 2 * 2
        # count sum + 3 lookups forward + every gradient over data + loss sum
        assert [s["calls"] for s in r["stats"]] == [1 + 3 + n_leaves + 1] * DLRM_STEPS
    for r in _ranks(run, "dlrm_data8"):
        assert r["table_rows"] == [64, 32, 128]


# ----------------------------------------------------- refusals, no ranks


class _FakeMesh:
    """The axis sizes a mesh carries, without a process group."""

    def __init__(self, axes: dict) -> None:
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_pp_with_sp_needs_sequence_parallel_attention(impl):
    """The JAX package's refusal, with its message."""
    cfg = pt.TransformerConfig(**CFG_PP, attn_impl=impl)
    with pytest.raises(ValueError, match="a pp mesh with sp>1 requires sequence-parallel"):
        pt.Transformer(cfg, _FakeMesh({"pp": 2, "sp": 2, "data": 2}))


@pytest.mark.parametrize("axes,b,s,group,match", [
    ({"data": 4, "pp": 2}, 2, 16, 256, "microbatches on a batch-sharded mesh"),
    ({"data": 2, "ep": 2, "sp": 2}, 4, 8, 256, "cross the sp chunks"),
    ({"data": 2, "ep": 2}, 3, 16, 32, "straddle"),
], ids=["pp_microbatches", "sp_chunks", "straddle"])
def test_capacity_groups_the_port_cannot_place_raise(axes, b, s, group, match):
    """Capacity groups the JAX package forms over tokens that no rank's
    tokens line up with: pp microbatches on a batch-sharded mesh (a rank's
    microbatch holds other rows than JAX's global microbatch), groups
    across sp chunks, and groups of 32 over ranks of 48 tokens."""
    cfg = pt.TransformerConfig(**CAP, moe_group_size=group)
    with pytest.raises(ValueError, match=match):
        pt.Transformer(cfg, _FakeMesh(axes))._capacity_span(b, s)


@pytest.mark.parametrize("axes,b,s,want", [
    ({"data": 2, "ep": 2, "tp": 2}, 4, 16, (128, 2)),
    ({"data": 2, "ep": 2}, 16, 16, None),
    ({"data": 4, "pp": 2}, 2, 16, (128, 4)),
], ids=["one_group_two_ranks", "local_groups", "pp_one_microbatch"])
def test_capacity_group_placement(axes, b, s, want):
    """Where a rank's tokens lie in JAX's global groups: the JAX tests'
    8 x 16 tokens form one group of 128 over two data ranks; 16 x 16
    tokens a rank hold whole groups of 256; under pp with one microbatch
    the group is the global batch, over four data ranks."""
    cfg = pt.TransformerConfig(**CAP, pp_microbatches=1 if "pp" in axes else None)
    span = pt.Transformer(cfg, _FakeMesh(axes))._capacity_span(b, s)
    assert (None if span is None else (span.n_g, span.n_g // (b * s))) == want


@pytest.mark.parametrize("axes,match", [
    ({"pp": 3}, "pp=3 must divide n_layers"),
    ({"ep": 3}, "ep=3 must divide n_experts"),
], ids=["pp", "ep"])
def test_axes_that_do_not_divide_raise(axes, match):
    with pytest.raises(ValueError, match=match):
        pt.Transformer(pt.TransformerConfig(**MOE), _FakeMesh(axes))


@pytest.mark.parametrize("axes", [{"pp": 2}, {"ep": 2}, {"data": 2, "pp": 2, "ep": 2}],
                         ids=["pp", "ep", "data_pp_ep"])
def test_flash_attention_sharded_replicates_pp_and_ep(axes):
    """pp and ep are replicated axes for ``flash_attention_sharded``, as in
    the JAX package: a stage or an ep rank calls it on the rows and heads
    it holds, and gets ``flash_attention``'s result."""
    from torchkafka_tpu_torch.ops.flash import flash_attention, flash_attention_sharded

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 16, 4, 8), generator=g)
    k, v = (torch.randn((2, 16, 2, 8), generator=g) for _ in range(2))
    got = flash_attention_sharded(q, k, v, _FakeMesh(axes), True)
    assert torch.equal(got, flash_attention(q, k, v, True))
