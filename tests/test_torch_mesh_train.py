"""The port's data- and fsdp-parallel train step against the JAX package at
f32: JAX's ``make_train_step(cfg, mesh, adamw)`` on the 8-device virtual
CPU mesh (tests/conftest.py), the port's on 2 or 4 gloo processes
(tests/_torch_multiproc_worker.py, mode ``train``), from the same
parameters and the same global batches, 3 steps. Also
``flash_attention_sharded`` (2 processes) against JAX's in interpret mode,
the specs and placements, pp, ep and MoE meshes building (their runs:
tests/test_torch_pp_ep_train.py) and the meshes and impls the tp/sp step
refuses (its runs: tests/test_torch_tp_sp_train.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.ops.flash import flash_attention_sharded as jax_flash_sharded
from torchkafka_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.optim import adamw

from tests.test_torch_pod import diagnose, read, spawn_pod, wait_all

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
           max_seq_len=16)
LR = 1e-2
STEPS, GLOBAL_B, SEQ = 3, 8, 16
# f32 sums in another order (torch against XLA, shares summed across
# processes): the single-process trajectory test's tolerances
# (tests/test_torch_train.py).
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-4


def _jax_run(axes: dict):
    """JAX's mesh train step: (initial numpy params, tokens, losses,
    final numpy params)."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    cfg = jt.TransformerConfig(**CFG, dtype=jnp.float32, param_dtype=jnp.float32)
    init_fn, step_fn = jt.make_train_step(cfg, mesh, optax.adamw(LR))
    params, opt = init_fn(jax.random.key(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(
        0, CFG["vocab_size"], (STEPS, GLOBAL_B, SEQ)).astype(np.int32)
    mask = jnp.ones((GLOBAL_B, SEQ), jnp.int32)
    losses = []
    for s in range(STEPS):
        params, opt, loss = step_fn(params, opt, jnp.asarray(tokens[s]), mask)
        losses.append(float(loss))
    return init, tokens, losses, jax.tree_util.tree_map(np.asarray, params)


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.mark.parametrize("axes", [{"data": 2}, {"fsdp": 2}, {"data": 2, "fsdp": 2}],
                         ids=["data2", "fsdp2", "data2_fsdp2"])
def test_mesh_train_step_matches_jax(tmp_path, axes):
    init, tokens, jlosses, jfinal = _jax_run(axes)
    (tmp_path / "train_args.json").write_text(json.dumps({"axes": axes, "cfg": CFG, "lr": LR}))
    np.savez(tmp_path / "train_in.npz", tokens=tokens.astype(np.int64), **_flat(init))
    nproc = int(np.prod(list(axes.values())))
    procs = spawn_pod(nproc, str(tmp_path), "train")
    codes = wait_all(procs, str(tmp_path), timeout_s=180)
    assert codes == [0] * nproc, diagnose(procs, str(tmp_path))
    marks = [read(str(tmp_path), "train", pid) for pid in range(nproc)]
    for m in marks:  # every rank returns the global loss
        np.testing.assert_allclose(m["losses"], jlosses, atol=LOSS_ATOL, rtol=0)
    got = np.load(tmp_path / "train_out.npz")
    for name, ref in _flat(jfinal).items():
        np.testing.assert_allclose(got[name], ref, atol=PARAM_ATOL, rtol=0, err_msg=name)
    # Replicas over data hold the same bits; fsdp peers hold different
    # chunks (of the shapes param_specs names).
    fsdp = axes.get("fsdp", 1)
    by_chunk: dict[int, set] = {}
    for m in marks:
        by_chunk.setdefault(m["fsdp_index"], set()).add(m["digest"])
    assert all(len(d) == 1 for d in by_chunk.values()), by_chunk
    assert len(by_chunk) == fsdp
    shapes = marks[0]["local_shapes"]
    assert shapes["wq"] == [CFG["n_layers"], CFG["d_model"] // fsdp, CFG["n_heads"], 8]
    assert shapes["w_down"] == [CFG["n_layers"], CFG["d_ff"], CFG["d_model"] // fsdp]
    assert shapes["ln1"] == [CFG["n_layers"], CFG["d_model"]]
    assert marks[0]["stats"]["calls"] > 0 and marks[0]["stats"]["bytes"] > 0


def test_flash_attention_sharded_matches_jax(tmp_path):
    """Each rank's K1 (and K2/K3 in the backward) on its own rows of a
    {"data": 2} mesh, against JAX's shard_map'd Pallas kernel in interpret
    mode on the same global batch."""
    b, s, h, kh, d = 2, 128, 2, 1, 16  # GQA, one row a rank
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kh, kh))
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_sharded(q, k, v, mesh, True, interpret=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_out = np.asarray(out)
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    np.savez(tmp_path / "flash_in.npz", q=q, k=k, v=v, dout=dout)
    procs = spawn_pod(2, str(tmp_path), "flash")
    codes = wait_all(procs, str(tmp_path), timeout_s=120)
    assert codes == [0, 0], diagnose(procs, str(tmp_path))
    outs = [np.load(tmp_path / f"flash_out_{pid}.npz") for pid in (0, 1)]
    np.testing.assert_allclose(np.concatenate([o["out"] for o in outs]), ref_out,
                               atol=2e-5, rtol=2e-5)
    for name, ref in zip(("dq", "dk", "dv"), ref_grads):
        np.testing.assert_allclose(np.concatenate([o[name] for o in outs]), ref,
                                   atol=5e-5, rtol=5e-5, err_msg=name)


def test_param_specs_match_jax():
    """The port's specs are the JAX package's PartitionSpecs, entry for
    entry, for dense and MoE configs."""
    for extra in ({}, {"n_experts": 4}):
        jspecs = jt.param_specs(jt.TransformerConfig(**CFG, **extra))
        pspecs = pt.param_specs(pt.TransformerConfig(**CFG, **extra))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        got = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
               for path, spec in flat_j}
        want = {k: v for k, v in _flat(pspecs).items()}
        assert got == want


@pytest.fixture
def one_rank_mesh():
    """A one-process mesh in this process (an in-process store; no
    network), torn down after the test."""
    from torchkafka_tpu_torch.parallel import multihost
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    multihost.shutdown()
    meshes = {}

    def build(axes):
        meshes[str(axes)] = make_mesh(axes, device="cpu")
        return meshes[str(axes)]

    yield build
    multihost.shutdown()


def test_shardings_for_mesh_strip_absent_axes(one_rank_mesh):
    from torch.distributed.tensor import Replicate, Shard

    mesh = one_rank_mesh({"data": 1, "fsdp": 1})
    pl = pt.shardings_for_mesh(mesh, pt.param_specs(pt.TransformerConfig(**CFG)))
    assert pl["embed"] == [Replicate(), Shard(1)]  # ("tp", "fsdp"): tp stripped
    assert pl["lm_head"] == [Replicate(), Shard(0)]
    assert pl["layers"]["wo"] == [Replicate(), Shard(3)]
    assert pl["layers"]["ln1"] == [Replicate(), Replicate()]
    assert pt.batch_spec(mesh) == (("data", "fsdp"), None)


@pytest.mark.parametrize("axes", [{"data": 1, "tp": 1}, {"tp": 1, "sp": 1}],
                         ids=["tp1", "tp1_sp1"])
def test_size_one_model_axes_go_through(one_rank_mesh, axes):
    """Axes of size 1 (the JAX package strips absent ones) leave the
    data-parallel path running."""
    mesh = one_rank_mesh(axes)
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    init_fn, step_fn = pt.make_train_step(cfg, mesh, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    toks = torch.randint(0, CFG["vocab_size"], (2, SEQ))
    _, _, loss = step_fn(params, opt, toks, None)
    assert torch.isfinite(loss)


def test_one_process_mesh_step_equals_plain_step(one_rank_mesh):
    """On a one-process mesh the step is the single-device step, bit for
    bit (every collective is the identity)."""
    mesh = one_rank_mesh({"data": 1})
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    toks = torch.randint(0, CFG["vocab_size"], (2, SEQ), generator=torch.Generator().manual_seed(2))
    init_m, step_m = pt.make_train_step(cfg, mesh, device="cpu")
    init_p, step_p = pt.make_train_step(cfg, None, device="cpu")
    pm, om = init_m(torch.Generator().manual_seed(0))
    pp, op = init_p(torch.Generator().manual_seed(0))
    for _ in range(2):
        pm, om, lm = step_m(pm, om, toks, None)
        pp, op, lp = step_p(pp, op, toks, None)
        assert lm.item() == lp.item()
    assert torch.equal(pm["layers"]["wq"].to_local(), pp["layers"]["wq"].detach())


class _FakeMesh:
    """The axis sizes a mesh carries, without a process group."""

    def __init__(self, axes: dict) -> None:
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_model_axes_build_and_run(axis, one_rank_mesh):
    """A pp or ep axis builds the model (its process groups are fetched at
    first use, so a fake two-rank mesh suffices); on a one-rank mesh with
    the axis the step runs and equals the single-device step. The
    pipelined and expert-parallel runs: tests/test_torch_pp_ep_train.py."""
    cfg = pt.TransformerConfig(**CFG, n_experts=4 if axis == "ep" else 0,
                               dtype=torch.float32)
    assert pt.Transformer(cfg, _FakeMesh({axis: 2}))._sizes == {axis: 2}
    mesh = one_rank_mesh({"data": 1, axis: 1})
    init_fn, step_fn = pt.make_train_step(cfg, mesh, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    _, one = pt.make_train_step(cfg, None, device="cpu")
    plain = pt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    popt = adamw(1e-3).init(plain)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    for _ in range(2):
        params, opt, loss = step_fn(params, opt, toks)
        plain, popt, ref = one(plain, popt, toks)
        assert abs(loss.item() - ref.item()) < LOSS_ATOL


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("mesh", [None, {"data": 1, "sp": 1}], ids=["no_mesh", "sp1"])
def test_ring_and_ulysses_need_an_sp_axis(impl, mesh, one_rank_mesh):
    """As in the JAX package: an explicit sequence-parallel impl without an
    sp axis above 1 is a ValueError, not a silent fallback (they run on
    sp meshes: tests/test_torch_tp_sp_train.py)."""
    cfg = pt.TransformerConfig(**CFG, attn_impl=impl)
    with pytest.raises(ValueError, match="requires a mesh with an 'sp'"):
        pt.Transformer(cfg, one_rank_mesh(mesh) if mesh else None)


@pytest.mark.parametrize("axes", [{"tp": 4}, {"data": 2, "tp": 4}, {"tp": 3}],
                         ids=["kv_heads", "kv_heads_data2", "q_heads"])
def test_heads_tp_does_not_divide_raise(axes):
    """Head counts tp does not divide raise a ValueError naming them, in
    the model and in the step (the JAX package serves such a mesh through
    its dense dispatch, forward only: ROADMAP queue C)."""
    cfg = pt.TransformerConfig(**CFG)  # 4 q heads, 2 kv heads
    for build in (lambda: pt.Transformer(cfg, _FakeMesh(axes)),
                  lambda: pt.make_train_step(cfg, _FakeMesh(axes), device="cpu")):
        with pytest.raises(ValueError, match=r"q heads \(4\) and the kv heads \(2\)"):
            build()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_sp_mesh_needs_a_sequence_parallel_impl(impl):
    """On an sp mesh each rank holds one chunk of the sequence: attention
    over the chunk alone would be wrong, so dense and flash raise."""
    cfg = pt.TransformerConfig(**CFG, attn_impl=impl)
    with pytest.raises(ValueError, match="attn_impl must be 'ring', 'ulysses' or 'auto'"):
        pt.Transformer(cfg, _FakeMesh({"sp": 2}))


def test_moe_on_a_batch_sharded_mesh_builds():
    """MoE on a data mesh builds: the router statistics are summed over the
    data ranks (runs: tests/test_torch_pp_ep_train.py)."""
    model = pt.Transformer(pt.TransformerConfig(**CFG, n_experts=4), _FakeMesh({"data": 2}))
    assert model._batch_ranks() == 2


@pytest.mark.parametrize("axes", [{"tp": 2}, {"sp": 2}], ids=["tp", "sp"])
def test_moe_on_a_tp_or_sp_mesh_builds(axes):
    """MoE's experts split their d_ff over tp; under sp the router
    statistics are summed over the chunks. Capacity dispatch places its
    groups within a chunk."""
    cfg = pt.TransformerConfig(**CFG, n_experts=4, moe_dispatch="capacity",
                               moe_group_size=8)
    model = pt.Transformer(cfg, _FakeMesh(axes))
    assert model._capacity_span(4, 8 if "sp" in axes else 16) is None


def test_opt_shardings_like_mirrors_the_parameters(one_rank_mesh):
    """AdamW's moments take their parameter's placements; the step count
    replicates (the JAX package's ``opt_shardings_like`` on an optax
    state)."""
    from torch.distributed.tensor import Replicate

    mesh = one_rank_mesh({"data": 1, "fsdp": 1})
    cfg = pt.TransformerConfig(**CFG, dtype=torch.float32)
    init_fn, _ = pt.make_train_step(cfg, mesh, device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    p_sh = pt.shardings_for_mesh(mesh, pt.param_specs(cfg))
    repl = [Replicate(), Replicate()]
    got = pt.opt_shardings_like(opt.state_tree(params), params, p_sh, repl)
    assert got["exp_avg"] == p_sh and got["exp_avg_sq"] == p_sh
    assert got["step"] == repl
