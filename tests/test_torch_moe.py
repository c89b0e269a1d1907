"""The port's mixture-of-experts layers against the JAX package, on the CPU.

- ``tests/test_moe.py``'s cases without a mesh, re-rooted onto the port
  (routing against a per-token loop, top-1, the config checks, decode
  against the full forward, and capacity dispatch: ample capacity equals
  dense dispatch, starved capacity, primary-choice priority, the padded
  tail group, a prime token count). Its ``ep``-mesh cases wait for the
  mesh paths.
- Differentials at f32 from the same inputs: ``_moe_mlp_capacity`` under
  tight and ample capacity factors (outputs and routing stats within
  1e-5, the same rows fully dropped), three capacity-dispatch train steps
  giving ``optax.adamw``'s losses within 1e-5, and ``generate`` on a
  capacity and a dense config giving the JAX package's tokens.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchkafka_tpu as jtk
from _torch_fleet_common import load_rerooted
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.generate import generate as jax_generate
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.generate import generate
from torchkafka_tpu_torch.optim import adamw

# ---------------------------------------------------- tests/test_moe.py re-rooted

_moe = load_rerooted("test_moe", drop=("from torchkafka_tpu.parallel import make_mesh",),
                     replace=[
    ("params = model.init(jax.random.key(1))", 'params = model.init(jax.random.key(1), "cpu")'),
    (".astype(jnp.int32)", ".to(jnp.int32)"),
])
_moe.jnp = types.SimpleNamespace(
    float32=torch.float32, int32=torch.int32,
    asarray=lambda x, dtype=None: torch.as_tensor(x, dtype=dtype),
    zeros=lambda shape, dtype: torch.zeros(shape, dtype=dtype),
    isfinite=torch.isfinite, argmax=torch.argmax,
    concatenate=lambda xs, axis: torch.cat(xs, dim=axis),
)

TestRouting = _moe.TestRouting


class TestTrainingAndDecode:
    test_moe_generate_matches_full_forward = (
        _moe.TestTrainingAndDecode.test_moe_generate_matches_full_forward)


class TestCapacityDispatch:
    _layer = _moe.TestCapacityDispatch._layer
    test_ample_capacity_matches_dense = (
        _moe.TestCapacityDispatch.test_ample_capacity_matches_dense)
    test_tight_capacity_drops_but_stays_finite = (
        _moe.TestCapacityDispatch.test_tight_capacity_drops_but_stays_finite)
    test_primary_choice_has_priority = (
        _moe.TestCapacityDispatch.test_primary_choice_has_priority)
    test_bad_dispatch_config_rejected = (
        _moe.TestCapacityDispatch.test_bad_dispatch_config_rejected)
    test_nondividing_group_size_stays_grouped = (
        _moe.TestCapacityDispatch.test_nondividing_group_size_stays_grouped)
    test_prime_token_count_no_degenerate_groups = (
        _moe.TestCapacityDispatch.test_prime_token_count_no_degenerate_groups)


# ------------------------------------------------------- against the JAX package

TOL = 1e-5
SHAPE = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=48, max_seq_len=40, n_experts=4, expert_top_k=2)


def _configs(**extra):
    kw = {**SHAPE, **extra}
    return (
        jt.TransformerConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32,
                             attn_impl="dense"),
        pt.TransformerConfig(**kw, dtype=torch.float32, param_dtype=torch.float32,
                             attn_impl="dense"),
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer(seed, zero_router=False):
    rng = np.random.default_rng(seed)
    layer = {
        "router": rng.normal(size=(32, 4)).astype(np.float32),
        "w_gate": (rng.normal(size=(4, 32, 48)) * 0.1).astype(np.float32),
        "w_up": (rng.normal(size=(4, 32, 48)) * 0.1).astype(np.float32),
        "w_down": (rng.normal(size=(4, 48, 32)) * 0.1).astype(np.float32),
    }
    if zero_router:  # every probability ties: lax.top_k's index order decides
        layer["router"][:] = 0.0
    return layer


@pytest.mark.parametrize("cf,group,n_tok,zero_router", [
    (0.3, 10, 26, False),   # starved, a padded tail group of 4
    (0.5, 256, 26, False),  # one group, the floor of 8 slots engaged
    (0.6, 16, 48, True),    # ties everywhere: primaries to expert 0, then 1
    (4.0, 8, 13, False),    # ample: nothing drops
], ids=["starved_tail", "one_group", "ties", "ample"])
def test_capacity_dispatch_matches_jax(cf, group, n_tok, zero_router):
    jcfg, pcfg = _configs(moe_dispatch="capacity", capacity_factor=cf,
                          moe_group_size=group)
    assert pt.moe_capacity(pcfg, min(group, n_tok)) == jt.moe_capacity(
        jcfg, min(group, n_tok))
    layer = _layer(n_tok, zero_router)
    h = np.random.default_rng(7).normal(size=(2, n_tok // 2, 32)).astype(np.float32)
    jo, js = jax.jit(lambda x, lay: jt._moe_mlp_capacity(x, lay, jcfg))(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in layer.items()})
    po, ps = pt._moe_mlp_capacity(torch.from_numpy(h),
                                  {k: torch.from_numpy(v) for k, v in layer.items()}, pcfg)
    jo, js = np.asarray(jo), np.asarray(js)
    np.testing.assert_allclose(po.numpy(), jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ps.numpy(), js, atol=TOL, rtol=TOL)
    # The same tokens lose both choices (their MLP output is exactly 0).
    dropped = np.abs(jo).sum(-1) == 0
    np.testing.assert_array_equal(np.abs(po.numpy()).sum(-1) == 0, dropped)
    if cf >= 1:
        assert not dropped.any()
    if zero_router:  # tokens 8-15 of each group of 16 lose both choices
        assert dropped.reshape(-1, 16)[:, 8:].all()


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = pt._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_capacity_train_steps_match_optax():
    """Three adamw steps at a tight capacity factor (drops in every step)
    from the JAX package's initial parameters: losses within 1e-5."""
    jcfg, pcfg = _configs(moe_dispatch="capacity", capacity_factor=0.5,
                          moe_group_size=16)
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, 97, (2, 16)).astype(np.int32) for _ in range(3)]
    mask = np.ones((2, 16), np.int32)
    mask[-1, 10:] = 0
    mesh = jtk.make_mesh({"data": 1}, devices=jax.devices()[:1])
    init_fn, step_fn = jt.make_train_step(jcfg, mesh, optax.adamw(1e-3))
    jparams, jopt = init_fn(jax.random.key(0))
    start = _np_tree(jparams)
    jlosses = []
    for t in toks:
        jparams, jopt, loss = step_fn(jparams, jopt, jnp.asarray(t), jnp.asarray(mask))
        jlosses.append(float(loss))
    _, pstep = pt.make_train_step(pcfg, optimizer=adamw(1e-3), device="cpu")
    params = pt.params_from_numpy(start, pcfg, device="cpu")
    opt = adamw(1e-3).init(params)
    losses = []
    for t in toks:
        params, opt, loss = pstep(params, opt, torch.from_numpy(t), torch.from_numpy(mask))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)


@pytest.mark.parametrize("dispatch", ["capacity", "dense"])
def test_generate_matches_jax(dispatch):
    """Prefill through the config's dispatch (a tight capacity drops
    there), every decode step dense: the JAX package's tokens."""
    jcfg, pcfg = _configs(moe_dispatch=dispatch, capacity_factor=0.3,
                          moe_group_size=32)
    jparams = jt.init_params(jax.random.key(5), jcfg)
    prompt = np.random.default_rng(4).integers(0, 97, (3, 12)).astype(np.int32)
    want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompt), 8))
    params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
    got = generate(params, pcfg, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_prefill_drops_like_jax():
    """The serving prefill routes through the config's dispatch: at a
    tight capacity its logits differ from dense dispatch's, and equal the
    JAX package's prefill."""
    from torchkafka_tpu.models.generate import prefill as jax_prefill
    from torchkafka_tpu_torch.models.generate import prefill

    jcfg, pcfg = _configs(moe_dispatch="capacity", capacity_factor=0.3,
                          moe_group_size=32)
    jparams = jt.init_params(jax.random.key(6), jcfg)
    prompt = np.random.default_rng(8).integers(0, 97, (2, 16)).astype(np.int32)
    jl, _ = jax_prefill(jparams, jcfg, jnp.asarray(prompt), 24)
    params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
    pl, _ = prefill(params, pcfg, torch.from_numpy(prompt), 24)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    dense_l, _ = prefill(params, dataclasses.replace(pcfg, moe_dispatch="dense"),
                         torch.from_numpy(prompt), 24)
    assert np.abs(dense_l.numpy() - pl.numpy()).max() > 1e-3
