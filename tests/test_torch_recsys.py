"""The port's DLRM recommender (``models/recsys.py``) against the JAX
package, on the CPU.

- ``tests/test_recsys.py``'s cases without a mesh re-rooted onto the port
  (shapes, forward, config checks, masking, the record codecs, int8
  tables), and its stream → step → commit loop on one device with no mesh
  (``jnp``'s functional ``.at[].set`` spelled as torch ops). Their
  ``init_params`` draws the reference case's own weights (the JAX
  package's at the same seed, through ``params_from_numpy``).
- ``forward`` at f32 from the JAX package's parameters within 1e-5, and
  three ``optim.adam`` steps against ``make_dlrm_train_step`` with
  ``optax.adam``: the same losses within 1e-5 and the same parameters.
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
import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from torchkafka_tpu.models import recsys as jr
from torchkafka_tpu_torch.models import recsys as pr
from torchkafka_tpu_torch.optim import adam


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


_ref = load_rerooted("test_recsys", drop=("from torchkafka_tpu.parallel import make_mesh",),
                     replace=[
    ("        mask = jnp.ones(16).at[8:].set(0.0)\n",
     "        mask = torch.ones(16)\n        mask[8:] = 0.0\n"),
    ("            dense.at[8:].set(1e3),\n",
     "            torch.cat([dense[:8], torch.full_like(dense[8:], 1e3)]),\n"),
    ("            labels.at[8:].set(0.0),\n",
     "            torch.cat([labels[:8], torch.zeros_like(labels[8:])]),\n"),
    ('        mesh = make_mesh({"data": 8})\n', "        mesh = None\n"),
    ("            mesh=mesh,\n            idle_timeout_ms=300,\n",
     '            device="cpu",\n            idle_timeout_ms=300,\n'),
    ("        init_fn, step_fn = make_dlrm_train_step(CFG, mesh, optax.adam(1e-2))\n"
     "        params, opt = init_fn(jax.random.key(0))\n        seen = 0\n",
     '        init_fn, step_fn = make_dlrm_train_step(CFG, mesh, adam(1e-2), device="cpu")\n'
     "        params, opt = init_fn(jax.random.key(0))\n        seen = 0\n"),
])
_ref.jnp = types.SimpleNamespace(
    float32=torch.float32, int32=torch.int32,
    asarray=lambda x, dtype=None: torch.as_tensor(x, dtype=dtype),
    isfinite=torch.isfinite,
)
_ref.torch = torch
_ref.adam = adam


def _jax_drawn_params(gen, cfg):
    """The weights the reference case draws (JAX's ``init_params`` at the
    generator's seed), converted: its tolerances were set on those
    numbers, and the port's forward gives the JAX package's logits on
    them (``test_forward_and_loss_match_jax``)."""
    jcfg = jr.DLRMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                            if f.name not in ("dtype", "param_dtype")})
    tree = _jax_init(jax.random.key(gen.initial_seed()), jcfg)
    return pr.params_from_numpy(_np_tree(tree), device="cpu")


_ref.init_params = _jax_drawn_params
# One compiled program each, rather than JAX's op-by-op dispatch.
_jax_init = jax.jit(jr.init_params, static_argnums=1)
_jax_forward = jax.jit(jr.forward, static_argnums=3)
_jax_loss = jax.jit(jr.loss_fn, static_argnums=5)

TestModel = _ref.TestModel


class TestStreamTraining:
    test_stream_train_commit = _ref.TestStreamTraining.test_stream_train_commit
    test_record_roundtrip = _ref.TestStreamTraining.test_record_roundtrip
    test_chunk_processor_matches_per_record = (
        _ref.TestStreamTraining.test_chunk_processor_matches_per_record)
    test_chunk_processor_all_good_and_all_bad = (
        _ref.TestStreamTraining.test_chunk_processor_all_good_and_all_bad)


TestQuantized = _ref.TestQuantized


# ------------------------------------------------------- against the JAX package

TOL = 1e-5
SHAPE = dict(dense_dim=4, vocab_sizes=(64, 32, 128), embed_dim=8,
             bottom_mlp=(16, 8), top_mlp=(32, 1))


def _configs():
    return (jr.DLRMConfig(**SHAPE, dtype=jnp.float32),
            pr.DLRMConfig(**SHAPE, dtype=torch.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n, b=32, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.normal(size=(b, SHAPE["dense_dim"])).astype(np.float32)
        cats = np.stack([rng.integers(0, v, b) for v in SHAPE["vocab_sizes"]],
                        axis=1).astype(np.int32)
        labels = (dense.sum(1) + (cats[:, 0] % 2) > 0.5).astype(np.float32)
        mask = np.ones(b, np.float32)
        mask[-5:] = 0.0
        out.append((dense, cats, labels, mask))
    return out


def test_forward_and_loss_match_jax():
    jcfg, pcfg = _configs()
    jparams = _jax_init(jax.random.key(3), jcfg)
    params = pr.params_from_numpy(_np_tree(jparams), device="cpu")
    dense, cats, labels, mask = _batches(1)[0]
    want = np.asarray(_jax_forward(jparams, jnp.asarray(dense), jnp.asarray(cats), jcfg))
    got = pr.forward(params, torch.from_numpy(dense), torch.from_numpy(cats), pcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    jl = _jax_loss(jparams, *(jnp.asarray(a) for a in (dense, cats, labels, mask)), jcfg)
    pl = pr.loss_fn(params, *(torch.from_numpy(a) for a in (dense, cats, labels, mask)), pcfg)
    np.testing.assert_allclose(pl.item(), float(jl), atol=TOL, rtol=TOL)


def test_quantized_forward_matches_jax():
    jcfg, pcfg = _configs()
    jparams = _jax_init(jax.random.key(4), jcfg)
    jq = jr.quantize_dlrm_params(jparams)
    q = pr.quantize_dlrm_params(pr.params_from_numpy(_np_tree(jparams), device="cpu"))
    np.testing.assert_array_equal(q["tables"]["t1"].q.numpy(), np.asarray(jq["tables"]["t1"].q))
    dense, cats, _, _ = _batches(1, seed=5)[0]
    want = np.asarray(_jax_forward(jq, jnp.asarray(dense), jnp.asarray(cats), jcfg))
    got = pr.forward(q, torch.from_numpy(dense), torch.from_numpy(cats), pcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_three_adam_steps_match_optax():
    jcfg, pcfg = _configs()
    batches = _batches(3)
    mesh = jtk.make_mesh({"data": 1}, devices=jax.devices()[:1])
    init_fn, step_fn = jr.make_dlrm_train_step(jcfg, mesh, optax.adam(1e-2))
    jparams, jopt = init_fn(jax.random.key(0))
    params = pr.params_from_numpy(_np_tree(jparams), device="cpu")
    jlosses = []
    for b in batches:
        jparams, jopt, loss = step_fn(jparams, jopt, *(jnp.asarray(a) for a in b))
        jlosses.append(float(loss))
    _, pstep = pr.make_dlrm_train_step(pcfg, None, adam(1e-2), device="cpu")
    opt = adam(1e-2).init(params)
    losses = []
    for b in batches:
        params, opt, loss = pstep(params, opt, *(torch.from_numpy(a) for a in b))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=TOL, rtol=0)
    ref = jax.tree_util.tree_leaves(_np_tree(jparams))
    got = [t.detach().numpy() for t in ptk.utils.tree.tree_leaves(params)]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    assert pr.count_params(params) == jr.count_params(jparams)


def test_mesh_raises_and_defaults():
    """Anything but a DeviceMesh is refused; on a one-rank {data, tp} mesh
    the step runs and equals the single-device step (the multi-rank
    meshes: tests/test_torch_pp_ep_train.py)."""
    from torchkafka_tpu_torch.parallel import multihost
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    _, pcfg = _configs()
    with pytest.raises(TypeError, match="make_mesh"):
        pr.make_dlrm_train_step(pcfg, object(), device="cpu")
    multihost.shutdown()
    try:
        mesh = make_mesh({"data": 1, "tp": 1}, device="cpu")
        init_fn, step = pr.make_dlrm_train_step(pcfg, mesh, adam(1e-2), device="cpu")
        params, opt = init_fn(torch.Generator().manual_seed(0))
        _, one = pr.make_dlrm_train_step(pcfg, None, adam(1e-2), device="cpu")
        plain = pr.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
        popt = adam(1e-2).init(plain)
        rng = np.random.default_rng(0)
        highs = np.asarray(pcfg.vocab_sizes)
        b = (rng.normal(size=(8, pcfg.dense_dim)).astype(np.float32),
             rng.integers(0, highs, (8, len(highs))).astype(np.int32),
             rng.integers(0, 2, 8).astype(np.float32), np.ones(8, np.float32))
        for _ in range(2):
            params, opt, loss = step(params, opt, *b)
            plain, popt, ref = one(plain, popt, *(torch.from_numpy(a) for a in b))
            assert abs(loss.item() - ref.item()) < TOL
    finally:
        multihost.shutdown()
    assert adam(1e-2).weight_decay == 0.0
    assert dataclasses.replace(pcfg, embed_dim=8).n_interactions == 6
