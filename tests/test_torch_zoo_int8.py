"""The port's int8 serving weights (``random_serving_params(quantized=True)``)
against the JAX package's on a small dense config: the same tree, shapes,
dtypes and scale values, int8 payloads within [-127, 127] (the draws
themselves come from different generators), and equal byte counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models import zoo as jz
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models import zoo as pz
from torchkafka_tpu_torch.models.quant import QTensor
from torchkafka_tpu_torch.utils.tree import tree_flatten

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)


@pytest.fixture(scope="module")
def trees():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jtree = jz.random_serving_params(jax.random.key(0), jcfg, quantized=True)
    ptree = pz.random_serving_params(
        torch.Generator().manual_seed(0), pcfg, quantized=True, device="cpu"
    )
    return jtree, ptree


def test_same_structure_shapes_and_dtypes(trees):
    jtree, ptree = trees
    jl = jax.tree_util.tree_leaves(jtree)
    pl = tree_flatten(ptree)[0]
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", "")
    assert sorted(ptree) == sorted(jtree)
    assert sorted(ptree["layers"]) == sorted(jtree["layers"])
    for name in ("embed", "lm_head"):
        assert isinstance(ptree[name], QTensor)
    for name, w in ptree["layers"].items():
        assert isinstance(w, QTensor) == (name not in ("ln1", "ln2"))


def test_scales_norms_and_int8_range(trees):
    jtree, ptree = trees
    jl = jax.tree_util.tree_leaves(jtree)
    pl = tree_flatten(ptree)[0]
    for a, b in zip(jl, pl):
        a = np.asarray(a)
        b = b.numpy()
        if b.dtype == np.int8:
            assert b.min() >= -127 and b.max() <= 127
            assert len(np.unique(b)) > 50  # drawn, not constant
        else:  # the scales and the f32 norms are constants: equal exactly
            np.testing.assert_array_equal(b, a)


def test_params_nbytes_equal(trees):
    jtree, ptree = trees
    assert pz.params_nbytes(ptree) == jz.params_nbytes(jtree)
    # A QTensor counts q (one byte per weight) and its f32 scales.
    emb = ptree["embed"]
    assert pz.params_nbytes(emb) == emb.q.numel() + 4 * emb.scale.numel()


def test_moe_raises():
    cfg = pt.TransformerConfig(**SHAPE, n_experts=4, expert_top_k=2)
    with pytest.raises(ValueError, match="dense zoo"):
        pz.random_serving_params(torch.Generator().manual_seed(0), cfg,
                                 quantized=True, device="cpu")


def test_seeded_draws_repeat():
    cfg = pt.TransformerConfig(**SHAPE)
    a = pz.random_serving_params(torch.Generator().manual_seed(3), cfg,
                                 quantized=True, device="cpu")
    b = pz.random_serving_params(torch.Generator().manual_seed(3), cfg,
                                 quantized=True, device="cpu")
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)
