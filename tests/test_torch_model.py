"""The port's model against the JAX package: parameters the JAX package
initialised, converted name for name, must give the same prefill logits and
captured k/v at f32, plain and int8-quantized."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.generate import prefill as jax_prefill
from torchkafka_tpu.models.quant import quantize_params as jax_quantize_params
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.generate import prefill
from torchkafka_tpu_torch.models.quant import QTensor
from torchkafka_tpu_torch.models.zoo import random_serving_params, zoo_config

ATOL = 1e-4
SHAPE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=96, max_seq_len=160)


def _configs(attn_impl):
    return (
        jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32,
                             attn_impl=attn_impl),
        pt.TransformerConfig(**SHAPE, dtype=torch.float32,
                             param_dtype=torch.float32, attn_impl=attn_impl),
    )


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compare_prefill(jcfg, pcfg, jparams, seq, seed):
    tokens = np.random.default_rng(seed).integers(0, 97, size=(2, seq)).astype(np.int32)
    max_len = seq + 8
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(tokens), max_len)
    params = pt.params_from_numpy(_numpy_tree(jparams), pcfg, device="cpu")
    pl, pc = prefill(params, pcfg, torch.from_numpy(tokens), max_len)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(pc.v.numpy(), np.asarray(jc.v), atol=ATOL, rtol=ATOL)
    assert pl.dtype == torch.float32 and pc.k.shape == jc.k.shape


@pytest.mark.parametrize("attn_impl,seq", [("dense", 24), ("flash", 128)])
def test_prefill_matches(attn_impl, seq):
    """'flash' runs the JAX package's Pallas kernel in interpret mode
    (S=128 tiles it) against the port's flash wrapper on the CPU."""
    jcfg, pcfg = _configs(attn_impl)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    _compare_prefill(jcfg, pcfg, jparams, seq, seed=1)


def test_quantized_prefill_matches():
    jcfg, pcfg = _configs("dense")
    jparams = jax_quantize_params(jt.init_params(jax.random.key(1), jcfg), jcfg)
    assert isinstance(jparams["layers"]["wq"], tuple)
    params = pt.params_from_numpy(_numpy_tree(jparams), pcfg, device="cpu")
    assert isinstance(params["layers"]["wq"], QTensor)
    assert params["layers"]["wq"].q.dtype == torch.int8
    _compare_prefill(jcfg, pcfg, jparams, 24, seed=2)


def test_port_quantize_params_matches_jax():
    from torchkafka_tpu_torch.models.quant import quantize_params

    jcfg, pcfg = _configs("dense")
    jparams = jt.init_params(jax.random.key(2), jcfg)
    ref = _numpy_tree(jax_quantize_params(jparams, jcfg))
    got = quantize_params(pt.params_from_numpy(_numpy_tree(jparams), pcfg, "cpu"), pcfg)
    for name in ("wq", "wo", "w_down"):
        np.testing.assert_array_equal(got["layers"][name].q.numpy(), ref["layers"][name].q)
        np.testing.assert_array_equal(got["layers"][name].scale.numpy(), ref["layers"][name].scale)
    np.testing.assert_array_equal(got["lm_head"].q.numpy(), ref["lm_head"].q)


@pytest.mark.parametrize("int8", [False, True])
def test_attend_cached_matches(int8):
    """The decode tail over an M-major cache, compute-dtype and int8 with
    the scales folded onto the scores and probabilities."""
    from torchkafka_tpu.models.generate import _attend_cached as jax_attend
    from torchkafka_tpu.models.quant import quant_kv_groups as jax_quant
    from torchkafka_tpu_torch.models.generate import _attend_cached

    jcfg, pcfg = _configs("dense")
    jparams = jt.init_params(jax.random.key(3), jcfg)
    params = pt.params_from_numpy(_numpy_tree(jparams), pcfg, device="cpu")
    rng = np.random.default_rng(6)
    b, m, kh, dh = 3, 12, SHAPE["n_kv_heads"], SHAPE["d_model"] // SHAPE["n_heads"]
    x = rng.normal(size=(b, 1, SHAPE["d_model"])).astype(np.float32)
    q = rng.normal(size=(b, 1, SHAPE["n_heads"], dh)).astype(np.float32)
    ck, cv = (rng.normal(size=(b, m, kh, dh)).astype(np.float32) for _ in range(2))
    valid = np.arange(m)[None, :] <= np.asarray([0, 5, 11])[:, None]
    scales = {}
    if int8:
        (ck, ks), (cv, vs) = ((np.array(a) for a in jax_quant(jnp.asarray(c))) for c in (ck, cv))
        scales = {"k_scale": ks, "v_scale": vs}
    jlayer = {n: w[0] for n, w in jparams["layers"].items()}
    ref = jax_attend(jnp.asarray(x), jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                     jnp.asarray(valid), jlayer, jcfg,
                     **{k: jnp.asarray(v) for k, v in scales.items()})
    got = _attend_cached(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(ck),
        torch.from_numpy(cv), torch.from_numpy(valid), pt.layer_at(params["layers"], 0),
        pcfg, **{k: torch.from_numpy(v) for k, v in scales.items()},
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None), (None, 0.6), (7, 0.3)])
def test_filter_logits_matches(top_k, top_p):
    from torchkafka_tpu.models.generate import filter_logits as jax_filter
    from torchkafka_tpu_torch.models.generate import filter_logits

    logits = np.random.default_rng(4).normal(size=(3, 40)).astype(np.float32) * 3
    logits[0, :4] = logits[0, 0]  # a tie at the top
    ref = np.asarray(jax_filter(jnp.asarray(logits), temperature=0.7,
                                top_k=top_k, top_p=top_p))
    got = filter_logits(torch.from_numpy(logits), temperature=0.7,
                        top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[~np.isinf(got)], ref[~np.isinf(ref)], rtol=1e-6)


def test_greedy_sampling_and_knob_checks():
    from torchkafka_tpu.models.generate import sample_logits as jax_sample
    from torchkafka_tpu_torch.models.generate import check_sampling_params, sample_logits

    logits = np.random.default_rng(5).normal(size=(6, 33)).astype(np.float32)
    logits[2, [3, 9]] = 10.0  # argmax ties resolve to the first maximum
    ref = np.asarray(jax_sample(jnp.asarray(logits), jax.random.key(0)))
    got = sample_logits(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # Top-1 sampling is greedy where the maximum is unique (ties are kept).
    untied = np.delete(logits, 2, axis=0)
    drawn = sample_logits(torch.from_numpy(untied), torch.Generator().manual_seed(0),
                          temperature=1.0, top_k=1)
    np.testing.assert_array_equal(drawn.numpy(), np.delete(ref, 2))
    for bad in ({"top_k": 0}, {"top_p": 0.0}, {"top_p": 1.5}):
        with pytest.raises(ValueError):
            check_sampling_params(bad.get("top_k"), bad.get("top_p"))


def test_moe_config_raises():
    """MoE configs train (the dense-dispatch trunk) but do not serve yet:
    the serving prefill and int8 quantization raise."""
    cfg = pt.TransformerConfig(**SHAPE, n_experts=4, dtype=torch.float32)
    params = pt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["layers"]["router"].shape == (2, 64, 4)
    with pytest.raises(NotImplementedError, match="MoE"):
        prefill(params, cfg, torch.zeros((1, 8), dtype=torch.int32), 16)
    from torchkafka_tpu_torch.models.quant import quantize_params

    with pytest.raises(NotImplementedError, match="MoE"):
        quantize_params(params, cfg)


def test_init_params_tree_matches_jax_layout():
    jcfg, pcfg = _configs("dense")
    ref = jax.eval_shape(lambda k: jt.init_params(k, jcfg), jax.random.key(0))
    got = pt.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert set(got) == set(ref) and set(got["layers"]) == set(ref["layers"])
    for name, leaf in ref["layers"].items():
        assert tuple(got["layers"][name].shape) == leaf.shape
    assert tuple(got["lm_head"].shape) == ref["lm_head"].shape


def test_zoo_1b_config_and_small_random_params():
    cfg = zoo_config("1b")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (2048, 24, 16, 8, 5632, 32000)
    assert cfg.param_dtype == torch.bfloat16
    small = pt.TransformerConfig(**SHAPE, param_dtype=torch.bfloat16)
    params = random_serving_params(torch.Generator().manual_seed(0), small, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    qparams = random_serving_params(torch.Generator(), small, quantized=True, device="cpu")
    assert qparams["embed"].q.dtype == torch.int8
