"""MoE serving on the port against the JAX package, on the CPU at f32.

- ``tests/test_serve.py``'s ``test_moe_serving`` and ``tests/test_quant.py``'s
  MoE cases (the router kept out of int8, a quantized MoE forward),
  re-rooted onto the port.
- The port's server against the JAX package's on the same broker content
  from the same parameters: a capacity-dispatch MoE config (its prefill
  drops, its decode routes dense) on the compute-dtype pool and on the
  int8 pool, and ``quantize_params`` int8 weights on the int8 pool: equal
  tokens per record and equal committed offsets.
- ``quantize_params`` of an MoE tree byte for byte, and ``kv_pages`` with
  an MoE config raising the same ``ValueError`` in both packages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
from _torch_fleet_common import load_rerooted
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.quant import quantize_params as jax_quantize_params
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.quant import quantize_params
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.records import TopicPartition

_SHIM = types.SimpleNamespace(
    float32=torch.float32, int32=torch.int32,
    asarray=lambda x, dtype=None: torch.as_tensor(x, dtype=dtype),
    zeros=lambda shape, dtype: torch.zeros(shape, dtype=dtype),
    isfinite=torch.isfinite,
)

# ------------------------------------------------------------ re-rooted cases

_serve_ref = load_rerooted("test_serve")
_serve_ref.jnp = _SHIM
_quant_ref = load_rerooted("test_quant")
_quant_ref.jnp = _SHIM


class TestStreamingGenerator:
    test_moe_serving = _serve_ref.TestStreamingGenerator.test_moe_serving


class TestQuantize:
    test_moe_weights_quantized_router_kept = (
        _quant_ref.TestQuantize.test_moe_weights_quantized_router_kept)


class TestQuantizedInference:
    test_moe_forward_runs_quantized = (
        _quant_ref.TestQuantizedInference.test_moe_forward_runs_quantized)


# ------------------------------------------------------- against the JAX server

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=48, max_seq_len=32, n_experts=4, expert_top_k=2,
             moe_dispatch="capacity", capacity_factor=0.3, moe_group_size=32)
N, PARTS, SLOTS, P, MAX_NEW, TICKS = 8, 2, 4, 16, 8, 3


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(11), jcfg)
    prompts = np.random.default_rng(1).integers(0, SHAPE["vocab_size"], (N, P),
                                                dtype=np.int32)
    return jcfg, jparams, pcfg, prompts


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _serve(which, model, kv_dtype, quantized):
    jcfg, jparams, pcfg, prompts = model
    if quantized:
        jparams = jax_quantize_params(jparams, jcfg)
    if which == "jax":
        broker, Consumer, TP = tk.InMemoryBroker(), tk.MemoryConsumer, tk.TopicPartition
    else:
        broker, Consumer, TP = InMemoryBroker(), MemoryConsumer, TopicPartition
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS)
    consumer = Consumer(broker, "t", group_id="g")
    kw = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, commit_every=SLOTS,
              ticks_per_sync=TICKS, kv_dtype=kv_dtype)
    if which == "jax":
        server = JaxServer(consumer, jparams, jcfg, kv_kernel=False, **kw)
    else:
        params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
        server = StreamingGenerator(consumer, params, pcfg, device="cpu", **kw)
    got = {(r.topic, r.partition, r.offset): out.tolist()
           for r, out in server.run(idle_timeout_ms=0)}
    consumer.close()
    return got, [broker.committed("g", TP("t", p)) for p in range(PARTS)]


@pytest.mark.parametrize("kv_dtype,quantized", [(None, False), ("int8", False),
                                                ("int8", True)],
                         ids=["compute_pool", "int8_pool", "int8_weights"])
def test_moe_server_matches_jax(model, kv_dtype, quantized):
    ref, ref_committed = _serve("jax", model, kv_dtype, quantized)
    got, committed = _serve("port", model, kv_dtype, quantized)
    assert len(ref) == N
    assert got == ref
    assert committed == ref_committed == [N // PARTS] * PARTS


def test_moe_quantize_params_matches_jax(model):
    jcfg, jparams, pcfg, _ = model
    ref = _np_tree(jax_quantize_params(jparams, jcfg))
    got = quantize_params(pt.params_from_numpy(_np_tree(jparams), pcfg, "cpu"), pcfg)
    for name in ("w_gate", "w_up", "w_down", "wq", "wo"):
        np.testing.assert_array_equal(got["layers"][name].q.numpy(), ref["layers"][name].q)
        np.testing.assert_array_equal(got["layers"][name].scale.numpy(),
                                      ref["layers"][name].scale)
    np.testing.assert_array_equal(got["layers"]["router"].numpy(), ref["layers"]["router"])


def test_moe_paged_pool_raises_as_jax(model):
    jcfg, jparams, pcfg, _ = model
    pages = {"block_size": 4, "num_blocks": 32}
    jb, pb = tk.InMemoryBroker(), InMemoryBroker()
    jb.create_topic("t", partitions=1)
    pb.create_topic("t", partitions=1)
    with pytest.raises(ValueError) as ref:
        JaxServer(tk.MemoryConsumer(jb, "t", group_id="g"), jparams, jcfg, slots=2,
                  prompt_len=P, max_new=MAX_NEW, kv_pages=pages)
    params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
    with pytest.raises(ValueError) as got:
        StreamingGenerator(MemoryConsumer(pb, "t", group_id="g"), params, pcfg, slots=2,
                           prompt_len=P, max_new=MAX_NEW, kv_pages=pages, device="cpu")
    assert str(got.value) == str(ref.value)
