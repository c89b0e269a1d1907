"""The dense int8 pool's kernel-off read and int8 weights in the port's
server, against the JAX server on the same broker content at f32: the
weights are the JAX package's ``quantize_params`` tree brought across by
``params_from_numpy``, both servers read an M-major int8 pool through the
scale-folded ``_attend_cached`` (``kv_kernel=False``), and the greedy
tokens and committed offsets must be identical. Then the port's
``kv_kernel=True`` read (the fill-bounded kernel's plain version on the
CPU) against its ``kv_kernel=False`` read, token for token, as the JAX
package's own kernel-serving test does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.quant import quantize_params as jax_quantize_params
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.kvcache import resolve_kv_backend
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.quant import QTensor
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.records import TopicPartition

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)
N, PARTS, SLOTS, P, MAX_NEW, TICKS = 10, 2, 4, 16, 8, 3


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jax_quantize_params(jt.init_params(jax.random.key(3), jcfg), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    prompts = np.random.default_rng(5).integers(
        0, SHAPE["vocab_size"], (N, P), dtype=np.int32
    )
    return jcfg, jparams, pcfg, params, prompts


def _serve(which, model, kv_kernel):
    jcfg, jparams, pcfg, params, prompts = model
    if which == "jax":
        broker = tk.InMemoryBroker()
        Consumer, TP = tk.MemoryConsumer, tk.TopicPartition
    else:
        broker, Consumer, TP = InMemoryBroker(), MemoryConsumer, TopicPartition
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS)
    consumer = Consumer(broker, "t", group_id="g")
    kw = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, commit_every=SLOTS,
              ticks_per_sync=TICKS, kv_dtype="int8", kv_kernel=kv_kernel)
    if which == "jax":
        server = JaxServer(consumer, jparams, jcfg, **kw)
    else:
        server = StreamingGenerator(consumer, params, pcfg, device="cpu", **kw)
    server.warmup()
    got = {
        (r.topic, r.partition, r.offset): out.tolist()
        for r, out in server.run(idle_timeout_ms=0)
    }
    consumer.close()
    committed = [broker.committed("g", TP("t", p)) for p in range(PARTS)]
    return got, committed, server


def test_int8_weights_arrive_as_qtensors(model):
    _, jparams, _, params, _ = model
    assert isinstance(params["lm_head"], QTensor)
    assert params["layers"]["w_gate"].q.dtype == torch.int8
    np.testing.assert_array_equal(params["layers"]["wq"].scale.numpy(),
                                  np.asarray(jparams["layers"]["wq"].scale))


def test_kernel_off_read_matches_jax(model):
    ref, ref_committed, _ = _serve("jax", model, kv_kernel=False)
    got, committed, server = _serve("port", model, kv_kernel=False)
    assert len(ref) == N
    assert got == ref
    assert committed == ref_committed == [N // PARTS] * PARTS
    kb = server.metrics.summary()["kv_backend"]
    assert kb["layout"] == "dense" and kb["kv_dtype"] == "int8"
    assert kb["kernel"] is False and kb["kernel_engaged"] == 0


def test_kernel_read_matches_kernel_off_read(model):
    off, off_committed, _ = _serve("port", model, kv_kernel=False)
    on, on_committed, _ = _serve("port", model, kv_kernel=True)
    assert on == off
    assert on_committed == off_committed == [N // PARTS] * PARTS


def test_kernel_off_pool_is_m_major(model):
    *_, pcfg, params, _ = model
    broker = InMemoryBroker()
    broker.create_topic("t", partitions=1)
    consumer = MemoryConsumer(broker, "t", group_id="g")
    kw = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, kv_dtype="int8", device="cpu")
    off = StreamingGenerator(consumer, params, pcfg, kv_kernel=False, **kw)
    on = StreamingGenerator(consumer, params, pcfg, kv_kernel=True, **kw)
    L, M, K, DH = pcfg.n_layers, P + MAX_NEW, pcfg.n_kv_heads, pcfg.head_dim
    assert tuple(off._caches[0].shape) == (L, SLOTS, M, K, DH)
    assert tuple(off._caches[1].shape) == (L, SLOTS, M, K)
    assert tuple(on._caches[0].shape) == (L, SLOTS, K, M, DH)


def test_mirror_of_the_jax_kernel_serving_test():
    """``tests/test_ops.py``'s kernel-serving case at its sizes (head_dim
    128, f32 weights, int8 pool): the kernel and kernel-off reads give the
    same completions, tokens and per-completion commits."""
    cfg = pt.TransformerConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=2,
                               n_kv_heads=2, d_ff=64, max_seq_len=16,
                               dtype=torch.float32, param_dtype=torch.float32)
    jcfg = jt.TransformerConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=2,
                                n_kv_heads=2, d_ff=64, max_seq_len=16, dtype=jnp.float32)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.key(0), jcfg)),
        cfg, device="cpu",
    )
    prompts = np.random.default_rng(7).integers(0, 64, (6, 8), dtype=np.int32)

    def serve(kv_kernel):
        broker = InMemoryBroker()
        broker.create_topic("p", partitions=1)
        for row in prompts:
            broker.produce("p", row.tobytes())
        consumer = MemoryConsumer(broker, "p", group_id="gkm")
        srv = StreamingGenerator(consumer, params, cfg, slots=2, prompt_len=8,
                                 max_new=8, kv_dtype="int8", kv_kernel=kv_kernel,
                                 commit_every=1, device="cpu")
        got = {rec.offset: np.asarray(t) for rec, t in srv.run(max_records=len(prompts))}
        committed = broker.committed("gkm", TopicPartition("p", 0))
        srv.close()
        consumer.close()
        return got, committed

    got_k, committed_k = serve(True)
    got_x, committed_x = serve(False)
    assert committed_k == committed_x == len(prompts)
    assert len(got_k) == len(got_x) == len(prompts)
    for off in got_x:
        np.testing.assert_array_equal(got_k[off], got_x[off])


@pytest.mark.parametrize("kv_kernel,device,head_dim,kernel,reason", [
    (False, "cpu", 16, False, None),
    (False, "cuda", 16, False, None),
    ("auto", "cuda", 16, True, None),
    ("auto", "cpu", 16, True, None),  # the wrapper runs its plain version
    ("auto", "cuda", 8, False, "tiling"),  # below the kernel's 16-wide loads
])
def test_resolve_dense_int8_read(kv_kernel, device, head_dim, kernel, reason):
    cfg = pt.TransformerConfig(**{**SHAPE, "d_model": 4 * head_dim})
    bk = resolve_kv_backend(cfg, kv_dtype="int8", kv_kernel=kv_kernel,
                            max_len=24, device=device)
    assert bk.layout == "dense" and bk.int8 and bk.kernel is kernel
    if reason is None:
        assert bk.kernel_disabled_reason is None
    else:
        assert reason in bk.kernel_disabled_reason


def test_resolve_dense_int8_kernel_true_still_raises_when_unhonorable():
    cfg = pt.TransformerConfig(**{**SHAPE, "d_model": 32})  # head_dim 8
    with pytest.raises(ValueError, match="cannot be honored"):
        resolve_kv_backend(cfg, kv_dtype="int8", kv_kernel=True, max_len=24,
                           device="cuda")
