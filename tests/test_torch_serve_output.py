"""The port's output topic (``output_producer``/``output_topic``, at-least-
once) against the JAX server's, the cases of ``tests/test_serve.py``'s
``TestOutputTopic``: the same prompts through both packages at f32 must
publish the same output records (key, value, headers) and commit the same
offsets, a failed flush must skip the commit, a synchronous send failure
must stall the watermark and not the server, a streak of them and a
terminal delivery failure must stop it, and a producer without a topic is
rejected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as jk
import torchkafka_tpu_torch as pk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator as PortServer

P, MAX_NEW, VOCAB = 8, 8, 64
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jk, JaxServer, jcfg, jparams, {}),
            "port": (pk, PortServer, pcfg, params, {"device": "cpu"})}


def _producers(tk):
    """The JAX test's failing producers, built on one package's
    ``MemoryProducer``."""

    class Flaky(tk.MemoryProducer):
        def flush(self, timeout_s=None):
            raise RuntimeError("output broker gone")

    class FailOnce(tk.MemoryProducer):
        def __init__(self, broker):
            super().__init__(broker)
            self.fails = 0

        def send(self, topic, value, **kw):
            if self.fails == 0:  # the first completion's send
                self.fails = 1
                raise RuntimeError("buffer full")
            return super().send(topic, value, **kw)

    class AlwaysDown(tk.MemoryProducer):
        def send(self, topic, value, **kw):
            raise RuntimeError("broker down")

    class DeadHandle:
        def get(self, timeout_s=None):
            raise RuntimeError("retries exhausted")

    class AsyncFail(tk.MemoryProducer):
        def send(self, topic, value, **kw):
            super().send(topic, value, **kw)
            return DeadHandle()

    return {"ok": tk.MemoryProducer, "flaky": Flaky, "fail_once": FailOnce,
            "down": AlwaysDown, "async_fail": AsyncFail}


def _serve(model, which, n, producer="ok", **kw):
    """n keyed prompts on two partitions served with an output topic;
    returns (completions, committed, output records, metrics summary,
    raised error or None)."""
    tk, Server, cfg, params, extra = model[which]
    broker = tk.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    broker.create_topic("out", partitions=1)
    prompts = np.random.default_rng(7).integers(0, VOCAB, (n, P), dtype=np.int32)
    for i in range(n):
        broker.produce("p", prompts[i].tobytes(), key=f"r{i}".encode(), partition=i % 2)
    consumer = tk.MemoryConsumer(broker, "p", group_id="g")
    server = Server(consumer, params, cfg, slots=4, prompt_len=P, max_new=MAX_NEW,
                    commit_every=2, output_producer=_producers(tk)[producer](broker),
                    output_topic="out", model_version=3, **kw, **extra)
    got, err = [], None
    try:
        for rec, out in server.run(max_records=n):
            got.append((rec.key, np.asarray(out, np.int32).tolist()))
    except tk.OutputDeliveryError as exc:
        err = exc
    committed = [broker.committed("g", tk.TopicPartition("p", p)) or 0 for p in (0, 1)]
    reader = tk.MemoryConsumer(broker, "out", group_id="g2")
    outs = [(r.key, r.value, tuple(r.headers)) for r in reader.poll(max_records=100, timeout_ms=200)]
    return got, committed, outs, server.metrics.summary(), err


def test_completions_published_before_commit(model):
    ref = _serve(model, "jax", 6)
    got, committed, outs, summary, err = _serve(model, "port", 6)
    assert err is None and len(got) == 6
    assert got == ref[0] and committed == ref[1] == [3, 3]
    assert outs == ref[2]
    # Every completion is on the topic, keyed by its prompt, tagged mv=3.
    want = sorted((k, np.asarray(t, np.int32).tobytes(), (("mv", b"3"),)) for k, t in got)
    assert sorted(outs) == want
    assert summary["output_flush_failures"] == 0 == ref[3]["output_flush_failures"]


def test_failed_output_flush_skips_commit(model):
    ref = _serve(model, "jax", 4, producer="flaky")
    got, committed, _, summary, err = _serve(model, "port", 4, producer="flaky")
    assert err is None and len(got) == 4  # serving itself continues
    assert summary["output_flush_failures"] == ref[3]["output_flush_failures"] >= 1
    assert committed == ref[1] == [0, 0]  # nothing committed: all re-deliver


def test_sync_send_failure_stalls_watermark_not_server(model):
    ref = _serve(model, "jax", 6, producer="fail_once")
    got, committed, outs, summary, err = _serve(model, "port", 6, producer="fail_once")
    assert err is None and len(got) == 6  # serving survived
    assert summary["output_send_failures"] == 1 == ref[3]["output_send_failures"]
    assert committed == ref[1] and sum(committed) < 6
    assert len(outs) == 5 and outs == ref[2]


def test_send_failure_streak_fail_stops(model):
    ref = _serve(model, "jax", 6, producer="down", max_send_failure_streak=3)
    got, committed, _, summary, err = _serve(model, "port", 6, producer="down",
                                             max_send_failure_streak=3)
    assert isinstance(err, pk.OutputDeliveryError) and "consecutive" in str(err)
    assert isinstance(ref[4], jk.OutputDeliveryError)
    assert summary["output_send_failures"] == 3 == ref[3]["output_send_failures"]
    assert committed == ref[1] == [0, 0]


def test_terminal_delivery_failure_is_fatal(model):
    ref = _serve(model, "jax", 4, producer="async_fail")
    got, committed, _, summary, err = _serve(model, "port", 4, producer="async_fail")
    assert isinstance(err, pk.OutputDeliveryError)
    assert isinstance(ref[4], jk.OutputDeliveryError)
    assert committed == ref[1] == [0, 0]  # nothing committed past lost output


def test_producer_without_topic_rejected(model):
    tk, Server, cfg, params, extra = model["port"]
    broker = tk.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    consumer = tk.MemoryConsumer(broker, "p", group_id="g")
    with pytest.raises(ValueError, match="together"):
        Server(consumer, params, cfg, slots=2, prompt_len=P, max_new=MAX_NEW,
               output_producer=tk.MemoryProducer(broker), **extra)
    with pytest.raises(ValueError, match="together"):
        Server(consumer, params, cfg, slots=2, prompt_len=P, max_new=MAX_NEW,
               output_topic="out", **extra)
    with pytest.raises(ValueError, match="streak"):
        Server(consumer, params, cfg, slots=2, prompt_len=P, max_new=MAX_NEW,
               output_producer=tk.MemoryProducer(broker), output_topic="out",
               max_send_failure_streak=0, **extra)
