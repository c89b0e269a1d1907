"""The slice whole: the port's continuous-batching server against the JAX
package's, on the same broker content, from the same parameters, at f32.
Greedy tokens per record and committed offsets must be identical, with the
compute-dtype pool and with the int8 pool (the JAX side reads its int8 pool
without the Pallas kernel, the same math as the port's read)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.models.generate import generate as jax_generate
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.source.memory import InMemoryBroker, MemoryConsumer
from torchkafka_tpu_torch.source.records import TopicPartition
from torchkafka_tpu_torch.utils import prng

SHAPE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq_len=32)
N, PARTS, SLOTS, P, MAX_NEW, TICKS = 10, 2, 4, 16, 8, 3


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(7), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    prompts = np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], (N, P), dtype=np.int32
    )
    # EOS = the modal generated token of a lockstep probe (scenario 7's
    # rule), so some generations stop early and slots recycle mid-stream.
    probe = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompts[:8]), MAX_NEW))
    toks, counts = np.unique(probe[:, 1:], return_counts=True)
    eos = int(toks[counts.argmax()])
    return jcfg, jparams, pcfg, params, prompts, eos


def _serve(which, model, kv_dtype, max_records=None):
    jcfg, jparams, pcfg, params, prompts, eos = model
    if which == "jax":
        broker = tk.InMemoryBroker()
        Consumer, TP = tk.MemoryConsumer, tk.TopicPartition
    else:
        broker, Consumer, TP = InMemoryBroker(), MemoryConsumer, TopicPartition
    broker.create_topic("t", partitions=PARTS)
    for i in range(N):
        broker.produce("t", prompts[i].tobytes(), partition=i % PARTS)
    consumer = Consumer(broker, "t", group_id="g")
    kw = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, eos_id=eos,
              commit_every=SLOTS, ticks_per_sync=TICKS, kv_dtype=kv_dtype)
    if which == "jax":
        server = JaxServer(consumer, jparams, jcfg, kv_kernel=False, **kw)
    else:
        server = StreamingGenerator(consumer, params, pcfg, device="cpu", **kw)
    server.warmup()
    got = {
        (r.topic, r.partition, r.offset): out.tolist()
        for r, out in server.run(max_records=max_records, idle_timeout_ms=0)
    }
    consumer.close()
    committed = [broker.committed("g", TP("t", p)) for p in range(PARTS)]
    return got, committed, server.metrics


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tokens_and_commits_match(model, kv_dtype):
    ref, ref_committed, _ = _serve("jax", model, kv_dtype)
    got, committed, metrics = _serve("port", model, kv_dtype)
    assert len(ref) == N
    assert got == ref
    assert committed == ref_committed == [N // PARTS] * PARTS
    assert metrics.truncated.count > 0  # EOS stopped some generations
    assert metrics.readmissions.count > 0  # slots refilled mid-stream


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_max_records_cut_commits_match(model, kv_dtype):
    ref, ref_committed, _ = _serve("jax", model, kv_dtype, max_records=6)
    got, committed, _ = _serve("port", model, kv_dtype, max_records=6)
    assert len(got) == len(ref) == 6
    assert got == ref
    assert committed == ref_committed


def _server(model, **kw):
    _, _, pcfg, params, _, _ = model
    broker = InMemoryBroker()
    broker.create_topic("t", partitions=1)
    consumer = MemoryConsumer(broker, "t", group_id="g")
    base = dict(slots=2, prompt_len=P, max_new=MAX_NEW, device="cpu")
    return StreamingGenerator(consumer, params, pcfg, **{**base, **kw})


# Cases of served arguments that the JAX server rejects as well, with the
# same exception (test_served_arguments_raise_as_jax): a TierConfig field
# that does not exist, a TierConfig without its capacity, and the tracer,
# its replica tag and the output budget beside a knob out of range.
SERVED_REJECTED = {
    "kw1": ({"kv_pages": {"block_size": 4, "num_blocks": 16},
             "kv_tier": {"host_bytes": 1}}, TypeError),
    "kw2": ({"kv_tier": {}}, TypeError),
    "kw4": ({"trace_replica": "r0", "max_new": 1}, ValueError),
    "kw5": ({"tracer": ptk.RecordTracer(), "ticks_per_sync": 0}, ValueError),
    "kw10": ({"max_new_of": lambda r: 2, "prompt_len": 10**4}, ValueError),
    # The distill publisher: in transactional mode without the output
    # producer, and at-least-once without any producer.
    "kw8": ({"distill_topic": "d", "exactly_once": True}, ValueError),
    "kw9": ({"distill_topic": "d"}, ValueError),
    # The disaggregated prefill role without chunked pages.
    "kw3": ({"prefill_role": True}, ValueError),
}


# The ids keep each case's position in the list. Sampling, the quarantine,
# the journal and exactly-once output are served now: their cases test the
# new checks (bad knobs raise ValueError at construction, exactly_once
# without an output producer raises ValueError as in JAX, an rng that is
# no key raises TypeError) or a still-deferred argument. So are the
# tracer, budgets and the host-RAM tier: kw1, kw2, kw4, kw5 and kw10 are
# the SERVED_REJECTED cases, and so are the distill publisher's kw8 and kw9
# and the prefill role's kw3 (once deferred, now served).
@pytest.mark.parametrize("kw,exc", [
    ({"mesh": object()}, TypeError),  # a mesh must be a parallel.make_mesh DeviceMesh
    SERVED_REJECTED["kw1"],
    SERVED_REJECTED["kw2"],
    SERVED_REJECTED["kw3"],
    SERVED_REJECTED["kw4"],
    SERVED_REJECTED["kw5"],
    ({"exactly_once": True}, ValueError),
    ({"top_k": 0}, ValueError),
    SERVED_REJECTED["kw8"],
    SERVED_REJECTED["kw9"],
    SERVED_REJECTED["kw10"],
    ({"temperature": 0.7, "top_p": 1.5}, ValueError),
    ({"rng": object()}, TypeError),
], ids=[f"kw{i}" for i in range(13)])
def test_unsupported_arguments_raise(model, kw, exc):
    with pytest.raises(exc, match="ROADMAP" if exc is NotImplementedError else None):
        _server(model, **kw)


@pytest.mark.parametrize("case", list(SERVED_REJECTED))
def test_served_arguments_raise_as_jax(model, case):
    """The JAX server raises the same exception for the same arguments."""
    jcfg, jparams, *_ = model
    kw, exc = SERVED_REJECTED[case]
    kw = {k: tk.RecordTracer() if isinstance(v, ptk.RecordTracer) else v
          for k, v in kw.items()}
    broker = tk.InMemoryBroker()
    broker.create_topic("t", partitions=1)
    consumer = tk.MemoryConsumer(broker, "t", group_id="g")
    base = dict(slots=2, prompt_len=P, max_new=MAX_NEW)
    with pytest.raises(exc):
        JaxServer(consumer, jparams, jcfg, **{**base, **kw})


@pytest.mark.parametrize("kw", [
    {"tracer": ptk.RecordTracer(), "trace_replica": 1},
    {"max_new_of": lambda r: 2},
    {"kv_pages": {"block_size": 4, "num_blocks": 16}, "kv_tier": {"capacity_bytes": 1}},
], ids=["tracer", "max_new_of", "kv_tier"])
def test_observability_budget_and_tier_arguments_go_through(model, kw):
    summary = _server(model, **kw).metrics.summary()
    assert summary["output_capped"] == 0
    assert summary["prefix_cache"]["tier"]["demotions"] == 0


def _queue_a_titles() -> list[str]:
    """The item titles of ROADMAP.md's queue A, lower-cased."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    queue = text.split("### Queue A", 1)[1].split("\n### ", 1)[0]
    return [t.rstrip(".").lower()
            for t in re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M)]


class _PPMesh:
    """A stand-in mesh with a pp axis (no process group is needed: the
    refusal comes before any rank's share is built)."""
    mesh_dim_names = ("pp",)
    mesh = torch.zeros(2)


def test_every_deferral_names_a_queue_a_title(model):
    """What the server still defers, a serving mesh with a pp axis
    (layer-sharded serving), raises an error naming the title of the
    ROADMAP queue A item that ports it, never a bare item number."""
    titles = _queue_a_titles()
    assert len(titles) >= 8
    with pytest.raises(NotImplementedError) as info:
        _server(model, mesh=_PPMesh())
    msg = str(info.value).lower()
    assert any(t in msg for t in titles), (msg, titles)


@pytest.mark.parametrize("kw", [
    {"top_k": 4}, {"quarantine": object()}, {"temperature": 0.7},
    {"rng": prng.key(3)}, {"rng": np.array([0, 3], np.uint32)},
])
def test_sampling_and_quarantine_arguments_go_through(model, kw):
    summary = _server(model, **kw).metrics.summary()
    assert summary["quarantined"] == summary["dlq_delivery_failures"] == 0


def test_unknown_argument_is_a_type_error(model):
    with pytest.raises(TypeError):
        _server(model, no_such_option=1)


def test_no_device_without_cuda_raises(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _server(model, device=None)


def test_metrics_summary_names_the_backend(model):
    server = _server(model, kv_dtype="int8")
    kb = server.metrics.summary()["kv_backend"]
    assert kb["kv_dtype"] == "int8" and kb["kernel"] and kb["device"] == "cpu"
