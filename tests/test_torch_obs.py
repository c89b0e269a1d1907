"""The port's observability plane against the JAX package's.

- ``test_obs.py``'s host cases run over the port: the module's source is
  loaded with the package name re-rooted onto ``torchkafka_tpu_torch``
  and its tracer, windowed-histogram, burn-rate, exporter and ingest-lag
  classes are collected here, with its exposition-conformance cases for
  every source (the fleet's and the traced fleet's included) and its
  label-escaping case on the server's exposition. Its traced fleets run
  in ``test_torch_fleet.py``, against the JAX fleet.
- Differentials at f32, one seeded broker content through both servers,
  each traced under a manual clock that steps 1 ms a reading: the event
  lists and the JSONL exports are equal for dense greedy, chunked paged
  greedy, dense sampled, a poison record (quarantined, and dropped
  without a quarantine), a journal warm resume (``journal_served``,
  ``warm_resumed``) and per-record budgets (``max_new_of``). After the
  same run ``metrics.render_prometheus()`` is equal line for line, except
  the KV-backend lines (each package's own backend) and the host-timing
  gauges (family, type and labels only), and ``summary()``'s keys are a
  superset of JAX's.
- The server's host phases open their ``utils.tracing`` spans on a CPU
  ``torch.profiler`` trace.
"""

import json
import pathlib
import re
import sys
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.utils import prng, tracing

_REF = pathlib.Path(__file__).with_name("test_obs.py")
_mod = types.ModuleType("_port_obs")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
_src = _REF.read_text()
# The port's KVBackend names its device and has no mesh extents (one
# device; its ``describe()`` reports data = tp = 1).
_MESH = "chunked=True, data=2, tp=2,"
assert _src.count(_MESH) == 1
_src = _src.replace(_MESH, 'chunked=True, device="cpu",')
exec(compile(_src.replace("torchkafka_tpu", "torchkafka_tpu_torch"), str(_REF),
             "exec"), _mod.__dict__)
assert _mod.tk is ptk and _mod.RecordTracer is ptk.RecordTracer

TestTracerDerivations = _mod.TestTracerDerivations
TestWindowedHistograms = _mod.TestWindowedHistograms
TestBurnRateMonitor = _mod.TestBurnRateMonitor
TestExporter = _mod.TestExporter
TestIngestLagClock = _mod.TestIngestLagClock


@pytest.mark.parametrize("render", [
    _mod._stream_metrics, _mod._serve_metrics, _mod._resilience_metrics,
    _mod._slo_tracer, _mod._burn_monitor, _mod._windowed_slo_tracer,
    _mod._broker_metrics, _mod._fleet_metrics, _mod._traced_fleet_metrics,
], ids=["stream", "serve", "resilience", "slo", "burn", "windowed-slo", "broker",
        "fleet", "traced-fleet"])
def test_exposition_conformance(render):
    _mod._assert_conformant(render())


def test_exposition_label_escaping_roundtrip():
    """``test_obs.py``'s escaping case; the hostile tenant key's samples
    are read from the server's per-tenant families (the fleet's wait for
    the fleet)."""
    assert _mod.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    body = _mod.format_labels(tenant=_mod.EVIL_TENANT, percentile="p50")
    assert "\n" not in body
    text = _mod._serve_metrics()
    evil = [li for li in text.splitlines() if "tenant_prefix_cache_hits_total{" in li]
    assert evil and all(_mod._SAMPLE_RE.match(li) for li in evil)


def test_combined_exposition_has_no_duplicate_metric_families():
    text = "".join(r() for r in (
        _mod._stream_metrics, _mod._serve_metrics, _mod._resilience_metrics,
        _mod._slo_tracer, _mod._burn_monitor, _mod._windowed_slo_tracer,
        _mod._broker_metrics,
    ))
    names = re.findall(r"^# TYPE (\S+)", text, re.M)
    assert len(names) == len(set(names))
    _mod._assert_conformant(text)


# ------------------------------------------------------------- differentials

P, MAX_NEW, VOCAB, SLOTS, PARTS, N = 8, 8, 64, 4, 2, 8
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + 2 * MAX_NEW)
PAGES = {"block_size": 4, "num_blocks": 40}
PKG = {"jax": (tk, JaxServer), "port": (ptk, StreamingGenerator)}
# Hosts' wall-clock gauges: compared by family, type and labels only.
TIMING = ("commit_latency_p50_milliseconds", "commit_latency_p99_milliseconds",
          "completions_per_second", "tokens_per_second", "step_time_ms")
BACKEND = ("kv_backend_info", "kv_kernel_engaged", "kv_kernel_disabled_total")


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jcfg, jparams), "port": (pcfg, params)}


def _kw(pkg: str, kw: dict) -> dict:
    kw = dict(kw)
    if "rng" in kw:
        kw["rng"] = (jax.random.key if pkg == "jax" else prng.key)(kw["rng"])
    if pkg == "jax":
        if kw.get("kv_dtype") == "int8":
            kw["kv_kernel"] = False
    else:
        kw["device"] = "cpu"
    return kw


def _tracer(mod):
    """A tracer on a manual clock that steps 1 ms at every reading: the
    timestamps then count the clock reads, so equal exports also mean the
    same reads in the same order."""
    mc = mod.ManualClock()

    def clock():
        mc.advance(0.001)
        return mc.now()

    return mod.RecordTracer(mod.ObsConfig(clock=clock))


def _decode(rec):
    if rec.value.startswith(b"POISON"):
        raise ValueError("undecodable prompt")
    return np.frombuffer(rec.value, np.int32)[:P]


def _produce(broker, poison=False):
    broker.create_topic("p", partitions=PARTS)
    broker.create_topic("dlq", partitions=1)
    prompts = np.random.default_rng(7).integers(0, VOCAB, (N, P), dtype=np.int32)
    prompts[:, :5] = np.arange(5, dtype=np.int32)  # one shared radix block
    for i in range(N):
        broker.produce("p", prompts[i].tobytes(), partition=i % PARTS,
                       key=b"ten%d" % (i % 2))
        if poison and i == 3:
            broker.produce("p", b"POISON-payload", key=b"bad", partition=1)


def _result(mod, broker, server, tracer, got, path):
    n = tracer.export_jsonl(str(path))
    return {
        "tokens": got,
        "committed": [broker.committed("g", mod.TopicPartition("p", p)) or 0
                      for p in range(PARTS)],
        "events": [e.to_json() for e in tracer.events],
        "jsonl": (n, pathlib.Path(path).read_bytes()),
        "trace_summary": tracer.summary(),
        "slo_exposition": tracer.render_prometheus(),
        "exposition": server.metrics.render_prometheus(),
        "summary": server.metrics.summary(),
    }


def _traced_run(pkg, model, path, *, poison=None, **kw):
    """One traced serve of the shared broker content; ``poison``: None,
    "quarantine" (a ``PoisonQuarantine`` with budget 2) or "drop"."""
    mod, Server = PKG[pkg]
    cfg, params = model[pkg]
    broker = mod.InMemoryBroker()
    _produce(broker, poison=poison is not None)
    consumer = mod.MemoryConsumer(broker, "p", group_id="g")
    tracer = _tracer(mod)
    extra = {}
    if poison is not None:
        extra["decode_prompt"] = _decode
    if poison == "quarantine":
        extra["quarantine"] = mod.PoisonQuarantine(mod.MemoryProducer(broker), "dlq",
                                                   budget=2)
    server = Server(consumer, params, cfg, slots=SLOTS, prompt_len=P,
                    max_new=MAX_NEW, commit_every=4, tracer=tracer, trace_replica=0,
                    **extra, **_kw(pkg, kw))
    got = {(r.partition, r.offset): t.tolist() for r, t in server.run(idle_timeout_ms=0)}
    consumer.close()
    return _result(mod, broker, server, tracer, got, path)


def _resume_run(pkg, model, tmp_path):
    """A journal warm resume: the first server serves two records to the
    end and two more four tokens in, then dies uncommitted; the second,
    traced and hinted from the journal, re-serves the two finished ones
    from it (``journal_served``), warm-resumes the two partial ones
    (``warm_resumed``) and serves the rest cold."""
    mod, Server = PKG[pkg]
    cfg, params = model[pkg]
    broker = mod.InMemoryBroker()
    _produce(broker)
    jpath = str(tmp_path / f"{pkg}.journal")
    skw = dict(slots=2, prompt_len=P, max_new=MAX_NEW, ticks_per_sync=1, **_kw(pkg, {}))
    c1 = mod.MemoryConsumer(broker, "p", group_id="g")
    gen1 = Server(c1, params, cfg, commit_every=2**31 - 1,
                  journal=mod.DecodeJournal(jpath, cadence=2), **skw)
    for steps in (MAX_NEW - 1, 4):
        recs = c1.poll(max_records=2, timeout_ms=100)
        gen1.note_fetched(recs)
        gen1.admit_records(recs)
        for _ in range(steps):
            gen1.step()
    c1.close()
    c2 = mod.MemoryConsumer(broker, "p", group_id="g")
    tracer = _tracer(mod)
    gen2 = Server(c2, params, cfg, commit_every=4, tracer=tracer, **skw)
    gen2.add_resume_hints(mod.DecodeJournal.load(jpath))
    got = {(r.partition, r.offset): t.tolist() for r, t in gen2.run(idle_timeout_ms=0)}
    gen2.close()
    return _result(mod, broker, gen2, tracer, got, tmp_path / f"{pkg}.jsonl")


MODES = {
    "dense-greedy": {},
    "paged-chunked": {"kv_pages": PAGES},
    "dense-sampled": {"temperature": 0.8, "top_k": 8, "rng": 3},
    "poison-quarantined": {"poison": "quarantine"},
    "poison-dropped": {"poison": "drop"},
    "budgets": {"max_new_of": lambda r: 3 if r.key == b"ten1" else None},
    "paged-budgets": {"kv_pages": PAGES,
                      "max_new_of": lambda r: 5 if r.key == b"ten0" else 2},
}


@pytest.fixture(scope="module")
def runs(model, tmp_path_factory):
    """Each (package, mode) run once per module."""
    root = tmp_path_factory.mktemp("traces")
    cache: dict = {}

    def get(pkg, mode):
        if (pkg, mode) not in cache:
            if mode == "journal-resume":
                d = root / f"resume-{pkg}"
                d.mkdir()
                cache[pkg, mode] = _resume_run(pkg, model, d)
            else:
                cache[pkg, mode] = _traced_run(pkg, model, root / f"{pkg}-{mode}.jsonl",
                                               **MODES[mode])
        return cache[pkg, mode]

    return get


ALL_MODES = [*MODES, "journal-resume"]


@pytest.mark.parametrize("mode", ALL_MODES)
def test_trace_matches_jax(runs, mode):
    ref, got = runs("jax", mode), runs("port", mode)
    assert got["tokens"] == ref["tokens"]
    assert got["committed"] == ref["committed"]
    assert got["events"] == ref["events"]
    assert got["jsonl"] == ref["jsonl"]
    assert got["trace_summary"] == ref["trace_summary"]
    assert got["slo_exposition"] == ref["slo_exposition"]
    # Balanced: every served record polled, active, finished and committed
    # once; nothing left open.
    stages = [e["stage"] for e in got["events"]]
    served = len(got["tokens"])
    assert served >= N
    for stage in ("polled", "finished", "committed"):
        assert stages.count(stage) >= served, stage
    assert got["trace_summary"]["open_records"] == 0


def _branch_stages(events):
    return {e["stage"] for e in events}


def test_branch_events_are_emitted(runs):
    """The branch events the modes exist for actually occur."""
    assert "chunk_scheduled" in _branch_stages(runs("port", "paged-chunked")["events"])
    assert "prefill_queued" in _branch_stages(runs("port", "paged-chunked")["events"])
    assert "quarantined" in _branch_stages(runs("port", "poison-quarantined")["events"])
    assert "dropped" in _branch_stages(runs("port", "poison-dropped")["events"])
    resumed = _branch_stages(runs("port", "journal-resume")["events"])
    assert {"journal_served", "warm_resumed"} <= resumed


def _exposition_lines(text):
    """Each line of an exposition, with the KV-backend families left out and
    the host-timing gauges' values cut off."""
    out = []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else re.split(r"[{ ]", line)[0]
        family = name.removeprefix("torchkafka_serve_")
        if family in BACKEND:
            continue
        if family in TIMING and not line.startswith("#"):
            line = line.rsplit(" ", 1)[0]
        out.append(line)
    return out


@pytest.mark.parametrize("mode", ALL_MODES)
def test_prometheus_matches_jax(runs, mode):
    ref, got = runs("jax", mode), runs("port", mode)
    assert _exposition_lines(got["exposition"]) == _exposition_lines(ref["exposition"])
    _mod._assert_conformant(got["exposition"])


def _assert_superset(port, ref, path="summary"):
    missing = sorted(set(ref) - set(port))
    assert not missing, (path, missing)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert isinstance(port[k], dict), (path, k)
            _assert_superset(port[k], v, f"{path}.{k}")


@pytest.mark.parametrize("mode", ["paged-chunked", "budgets"])
def test_summary_keys_are_a_superset_of_jax(runs, mode):
    ref, got = runs("jax", mode), runs("port", mode)
    _assert_superset(got["summary"], ref["summary"])
    for k in ("decoded_tokens", "prefills", "decode_ticks"):
        assert k in got["summary"]


def test_budgets_cut_each_record(runs):
    got = runs("port", "budgets")
    for (part, off), toks in got["tokens"].items():
        # Records alternate keys ten0/ten1 by index, and index i lands on
        # partition i % 2 at offset i // 2.
        key = (off * PARTS + part) % 2
        assert len(toks) == (3 if key == 1 else MAX_NEW), (part, off)
    assert got["summary"]["output_capped"] == N // 2


def test_tenant_cache_counters(runs):
    s = runs("port", "paged-chunked")["summary"]
    tc = s["tenant_cache"]
    assert set(tc) == {"ten0", "ten1"}
    assert sum(v["hits"] for v in tc.values()) == s["prefix_cache"]["hits"]
    assert sum(v["misses"] for v in tc.values()) == s["prefix_cache"]["misses"]


def test_untraced_run_is_unchanged(model, tmp_path):
    """The tracer changes no token and no commit."""
    traced = _traced_run("port", model, tmp_path / "t.jsonl", kv_pages=PAGES)
    mod, Server = PKG["port"]
    cfg, params = model["port"]
    broker = mod.InMemoryBroker()
    _produce(broker)
    consumer = mod.MemoryConsumer(broker, "p", group_id="g")
    server = Server(consumer, params, cfg, slots=SLOTS, prompt_len=P, max_new=MAX_NEW,
                    commit_every=4, kv_pages=PAGES, device="cpu")
    got = {(r.partition, r.offset): t.tolist() for r, t in server.run(idle_timeout_ms=0)}
    assert got == traced["tokens"]
    assert [broker.committed("g", mod.TopicPartition("p", p)) for p in range(PARTS)] \
        == traced["committed"]


# ------------------------------------------------------------ profiler spans


def test_host_spans_on_a_profiler_trace(model, tmp_path):
    """A two-tick dense serve (admit, tick, sync, commit) and a two-tick
    chunked paged serve (chunk_pack, tick, sync, commit) under one
    profiler session: every span name is on the trace."""
    mod, Server = PKG["port"]
    cfg, params = model["port"]
    with tracing.trace_session(str(tmp_path)) as prof:
        for kw in ({}, {"kv_pages": PAGES}):
            broker = mod.InMemoryBroker()
            _produce(broker)
            consumer = mod.MemoryConsumer(broker, "p", group_id="g")
            server = Server(consumer, params, cfg, slots=SLOTS, prompt_len=P,
                            max_new=3, ticks_per_sync=1, device="cpu", **kw)
            recs = consumer.poll(max_records=SLOTS, timeout_ms=100)
            server.note_fetched(recs)
            server.admit_records(recs)
            for _ in range(2):
                server.step()
            assert server.flush_commits()
    names = {e.key for e in prof.key_averages()}
    trace = json.loads((tmp_path / "trace.json").read_text())
    on_trace = {e.get("name") for e in trace["traceEvents"]}
    for span in (tracing.SPAN_ADMIT, tracing.SPAN_CHUNK_PACK, tracing.SPAN_TICK,
                 tracing.SPAN_SYNC, tracing.SPAN_COMMIT):
        assert span in names and span in on_trace, span


def test_exporter_scrapes_server_and_tracer(runs):
    """The server's and the tracer's expositions on one endpoint parse as
    one conformant scrape with no duplicate family."""
    got = runs("port", "paged-chunked")
    with ptk.MetricsExporter([lambda: got["exposition"],
                              lambda: got["slo_exposition"]]) as exporter:
        with urllib.request.urlopen(exporter.url, timeout=10) as resp:
            body = resp.read().decode()
    _mod._assert_conformant(body)
    names = re.findall(r"^# TYPE (\S+)", body, re.M)
    assert len(names) == len(set(names))
