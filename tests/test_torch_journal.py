"""The port's decode journal and warm resume against the JAX package's.

- ``test_journal.py``'s journal and crash-point unit cases
  (``TestDecodeJournal``, ``TestCrashPoints``) run over the port: the
  module's source is loaded with the package name re-rooted onto
  ``torchkafka_tpu_torch`` and the two classes are collected here. Its
  fleet cases (``TestFleetDrainJournal``) are not re-rooted yet, though
  the fleet is ported (ROADMAP queue C item 16).
- The warm-failover differential, ``test_journal.py``'s ``_kill_run``
  driven through both packages from the same parameters at f32, with the
  plain and the speculative server (greedy, dense and chunked paged; a
  resume prefills both models' cache rows): a first
  server journals, decodes a few ticks and dies without committing or
  flushing; a second one, hinted from the journal file on disk, serves
  everything. Completions, committed watermarks, the journal counters and
  ``decoded_tokens`` must be equal to the JAX package's (whose own tests
  hold its kill runs equal to its uncut runs), and the journal files the
  dying servers leave must be byte-identical. Each JAX run is made once
  per module (``jax_runs``).
- A journal file written by the JAX server's killed run resumes the
  port's server to JAX's uncut tokens.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.journal import DecodeJournal as JaxJournal
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu.serve import StreamingGenerator as JaxServer
from torchkafka_tpu.serve_spec import SpecStreamingGenerator as JaxSpec
from torchkafka_tpu_torch.journal import DecodeJournal, JournalEntry, value_crc
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.serve import StreamingGenerator
from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator
from torchkafka_tpu_torch.utils import prng

_REF = pathlib.Path(__file__).with_name("test_journal.py")
_mod = types.ModuleType("_port_journal")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk and _mod.DecodeJournal is DecodeJournal

TestDecodeJournal = _mod.TestDecodeJournal
TestCrashPoints = _mod.TestCrashPoints

P, MAX_NEW, VOCAB, SLOTS, PARTS = 8, 16, 64, 2, 2
N, KILL_STEPS = 6, 5
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
PAGES = {"block_size": 4, "num_blocks": SLOTS * -(-(P + MAX_NEW) // 4) + 9}
SAMPLED = {"temperature": 0.9, "top_k": 16, "rng": 11}
PAGED_SAMPLED = {"temperature": 0.7, "top_p": 0.9, "rng": 5}
PKG = {"jax": (tk, JaxServer, JaxJournal), "port": (ptk, StreamingGenerator, DecodeJournal)}
SPEC = {"jax": JaxSpec, "port": SpecStreamingGenerator}


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
    """One case's server arguments for ``pkg``: the base key as that
    package spells it, the JAX int8 pool read without its TPU kernel, the
    port on the CPU."""
    kw = dict(kw)
    if "rng" in kw:
        kw["rng"] = (jax.random.key if pkg == "jax" else prng.key)(kw["rng"])
    if pkg == "jax":
        if kw.get("kv_dtype") == "int8":
            kw["kv_kernel"] = False
    else:
        kw["device"] = "cpu"
    return kw


def _produce(broker, n, topic="p", seed=7):
    broker.create_topic(topic, partitions=PARTS)
    prompts = np.random.default_rng(seed).integers(0, VOCAB, (n, P), dtype=np.int32)
    for i in range(n):
        broker.produce(topic, prompts[i].tobytes(), partition=i % PARTS)


def _watermarks(pkg, broker, group):
    tp = PKG[pkg][0].TopicPartition
    return [broker.committed(group, tp("p", p)) or 0 for p in range(PARTS)]


def _reference(pkg, model, n=N, **kw):
    """The uncut run: completions by (partition, offset), watermarks."""
    mod, Server, _ = PKG[pkg]
    cfg, params = model[pkg]
    broker = mod.InMemoryBroker()
    _produce(broker, n)
    consumer = mod.MemoryConsumer(broker, "p", group_id="ref")
    server = Server(consumer, params, cfg, slots=SLOTS, prompt_len=P,
                    max_new=MAX_NEW, commit_every=4, **_kw(pkg, kw))
    got = {(r.partition, r.offset): t.tolist() for r, t in server.run(max_records=n)}
    server.close()
    return got, _watermarks(pkg, broker, "ref")


def _kill_run(pkg, model, jpath, cadence, kill_steps=KILL_STEPS, *, warm=True,
              hints_from=None, resume_kw=None, n=N, **kw):
    """``test_journal.py``'s seeded death through ``pkg``: the first server
    journals at ``cadence``, decodes ``kill_steps`` ticks and dies with no
    close, commit or flush; the second, hinted from the journal on disk
    (``hints_from``: another file, loaded by ``pkg``'s journal) when
    ``warm``, serves everything, with ``resume_kw`` over the first's
    arguments; ``spec=True``: the speculative server. Returns
    (completions, watermarks, journal counters, the dying server's journal
    bytes)."""
    mod, Server, Journal = PKG[pkg]
    if kw.pop("spec", False):
        Server = SPEC[pkg]
    cfg, params = model[pkg]
    broker = mod.InMemoryBroker()
    _produce(broker, n)
    skw = dict(slots=SLOTS, prompt_len=P, max_new=MAX_NEW, ticks_per_sync=1,
               **_kw(pkg, kw))
    c1 = mod.MemoryConsumer(broker, "p", group_id="g")
    gen1 = Server(c1, params, cfg, commit_every=2**31 - 1,
                  journal=Journal(jpath, cadence=cadence), **skw)
    got: dict = {}

    def absorb(completions):
        for rec, toks in completions:
            key = (rec.partition, rec.offset)
            if key in got:  # a duplicate must be byte-identical
                assert got[key] == toks.tolist(), key
            got[key] = toks.tolist()

    records = c1.poll(max_records=SLOTS, timeout_ms=100)
    gen1.note_fetched(records)
    gen1.admit_records(records[: gen1.free_slots()])
    assert gen1.has_active()
    for _ in range(kill_steps):
        absorb(gen1.step())
    c1.close()
    with open(jpath, "rb") as f:
        journal_bytes = f.read()

    c2 = mod.MemoryConsumer(broker, "p", group_id="g")
    gen2 = Server(c2, params, cfg, commit_every=4, **{**skw, **(resume_kw or {})})
    if warm:
        gen2.add_resume_hints(Journal.load(hints_from or jpath))
    absorb(gen2.run(max_records=n))
    counters = gen2.metrics.journal_summary()
    gen2.close()
    return got, _watermarks(pkg, broker, "g"), counters, journal_bytes


@pytest.fixture(scope="module")
def jax_runs(model, tmp_path_factory):
    """The JAX package's runs, each made once per module (JAX compiles
    every server's programs anew): ``ref(**kw)`` the uncut run,
    ``kill(cadence, ...)`` a kill run and the path of its journal file."""
    root = tmp_path_factory.mktemp("jax-journals")
    cache: dict = {}

    def ref(**kw):
        key = ("ref", repr(sorted(kw.items())))
        if key not in cache:
            cache[key] = _reference("jax", model, **kw)
        return cache[key]

    def kill(cadence, kill_steps=KILL_STEPS, **kw):
        key = ("kill", cadence, kill_steps, repr(sorted(kw.items())))
        if key not in cache:
            path = str(root / f"{len(cache)}.json")
            cache[key] = (_kill_run("jax", model, path, cadence, kill_steps, **kw),
                          path)
        return cache[key]

    return types.SimpleNamespace(ref=ref, kill=kill)


def _differential(model, jax_runs, tmp_path, cadence, kill_steps=KILL_STEPS, **kw):
    """The port's kill run against the JAX package's (which
    ``test_journal.py`` holds equal to its uncut run): the same
    completions, watermarks, journal counters and journal file. Returns
    the port's counters."""
    (jgot, jwm, jcount, jbytes), _ = jax_runs.kill(cadence, kill_steps, **kw)
    got, wm, count, pbytes = _kill_run("port", model, str(tmp_path / "port.json"),
                                       cadence, kill_steps, **kw)
    assert got == jgot and len(got) == N
    assert wm == jwm
    assert count == jcount
    assert pbytes == jbytes  # the journal file format is the JAX package's
    return count


@pytest.mark.parametrize("cadence", [1, 4, 16])
def test_greedy_dense_matches_jax(model, jax_runs, tmp_path, cadence):
    """Cadence 16 > MAX_NEW leaves only admit-time entries: every record
    replays cold, still exact."""
    count = _differential(model, jax_runs, tmp_path, cadence)
    assert (count["warm_resumes"] > 0) == (cadence < MAX_NEW)


def test_sampled_dense_matches_jax(model, jax_runs, tmp_path):
    count = _differential(model, jax_runs, tmp_path, 4, **SAMPLED)
    assert count["warm_resumes"] > 0


@pytest.mark.parametrize("chunk", [None, 0], ids=["chunked", "legacy"])
def test_greedy_paged_matches_jax(model, jax_runs, tmp_path, chunk):
    pages = {**PAGES, "prefill_chunk": chunk}
    count = _differential(model, jax_runs, tmp_path, 4, kv_pages=pages)
    assert count["warm_resumes"] > 0


def test_sampled_paged_matches_jax(model, jax_runs, tmp_path):
    count = _differential(model, jax_runs, tmp_path, 4, kv_pages=PAGES,
                          **PAGED_SAMPLED)
    assert count["warm_resumes"] > 0


@pytest.mark.parametrize("pages", [None, PAGES], ids=["dense", "paged"])
def test_spec_matches_jax(model, jax_runs, tmp_path, pages):
    """``test_journal.py``'s two speculative cases: the dense resume
    prefills both models' cache rows, the paged one rides the chunk queue
    through both models' pools, and accept/rollback continues from the
    journaled position. The completions and watermarks also equal the
    plain server's uncut run."""
    kw = {"kv_pages": pages} if pages else {}
    count = _differential(model, jax_runs, tmp_path, 4, spec=True, k=2, **kw)
    assert count["warm_resumes"] > 0
    (got, wm, _, _), _ = jax_runs.kill(4, spec=True, k=2, **kw)
    assert (got, wm) == jax_runs.ref()


@pytest.mark.parametrize("pages", [None, {**PAGES, "prefill_chunk": None}],
                         ids=["dense", "paged"])
def test_warm_decodes_fewer_tokens_than_cold(model, jax_runs, tmp_path, pages):
    """The same death with hints on (held against the JAX package's run)
    and off: the cold survivor serves the same completions and watermarks,
    restores nothing and decodes more tokens than the warm one."""
    kw = {"kv_pages": pages} if pages else {}
    warm = _differential(model, jax_runs, tmp_path, 4, **kw)
    (jgot, jwm, _, _), _ = jax_runs.kill(4, **kw)
    got, wm, cold, _ = _kill_run("port", model, str(tmp_path / "cold.json"), 4,
                                 warm=False, **kw)
    assert got == jgot and wm == jwm
    assert cold["tokens_restored"] == cold["warm_resumes"] == 0
    assert warm["tokens_restored"] > 0
    assert warm["decoded_tokens"] < cold["decoded_tokens"]


def test_finished_uncommitted_served_from_journal(model, jax_runs, tmp_path):
    count = _differential(model, jax_runs, tmp_path, 1, kill_steps=MAX_NEW + 2)
    assert count["served_from_journal"] > 0


def test_int8_pool_replays_partial_hints_cold(model, jax_runs, tmp_path):
    """An int8 pool takes no partial hint (each counts in resume_rejected)
    and replays those records cold, as the JAX server does."""
    count = _differential(model, jax_runs, tmp_path, 4, kv_dtype="int8")
    assert count["warm_resumes"] == 0 < count["resume_rejected"]


def test_model_version_mismatch_rejects_hints(model, jax_runs, tmp_path):
    """Hints journaled under model version 0 do not resume a server of
    version 1: cold replay, each partial hint counted as rejected."""
    count = _differential(model, jax_runs, tmp_path, 4,
                          resume_kw={"model_version": 1})
    assert count["warm_resumes"] == 0 < count["resume_rejected"]


def test_crc_mismatch_rejects_hint(model, jax_runs):
    """A hint whose payload CRC does not match its record is discarded
    and the record admitted cold."""
    ref, ref_wm = jax_runs.ref()
    cfg, params = model["port"]
    broker = ptk.InMemoryBroker()
    _produce(broker, N)
    server = StreamingGenerator(
        ptk.MemoryConsumer(broker, "p", group_id="ref"), params, cfg,
        slots=SLOTS, prompt_len=P, max_new=MAX_NEW, commit_every=4, device="cpu",
    )
    bogus = JournalEntry(topic="p", partition=0, offset=0, crc=0xDEADBEEF,
                         key_data=None, temperature=0.0, top_k=None, top_p=None,
                         tokens=(1, 2, 3), finished=False)
    server.add_resume_hints({bogus.key: bogus})
    got = {(r.partition, r.offset): t.tolist() for r, t in server.run(max_records=N)}
    server.close()
    assert got == ref and _watermarks("port", broker, "ref") == ref_wm
    assert server.metrics.resume_rejected.count == 1
    assert server.metrics.warm_resumes.count == 0


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_jax_journal_resumes_port_server(model, jax_runs, tmp_path, kw):
    """The journal file is a wire between incarnations: the one the JAX
    server's killed run leaves resumes the port's server to JAX's uncut
    tokens and watermarks, with JAX's own counters."""
    ref, ref_wm = jax_runs.ref(**kw)
    (_, _, jcount, _), jpath = jax_runs.kill(4, **kw)
    got, wm, count, _ = _kill_run("port", model, str(tmp_path / "port.json"), 4,
                                  hints_from=jpath, **kw)
    assert got == ref and wm == ref_wm
    assert count == jcount and count["warm_resumes"] > 0


def test_journal_entry_carries_the_record_key(tmp_path):
    """Every entry the server writes carries ``_record_key_data``'s key,
    the one its slot samples with."""
    cfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
    params = pt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    broker = ptk.InMemoryBroker()
    _produce(broker, 2)
    journal = DecodeJournal(str(tmp_path / "j.json"), cadence=2)
    server = StreamingGenerator(
        ptk.MemoryConsumer(broker, "p", group_id="k"), params, cfg, slots=SLOTS,
        prompt_len=P, max_new=MAX_NEW, journal=journal, **_kw("port", SAMPLED),
    )
    records = server._consumer.poll(max_records=2, timeout_ms=100)
    server.note_fetched(records)
    server.admit_records(records)
    entries = DecodeJournal.load(journal.path)
    assert len(entries) == 2
    for rec in records:
        e = entries[(rec.topic, rec.partition, rec.offset)]
        assert e.key_data == tuple(int(w) for w in server._record_key_data(rec))
        assert e.crc == value_crc(rec.value) and e.tokens == ()
        assert (e.temperature, e.top_k) == (0.9, 16)
