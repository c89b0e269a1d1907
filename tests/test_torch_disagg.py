"""The port's disaggregated prefill (the server's ``prefill_role=`` and
handoff adoption, ``fleet/prefill.py``) against the JAX package's.

- Differentials at f32: one seeded prompt stream through both packages'
  lockstep prefill worker + decode server (``test_disagg.py``'s
  ``_disagg``) — greedy, sampled, int8 paged, and a prefill worker
  abandoned mid-storm whose held records fall back to local prefills.
  Tokens, committed offsets and the disagg counters (adopted slots,
  routed records, published handoffs, the decode side's prefill tokens)
  equal JAX's, and the port's tokens and commits equal its own
  monolithic paged server's.
- ``test_disagg.py``'s ``TestHandoffPlumbing`` runs over the port (its
  source re-rooted, the pool slice read from the port's ``_pools``).
- The wire: ``encode_handoff`` of the same record contents gives JAX's
  bytes at f32, int8 and bf16 (bf16 as its 16-bit patterns under the
  name ``bfloat16``), each package decodes the other's bytes, a handoff
  cut by JAX's prefill worker carries the port worker's header, and a
  JAX-encoded handoff is adopted by the port's decode server.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import test_disagg as jd
import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from _torch_fleet_common import jax_and_port, load_rerooted
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture
from torchkafka_tpu.fleet import prefill as jpre
from torchkafka_tpu.serve import PrefillHandoff as JHandoff
from torchkafka_tpu.serve import StreamingGenerator as JServer
from torchkafka_tpu_torch.fleet import prefill as ppre
from torchkafka_tpu_torch.serve import PrefillHandoff as PHandoff
from torchkafka_tpu_torch.serve import StreamingGenerator as PServer
from torchkafka_tpu_torch.utils import prng

_mod = load_rerooted("test_disagg", replace=[
    ("                    np.zeros((cfg.n_layers, nb_p) + p.shape[2:],\n"
     "                             np.dtype(p.dtype))\n"
     "                    for p in dgen._caches[:dgen._paged_table_idx]\n",
     "                    np.zeros((cfg.n_layers, nb_p) + tuple(p.shape[2:]),\n"
     "                             p[:1, :1].numpy().dtype)\n"
     "                    for p in dgen._pools\n"),
])

model = _mod.model
TestHandoffPlumbing = _mod.TestHandoffPlumbing


@pytest.fixture(scope="module")
def pkgs():
    return jax_and_port()


def _summary(out, committed, dgen, pgen) -> dict:
    return {
        "tokens": {k: np.asarray(v).tolist() for k, v in sorted(out.items())},
        "committed": committed,
        "decode": {**dgen.metrics.disagg_summary(),
                   "prefill_tokens": dgen.metrics.prefill_tokens.count,
                   "resume_rejected": dgen.metrics.resume_rejected.count},
        "prefill": {**pgen.metrics.disagg_summary(),
                    "prefill_tokens": pgen.metrics.prefill_tokens.count,
                    "prefix_hits": pgen.metrics.prefix_hits.count},
    }


CASES = {
    "greedy": (dict(), dict(), dict(seed=7)),
    "sampled": (dict(temperature=0.9, top_k=16, top_p=0.95, rng=jax.random.key(3)),
                dict(temperature=0.9, top_k=16, top_p=0.95, rng=prng.key(3)),
                dict(seed=11)),
    "int8": (dict(kv_dtype="int8"), dict(kv_dtype="int8"), dict(seed=13)),
    "prefill_kill": (dict(kill_prefill_after=1, patience=6),
                     dict(kill_prefill_after=1, patience=6), dict(seed=17)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_disagg_matches_jax(pkgs, case):
    jkw, pkw, pr = CASES[case]
    prompts = jd._prompts(**pr)
    jcfg, jparams = pkgs["jax"]
    pcfg, pparams = pkgs["port"]
    want = _summary(*jd._disagg(jcfg, jparams, prompts, **jkw))
    got = _summary(*_mod._disagg(pcfg, pparams, prompts, **pkw))
    assert got == want
    n = prompts.shape[0]
    if case == "prefill_kill":
        # The death bit: some adopted, the rest prefilled locally.
        assert 0 < got["decode"]["adopted_slots"] < n
        assert got["decode"]["prefill_tokens"] > 0
    else:
        assert got["decode"]["adopted_slots"] == n
        assert got["decode"]["prefill_tokens"] == 0
        assert got["prefill"]["handoffs_published"] == n
    mono_kw = {k: v for k, v in pkw.items() if k not in ("kill_prefill_after", "patience")}
    mono, mono_committed, _ = _mod._mono(pcfg, pparams, prompts, **mono_kw)
    assert {k: np.asarray(v).tolist() for k, v in sorted(mono.items())} == got["tokens"]
    assert mono_committed == got["committed"]


def _contents(rng, dtype):
    """One record's handoff fields and pools as numpy arrays (bf16 as
    ml_dtypes arrays), the shapes of a 2-layer pool of blocks of 4."""
    f = dict(topic="p", partition=1, offset=42, crc=12345, key_data=(1, 2),
             temperature=0.7, top_k=8, top_p=0.9, token0=17, prompt_blocks=2)
    if dtype == "int8":
        pay = rng.integers(-128, 127, (2, 2, 1, 4, 4), dtype=np.int8)
        sc = rng.random((2, 2, 1, 4), dtype=np.float32)
        pools = (pay, sc, pay[::-1].copy(), sc[::-1].copy())
    else:
        x = rng.standard_normal((2, 2, 4, 1, 4), dtype=np.float32)
        if dtype == "bfloat16":
            x = x.astype(ml_dtypes.bfloat16)
        pools = (x, x[::-1].copy())
    return f, pools


def _port_pools(pools):
    return tuple(
        torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype == ml_dtypes.bfloat16 else a
        for a in pools
    )


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_handoff_bytes_equal_jax(dtype):
    f, pools = _contents(np.random.default_rng(3), dtype)
    jbytes = jpre.encode_handoff(JHandoff(**f, pools=pools))
    pbytes = ppre.encode_handoff(PHandoff(**f, pools=_port_pools(pools)))
    assert pbytes == jbytes
    header = json.loads(pbytes[4:4 + int.from_bytes(pbytes[:4], "big")])
    assert [a["dtype"] for a in header["arrays"]] == [str(a.dtype) for a in pools]
    # Each package decodes the other's bytes to the same contents.
    back = ppre.decode_handoff(jbytes)
    assert back.key == ("p", 1, 42) and back.token0 == 17
    for a, b in zip(pools, back.pools):
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.bfloat16
            b = b.view(torch.int16).numpy()
            a = a.view(np.int16)
        np.testing.assert_array_equal(b, a)
    jback = jpre.decode_handoff(pbytes)
    for a, b in zip(pools, jback.pools):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
    assert PHandoff(**f, pools=_port_pools(pools)).payload_bytes() == sum(
        a.nbytes for a in pools)


def _one_handoff(pkg, model, prompts, **kw):
    """The handoff bytes a prefill worker of ``pkg`` publishes for each
    prompt (lockstep: one worker over its own broker)."""
    mod = {"jax": tk, "port": ptk}[pkg]
    pre = {"jax": jpre, "port": ppre}[pkg]
    cfg, params = model
    broker = mod.InMemoryBroker()
    jd._fill(broker, prompts)
    broker.create_topic("ho", partitions=1)
    c = mod.MemoryConsumer(broker, "p", group_id="pf")
    extra = {"device": "cpu"} if pkg == "port" else {}
    gen = {"jax": JServer, "port": PServer}[pkg](
        c, params, cfg, slots=4, prompt_len=jd.P, max_new=jd.MAX_NEW,
        commit_every=4, kv_pages=jd.PAGES, prefill_role=True, **kw, **extra)
    w = pre.PrefillWorker(gen, c, mod.MemoryProducer(broker), "ho")
    for _ in range(50):
        w.pump()
    w.close()
    tp = mod.TopicPartition("ho", 0)
    c.close()
    return [r.value for r in broker.fetch(tp, 0, broker.end_offset(tp))]


def _split(data: bytes):
    n = int.from_bytes(data[:4], "big")
    return json.loads(data[4:4 + n]), data[4 + n:]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_worker_handoffs_match_jax(pkgs, kv_dtype):
    """Each package's prefill worker publishes one handoff per prompt, in
    the same order, with equal headers (identity, CRC, record key, token
    0, block count, dtypes, shapes); the f32 pools agree to f32 rounding,
    the int8 payloads to one step of their quantizer."""
    prompts = jd._prompts(6, seed=31)
    want = _one_handoff("jax", pkgs["jax"], prompts, kv_dtype=kv_dtype)
    got = _one_handoff("port", pkgs["port"], prompts, kv_dtype=kv_dtype)
    assert len(got) == len(want) == prompts.shape[0]
    for g, w in zip(got, want):
        assert _split(g)[0] == _split(w)[0]
        gp, wp = ppre.decode_handoff(g).pools, jpre.decode_handoff(w).pools
        for a, b in zip(gp, wp):
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b).max() <= 1
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_jax_encoded_handoff_adopted_by_port(pkgs):
    """Handoffs a JAX prefill worker encoded, decoded by the port and
    installed on its decode server, are adopted: no prompt pass, and the
    completions and commits equal the port's monolithic server's."""
    prompts = jd._prompts(6, seed=37)
    wire = _one_handoff("jax", pkgs["jax"], prompts)
    pcfg, pparams = pkgs["port"]
    broker = ptk.InMemoryBroker()
    jd._fill(broker, prompts)
    c = ptk.MemoryConsumer(broker, "p", group_id="g")
    gen = PServer(
        c, pparams, pcfg, slots=4, prompt_len=jd.P, max_new=jd.MAX_NEW,
        commit_every=4, kv_pages=jd.PAGES, device="cpu")
    hands = [ppre.decode_handoff(b) for b in wire]
    gen.add_prefill_handoffs({h.key: h for h in hands})
    out = {(r.partition, r.offset): np.asarray(t).tolist()
           for r, t in gen.run(max_records=prompts.shape[0])}
    committed = {p: broker.committed("g", ptk.TopicPartition("p", p)) for p in (0, 1)}
    c.close()
    assert gen.metrics.adopted_slots.count == prompts.shape[0]
    assert gen.metrics.prefill_tokens.count == 0
    mono, mono_committed, _ = _mod._mono(pcfg, pparams, prompts)
    assert out == {k: np.asarray(v).tolist() for k, v in mono.items()}
    assert committed == mono_committed


class _Mesh:
    def __init__(self, coord) -> None:
        self._coord = coord

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("coord,producer,match", [
    (None, None, "needs a producer"),
    ([0, 0], None, "needs a producer"),
    ([0, 1], object(), "only the serving mesh's root"),
], ids=["meshless_without_producer", "root_without_producer", "producer_off_the_root"])
def test_worker_publishes_from_the_root_only(coord, producer, match):
    """A prefill worker publishes once: a mesh-less server's worker, or the
    root's on a serving mesh, needs a producer; another rank's worker is
    refused one."""
    import types

    shard = None if coord is None else types.SimpleNamespace(mesh=_Mesh(coord))
    gen = types.SimpleNamespace(_prefill_role=True, _shard=shard)
    with pytest.raises(ValueError, match=match):
        ppre.PrefillWorker(gen, None, producer, "ho")
