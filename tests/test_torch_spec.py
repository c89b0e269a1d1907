"""The port's speculative decoding (``models/spec_decode.py``) against the
JAX package's.

- ``test_spec.py`` runs over the port: the module's source is loaded with
  the package name re-rooted onto ``torchkafka_tpu_torch`` and its two
  classes (``TestSpeculativeGenerate``, ``TestTruncatedDraft``) are
  collected here. Its few JAX spellings are bound to the port's: the key
  is a seeded ``torch.Generator``, ``init_params`` draws on the CPU,
  ``jax.jit`` is the identity, ``jnp`` dtypes are torch dtypes and
  ``jax.tree_util.tree_leaves`` is ``utils.tree``'s.
- ``speculative_generate`` from the same parameters (JAX's
  ``init_params`` through ``params_from_numpy``) at f32: tokens and
  ``SpecStats`` equal to the JAX package's for an independent draft, the
  perfect draft and a truncated draft, at k = 1, 2, 4 and max_new = 2,
  7, 9, over rows that pace independently.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchkafka_tpu.models import spec_decode as jspec
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu_torch.models import spec_decode as pspec
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.quant import QTensor, quantize
from torchkafka_tpu_torch.utils.tree import tree_leaves

_REF = pathlib.Path(__file__).with_name("test_spec.py")
_mod = types.ModuleType("_port_spec")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
_JAX_IMPORTS = "import jax\nimport jax.numpy as jnp\n"
_src = _REF.read_text()
assert _src.count(_JAX_IMPORTS) == 1
_mod.jax = types.SimpleNamespace(
    random=types.SimpleNamespace(key=lambda seed: torch.Generator().manual_seed(seed)),
    jit=lambda fn: fn,
    tree_util=types.SimpleNamespace(tree_leaves=tree_leaves),
)
_mod.jnp = types.SimpleNamespace(
    float32=torch.float32, int32=torch.int32,
    asarray=lambda a, dtype=None: torch.as_tensor(np.asarray(a), dtype=dtype),
)
exec(compile(_src.replace(_JAX_IMPORTS, "").replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.speculative_generate is pspec.speculative_generate
_mod.init_params = lambda gen, cfg: pt.init_params(gen, cfg, device="cpu")

TestSpeculativeGenerate = _mod.TestSpeculativeGenerate
TestTruncatedDraft = _mod.TestTruncatedDraft

SHAPE = dict(vocab_size=256, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=512)
DRAFT_SHAPE = dict(SHAPE, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64)


def _pair(shape, seed):
    """(JAX cfg, JAX params, port cfg, port params) from one JAX init."""
    jcfg = jt.TransformerConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**shape, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return jcfg, jparams, pcfg, params


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(SHAPE, 0), "independent": _pair(DRAFT_SHAPE, 99)}


def _drafts(models, kind):
    """(JAX draft params, cfg, port draft params, cfg) of ``kind``."""
    jcfg, jparams, pcfg, params = models["target"]
    if kind == "independent":
        return models["independent"]
    if kind == "perfect":
        return jcfg, jparams, pcfg, params
    jd, jdcfg = jspec.truncated_draft(jparams, jcfg, 2)
    pd, pdcfg = pspec.truncated_draft(params, pcfg, 2)
    return jdcfg, jd, pdcfg, pd


@pytest.mark.parametrize("kind", ["independent", "perfect", "truncated"])
@pytest.mark.parametrize("k,max_new", [(1, 9), (2, 7), (4, 2)])
def test_speculative_generate_matches_jax(models, kind, k, max_new):
    """Four rows of one batch that accept differently (the independent
    and truncated drafts) or all accept (the perfect draft): tokens and
    every counter equal to the JAX package's."""
    jcfg, jparams, pcfg, params = models["target"]
    jdcfg, jd, pdcfg, pd = _drafts(models, kind)
    prompt = np.random.default_rng(k).integers(0, SHAPE["vocab_size"], (4, 6),
                                               dtype=np.int32)
    jtoks, jstats = jspec.speculative_generate(
        jparams, jcfg, jd, jdcfg, jnp.asarray(prompt), max_new, k=k
    )
    toks, stats = pspec.speculative_generate(
        params, pcfg, pd, pdcfg, torch.from_numpy(prompt), max_new, k=k
    )
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert [int(x) for x in stats] == [int(x) for x in jstats]
    assert stats._fields == jstats._fields
    if kind == "perfect":
        assert int(stats.accepted) == int(stats.proposed) > 0


def test_truncated_draft_is_views_sharing_head_and_embedding(models):
    _, _, pcfg, params = models["target"]
    draft, dcfg = pspec.truncated_draft(params, pcfg, 2)
    assert dcfg.n_layers == 2 and dcfg.d_model == pcfg.d_model
    for name in ("embed", "ln_f", "lm_head"):
        assert draft[name] is params[name]
    for name, w in draft["layers"].items():
        assert w.shape[0] == 2
        assert w.data_ptr() == params["layers"][name].data_ptr()  # a view


def test_truncated_draft_slices_qtensor_fields(models):
    _, _, pcfg, params = models["target"]
    layers = dict(params["layers"], wq=quantize(params["layers"]["wq"], (1,)))
    draft, _ = pspec.truncated_draft(dict(params, layers=layers), pcfg, 1)
    wq = draft["layers"]["wq"]
    assert isinstance(wq, QTensor)
    assert wq.q.shape[0] == wq.scale.shape[0] == 1
    assert wq.q.data_ptr() == layers["wq"].q.data_ptr()
