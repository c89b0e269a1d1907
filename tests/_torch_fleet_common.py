"""Shared pieces of the fleet differentials (``test_torch_fleet.py``,
``test_torch_rollout.py``, ``test_torch_workload.py``,
``test_torch_distill.py``, ``test_torch_autoscale.py``): the same seeded
model in both packages, seeded broker content, a fleet of either package
over it, one serve normalized for comparison, and the loader that runs a
JAX test module over the port.
"""

from __future__ import annotations

import functools
import importlib
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
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu_torch.fleet import drill
from torchkafka_tpu_torch.models import transformer as pt

P, MAX_NEW, VOCAB = 8, 8, 64
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
MOD = {"jax": tk, "port": ptk}
PKGS = ("jax", "port")
COUNTERS = ("completions", "duplicates", "drains", "replica_deaths",
            "journal_handoffs", "drain_timeout_kills", "replica_joins")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU models on one intra-op thread for the module
    (restored after it): under the suite's parallel workers, torch's
    default pool of one thread a core oversubscribes the machine and the
    fleets' many small ops run several times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one intra-op thread
    each, so several small CPU workers do not oversubscribe the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def sub(pkg: str, name: str):
    """``pkg``'s submodule ``name`` (e.g. ``sub("port", "fleet")``)."""
    return importlib.import_module(f"{MOD[pkg].__name__}.{name}")


def jax_and_port(shape=None, seed=0) -> dict:
    """{"jax": (cfg, params), "port": (cfg, params)}: JAX's ``init_params``
    at f32, and the same numbers on the CPU through ``params_from_numpy``."""
    shape = dict(SHAPE if shape is None else shape)
    jcfg = jt.TransformerConfig(**shape, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**shape, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    params = pt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), pcfg, device="cpu"
    )
    return {"jax": (jcfg, jparams), "port": (pcfg, params)}


def produce(broker, n, *, parts=4, topic="p", key_of=None, lane_of=None, seed=7):
    """``n`` seeded prompts round-robin over ``parts`` partitions (the JAX
    fleet tests' ``_produce``); returns the prompts."""
    broker.create_topic(topic, partitions=parts)
    prompts = np.random.default_rng(seed).integers(0, VOCAB, (n, P), dtype=np.int32)
    for i in range(n):
        headers = () if lane_of is None else (("lane", lane_of(i)),)
        broker.produce(topic, prompts[i].tobytes(), partition=i % parts,
                       key=None if key_of is None else key_of(i), headers=headers)
    return prompts


def fleet(pkg, model, broker, *, group="fleet", topic="p", consumer=None, **kw):
    """A ``ServingFleet`` of ``pkg`` over ``broker`` (``model``: that
    package's (cfg, params)); the port's replicas serve on the CPU."""
    cfg, params = model
    mod = MOD[pkg]
    kw.setdefault("replicas", 2)
    kw.setdefault("slots", 2)
    if pkg == "port":
        kw["gen_kwargs"] = {"device": "cpu", **(kw.get("gen_kwargs") or {})}
    # Member ids fixed per replica: range assignment orders members by id,
    # and the default ids come from a per-package process-wide counter.
    factory = consumer or (
        lambda rid: mod.MemoryConsumer(broker, topic, group_id=group,
                                       member_id=f"{group}-r{rid:03d}")
    )
    return sub(pkg, "fleet").ServingFleet(
        factory, params, cfg, prompt_len=P, max_new=MAX_NEW, **kw
    )


def record(rid, rec, toks) -> tuple:
    return (rid, rec.topic, rec.partition, rec.offset, np.asarray(toks).tolist())


def summary(f) -> dict:
    """A fleet's comparable end state: counters, merged watermarks and
    per-replica states."""
    m = f.metrics
    return {
        "counters": {c: getattr(m, c).count for c in COUNTERS},
        "watermarks": sorted((tp.topic, tp.partition, off)
                             for tp, off in f.watermarks().items()),
        "states": [r.state for r in f.replicas],
    }


def committed(pkg, broker, group, parts, topic="p") -> list:
    return [broker.committed(group, MOD[pkg].TopicPartition(topic, p)) or 0
            for p in range(parts)]


def audited_consumer(pkg, audit: dict):
    """``pkg``'s ``MemoryConsumer`` under the port's commit audit
    (``fleet/drill.py``, one copy for both packages): every commit
    asserts INSIDE it that each committed offset is covered by a
    completion the fleet already registered (``tests/test_fleet.py``'s
    ``_AuditedConsumer``)."""
    return drill.audited_consumer(MOD[pkg].MemoryConsumer, audit)


class StepClock:
    """A manual clock stepping ``dt`` at every reading: exact timestamps
    in both packages' traces."""

    def __init__(self, dt: float = 0.001, start: float = 1000.0) -> None:
        self.t, self.dt = start, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def load_rerooted(name: str, *, drop=(), replace=()) -> types.ModuleType:
    """Load ``tests/<name>.py`` with ``torchkafka_tpu`` re-rooted onto the
    port, its ``import jax``/``jax.numpy`` lines bound to shims (a seeded
    CPU ``torch.Generator`` for ``jax.random.key``, ``torch.float32`` for
    ``jnp.float32``), lines starting with an entry of ``drop`` removed and
    each ``(old, new)`` of ``replace`` applied first. The port's
    ``init_params`` draws on the CPU, and its fleets and servers serve
    there."""
    ref = pathlib.Path(__file__).with_name(f"{name}.py")
    mod = types.ModuleType(f"_port_{name}")
    mod.__file__ = str(ref)
    sys.modules[mod.__name__] = mod
    src = "".join(
        line for line in ref.read_text().splitlines(keepends=True)
        if not line.startswith(("import jax\n", "import jax.numpy as jnp\n", *drop))
    )
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    mod.jax = types.SimpleNamespace(random=types.SimpleNamespace(
        key=lambda seed: torch.Generator().manual_seed(seed)))
    mod.jnp = types.SimpleNamespace(float32=torch.float32, int32=torch.int32,
                                    asarray=torch.as_tensor)
    exec(compile(src.replace("torchkafka_tpu", "torchkafka_tpu_torch"), str(ref),
                 "exec"), mod.__dict__)
    assert mod.__dict__.get("tk", ptk) is ptk
    if "init_params" in mod.__dict__:
        mod.init_params = lambda gen, cfg: pt.init_params(gen, cfg, device="cpu")
    mod.ServingFleet = _cpu_fleet  # also for a function's own import, dropped
    for cls in ("StreamingGenerator", "SpecStreamingGenerator"):
        if cls in mod.__dict__:
            mod.__dict__[cls] = functools.partial(mod.__dict__[cls], device="cpu")
    return mod


def _cpu_fleet(*args, gen_kwargs=None, **kw):
    from torchkafka_tpu_torch.fleet import ServingFleet

    return ServingFleet(*args, gen_kwargs={"device": "cpu", **(gen_kwargs or {})},
                        **kw)
