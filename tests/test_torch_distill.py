"""The port's distillation plane (``distill/``) and the server's distill
publisher against the JAX package's.

- ``test_distill.py`` runs over the port: the module's source is loaded
  with the package name re-rooted onto ``torchkafka_tpu_torch`` (trained
  leaves read detached) and its wire, controller and trainer classes
  are collected here, with ``TestProcessDistillRole`` on port worker
  processes serving and training on the CPU (every wait bounded at
  60 s). Its refresh-under-chaos case runs below as a differential
  against the JAX fleet.
- ``DistillTrainer`` of both packages over one corpus: equal reports,
  losses equal to f32 rounding.
- Differentials at f32, one seeded broker content through both packages'
  2-replica fleets with ``distill_topic``: the frames on the distill
  topic are byte-equal to JAX's, at-least-once (produced after the
  covering offset commit) and exactly-once (inside the commit window's
  transaction, read committed); one frame per committed completion, each
  decoding to its prompt, committed tokens, tenant and model version;
  the same for a speculative fleet whose draft is refreshed through
  ``start_distill`` mid-serve while a replica is killed (completions,
  controller state and ``spec_stats`` equal, every completion equal to
  the no-refresh, no-kill run).
- The publisher's validation is JAX's: ``distill_topic`` without a
  producer in at-least-once mode raises ``ValueError``.
"""

import importlib

import numpy as np
import pytest

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import (
    MOD,
    MAX_NEW,
    P,
    PKGS,
    committed,
    fleet,
    jax_and_port,
    load_rerooted,
    produce,
    record,
    sub,
)
from _torch_fleet_common import one_torch_thread  # noqa: F401 - autouse fixture

_mod = load_rerooted("test_distill", replace=[
    ("        from torchkafka_tpu.fleet import ReplicaChaos, ServingFleet\n",
     "        from torchkafka_tpu.fleet import ReplicaChaos\n"),
    # The port's trained leaves are autograd leaves: read them detached.
    ("    return jax.tree_util.tree_leaves(\n"
     "        jax.tree_util.tree_map(np.asarray, tree)\n    )\n",
     "    return [t.detach().numpy() for t in _tree.tree_leaves(tree)]\n"),
    ('            np.asarray(trainer.draft_params["embed"]),\n',
     '            trainer.draft_params["embed"].detach().numpy(),\n'),
    ("        host = jax.tree_util.tree_map(np.asarray, trainer.draft_params)\n",
     "        host = _tree.tree_map(lambda t: t.detach().clone(),\n"
     "                              trainer.draft_params)\n"),
    # The distill role's workers serve and train on the CPU, every wait
    # bounded at 60 s.
    ('            heartbeat_interval_s=0.2, respawn=True, group="dg",\n',
     '            heartbeat_interval_s=0.2, respawn=True, group="dg",\n'
     '            device="cpu",\n'),
    ("timeout_s=300", "timeout_s=60"),
    ("timeout_s=120", "timeout_s=60"),
])
_mod._tree = importlib.import_module("torchkafka_tpu_torch.utils.tree")

model = _mod.model
TestDistillWire = _mod.TestDistillWire
TestDistillController = _mod.TestDistillController
TestDistillTrainer = _mod.TestDistillTrainer
TestProcessDistillRole = _mod.TestProcessDistillRole


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes inherit the environment: one intra-op thread
    each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def pkgs():
    return jax_and_port()


def _frames(pkg, broker, read_committed: bool) -> list:
    mod = MOD[pkg]
    tp = mod.TopicPartition("d", 0)
    if read_committed:
        return [r.value for r in broker.fetch_stable(tp, 0, 10**6)[0]]
    return [r.value for r in broker.fetch(tp, 0, broker.end_offset(tp))]


def _publish_run(pkg, pkgs, exactly_once: bool, n=16):
    mod = MOD[pkg]
    broker = mod.InMemoryBroker()
    produce(broker, n, key_of=lambda i: b"tenant-%d" % (i % 3))
    broker.create_topic("out", partitions=1)
    broker.create_topic("d", partitions=1)
    if exactly_once:
        producer = mod.TransactionalProducer(broker, "txn-d")
        kw = {"exactly_once": True}
    else:
        producer = mod.MemoryProducer(broker)
        kw = {}
    f = fleet(pkg, pkgs[pkg], broker, commit_every=3,
              gen_kwargs={"output_producer": producer, "output_topic": "out",
                          "distill_topic": "d", **kw})
    got = [record(*c) for c in f.serve(idle_timeout_ms=500)]
    published = [r.gen.metrics.distill_published.count for r in f.replicas]
    f.close()
    return {
        "records": got,
        "frames": _frames(pkg, broker, exactly_once),
        "published": published,
        "committed": committed(pkg, broker, "fleet", 4),
    }


@pytest.mark.parametrize("exactly_once", [False, True], ids=["alo", "eos"])
def test_distill_frames_match_jax(pkgs, exactly_once):
    got = _publish_run("port", pkgs, exactly_once)
    ref = _publish_run("jax", pkgs, exactly_once)
    assert got == ref
    assert got["committed"] == [4] * 4
    assert sum(got["published"]) == len(got["frames"]) == 16
    prompts = produce(ptk.InMemoryBroker(), 16)
    served = {(r[2], r[3]): r[4] for r in got["records"]}
    decoded = [_mod.decode_completion(f) for f in got["frames"]]
    for d in decoded:
        idx = next(i for i in range(16)
                   if np.array_equal(prompts[i], d["prompt"]))
        assert list(d["tokens"]) == served[(idx % 4, idx // 4)]
        assert d["tenant"] == b"tenant-%d" % (idx % 3)
        assert d["model_version"] == 0


def test_distill_topic_without_producer_raises_as_jax(pkgs):
    for pkg in PKGS:
        mod = MOD[pkg]
        broker = mod.InMemoryBroker()
        broker.create_topic("p", partitions=1)
        cfg, params = pkgs[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(ValueError, match="distill_topic requires a producer"):
            sub(pkg, "serve").StreamingGenerator(
                mod.MemoryConsumer(broker, "p", group_id="g"), params, cfg,
                slots=2, prompt_len=P, max_new=MAX_NEW, distill_topic="d", **kw)


def _refresh_run(pkg, pkgs, *, refresh: bool):
    """A speculative 2-replica fleet (self-draft of one layer, k = 3); with
    ``refresh``, draft version 1 (other weights, same geometry) is applied
    through ``start_distill`` after the sixth completion while a seeded
    kill fires."""
    mod = MOD[pkg]
    spec = sub(pkg, "serve_spec").SpecStreamingGenerator
    trunc = sub(pkg, "models.spec_decode").truncated_draft
    broker = mod.InMemoryBroker()
    produce(broker, 24, seed=17)
    f = fleet(pkg, pkgs["v0"][pkg], broker, group="g", commit_every=2,
              generator_cls=spec, gen_kwargs={"k": 3, "draft_layers": 1})
    hook = chaos = drv = None
    if refresh:
        cfg, alt = pkgs["v1"][pkg]
        draft, _ = trunc(alt, cfg, 1)
        drv = f.start_distill(
            policy=sub(pkg, "distill").DistillPolicy(
                window_rounds=4, min_proposed=8, cooldown_s=0.0,
                refresh_on_publish=True),
            versions={1: draft},
        )
        chaos = sub(pkg, "fleet").ReplicaChaos(seed=3, min_completions=4,
                                               max_completions=8)

        def hook(fl, served):
            if served >= 6:
                drv.note_version(1)
            drv.on_round(fl, served)

    got = [record(*c) for c in f.serve(idle_timeout_ms=500, chaos=chaos,
                                       on_round=hook)]
    out = {
        "records": got,
        "stats": [r.gen.spec_stats() for r in f.replicas],
        "killed": chaos.killed if chaos else None,
        "applied": drv.controller.applied_version if drv else None,
        "refreshes": drv.controller.refreshes if drv else None,
        "draft_version": int(f.metrics.draft_version.value),
    }
    f.close()
    return out


def test_refresh_under_chaos_matches_jax(pkgs):
    both = {"v0": pkgs, "v1": jax_and_port(seed=1)}
    got = _refresh_run("port", both, refresh=True)
    assert got == _refresh_run("jax", both, refresh=True)
    assert got["killed"] and got["applied"] == 1 and got["refreshes"] == 1
    base = {(r[2], r[3]): r[4] for r in _refresh_run("port", both, refresh=False)["records"]}
    assert {(r[2], r[3]) for r in got["records"]} == set(base)
    for r in got["records"]:
        assert r[4] == base[(r[2], r[3])], r[:4]


def _train(pkg, pkgs):
    """``pkg``'s ``DistillTrainer`` over one seeded corpus → its report."""
    mod = MOD[pkg]
    cfg, params = pkgs[pkg]
    broker = mod.InMemoryBroker()
    broker.create_topic("d", partitions=1)
    for frame in _mod._frames(12):
        broker.produce("d", frame)
    consumer = mod.MemoryConsumer(broker, "d", group_id="tr")
    trainer = sub(pkg, "distill").DistillTrainer(
        consumer, params, cfg, seq_len=P + MAX_NEW, batch_size=4,
        draft_layers=1, learning_rate=5e-3)
    report = trainer.run(idle_timeout_ms=50)
    consumer.close()
    return report


def test_distill_trainer_matches_jax(pkgs):
    """Both packages' trainers over the same target and corpus: equal
    reports, the last step's loss equal to f32 rounding (the port's AdamW
    carries optax's weight decay of 1e-4)."""
    jrep, prep = _train("jax", pkgs), _train("port", pkgs)
    assert {k: v for k, v in prep.items() if k != "loss"} == {
        k: v for k, v in jrep.items() if k != "loss"}
    assert prep["steps"] == 3 and prep["records"] == 12
    np.testing.assert_allclose(prep["loss"], jrep["loss"], rtol=1e-4)
