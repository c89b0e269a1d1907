"""Rank-side cases of the port's sharded-serving tests, run by
tests/_torch_multiproc_worker.py in one gloo process group (mode
``serve_mesh``), as tests/_torch_pp_ep_cases.py runs the pipeline ones.

Every rank builds every mesh of the case list, in the same order, then
runs the cases its meshes include (cases on disjoint ranks run at the same
time). The mesh's root (every coordinate 0) owns the broker and the
consumer; the other ranks pass ``consumer=None``. Each rank writes a
``serve_mesh_<pid>.json`` marker: per case its tokens in yield order, and
on the root the committed offsets; the parent holds them against the JAX
package.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from _torch_tp_sp_cases import _mesh_of, _meshes

P, MAX_NEW, VOCAB = 8, 8, 64


def _cfg(c):
    import torch

    from torchkafka_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**c["cfg"], dtype=torch.float32, param_dtype=torch.float32)


class _Inputs:
    """The parent's inputs, one file a group (``serve_mesh_in_<group>.npz``:
    ``inputs``, the prompts and distill frames, then each parameter tree
    as JAX builds it), each read when a case first needs it. The parent
    writes them while the ranks start and renames each into place when it
    is whole."""

    def __init__(self, outdir: str) -> None:
        self._outdir = outdir
        self._groups: dict = {}

    def group(self, name: str):
        if name not in self._groups:
            path = os.path.join(self._outdir, f"serve_mesh_in_{name}.npz")
            deadline = time.monotonic() + 300.0
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no inputs at {path}")
                time.sleep(0.05)
            self._groups[name] = np.load(path)
        return self._groups[name]

    def __getitem__(self, key: str):
        return self.group("inputs")[key]


def _params(data, key, cfg, quantized=False):
    from torchkafka_tpu_torch.models.quant import quantize_params
    from torchkafka_tpu_torch.models.transformer import params_from_numpy

    tree = {"layers": {}}
    arrays = data.group(key)
    for name in arrays.files:
        if name.startswith("layers/"):
            tree["layers"][name[7:]] = arrays[name]
        else:
            tree[name] = arrays[name]
    params = params_from_numpy(tree, cfg, device="cpu")
    return quantize_params(params, cfg) if quantized else params


def _kw(c):
    from torchkafka_tpu_torch.utils import prng

    kw = dict(c.get("kw", {}))
    if "rng" in kw:
        kw["rng"] = prng.key(kw["rng"])
    return kw


def _root_topic(root, prompts, keyed=False):
    """(broker, consumer) on the root, (None, None) elsewhere: the prompts
    over two partitions."""
    if not root:
        return None, None
    import torchkafka_tpu_torch as ptk

    broker = ptk.InMemoryBroker()
    broker.create_topic("p", partitions=2)
    for i in range(prompts.shape[0]):
        broker.produce("p", prompts[i].tobytes(), partition=i % 2,
                       key=str(i).encode() if keyed else None)
    return broker, ptk.MemoryConsumer(broker, "p", group_id="g")


def _committed(broker, group="g"):
    from torchkafka_tpu_torch.source.records import TopicPartition

    if broker is None:
        return None
    return {str(p): broker.committed(group, TopicPartition("p", p)) for p in (0, 1)}


def _generate_case(c, mesh, data, info):
    import torch

    from torchkafka_tpu_torch.models.generate import generate

    cfg = _cfg(c)
    params = _params(data, c["params"], cfg, c.get("quantized", False))
    out = generate(params, cfg, torch.from_numpy(data[c["prompts"]]), c["max_new"], mesh=mesh)
    info[c["name"]] = {"tokens": out.numpy().tolist()}


def _serve_case(c, mesh, data, info):
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.parallel import collectives
    from torchkafka_tpu_torch.parallel.lockstep import is_root
    from torchkafka_tpu_torch.serve import StreamingGenerator
    from torchkafka_tpu_torch.serve_spec import SpecStreamingGenerator
    from torchkafka_tpu_torch.source.records import TopicPartition

    cfg = _cfg(c)
    params = _params(data, c["params"], cfg)
    prompts = data[c["prompts"]]
    root = is_root(mesh)
    broker, consumer = _root_topic(root, prompts)
    # Every rank is handed an output producer over a broker of its own:
    # only the root's may ever receive a record.
    obroker = ptk.InMemoryBroker()
    obroker.create_topic("out", partitions=1)
    cls = SpecStreamingGenerator if c["fn"] == "spec" else StreamingGenerator
    server = cls(consumer, params, cfg, slots=c["slots"], prompt_len=P, max_new=MAX_NEW,
                 commit_every=c["commit_every"], mesh=mesh, device="cpu",
                 output_producer=ptk.MemoryProducer(obroker), output_topic="out",
                 **_kw(c))
    before = collectives.COUNTS.calls
    got = [(f"{rec.partition}:{rec.offset}", toks.tolist())
           for rec, toks in server.run(max_records=prompts.shape[0])]
    server.close()
    pools = server._pools if server._kv_pages is not None else server._caches
    res = {"yields": got, "committed": _committed(broker),
           "sent": obroker.end_offset(TopicPartition("out", 0)),
           "pool_shapes": [list(t.shape) for t in pools],
           "kv_backend": server.metrics.summary()["kv_backend"],
           "collectives": collectives.COUNTS.calls - before,
           "w_gate": list((server._params["layers"]["w_gate"]).shape)}
    if server._tick_collectives:  # no device tick to time: refused by rule
        try:
            server.decode_roofline(iters=1, windows=1)
            res["roofline"] = "ran"
        except ValueError as e:
            res["roofline"] = str(e)
    if c["fn"] == "spec":
        res["spec"] = server.spec_stats()
        # This rank's own count of the rounds its slots were live in.
        res["rank_rounds"] = int(server._spec_counts[2])
    res["sharding"] = [ln for ln in server.metrics.render_prometheus().splitlines()
                       if ln.startswith("torchkafka_serve_kv_backend_info")]
    if server._kv_pages is not None:
        res["cache_hits"] = server.metrics.cache_summary()["hits"]
    if consumer is not None:
        consumer.close()
    info[c["name"]] = res


def _disagg_case(c, mesh, data, info):
    """``tests/test_disagg.py _disagg`` on a mesh: a prefill worker (its
    own group) and a decode server (group "g") pumped in lockstep over the
    root's broker; every consumer is the root's, read through
    ``MeshConsumer``."""
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.fleet.prefill import PrefillRouter, PrefillWorker, drain_handoffs
    from torchkafka_tpu_torch.parallel.lockstep import MeshConsumer, is_root
    from torchkafka_tpu_torch.serve import StreamingGenerator

    cfg = _cfg(c)
    params = _params(data, c["params"], cfg)
    prompts = data[c["prompts"]]
    root = is_root(mesh)
    broker, dc0 = _root_topic(root, prompts, keyed=True)
    pc0 = ho0 = producer = None
    if root:
        pc0 = ptk.MemoryConsumer(broker, "p", group_id="pf")
        broker.create_topic("ho", partitions=1)
        producer = ptk.MemoryProducer(broker)
        ho0 = ptk.MemoryConsumer(broker, "ho", group_id="ho-d0")
    pc, dc, ho_c = (MeshConsumer(x, mesh) for x in (pc0, dc0, ho0))
    common = dict(slots=4, prompt_len=P, max_new=MAX_NEW, kv_pages=c["pages"], mesh=mesh,
                  device="cpu")
    pgen = StreamingGenerator(pc, params, cfg, commit_every=4, prefill_role=True, **common)
    worker = PrefillWorker(pgen, pc, producer, "ho")
    dgen = StreamingGenerator(dc, params, cfg, commit_every=4, **common)
    router = PrefillRouter(dgen, patience=40)
    out, pending = [], []
    n = prompts.shape[0]
    for _ in range(6000):
        worker.pump()
        drain_handoffs(ho_c, dgen)
        free = dgen.free_slots() - dgen.pending_admissions
        if free > len(pending):
            recs = dc.poll(max_records=free - len(pending), timeout_ms=0)
            if recs:
                dgen.note_fetched(recs)
                pending.extend(recs)
        take = []
        while pending and len(take) < free:
            if router.should_hold(pending[0]):
                break
            take.append(pending.pop(0))
        if take or dgen.pending_admissions:
            dgen.admit_records(take)
        for rec, toks in dgen.step():
            out.append((f"{rec.partition}:{rec.offset}", toks.tolist()))
        if len(out) >= n and not dgen.has_active():
            break
    dgen.flush_commits()
    info[c["name"]] = {"yields": out, "committed": _committed(broker),
                       "adopted": dgen.metrics.adopted_slots.count,
                       "decode_prefill_tokens": dgen.metrics.prefill_tokens.count,
                       "published": pgen.metrics.handoffs_published.count}


def _distill_case(c, mesh, data, info):
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.distill import DistillTrainer
    from torchkafka_tpu_torch.parallel.lockstep import is_root

    cfg = _cfg(c)
    params = _params(data, c["params"], cfg)
    consumer = None
    if is_root(mesh):
        broker = ptk.InMemoryBroker()
        broker.create_topic("d", partitions=1)
        frames = data[c["frames"]]
        for i in range(len(data[c["frame_ends"]]) - 1):
            lo, hi = data[c["frame_ends"]][i:i + 2]
            broker.produce("d", frames[lo:hi].tobytes())
        consumer = ptk.MemoryConsumer(broker, "d", group_id="tr")
    trainer = DistillTrainer(consumer, params, cfg, seq_len=P + MAX_NEW, batch_size=4,
                             draft_layers=1, learning_rate=5e-3, mesh=mesh)
    report = trainer.run(idle_timeout_ms=200)
    if consumer is not None:
        consumer.close()
    info[c["name"]] = {"report": report}


def _scenario20_case(c, mesh, info):
    from torchkafka_tpu_torch.harness.scenarios import scenario_20

    info[c["name"]] = {"summary": scenario_20("tiny", device="cpu", mesh=mesh)}


def serve_mesh_main(pid: int, outdir: str, mark) -> int:
    import torch

    torch.manual_seed(0)
    cases = json.loads(open(os.path.join(outdir, "serve_mesh_cases.json")).read())
    data = _Inputs(outdir)
    meshes = _meshes(cases)
    info: dict = {}
    for c in cases:
        mesh = _mesh_of(meshes, c)
        if mesh.get_coordinate() is None:
            continue
        t0 = time.perf_counter()
        try:
            if c["fn"] == "generate":
                _generate_case(c, mesh, data, info)
            elif c["fn"] in ("serve", "spec"):
                _serve_case(c, mesh, data, info)
            elif c["fn"] == "disagg":
                _disagg_case(c, mesh, data, info)
            elif c["fn"] == "distill":
                _distill_case(c, mesh, data, info)
            elif c["fn"] == "scenario20":
                _scenario20_case(c, mesh, info)
        except Exception as e:  # noqa: BLE001 - reported to the parent, then re-raised
            import traceback

            info[c["name"]] = {"error": traceback.format_exc()}
            mark("serve_mesh", info)
            raise e
        # Each case's seconds on this rank (waits for its inputs included).
        info[c["name"]]["seconds"] = time.perf_counter() - t0
    mark("serve_mesh", info)
    return 0
