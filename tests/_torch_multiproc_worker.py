"""Worker process for the port's multi-process pod tests (test_torch_pod.py,
test_torch_mesh_train.py): port of tests/_multiproc_worker.py.

Runs as ``python _torch_multiproc_worker.py <pid> <nproc> <port> <outdir>
<mode>``: one rank of an N-process CPU "pod", wired through
``torch.distributed`` (gloo) to a localhost store by
``parallel.multihost.initialize``. The modes are the reference's:

  happy — every rank streams 4 batches through ``KafkaStream(mesh=)``,
          reduces the GLOBAL batch (a cross-process sum over the
          DTensor), commits each through the default ``BarrierWatchdog``
          → ``CommitBarrier`` → barrier, writes results, exits 0.
  die   — rank nproc-1 exits hard before committing batch 3; the
          survivors' barriers must fail CLOSED: the watchdog fires (exit
          42) or the barrier raises BarrierError (exit 43).
  elastic / elastic_join — group-managed consumers of ONE shared broker
          served by the parent over a BrokerServer socket (<port> is the
          broker's); no process group (the subject is the Kafka group's
          rebalance, not collectives).
  serve — each rank serves its own prompt topic through the
          continuous-batching server under a live process group, with
          per-rank commit accounting (the JAX mode's tp=2 model sharding
          is ROADMAP queue A "Sharded serving").
  ckpt  — a pod checkpoint: a global tensor sharded over the data axis
          plus per-process offsets, committed by process 0's rename
          between barriers; every rank restores the identical global
          state and the MERGED watermark.
  train — the port's ``make_train_step(cfg, mesh)`` on the mesh in
          ``<outdir>/train_args.json`` from the numpy parameters and
          tokens the parent wrote (``train_in.npz``); rank 0 writes the
          losses and the full parameters, every rank a digest of its
          replicated parameters (data replicas must agree bit for bit).
  flash — ``flash_attention_sharded`` on DTensors of this rank's rows of
          ``flash_in.npz`` (q, k, v, dout) over ``{"data": nproc}``: the
          output and the q/k/v gradients of its rows, to
          ``flash_out_<pid>.npz``.
  sp_ops / tp_sp_train — the tensor- and sequence-parallel cases of
          ``<outdir>/<mode>_cases.json`` (tests/_torch_tp_sp_cases.py).
  pipeline / pp_ep_train — the pipeline- and expert-parallel cases
          (tests/_torch_pp_ep_cases.py), the same way.

Each rank uses its own InMemoryBroker primed with deterministic records
(its slice of a pod's disjoint partitions). Committed offsets are written
to ``<outdir>/committed_<pid>.json`` after each commit, so the parent can
replay the durable state and check re-delivery.

Importable from the tests: argv parsing happens under the ``__main__``
guard, and ``build_broker`` takes the package as an argument.
"""

import hashlib
import json
import os
import sys

RECORDS_PER_PROCESS = 64
BATCH = 16  # rank-local rows; global batch = BATCH * NPROC
ELASTIC_PARTITIONS = 4
ELASTIC_RECORDS_PER_PARTITION = 50


def encode_value(pid: int, idx: int) -> bytes:
    """The record payload: 1 byte of producer pid + 4 bytes of index."""
    return pid.to_bytes(1, "little") + idx.to_bytes(4, "little")


def build_broker(tk, pid: int):
    """Deterministic per-process broker = this rank's partition slice."""
    broker = tk.InMemoryBroker()
    broker.create_topic("t", partitions=2)
    for i in range(RECORDS_PER_PROCESS):
        broker.produce("t", encode_value(pid, i), partition=i % 2)
    return broker


def _init(pid: int, nproc: int, port: str, timeout_s: float = 60.0):
    from torchkafka_tpu_torch.parallel import multihost

    idx, count = multihost.initialize(
        f"127.0.0.1:{port}", nproc, pid, device="cpu", timeout_s=timeout_s)
    assert (idx, count) == (pid, nproc), (idx, count)
    return multihost


def serve_main(pid: int, outdir: str, mark) -> int:
    """Pod serving: this rank's own prompt topic through the
    continuous-batching server (a replicated tiny model) under the live
    process group; the per-rank commit accounting must hold."""
    import numpy as np
    import torch

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.models.transformer import TransformerConfig, init_params
    from torchkafka_tpu_torch.serve import StreamingGenerator

    P, MAX_NEW, N = 8, 4, 8
    cfg = TransformerConfig(
        vocab_size=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=32, max_seq_len=P + MAX_NEW, dtype=torch.float32,
    )
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    broker = tk.InMemoryBroker()
    broker.create_topic("prompts", partitions=1)
    rng = np.random.default_rng(pid)
    for _ in range(N):
        broker.produce("prompts", rng.integers(0, 64, P, dtype=np.int32).tobytes())
    consumer = tk.MemoryConsumer(broker, "prompts", group_id="gs")
    server = StreamingGenerator(
        consumer, params, cfg, slots=2, prompt_len=P, max_new=MAX_NEW,
        commit_every=2, device="cpu",
    )
    served = sum(1 for _ in server.run(max_records=N))
    committed = broker.committed("gs", tk.TopicPartition("prompts", 0))
    consumer.close()
    mark("served", {"served": served, "committed": committed,
                    "rank": torch.distributed.get_rank(),
                    "world": torch.distributed.get_world_size()})
    return 0


def ckpt_main(pid: int, nproc: int, outdir: str, mark) -> int:
    """Pod checkpoint round-trip: sharded global state + per-rank offsets."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer
    from torchkafka_tpu_torch.parallel.mesh import distribute, full_tensor, make_mesh
    from torchkafka_tpu_torch.source.records import TopicPartition

    mesh = make_mesh({"data": nproc}, device="cpu")
    # Global [2·nproc, 4] tensor, row r = r everywhere; each rank holds its
    # 2 rows.
    full = torch.arange(2 * nproc, dtype=torch.float32)[:, None].repeat(1, 4)
    state = {"w": distribute(full, mesh, [Shard(0)]), "step_scalar": torch.tensor(7.0)}
    assert state["w"].to_local().shape == (2, 4)
    offsets = {TopicPartition("t", pid): 100 + pid}
    root = os.path.join(outdir, "ck")
    ck = StreamCheckpointer(root)
    ck.save(3, state, offsets)

    template = {"w": distribute(torch.zeros_like(full), mesh, [Shard(0)]),
                "step_scalar": torch.tensor(0.0)}
    restored, off2, step = ck.restore(template=template)
    assert step == 3
    # restore merges every process's offsets file into the pod-global
    # watermark (what makes elastic rescale work).
    assert off2 == {TopicPartition("t", p): 100 + p for p in range(nproc)}, off2
    assert restored["w"].placements == (Shard(0),) or list(restored["w"].placements) == [Shard(0)]
    total = float(full_tensor(restored["w"]).sum())  # global sum across ranks
    expected = 4.0 * sum(range(2 * nproc))
    assert total == expected, (total, expected)
    assert float(restored["step_scalar"]) == 7.0
    # A one-process view of the same checkpoint: the full array, no mesh.
    plain, _, _ = ck.restore()
    assert torch.equal(plain["w"], full)
    assert Replicate() not in restored["w"].placements

    # The reverse: a checkpoint the parent saved from ONE process restores
    # here as this rank's chunk, and resume seeks only this rank's
    # partition (the other's belongs to its peer).
    import torchkafka_tpu_torch as tk

    one = StreamCheckpointer(os.path.join(outdir, "ck1"))
    broker = tk.InMemoryBroker()
    broker.create_topic("t", partitions=nproc)
    for p in range(nproc):
        for i in range(8):
            broker.produce("t", bytes([i]), partition=p)
    consumer = tk.MemoryConsumer(broker, "t", group_id="g",
                                 assignment=[TopicPartition("t", pid)])
    state1, step1 = one.resume(consumer, template={
        "w": distribute(torch.zeros(2 * nproc, 4), mesh, [Shard(0)])})
    assert step1 == 5
    mine = state1["w"].to_local()
    assert torch.equal(mine, torch.arange(2 * pid, 2 * pid + 2, dtype=torch.float32)[:, None]
                       .repeat(1, 4) * 10), mine
    position = consumer.position(TopicPartition("t", pid))
    consumer.close()
    mark("ckpt_ok", {"total": total, "offsets": {str(k): v for k, v in off2.items()},
                     "reverse_position": position})
    return 0


def train_main(pid: int, nproc: int, outdir: str, mark) -> int:
    """The port's mesh train step from the parent's numpy parameters and
    tokens; see the module note."""
    import numpy as np
    import torch

    from torchkafka_tpu_torch.models.transformer import (
        TransformerConfig,
        make_train_step,
        params_from_numpy,
        shard_params,
    )
    from torchkafka_tpu_torch.optim import adamw
    from torchkafka_tpu_torch.parallel.mesh import axis_sizes, full_tensor, local_part, make_mesh
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    with open(os.path.join(outdir, "train_args.json")) as f:
        args = json.load(f)
    mesh = make_mesh(args["axes"], device="cpu")
    sizes = axis_sizes(mesh)
    cfg = TransformerConfig(**args["cfg"], dtype=torch.float32, param_dtype=torch.float32)
    data = np.load(os.path.join(outdir, "train_in.npz"))
    tree = {"embed": data["embed"], "ln_f": data["ln_f"], "lm_head": data["lm_head"],
            "layers": {k[len("layers/"):]: data[k] for k in data.files if k.startswith("layers/")}}
    params = shard_params(params_from_numpy(tree, cfg, device="cpu"), cfg, mesh)
    opt = adamw(args["lr"]).init(params)
    _, step_fn = make_train_step(cfg, mesh, adamw(args["lr"]), device="cpu")
    tokens = data["tokens"]  # [steps, B_global, S]
    shards = sizes.get("data", 1) * sizes.get("fsdp", 1)
    b = tokens.shape[1] // shards
    losses = []
    for s in range(tokens.shape[0]):
        local = torch.as_tensor(tokens[s, pid * b:(pid + 1) * b])
        params, opt, loss = step_fn(params, opt, local, None)
        losses.append(float(loss))
    digest = hashlib.sha256()
    for leaf in tree_leaves(params):
        digest.update(local_part(leaf).detach().numpy().tobytes())
    full = {name: full_tensor(v) for name, v in params.items() if name != "layers"}
    full.update({f"layers/{k}": full_tensor(v) for k, v in params["layers"].items()})
    if pid == 0:
        np.savez(os.path.join(outdir, "train_out.npz"),
                 **{k: v.detach().numpy() for k, v in full.items()})
    coord = mesh.get_coordinate()
    fsdp_index = coord[mesh.mesh_dim_names.index("fsdp")] if "fsdp" in sizes else 0
    mark("train", {"losses": losses, "digest": digest.hexdigest(), "fsdp_index": fsdp_index,
                   "local_shapes": {k: list(local_part(v).shape) for k, v in params["layers"].items()},
                   "stats": step_fn.stats})
    return 0


def flash_main(pid: int, nproc: int, outdir: str, mark) -> int:
    """flash_attention_sharded forward and backward on this rank's rows."""
    import numpy as np
    import torch

    from torchkafka_tpu_torch.ops.flash import flash_attention_sharded
    from torchkafka_tpu_torch.parallel.mesh import global_batch, make_mesh

    data = np.load(os.path.join(outdir, "flash_in.npz"))
    mesh = make_mesh({"data": nproc}, device="cpu")
    b = data["q"].shape[0] // nproc
    rows = {k: torch.from_numpy(data[k][pid * b:(pid + 1) * b].copy()) for k in data.files}
    q, k, v = (global_batch(rows[n], mesh).requires_grad_(True) for n in ("q", "k", "v"))
    out = flash_attention_sharded(q, k, v, mesh, True)
    assert tuple(out.shape) == data["q"].shape and list(out.placements) == list(q.placements)
    (out.to_local() * rows["dout"]).sum().backward()
    np.savez(os.path.join(outdir, f"flash_out_{pid}.npz"),
             out=out.to_local().detach().numpy(),
             **{f"d{n}": t.grad.to_local().numpy() for n, t in (("q", q), ("k", k), ("v", v))})
    mark("flash", {"rows": b})
    return 0


def _wait_for_marker(outdir: str, name: str, pids, timeout_s: float = 60.0) -> None:
    import time as _time

    deadline = _time.monotonic() + timeout_s
    want = [os.path.join(outdir, f"{name}_{p}.json") for p in pids]
    while not all(os.path.exists(p) for p in want):
        if _time.monotonic() > deadline:
            raise TimeoutError(f"markers {want} never appeared")
        _time.sleep(0.02)


def _ids(recs) -> list[list[int]]:
    return [[r.partition, r.offset] for r in recs]


def _group_consumer(client, pid: int):
    """One ELASTIC (broker-side group membership) member over the shared
    socket broker."""
    import functools

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.parallel.multihost import pod_consumer

    return pod_consumer(
        "t", ELASTIC_PARTITIONS, "g",
        transport=functools.partial(tk.MemoryConsumer, client),
        assignment=None, member_id=f"member-{pid}",
    )


def _assignment_snapshot(consumer) -> list[tuple[str, int]]:
    return sorted((tp.topic, tp.partition) for tp in consumer.assignment())


def elastic_main(pid: int, nproc: int, broker_port: int, outdir: str, mark) -> int:
    """One group-managed member of a SHARED cross-process consumer group
    (the reference's elastic_main): everyone joins and snapshots, member
    nproc-1 consumes two batches, commits only the first, and leaves; the
    survivors absorb its partitions and drain."""
    import time as _time

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.errors import CommitFailedError

    client = tk.BrokerClient("127.0.0.1", broker_port)
    consumer = _group_consumer(client, pid)
    mark("joined")
    _wait_for_marker(outdir, "joined", range(nproc))
    pre_leave = _assignment_snapshot(consumer)
    assert pre_leave, "every member must own partitions (4 > 3)"
    mark("armed")
    _wait_for_marker(outdir, "armed", range(nproc))

    if pid == nproc - 1:
        batch1 = consumer.poll(max_records=20, timeout_ms=2000)
        consumer.commit()
        batch2 = consumer.poll(max_records=10, timeout_ms=2000)
        mark("leaver", {"committed": _ids(batch1), "uncommitted": _ids(batch2)})
        consumer.close()  # leave-group -> eager rebalance on the broker
        client.close()
        return 0

    consumed: list[list[int]] = []
    empty_after_leave = 0
    post_leave_assignment = None
    while True:
        recs = consumer.poll(max_records=20, timeout_ms=200)
        consumed.extend(_ids(recs))
        if recs:
            try:
                consumer.commit()
            except CommitFailedError:
                pass
        left = os.path.exists(os.path.join(outdir, f"leaver_{nproc - 1}.json"))
        if left and post_leave_assignment is None:
            assign_now = consumer.assignment()
            if assign_now and sorted(
                (tp.topic, tp.partition) for tp in assign_now
            ) != pre_leave:
                post_leave_assignment = [[tp.topic, tp.partition] for tp in assign_now]
        if post_leave_assignment is not None and not recs:
            if all(v == 0 for v in consumer.lag().values()):
                empty_after_leave += 1
                if empty_after_leave >= 3:
                    break
        else:
            empty_after_leave = 0
        _time.sleep(0.01)
    mark("survivor", {"consumed": consumed, "assignment": post_leave_assignment})
    consumer.close()
    client.close()
    return 0


def elastic_join_main(pid: int, nproc: int, broker_port: int, outdir: str, mark) -> int:
    """Scale-UP counterpart (the reference's elastic_join_main): members
    0..nproc-2 commit one batch each, then member nproc-1 joins the live
    group mid-stream."""
    import time as _time

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.errors import CommitFailedError

    client = tk.BrokerClient("127.0.0.1", broker_port)

    def drain(consumer, consumed, committed):
        empty = 0
        while True:
            recs = consumer.poll(max_records=20, timeout_ms=200)
            consumed.extend(_ids(recs))
            if recs:
                try:
                    consumer.commit()
                    committed.extend(_ids(recs))
                except CommitFailedError:
                    pass
            if not recs:
                if all(v == 0 for v in consumer.lag().values()):
                    empty += 1
                    if empty >= 3:
                        return
            else:
                empty = 0
            _time.sleep(0.01)

    if pid == nproc - 1:
        _wait_for_marker(outdir, "early_progress", range(nproc - 1))
        consumer = _group_consumer(client, pid)  # join -> eager rebalance
        mark("joining")
        consumed: list[list[int]] = []
        committed: list[list[int]] = []
        consumed.extend(_ids(consumer.poll(max_records=1, timeout_ms=500)))
        post_join = _assignment_snapshot(consumer)
        drain(consumer, consumed, committed)
        mark("joiner", {"consumed": consumed, "committed": committed,
                        "assignment": [list(t) for t in post_join]})
        consumer.close()
        client.close()
        return 0

    consumer = _group_consumer(client, pid)
    mark("joined_early")
    _wait_for_marker(outdir, "joined_early", range(nproc - 1))
    pre_join = _assignment_snapshot(consumer)
    assert pre_join, "every early member must own partitions"
    consumed = []
    committed = []
    while not consumed:
        consumed.extend(_ids(consumer.poll(max_records=20, timeout_ms=500)))
    consumer.commit()  # must succeed: membership is stable pre-join
    committed.extend(consumed)
    mark("early_progress")
    _wait_for_marker(outdir, "joining", [nproc - 1])
    drain(consumer, consumed, committed)
    post_join = _assignment_snapshot(consumer)
    mark("early", {"consumed": consumed, "committed": committed,
                   "pre_join": [list(t) for t in pre_join],
                   "assignment": [list(t) for t in post_join]})
    consumer.close()
    client.close()
    return 0


def stream_main(pid: int, nproc: int, outdir: str, mode: str, mark) -> int:
    """The happy and die modes: KafkaStream(mesh=) → a global reduction
    → token.commit through the default watchdog barrier."""
    import numpy as np

    import torchkafka_tpu_torch as tk
    from torchkafka_tpu_torch.errors import BarrierError
    from torchkafka_tpu_torch.parallel.mesh import full_tensor, make_mesh

    broker = build_broker(tk, pid)
    consumer = tk.MemoryConsumer(broker, "t", group_id="g")

    def processor(record):
        # Rank-dependent values: a rank that reduced only its LOCAL rows
        # would produce a sum the parent's global-total check rejects.
        rpid = record.value[0]
        idx = int.from_bytes(record.value[1:5], "little")
        return np.full((8,), float(rpid * 1000 + idx), np.float32)

    mesh = make_mesh({"data": nproc}, device="cpu")
    # No explicit barrier: a multi-process stream gets the BarrierWatchdog
    # (exit 42 on timeout) by default. The short timeout applies only in
    # die mode, where the watchdog may be what ends the survivor.
    stream = tk.KafkaStream(
        consumer, processor, BATCH, mesh=mesh, device="cpu",
        idle_timeout_ms=2000,
        barrier_timeout_s=20.0 if mode == "die" else 300.0,
        on_barrier_timeout=lambda: mark("watchdog_fired", {"batch": "3"}),
    )
    committed: list = []
    losses: list[float] = []
    n = 0
    try:
        for batch, token in stream:
            n += 1
            assert tuple(batch.data.shape) == (BATCH * nproc, 8), batch.data.shape
            loss = full_tensor(batch.data.sum())  # a cross-process reduction
            if mode == "die" and n == 3:
                if pid == nproc - 1:
                    # Hard death mid-step, before the commit barrier: the
                    # survivors must NOT commit batch 3.
                    mark("died_before_commit", {"batch": n})
                    os._exit(1)
                mark("attempting", {"batch": n})
            try:
                ok = token.commit(wait_for=loss)
            except BarrierError as e:
                mark("barrier_error", {"batch": n, "error": str(e)})
                os._exit(43)
            assert ok, f"commit {n} failed"
            losses.append(float(loss))
            committed.append([[k.topic, k.partition, v] for k, v in token.offsets.items()])
            mark("committed", {"batches": committed, "losses": losses})
            if n == 4:
                break
    finally:
        stream.close()
        consumer.close()
    mark("done", {"batches": n, "losses": losses,
                  "barrier": type(stream._barrier).__name__})
    return 0


def main(pid: int, nproc: int, port: str, outdir: str, mode: str) -> int:
    def mark(name: str, payload=None) -> None:
        path = os.path.join(outdir, f"{name}_{pid}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload if payload is not None else {}, f)
        os.replace(tmp, path)

    if mode in ("elastic", "elastic_join"):
        fn = elastic_main if mode == "elastic" else elastic_join_main
        return fn(pid, nproc, int(port), outdir, mark)

    import torch

    torch.set_num_threads(1)
    multihost = _init(pid, nproc, port, timeout_s=30.0 if mode == "die" else 60.0)
    try:
        if mode == "serve":
            return serve_main(pid, outdir, mark)
        if mode == "ckpt":
            return ckpt_main(pid, nproc, outdir, mark)
        if mode == "train":
            return train_main(pid, nproc, outdir, mark)
        if mode == "flash":
            return flash_main(pid, nproc, outdir, mark)
        if mode in ("sp_ops", "tp_sp_train"):
            import _torch_tp_sp_cases as cases

            return getattr(cases, f"{mode}_main")(pid, outdir, mark)
        if mode == "serve_mesh":
            import _torch_serve_mesh_cases as cases

            return cases.serve_mesh_main(pid, outdir, mark)
        if mode in ("pipeline", "pp_ep_train"):
            import _torch_pp_ep_cases as cases

            return getattr(cases, f"{mode}_main")(pid, outdir, mark)
        return stream_main(pid, nproc, outdir, mode, mark)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
