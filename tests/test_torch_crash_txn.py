"""Crash-matrix cases of the port's server: a real subprocess serving
through ``torchkafka_tpu_torch`` is SIGKILLed at a named crash point, and
the invariants of ``test_crash_matrix.py`` (``_run_serve_case`` and
``_run_txn_case``) are held at the moment of death and after an in-process
recovery incarnation.

- ``journal_mid_write`` (at-least-once serving with a decode journal): the
  death inside the journal's tmp write leaves the torn tmp beside the
  previous complete journal; no committed offset lacks a durable output
  (or, for the poison record, a DLQ copy); recovery, warm-resumed from the
  journal, serves every prompt, duplicates byte-identical.
- ``txn_begin_post``, ``txn_produce_mid``, ``txn_pre_commit``,
  ``txn_post_commit_pre_ack`` (exactly-once serving): at death and after
  recovery the read_committed output view holds each completion at most
  and then exactly once, every committed offset is covered by a committed
  output or DLQ copy, the poison is dead-lettered once, and a commit
  forged with the corpse's stale epoch is fenced.

The reference completions come from the JAX package's own crash worker
(``_crash_worker.run_serve``) in process, whose parameters the parent
writes to an ``.npz`` for the child. Run as ``python
tests/test_torch_crash_txn.py <serve|txn> <host> <port> <workdir>``, this
file is the child: it imports only torch, numpy and the port, arms the
crash point from ``TORCHKAFKA_CRASHPOINT`` and serves over a
``BrokerClient``.
"""

import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

P, MAX_NEW, VOCAB, SLOTS = 8, 8, 64, 2
PROMPT_TOPIC, OUT_TOPIC, DLQ_TOPIC = "t", "out", "dlq"
GROUP, TXN_ID = "crash", "crash-txn"
POISON = b"POISON"
N_PROMPTS, PARTS = 8, 2
JOURNAL_CADENCE, COMMIT_EVERY = 2, 2
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=P + MAX_NEW)
# point -> (worker mode, Nth arrival to die at): test_crash_matrix.py's.
MATRIX = {
    "journal_mid_write": ("serve", 3),
    "txn_begin_post": ("txn", 2),
    "txn_produce_mid": ("txn", 3),
    "txn_pre_commit": ("txn", 2),
    "txn_post_commit_pre_ack": ("txn", 2),
}

# ------------------------------------------------------------- the child


def build_model(workdir: str):
    """The port's model from the parameters the parent wrote: f32, the
    JAX crash worker's shape."""
    import torch

    from torchkafka_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(**SHAPE, dtype=torch.float32,
                               param_dtype=torch.float32)
    tree: dict = {}
    with np.load(os.path.join(workdir, "params.npz")) as z:
        for name in z.files:
            *path, leaf = name.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[name]
    return cfg, pt.params_from_numpy(tree, cfg, device="cpu")


def decode_prompt(record):
    if record.value == POISON:
        raise ValueError("poison prompt")
    return np.frombuffer(record.value, dtype=np.int32)[:P]


def prime_topics(broker) -> None:
    """``_crash_worker.prime_topics``'s layout: prompt i on partition i %
    PARTS keyed by i, the poison after them on partition 0."""
    broker.create_topic(PROMPT_TOPIC, partitions=PARTS)
    broker.create_topic(OUT_TOPIC, partitions=1)
    broker.create_topic(DLQ_TOPIC, partitions=1)
    prompts = np.random.default_rng(7).integers(0, VOCAB, (N_PROMPTS, P),
                                                dtype=np.int32)
    for i in range(N_PROMPTS):
        broker.produce(PROMPT_TOPIC, prompts[i].tobytes(), partition=i % PARTS,
                       key=str(i).encode())
    broker.produce(PROMPT_TOPIC, POISON, partition=0, key=b"poison")


def run_serve(broker, workdir: str, txn: bool) -> None:
    """One serving incarnation (``_crash_worker.run_serve`` or, with
    ``txn``, ``run_serve_txn``, over the port): warm-resumed from the
    journal a previous incarnation left in ``workdir``."""
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.serve import StreamingGenerator

    cfg, params = build_model(workdir)
    jpath = os.path.join(workdir, "journal.json")
    hints = ptk.DecodeJournal.load(jpath)  # before the new journal's 1st flush
    consumer = ptk.MemoryConsumer(broker, PROMPT_TOPIC, group_id=GROUP)
    producer = (ptk.TransactionalProducer(broker, TXN_ID) if txn
                else ptk.MemoryProducer(broker))
    server = StreamingGenerator(
        consumer, params, cfg, slots=SLOTS, prompt_len=P, max_new=MAX_NEW,
        commit_every=COMMIT_EVERY, ticks_per_sync=1, max_poll_records=SLOTS,
        decode_prompt=decode_prompt, output_producer=producer,
        output_topic=OUT_TOPIC, exactly_once=txn,
        quarantine=ptk.PoisonQuarantine(producer, DLQ_TOPIC, budget=1,
                                        timeout_s=5.0),
        journal=ptk.DecodeJournal(jpath, cadence=JOURNAL_CADENCE), device="cpu",
    )
    if hints:
        server.add_resume_hints(hints)
    for _rec, _toks in server.run(idle_timeout_ms=400):
        pass
    server.close()
    consumer.close()
    producer.close()


def main() -> int:
    mode, host, port, workdir = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    from torchkafka_tpu_torch.resilience.crashpoint import arm_from_env

    arm_from_env()
    import torchkafka_tpu_torch as ptk

    client = ptk.BrokerClient(host, port)
    try:
        run_serve(client, workdir, txn=mode == "txn")
    finally:
        client.close()
    return 0


# ------------------------------------------------------------ the parent


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX crash worker's no-kill serve run in process: key → tokens;
    and its parameters written for the child."""
    import jax

    import torchkafka_tpu as tk
    from tests import _crash_worker as W
    from torchkafka_tpu.source.records import TopicPartition

    assert (W.P, W.MAX_NEW, W.VOCAB, W.SLOTS, W.N_PROMPTS, W.PARTS) == (
        P, MAX_NEW, VOCAB, SLOTS, N_PROMPTS, PARTS)
    broker = tk.InMemoryBroker()
    W.prime_topics(broker)
    W.run_serve(broker, str(tmp_path_factory.mktemp("jax-ref")))
    outs = {rec.key: np.frombuffer(rec.value, np.int32).tolist()
            for rec in broker.fetch(TopicPartition(OUT_TOPIC, 0), 0, 1000)}
    assert set(outs) == {str(i).encode() for i in range(N_PROMPTS)}
    _cfg, params = W.build_model()
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(k.key) for k in path)] = np.asarray(leaf)
    npz = str(tmp_path_factory.mktemp("params") / "params.npz")
    np.savez(npz, **flat)
    return outs, npz


def _spawn(mode: str, port: int, workdir: str, point: str, at: int):
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    marker = os.path.join(workdir, "marker")
    env["TORCHKAFKA_CRASHPOINT"] = f"{point}:{at}:kill:{marker}"
    with open(os.path.join(workdir, "child.log"), "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, "localhost",
             str(port), workdir],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
    return proc, marker


def _reap_group(broker, group_id: str) -> None:
    # The in-memory broker has no session timeout: evict the corpse's
    # membership, as Kafka's session reaper would.
    grp = broker._groups.get(group_id)
    for member in list(grp.members) if grp else ():
        broker.leave(group_id, member)


def _committed(broker):
    from torchkafka_tpu_torch.source.records import TopicPartition

    return {p: broker.committed(GROUP, TopicPartition(PROMPT_TOPIC, p)) or 0
            for p in range(PARTS)}


def _by_key(broker, topic, committed_only: bool, raw=False):
    from torchkafka_tpu_torch.source.records import TopicPartition

    tp = TopicPartition(topic, 0)
    recs = (broker.fetch_stable(tp, 0, 100000)[0] if committed_only
            else broker.fetch(tp, 0, 100000))
    out: dict = {}
    for rec in recs:
        out.setdefault(rec.key, []).append(
            rec.value if raw else np.frombuffer(rec.value, np.int32).tolist())
    return out


def _audit_coverage(broker, outs, dlq) -> None:
    """Every committed offset is covered by an output (the poison's by a
    DLQ copy): a commit never passes a prompt that exists nowhere."""
    from torchkafka_tpu_torch.source.records import TopicPartition

    poison = (0, N_PROMPTS // PARTS)
    for p, wm in _committed(broker).items():
        assert wm <= broker.end_offset(TopicPartition(PROMPT_TOPIC, p))
        for off in range(wm):
            if (p, off) == poison:
                assert dlq, "poison offset committed with no DLQ copy"
            else:
                assert str(off * PARTS + p).encode() in outs, (p, off)


@pytest.mark.parametrize("point", list(MATRIX))
def test_port_server_survives_sigkill(tmp_path, reference, point):
    import torchkafka_tpu_torch as ptk
    from torchkafka_tpu_torch.errors import ProducerFencedError
    from torchkafka_tpu_torch.source.records import TopicPartition

    refs, npz = reference
    mode, at = MATRIX[point]
    txn = mode == "txn"
    broker = ptk.InMemoryBroker()
    prime_topics(broker)
    workdir = str(tmp_path / point)
    os.makedirs(workdir)
    shutil.copy(npz, os.path.join(workdir, "params.npz"))
    with ptk.BrokerServer(broker) as host:
        proc, marker = _spawn(mode, host.port, workdir, point, at)
        proc.wait(timeout=180)
    with open(os.path.join(workdir, "child.log"), "rb") as f:
        log = f.read().decode(errors="replace")
    assert proc.returncode == -signal.SIGKILL, f"child exited {proc.returncode}\n{log}"
    with open(marker) as f:
        assert f.read().strip() == f"{point}:{at}"
    _reap_group(broker, GROUP)

    # ---- at the moment of death
    outs = _by_key(broker, OUT_TOPIC, committed_only=txn)
    dlq = _by_key(broker, DLQ_TOPIC, committed_only=txn, raw=True)
    for key, copies in outs.items():
        if txn:
            assert len(copies) == 1, f"duplicate committed output for {key!r}"
        assert all(c == refs[key] for c in copies), key
    _audit_coverage(broker, outs, dlq)
    jpath = os.path.join(workdir, "journal.json")
    ptk.DecodeJournal.load(jpath)  # the corpse's journal parses
    if point == "journal_mid_write":
        assert os.path.exists(jpath + ".tmp"), "expected the torn tmp"

    # ---- recovery: the same serving code, in process
    run_serve(broker, workdir, txn)
    outs = _by_key(broker, OUT_TOPIC, committed_only=txn)
    dlq = _by_key(broker, DLQ_TOPIC, committed_only=txn, raw=True)
    assert set(outs) == set(refs)
    for key, copies in outs.items():
        if txn:
            assert len(copies) == 1, f"{len(copies)} committed copies of {key!r}"
        assert all(c == refs[key] for c in copies), key  # duplicates identical
    assert list(dlq) == [b"poison"] and all(v == POISON for v in dlq[b"poison"])
    if txn:
        assert len(dlq[b"poison"]) == 1, "poison dead-lettered more than once"
    for p, wm in _committed(broker).items():
        assert wm == broker.end_offset(TopicPartition(PROMPT_TOPIC, p))
    if txn:
        # The fence: a commit forged with the corpse's stale epoch bounces.
        pid, epoch = broker.init_producer_id(TXN_ID)
        before = _committed(broker)
        with pytest.raises(ProducerFencedError):
            broker.begin_txn(pid, epoch - 1)
        with pytest.raises(ProducerFencedError):
            broker.commit_txn(pid, epoch - 1)
        assert _committed(broker) == before


if __name__ == "__main__":
    sys.exit(main())
