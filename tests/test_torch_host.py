"""Host layer of the PyTorch port against the JAX package: the broker,
consumer-group commits and the offset ledger must agree byte for byte, and
the port must never import JAX or the JAX package."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from torchkafka_tpu.commit.ledger import OffsetLedger as JaxLedger
from torchkafka_tpu.errors import CommitFailedError as JaxCommitFailed
from torchkafka_tpu.source.memory import InMemoryBroker as JaxBroker
from torchkafka_tpu.source.memory import MemoryConsumer as JaxConsumer
from torchkafka_tpu.source.records import TopicPartition as JaxTP
from torchkafka_tpu_torch.commit.ledger import OffsetLedger as PortLedger
from torchkafka_tpu_torch.errors import CommitFailedError as PortCommitFailed
from torchkafka_tpu_torch.source.memory import InMemoryBroker as PortBroker
from torchkafka_tpu_torch.source.memory import MemoryConsumer as PortConsumer
from torchkafka_tpu_torch.source.records import TopicPartition as PortTP

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {
    "jax": (JaxBroker, JaxConsumer, JaxLedger, JaxCommitFailed, JaxTP),
    "port": (PortBroker, PortConsumer, PortLedger, PortCommitFailed, PortTP),
}


def _rec(r):
    return (r.topic, r.partition, r.offset, r.key, r.value)


def _group_sequence(which: str, seed: int):
    """One seeded produce/poll/commit/rebalance sequence; returns every
    polled record, the commits made and the final committed offsets."""
    Broker, Consumer, _, _, TP = PACKAGES[which]
    rng = np.random.default_rng(seed)
    broker = Broker()
    broker.create_topic("t", partitions=3)
    for i in range(60):
        key = None if i % 3 else f"k{rng.integers(0, 7)}".encode()
        broker.produce("t", rng.bytes(int(rng.integers(1, 24))), key=key,
                       timestamp_ms=1_000 + i)
    a = Consumer(broker, "t", group_id="g", member_id="a")
    seen, commits = [], []

    def take(c, n):
        batch = c.poll(max_records=n)
        seen.extend(_rec(r) for r in batch)
        if batch:
            offs = {}
            for r in batch[: max(1, len(batch) // 2)]:
                offs[r.tp] = max(offs.get(r.tp, 0), r.offset + 1)
            c.commit(offs)
            commits.append(sorted((tp.partition, o) for tp, o in offs.items()))
        return batch

    for _ in range(3):
        take(a, int(rng.integers(3, 9)))
    b = Consumer(broker, "t", group_id="g", member_id="b")  # rebalance
    for _ in range(6):
        take(a, int(rng.integers(2, 7)))
        take(b, int(rng.integers(2, 7)))
    b.close()  # rebalance back
    for _ in range(4):
        take(a, 10)
    final = [broker.committed("g", TP("t", p)) for p in range(3)]
    return seen, commits, final


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_sequence_matches(seed):
    assert _group_sequence("port", seed) == _group_sequence("jax", seed)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_stale_commit_raises(which):
    """A member that commits after a rebalance it has not seen is fenced
    with CommitFailedError, in both packages."""
    Broker, Consumer, _, CommitFailed, _ = PACKAGES[which]
    broker = Broker()
    broker.create_topic("t", partitions=2)
    for i in range(8):
        broker.produce("t", bytes([i]))
    a = Consumer(broker, "t", group_id="g", member_id="a")
    batch = a.poll(max_records=4)
    assert batch
    gen = a.generation
    Consumer(broker, "t", group_id="g", member_id="b").poll(max_records=1)
    with pytest.raises(CommitFailed):
        broker.commit(
            "g", {batch[0].tp: batch[0].offset + 1}, member_id="a",
            generation=gen,
        )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ledger_out_of_order_matches(seed):
    """Random out-of-order emits and drops give identical snapshots after
    every operation."""
    from torchkafka_tpu.source.records import Record as JaxRecord
    from torchkafka_tpu_torch.source.records import Record as PortRecord

    rng = np.random.default_rng(seed)
    recs = [(p, o) for p in range(3) for o in range(int(rng.integers(5, 15)))]
    ops = rng.permutation(len(recs))
    kinds = rng.random(len(recs)) < 0.2
    snaps = {}
    for which, Record in (("jax", JaxRecord), ("port", PortRecord)):
        ledger = PACKAGES[which][2]()
        rs = [Record("t", p, o, None, b"x", 0) for p, o in recs]
        ledger.fetched_many(rs)
        out = []
        for i, drop in zip(ops, kinds):
            (ledger.dropped if drop else ledger.emitted)(rs[i])
            out.append(sorted((tp.partition, o) for tp, o in ledger.snapshot().items()))
        snaps[which] = out
    assert snaps["port"] == snaps["jax"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "torchkafka_tpu")


def test_port_never_imports_jax_ast():
    files = sorted((ROOT / "torchkafka_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert bad == []


def test_port_import_adds_no_jax_module():
    code = (
        "import sys\n"
        "import torchkafka_tpu_torch.serve, torchkafka_tpu_torch.models.zoo\n"
        "import torchkafka_tpu_torch.source.memory\n"
        "import torchkafka_tpu_torch.ops.qmatmul, torchkafka_tpu_torch.source.producer\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torchkafka_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT) + ":" + ":".join(p for p in sys.path if p)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
