"""The port's producers (a copy of ``source/producer.py``) against the JAX
package's: one seeded sequence of sends, transactions, fencing and
dead-letter produces through both packages' ``MemoryProducer`` and
``TransactionalProducer`` must give identical records, partitions, send
metadata and read_committed / read_uncommitted visibility."""

import numpy as np
import pytest

import torchkafka_tpu as jk
import torchkafka_tpu_torch as pk
from torchkafka_tpu.source.producer import TransactionalProducer as JaxTxn
from torchkafka_tpu_torch.source import TransactionalProducer as PortTxn


def _row(r):
    return (r.topic, r.partition, r.offset, r.key, r.value, tuple(r.headers))


def _read(tk, broker, topic, isolation):
    c = tk.MemoryConsumer(broker, topic, group_id=f"read-{isolation}",
                          isolation_level=isolation)
    rows = []
    while True:
        batch = c.poll(max_records=100, timeout_ms=0)
        if not batch:
            break
        rows.extend(_row(r) for r in batch)
    c.close()
    return sorted(rows, key=lambda r: (r[1], r[2]))


def _sequence(tk, Txn, seed: int):
    rng = np.random.default_rng(seed)
    broker = tk.InMemoryBroker()
    broker.create_topic("out", partitions=3)
    broker.create_topic("dlq", partitions=1)
    broker.create_topic("src", partitions=2)
    meta, events = [], []
    p = tk.MemoryProducer(broker)
    for i in range(24):
        kw = {}
        r = rng.integers(0, 3)
        if r == 0:
            kw["key"] = f"k{rng.integers(0, 5)}".encode()
        elif r == 1:
            kw["partition"] = int(rng.integers(0, 3))
        if rng.random() < 0.3:
            kw["headers"] = (("mv", str(i).encode()),)
        md = p.send("out", rng.bytes(int(rng.integers(1, 16))), **kw).get(1.0)
        meta.append((md.topic, md.partition, md.offset))
    t1 = Txn(broker, "tx")
    for outcome in ("commit", "abort", "open"):
        t1.begin()
        for _ in range(int(rng.integers(1, 5))):
            md = t1.send("out", rng.bytes(8), key=f"t{rng.integers(0, 3)}".encode()).get()
            meta.append((md.topic, md.partition, md.offset))
        if outcome == "commit":
            t1.commit()
        elif outcome == "abort":
            events.append(("abort", t1.abort()))
    events.append(("epoch1", t1.epoch))
    t2 = Txn(broker, "tx")  # fences t1 and aborts its open transaction
    events.append(("epoch2", t2.epoch))
    with pytest.raises(tk.ProducerFencedError):
        t1.begin()
    t2.begin()
    md = t2.send("out", b"last", key=b"t0").get()
    meta.append((md.topic, md.partition, md.offset))
    t2.send_offsets("grp", {tk.TopicPartition("src", 1): 7})
    t2.commit()
    events.append(("committed", broker.committed("grp", tk.TopicPartition("src", 1))))
    with pytest.raises(tk.TransactionStateError):
        t2.send("out", b"x")
    bad = tk.Record(topic="src", partition=1, offset=3, value=b"poison", key=b"k")
    tk.dead_letter_to_topic(p, "dlq")(bad, ValueError("bad payload"))
    p.close()
    with pytest.raises(tk.ProducerClosedError):
        p.send("out", b"x")
    return {
        "meta": meta,
        "events": events,
        "committed_view": _read(tk, broker, "out", "read_committed"),
        "uncommitted_view": _read(tk, broker, "out", "read_uncommitted"),
        "dlq": _read(tk, broker, "dlq", "read_uncommitted"),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_producer_sequence_matches(seed):
    ref = _sequence(jk, JaxTxn, seed)
    got = _sequence(pk, PortTxn, seed)
    assert got == ref
    # The aborted and fenced transactions' records stay out of the
    # committed view but appear in the uncommitted one.
    assert len(got["committed_view"]) < len(got["uncommitted_view"])
    assert got["dlq"][0][5][0] == ("dlq.error", b"bad payload")
