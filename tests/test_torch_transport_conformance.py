"""The transport-conformance suite of ``test_transport_conformance.py`` run
over the port's transports: the same cases, with every name of the JAX
package re-rooted onto ``torchkafka_tpu_torch`` (the module's source is
loaded with the package name replaced and its test classes and fixtures
are collected here). Environments: memory, netbroker, chaos, chaos-net,
WAL broker and resilient, plus the producer and replication-wire cases.

The wire of each package is length-prefixed pickle of that package's own
classes, so a port client never talks to a JAX server: the cross-package
check is the paired run at the end, where one seeded op sequence goes
through the JAX client/server and through the port's, and the records and
commits are compared byte for byte."""

import pathlib
import sys
import types

import numpy as np
import pytest

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk

_REF = pathlib.Path(__file__).with_name("test_transport_conformance.py")
_mod = types.ModuleType("_port_transport_conformance")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)

assert _mod.tk is ptk
TRANSPORTS = _mod.TRANSPORTS
env, penv, renv = _mod.env, _mod.penv, _mod.renv
TestConformance = _mod.TestConformance
TestProducerConformance = _mod.TestProducerConformance
TestReplicationWireConformance = _mod.TestReplicationWireConformance


def test_every_port_transport_is_covered():
    assert {"memory", "netbroker", "chaos", "chaosnet", "resilient",
            "walbroker"} <= set(TRANSPORTS)


def _wire_sequence(pkg, seed: int):
    """One seeded produce/poll/commit/rebalance sequence over a
    ``BrokerServer`` on localhost and two ``BrokerClient`` group members;
    returns every polled record, the commits and the final watermarks."""
    rng = np.random.default_rng(seed)
    broker = pkg.InMemoryBroker()
    broker.create_topic("t", partitions=3)
    server = pkg.BrokerServer(broker)
    clients = [pkg.BrokerClient(server.host, server.port) for _ in range(3)]
    try:
        producer = pkg.MemoryProducer(clients[0])
        for i in range(40):
            key = None if i % 3 else f"k{rng.integers(0, 5)}".encode()
            producer.send("t", rng.bytes(int(rng.integers(1, 20))), key=key,
                          timestamp_ms=5_000 + i).get(5.0)
        seen, commits = [], []
        a = pkg.MemoryConsumer(clients[1], "t", group_id="g", member_id="a")

        def take(c, n):
            batch = c.poll(max_records=n, timeout_ms=100)
            seen.append([(r.topic, r.partition, r.offset, r.key, r.value,
                          r.timestamp_ms) for r in batch])
            if batch:
                offs = {}
                for r in batch[: max(1, len(batch) // 2)]:
                    offs[r.tp] = max(offs.get(r.tp, 0), r.offset + 1)
                c.commit(offs)
                commits.append(sorted((tp.partition, o) for tp, o in offs.items()))

        for _ in range(3):
            take(a, int(rng.integers(2, 8)))
        b = pkg.MemoryConsumer(clients[2], "t", group_id="g", member_id="b")
        for _ in range(5):
            take(a, int(rng.integers(2, 6)))
            take(b, int(rng.integers(2, 6)))
        b.close()
        for _ in range(4):
            take(a, 10)
        a.close()
        final = [broker.committed("g", pkg.TopicPartition("t", p)) for p in range(3)]
        return seen, commits, final
    finally:
        for c in clients:
            c.close()
        server.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paired_wire_runs_match(seed):
    """The same seeded ops through the JAX package's client/server and the
    port's: identical records (bytes, keys, timestamps) and commits."""
    assert _wire_sequence(ptk, seed) == _wire_sequence(tk, seed)
