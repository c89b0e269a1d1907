"""The reference's broker, WAL, replication, native-decoder, producer and
kafka-adapter test files run over the port: each module's source is loaded
with ``torchkafka_tpu`` re-rooted onto ``torchkafka_tpu_torch``
(``_torch_fleet_common.load_rerooted``) and its test classes and functions
are collected here.

- ``test_wal.py``: the write-ahead log's framing, broker recovery and the
  torn-tail fuzz (``source/wal.py``, ``source/memory.py``);
- ``test_replication.py``: the quorum replicator, follower replicas and
  the broker cell (``source/replication.py``, ``source/cluster.py``);
- ``test_netbroker.py``: the socket broker, leases, zombie fencing,
  reconnects and the chaos transport (``source/netbroker.py``);
- ``test_native.py``: the C++ record decoders against their NumPy
  fallbacks (``native/``), the wire codec through the port's
  ``ops.bitpack.unpack_bits``;
- ``test_kafka_adapter.py`` and ``test_producer.py``: the kafka-python
  adapter against a stub ``kafka`` module, and the producers
  (``source/kafka.py``, ``source/producer.py``).

The producer file's adapter fixture imports the adapter file's stub
helpers by module path: that one import is bound to the re-rooted adapter
module, so the stub reloads the port's ``source.kafka``."""

import pytest

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


_wal = load_rerooted("test_wal")
TestFraming = _wal.TestFraming
TestBrokerRecoveryUnit = _wal.TestBrokerRecoveryUnit
test_torn_tail_fuzz_fast = _wal.test_torn_tail_fuzz_fast
test_torn_tail_fuzz_full = _wal.test_torn_tail_fuzz_full
test_follower_torn_tail_fuzz_fast = _wal.test_follower_torn_tail_fuzz_fast
test_follower_torn_tail_fuzz_full = _wal.test_follower_torn_tail_fuzz_full
test_recovery_equivalent_across_durability_modes = (
    _wal.test_recovery_equivalent_across_durability_modes)

_repl = load_rerooted("test_replication")
TestReplicationConfig = _repl.TestReplicationConfig
TestFollowerReplica = _repl.TestFollowerReplica
TestReplicatorQuorum = _repl.TestReplicatorQuorum
TestBrokerCell = _repl.TestBrokerCell

_net = load_rerooted("test_netbroker")
server = _net.server
TestBrokerRPC = _net.TestBrokerRPC
TestSharedGroupAcrossConnections = _net.TestSharedGroupAcrossConnections
TestZombieFencing = _net.TestZombieFencing
TestHeartbeatLeases = _net.TestHeartbeatLeases
TestReconnect = _net.TestReconnect
TestSamePortRestart = _net.TestSamePortRestart
TestChaosTransport = _net.TestChaosTransport

_native = load_rerooted("test_native")
TestPackBits = _native.TestPackBits
TestGatherRows = _native.TestGatherRows
TestJsonTokens = _native.TestJsonTokens
TestProcessorIntegration = _native.TestProcessorIntegration
TestFuzzDifferential = _native.TestFuzzDifferential

_kafka = load_rerooted("test_kafka_adapter")
adapter = _kafka.adapter
adapter_old_oam = _kafka.adapter_old_oam
TestConstruction = _kafka.TestConstruction
TestCommitTranslation = _kafka.TestCommitTranslation
TestPollTranslation = _kafka.TestPollTranslation
TestIteratorMode = _kafka.TestIteratorMode
TestClose = _kafka.TestClose
TestTimeAndFlowControl = _kafka.TestTimeAndFlowControl
TestPatternSubscription = _kafka.TestPatternSubscription
TestRebalanceListenerTranslation = _kafka.TestRebalanceListenerTranslation

_producer = load_rerooted("test_producer", replace=[
    ("from tests.test_kafka_adapter import", f"from {_kafka.__name__} import"),
])
TestMemoryProducer = _producer.TestMemoryProducer
TestDeadLetterToTopic = _producer.TestDeadLetterToTopic
TestKafkaProducerAdapter = _producer.TestKafkaProducerAdapter


def test_closed_server_drops_a_connection_it_had_not_registered(monkeypatch):
    """A connection that ``accept()`` returned just before ``close()`` but
    that the server had not registered yet is dropped, not served: the
    case ``TestReconnect::test_no_policy_still_translates_but_does_not_retry``
    loses about one run in fifty against the JAX package's copy
    (``tests/netbroker_close_race.py``). Every accept is held 50 ms here,
    which opens that window on most runs."""
    import socket
    import time

    from torchkafka_tpu_torch.errors import BrokerUnavailableError
    from torchkafka_tpu_torch.source.netbroker import BrokerClient, BrokerServer

    accept = socket.socket.accept

    def slow_accept(self):
        got = accept(self)
        time.sleep(0.05)
        return got

    monkeypatch.setattr(socket.socket, "accept", slow_accept)
    for _ in range(10):
        server = BrokerServer(ptk.InMemoryBroker())
        client = BrokerClient(server.host, server.port)
        server.close()
        with pytest.raises(BrokerUnavailableError):
            client.wait_for_data(0.01)
        client.close()


def test_frames_are_received_in_bounded_chunks():
    """A frame of several MiB arrives whole through reads of at most 1 MiB
    each, joined once: a frame received by appending to one bytes object
    costs time quadratic in its size (a checkpoint fetch then held the
    client's lock past its heartbeat's session timeout)."""
    from torchkafka_tpu_torch.source import netbroker

    payload = bytes(range(256)) * (5 * 4096 + 7)

    class Pipe:
        def __init__(self):
            self.sent, self.asks = b"", []

        def sendall(self, data):
            self.sent += data

        def recv(self, n):
            self.asks.append(n)
            out, self.sent = self.sent[:min(n, 300_000)], self.sent[min(n, 300_000):]
            return out

    pipe = Pipe()
    netbroker._send(pipe, ("ok", payload))
    assert netbroker._recv(pipe) == ("ok", payload)
    assert max(pipe.asks) <= 1 << 20 and len(pipe.asks) > 5
