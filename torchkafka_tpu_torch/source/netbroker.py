"""Socket-RPC transport for ``InMemoryBroker``: one broker, many processes.

The in-memory broker (source/memory.py) implements the full consumer-group
protocol — range assignment, generations, eager rebalance, generation-checked
commits — but lives inside one Python process. Real elasticity questions
("a member LEAVES mid-stream; do the survivors absorb its partitions and do
its uncommitted records re-deliver?") are multi-PROCESS questions: each group
member is its own OS process, exactly like the reference's per-DataLoader-
worker consumers (the reference's src/kafka_dataset.py:208-233) and like one
consumer per TPU pod host.

``BrokerServer`` hosts an ``InMemoryBroker`` behind a localhost socket;
``BrokerClient`` exposes the same *broker* surface over RPC. Because
``MemoryConsumer`` talks only to that surface (join/leave/group_state/fetch/
commit/...), the UNCHANGED consumer — including all its rebalance-sync logic
— runs against a shared cross-process broker: the group protocol itself is
what gets exercised, not a reimplementation of it.

Scope: a hermetic test/pod-harness transport on a TRUSTED channel. Framing is
length-prefixed pickle (the payloads are this package's own Record /
TopicPartition values and broker exceptions); never expose the port beyond
localhost or a trusted fabric — production traffic belongs to real Kafka via
source/kafka.py.
"""

from __future__ import annotations

import pickle
import random
import socket
import struct
import threading
import time
from typing import Any

from torchkafka_tpu_torch.source.memory import InMemoryBroker

_LEN = struct.Struct(">I")

# The broker surface MemoryConsumer + tests use. An explicit allowlist: the
# server dispatches nothing else (no arbitrary attribute access over the
# wire).
_METHODS = frozenset(
    {
        "create_topic",
        "partitions_for",
        "produce",
        "end_offset",
        "fetch",
        "offset_for_time",
        "join",
        "leave",
        "group_state",
        "commit",
        "committed",
        "wait_for_data",
        "heartbeat",
        "fence",
        "membership",
        # Transactions (KIP-98 surface): epoch fencing crosses the wire
        # as the marshalled terminal ProducerFencedError; transport
        # faults stay the retryable BrokerUnavailableError — the same
        # retryable-vs-terminal split every other RPC rides.
        "init_producer_id",
        "begin_txn",
        "txn_produce",
        "txn_commit_offsets",
        "commit_txn",
        "abort_txn",
        "fetch_stable",
        "last_stable_offset",
        # Replication (broker-cell surface): the leader ships WAL frames
        # to FollowerReplica objects served by this same BrokerServer, and
        # the cell probes liveness/position over the same wire. Stale-
        # epoch fencing crosses as the marshalled terminal StaleEpochError;
        # transport faults stay the retryable BrokerUnavailableError.
        "repl_append",
        "repl_status",
        "repl_ping",
    }
)


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        raise ConnectionError("broker connection closed")
    (n,) = _LEN.unpack(header)
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ConnectionError("broker connection closed mid-frame")
    return pickle.loads(payload)


_RECV_CHUNK = 1 << 20


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    # Chunks joined once at the end, each recv at most 1 MiB: appending
    # to one bytes object copies it whole at every chunk (and ``recv(n)``
    # allocates n bytes a call), quadratic in the frame. A checkpoint
    # fetch of a few hundred MB then holds the client's lock for seconds,
    # and its heartbeat thread waits behind it past the session timeout.
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, _RECV_CHUNK))
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class WireFaults:
    """Seeded socket-layer fault plan for :class:`ChaosTransport`.

    The transport-level complement to ``ChaosConsumer`` (source/chaos.py):
    where that injects faults at the *consumer API* boundary, this
    injects them at the *wire* — a request frame cut off mid-write, a
    connection reset while the reply is in flight, an op-counted stall —
    so broker outages are reproducible at the socket layer without
    killing any process. One instance carries the RNG and the op counter
    ACROSS reconnects (a reconnecting client keeps consuming the same
    schedule), so a seeded run replays identically.

    All rates default to 0.0 and all op sets to empty: a zero-fault plan
    is a pure pass-through, asserted contract-transparent by the
    transport-conformance suite.

    - ``reset_rate`` / ``reset_at_ops``: the request's ``sendall`` is cut
      short — a seeded PARTIAL prefix of the frame is written (the torn
      bytes the server must discard), then the connection resets. The
      RPC provably never executed.
    - ``recv_reset_rate`` / ``recv_reset_at_ops``: the request was sent
      (and likely executed broker-side) but the reply is lost mid-read —
      the lost-ack hazard; only idempotent/at-least-once-tolerant
      operations survive retries of this, which is exactly the
      transport's documented contract.
    - ``stall_rate`` / ``stall_at_ops`` (+ ``stall_s``): latency
      injection before the request goes out.

    An *op* is one RPC request (one ``sendall``); ``*_at_ops`` sets fire
    deterministically at those op indices (0-based), composing with the
    seeded rates."""

    def __init__(
        self,
        seed: int = 0,
        *,
        reset_rate: float = 0.0,
        recv_reset_rate: float = 0.0,
        stall_rate: float = 0.0,
        stall_s: float = 0.005,
        reset_at_ops: tuple[int, ...] = (),
        recv_reset_at_ops: tuple[int, ...] = (),
        stall_at_ops: tuple[int, ...] = (),
    ) -> None:
        for name, rate in (("reset_rate", reset_rate),
                           ("recv_reset_rate", recv_reset_rate),
                           ("stall_rate", stall_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self._rng = random.Random(seed)
        self.reset_rate = reset_rate
        self.recv_reset_rate = recv_reset_rate
        self.stall_rate = stall_rate
        self.stall_s = stall_s
        self.reset_at_ops = frozenset(reset_at_ops)
        self.recv_reset_at_ops = frozenset(recv_reset_at_ops)
        self.stall_at_ops = frozenset(stall_at_ops)
        self.ops = 0  # RPC requests seen, across reconnects
        self.faults_injected = 0

    def next_op(self) -> int:
        op = self.ops
        self.ops += 1
        return op

    def send_cut(self, op: int, nbytes: int) -> int | None:
        """None = write goes through; else the seeded prefix length to
        write before resetting."""
        if op in self.reset_at_ops or (
            self.reset_rate and self._rng.random() < self.reset_rate
        ):
            self.faults_injected += 1
            return self._rng.randrange(nbytes) if nbytes else 0
        return None

    def recv_reset(self, op: int) -> bool:
        if op in self.recv_reset_at_ops or (
            self.recv_reset_rate
            and self._rng.random() < self.recv_reset_rate
        ):
            self.faults_injected += 1
            return True
        return False

    def stall(self, op: int) -> bool:
        return op in self.stall_at_ops or (
            self.stall_rate and self._rng.random() < self.stall_rate
        )


class ChaosTransport:
    """A connected socket wrapped with a :class:`WireFaults` plan.

    Implements exactly the surface ``BrokerClient``'s framing uses
    (``sendall``/``recv``/``close``), forwarding to the real socket and
    consulting the plan per RPC. Injected failures surface as
    ``ConnectionResetError`` — indistinguishable from a real peer reset,
    so the client's translation to the retryable
    ``BrokerUnavailableError`` (and a ``RetryPolicy``'s reconnects) get
    exercised by the genuine code path, not a simulation of it."""

    def __init__(self, sock: socket.socket, faults: WireFaults) -> None:
        self._sock = sock
        self._faults = faults
        # The reply-loss decision is drawn ONCE per RPC (at request
        # time), not per recv chunk — chunk counts are data-dependent
        # and would desynchronize the seeded schedule.
        self._pending_recv_reset = False

    def sendall(self, data: bytes) -> None:
        f = self._faults
        op = f.next_op()
        cut = f.send_cut(op, len(data))
        if cut is not None:
            try:
                self._sock.sendall(data[:cut])
            finally:
                self.close()
            raise ConnectionResetError(
                f"chaos: connection reset after {cut}/{len(data)} bytes "
                f"of request (op {op})"
            )
        if f.stall(op):
            time.sleep(f.stall_s)
        self._pending_recv_reset = f.recv_reset(op)
        self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        if self._pending_recv_reset:
            self._pending_recv_reset = False
            self.close()
            raise ConnectionResetError(
                "chaos: connection reset mid-reply (request may have "
                "executed broker-side — the lost-ack hazard)"
            )
        return self._sock.recv(n)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class BrokerServer:
    """Serve an ``InMemoryBroker`` on a localhost socket.

    One thread per connection: ``wait_for_data`` blocks server-side, so a
    long-polling client must not starve others. The underlying broker is
    already thread-safe (RLock).
    """

    def __init__(
        self, broker: InMemoryBroker | None = None, host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.broker = broker if broker is not None else InMemoryBroker()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.host, self.port = self._sock.getsockname()
        self._closing = False
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="broker-server-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closing:
                    # close() ran between accept() and here: it has already
                    # taken its snapshot of the connections, so this one is
                    # dropped here or a "closed" server would serve it.
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="broker-server-conn", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                try:
                    method, args, kwargs = _recv(conn)
                except (ConnectionError, OSError):
                    return
                # A client that disconnects mid-request makes the reply
                # _send raise (EBADF/EPIPE); without this guard the "ok"
                # send's failure would route into the except branch whose
                # _send raises AGAIN and escapes the handler thread
                # (ADVICE r4). A vanished client just closes its handler.
                try:
                    if method not in _METHODS:
                        _send(conn, ("err", ValueError(f"unknown method {method!r}")))
                        continue
                    try:
                        value = getattr(self.broker, method)(*args, **kwargs)
                        reply = ("ok", value)
                    except Exception as exc:  # noqa: BLE001 - marshalled to client
                        reply = ("err", exc)
                    _send(conn, reply)
                except (ConnectionError, OSError):
                    return
        finally:
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._closing = True
        try:
            # shutdown() BEFORE close(): the accept thread blocked in
            # accept() holds a kernel reference to the listening socket,
            # so a bare close() leaves the listener alive (and accepting!)
            # until that syscall returns — a "closed" server that still
            # answers is exactly the zombie the fencing tests exist to
            # rule out. shutdown() wakes the acceptor with an error.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already disconnected/never listening
            self._sock.close()
        finally:
            with self._lock:
                conns, self._conns = self._conns, []
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass

    def __enter__(self) -> "BrokerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BrokerClient:
    """The ``InMemoryBroker`` surface, proxied over a ``BrokerServer`` socket.

    Drop-in where a broker object is expected:
    ``MemoryConsumer(BrokerClient(host, port), topic, group_id=...)`` gives a
    group-managed consumer whose membership lives in the SERVER process —
    several OS processes doing this share one real consumer group.

    Thread-safe via a per-client request lock (one in-flight RPC per
    client); a raising broker call re-raises the marshalled exception
    (CommitFailedError and friends cross the wire intact).

    Transport faults (connection reset/refused, socket timeout, a frame
    cut mid-read) surface as the RETRYABLE ``BrokerUnavailableError`` —
    never a raw ``OSError`` — and mark the socket dead so the next call
    reconnects. Pass ``retry`` (a ``resilience.RetryPolicy``) and the
    client retries such faults itself, reconnecting with the policy's
    jittered backoff: group membership lives broker-side, so a reconnect
    resumes the same member identity (the lease, if any, still has to be
    renewed in time — a retry storm longer than the session timeout gets
    fenced, exactly as it should). Safe because every proxied operation
    is idempotent or at-least-once-tolerant: polls re-fetch from the
    consumer position, commits carry absolute offsets, a re-sent produce
    can at worst duplicate a record the downstream is already required
    to tolerate.
    """

    def __init__(
        self, host: str, port: int, timeout_s: float = 30.0, retry=None,
        faults: WireFaults | None = None,
    ) -> None:
        self._host = host
        self._port = port
        self._timeout_s = timeout_s
        self._retry = retry
        # Wire-fault injection (ChaosTransport): every connection this
        # client opens — including reconnects — is wrapped with the SAME
        # plan, so the seeded schedule spans the client's whole life.
        self._faults = faults
        self._lock = threading.Lock()
        self._closed = False
        self._sock: socket.socket | None = None
        # Eager connect: config errors (wrong port) surface at
        # construction — through the policy, so a racing server start is
        # absorbed too.
        if retry is not None:
            retry.run(self._ensure_connected)
        else:
            self._ensure_connected()

    def _ensure_connected(self) -> None:
        with self._lock:
            if self._closed:
                raise ConnectionError("broker client is closed")
            self._connect_locked()

    def _connect_locked(self) -> None:
        if self._sock is not None:
            return
        from torchkafka_tpu_torch.errors import BrokerUnavailableError

        try:
            sock = socket.create_connection(
                (self._host, self._port), timeout=self._timeout_s
            )
        except OSError as exc:
            raise BrokerUnavailableError(
                f"broker {self._host}:{self._port} unreachable: {exc}"
            ) from exc
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = (
            ChaosTransport(sock, self._faults)
            if self._faults is not None else sock
        )

    def _call_once(self, method: str, args: tuple, kwargs: dict) -> Any:
        from torchkafka_tpu_torch.errors import BrokerUnavailableError

        with self._lock:
            if self._closed:
                raise ConnectionError("broker client is closed")
            self._connect_locked()
            try:
                _send(self._sock, (method, args, kwargs))
                status, value = _recv(self._sock)
            except (ConnectionError, OSError, EOFError) as exc:
                # The socket is in an unknown framing state: drop it so
                # the next attempt reconnects cleanly.
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise BrokerUnavailableError(
                    f"broker RPC {method!r} failed mid-flight: {exc}"
                ) from exc
        if status == "err":
            raise value
        return value

    def _call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        if self._retry is None:
            return self._call_once(method, args, kwargs)
        return self._retry.run(lambda: self._call_once(method, args, kwargs))

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None

    def __enter__(self) -> "BrokerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- proxied broker surface (kept explicit: greppable + type-friendly)

    def create_topic(self, topic, partitions=1):
        return self._call("create_topic", topic, partitions)

    def partitions_for(self, topic):
        return self._call("partitions_for", topic)

    def produce(self, topic, value, **kw):
        return self._call("produce", topic, value, **kw)

    def end_offset(self, tp):
        return self._call("end_offset", tp)

    def fetch(self, tp, offset, max_records):
        return self._call("fetch", tp, offset, max_records)

    def offset_for_time(self, tp, timestamp_ms):
        return self._call("offset_for_time", tp, timestamp_ms)

    def join(self, group_id, member_id, topics, pattern=None):
        return self._call("join", group_id, member_id, topics, pattern=pattern)

    def leave(self, group_id, member_id):
        return self._call("leave", group_id, member_id)

    def group_state(self, group_id, member_id):
        return self._call("group_state", group_id, member_id)

    def commit(self, group_id, offsets, member_id=None, generation=None):
        return self._call(
            "commit", group_id, offsets,
            member_id=member_id, generation=generation,
        )

    def committed(self, group_id, tp):
        return self._call("committed", group_id, tp)

    def heartbeat(self, group_id, member_id, generation=None):
        return self._call("heartbeat", group_id, member_id, generation)

    def fence(self, group_id, member_id):
        return self._call("fence", group_id, member_id)

    def membership(self, group_id):
        return self._call("membership", group_id)

    def wait_for_data(self, timeout_s):
        # Cap the server-side block below the socket timeout so a quiet
        # broker never looks like a dead one.
        return self._call("wait_for_data", min(timeout_s, 5.0))

    # ---- transactions (KIP-98 surface over the socket) ----

    def init_producer_id(self, transactional_id):
        return self._call("init_producer_id", transactional_id)

    def begin_txn(self, producer_id, epoch):
        return self._call("begin_txn", producer_id, epoch)

    def txn_produce(self, producer_id, epoch, topic, value, **kw):
        return self._call("txn_produce", producer_id, epoch, topic, value, **kw)

    def txn_commit_offsets(
        self, producer_id, epoch, group_id, offsets,
        member_id=None, generation=None,
    ):
        return self._call(
            "txn_commit_offsets", producer_id, epoch, group_id, offsets,
            member_id=member_id, generation=generation,
        )

    def commit_txn(self, producer_id, epoch):
        return self._call("commit_txn", producer_id, epoch)

    def abort_txn(self, producer_id, epoch):
        return self._call("abort_txn", producer_id, epoch)

    def fetch_stable(self, tp, offset, max_records):
        return self._call("fetch_stable", tp, offset, max_records)

    def last_stable_offset(self, tp):
        return self._call("last_stable_offset", tp)

    # ---- replication (broker-cell surface over the socket) ----

    def repl_append(self, epoch, base, frames):
        return self._call("repl_append", epoch, base, frames)

    def repl_status(self, epoch=None):
        return self._call("repl_status", epoch)

    def repl_ping(self):
        return self._call("repl_ping")
