"""Count how often a ``BrokerClient`` call succeeds after its
``BrokerServer`` was closed (``test_netbroker.py::TestReconnect::
test_no_policy_still_translates_but_does_not_retry`` fails when it does).

    python tests/netbroker_close_race.py PACKAGE MODE RUNS

PACKAGE is ``torchkafka_tpu`` or ``torchkafka_tpu_torch``; MODE is

- ``loop``: the test's own steps, RUNS times (run it beside busy
  processes to load the machine);
- ``slow_accept``: the same, with every ``accept()`` held 50 ms after it
  returns, before the server registers the connection;
- ``reuse``: another server binds the freed port before the call.

Run from the repo root with the root on ``PYTHONPATH``."""

import importlib
import socket
import sys
import time


def main() -> None:
    pkg, mode, runs = sys.argv[1], sys.argv[2], int(sys.argv[3])
    nb = importlib.import_module(pkg + ".source.netbroker")
    memory = importlib.import_module(pkg + ".source.memory")
    errors = importlib.import_module(pkg + ".errors")
    if mode == "slow_accept":
        accept = socket.socket.accept

        def slow(self):
            got = accept(self)
            time.sleep(0.05)
            return got

        socket.socket.accept = slow
    served = 0
    for _ in range(runs):
        server = nb.BrokerServer(memory.InMemoryBroker())
        client = nb.BrokerClient(server.host, server.port)
        port = server.port
        server.close()
        other = (nb.BrokerServer(memory.InMemoryBroker(), port=port)
                 if mode == "reuse" else None)
        try:
            client.wait_for_data(0.01)
            served += 1
        except errors.BrokerUnavailableError:
            pass
        client.close()
        if other is not None:
            other.close()
    print(f"{pkg} {mode}: {served} of {runs} calls answered after close()")


if __name__ == "__main__":
    main()
