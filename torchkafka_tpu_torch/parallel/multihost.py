"""Multi-process wiring: process-group init, pod-aligned consumers, watchdog.

Port of ``torchkafka_tpu/parallel/multihost.py``. The JAX package brings
up ``jax.distributed`` across the hosts of a pod; the port brings up a
``torch.distributed`` process group across ranks, one process per rank.

``initialize`` applies two written rules, both fixed before the group
starts and never changed after a failure:

- **Device rule.** With ``device="cpu"`` every rank takes the CPU.
  Otherwise local rank r takes ``cuda:r`` when r is below the device
  count, and ranks beyond it share the cards in turn
  (``cuda:(r % device_count)``); no card raises.
- **Backend rule.** ``nccl`` when every rank of the host has a card of
  its own; ``gloo`` when ranks share a card (NCCL refuses two ranks on one
  device) or run on the CPU, and for a group of one process. Under gloo a
  CUDA tensor's collectives stage through host memory.

``rules()`` reports both choices. The group's timeout (init and every
collective) defaults to 300 s, well under gloo's 30-minute default, so a
wedged peer surfaces as an error; a dead peer closes its connections and
surfaces at once. ``initialize`` also makes a group of its own for the
commit barrier: the barrier may run on ``commit_async``'s thread, and
collectives of one group must come in the same order on every rank, which
two threads sharing a group could not promise.

``BarrierWatchdog``: the barrier fails *closed* (nothing commits if a
process is gone: records re-deliver), but a collective over a wedged peer
can hang until the group's timeout; the watchdog turns "hung longer than
timeout" into an explicit action (log, callback, optional exit 42) so the
orchestrator can restart the job instead of wedging.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import Any, Callable, Sequence

import torch

from torchkafka_tpu_torch.commit.barrier import CommitBarrier
from torchkafka_tpu_torch.parallel.mesh import process_count, process_index
from torchkafka_tpu_torch.source.assignment import partitions_for_process
from torchkafka_tpu_torch.source.records import TopicPartition
from torchkafka_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0

# What this process's group was started with (rules(), ensure_group()).
_STATE: dict[str, Any] = {}


def device_for_rank(local_rank: int, device: str | torch.device | None = None) -> torch.device:
    """The device rule: ``cpu`` for every rank when asked for, else
    ``cuda:r`` for local rank r below the device count and the cards in
    turn beyond it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        resolve_device(None)  # the device rule's error: no card, no CPU asked for
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(dev: torch.device, local_world: int) -> str:
    """The backend rule: ``nccl`` when every rank of the host has a card
    of its own, else ``gloo`` (shared cards, the CPU, one process)."""
    if dev.type == "cuda" and 1 < local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rules() -> dict:
    """The device and backend rules' choices for this process (empty
    before ``initialize`` or ``make_mesh`` started a group)."""
    return dict(_STATE.get("rules", {}))


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Bring up ``torch.distributed`` if needed. → (process_index,
    process_count).

    Idempotent: a no-op when a group is already up or for one process.
    Arguments left None come from ``torch.distributed.run``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). ``coordinator_address`` is
    ``host:port`` of rank 0's store. All ranks are taken to run on one
    host (local rank = rank) unless the environment says otherwise."""
    dist = torch.distributed
    if dist.is_initialized():
        return process_index(), process_count()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None or world <= 1:
        return 0, 1
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("process_id is required (or RANK in the environment)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    dev = device_for_rank(local_rank, device)
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _started(dev, backend, local_rank, local_world, timeout_s)
    return rank, world


def _started(dev: torch.device, backend: str, local_rank: int, local_world: int,
             timeout_s: float) -> None:
    dist = torch.distributed
    # The commit barrier's own group (see the module note). Every rank
    # creates it here, in the same order relative to any later group.
    barrier_group = dist.new_group(backend="gloo") if dist.get_world_size() > 1 else None
    _STATE.update(
        device=dev, barrier_group=barrier_group,
        rules={"device": str(dev), "backend": backend, "local_rank": local_rank,
               "local_world_size": local_world,
               "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
               "ranks_per_card": (-(-local_world // torch.cuda.device_count())
                                  if dev.type == "cuda" else None),
               "timeout_s": timeout_s},
    )


def ensure_group(device: str | torch.device | None = None) -> torch.device:
    """This rank's device, starting a one-process group on an in-process
    store when none is up (so a mesh can be built on one process, as the
    JAX package's ``make_mesh`` can). ``device`` names it; None takes the
    one ``initialize`` chose, or the device rule for this rank."""
    dist = torch.distributed
    if not dist.is_initialized():
        dev = device_for_rank(0, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
        _started(dev, "gloo", 0, 1, DEFAULT_TIMEOUT_S)
    if device is None and "device" in _STATE:
        return _STATE["device"]
    return device_for_rank(dist.get_rank(), device)


def barrier_group():
    """The group the commit barrier synchronises on: the one
    ``initialize`` made for it, else the default group."""
    return _STATE.get("barrier_group")


def shutdown() -> None:
    """Tear down the process group (and forget the rules' choices)."""
    dist = torch.distributed
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def pod_partitions(topic: str, num_partitions: int) -> list[TopicPartition]:
    """The partition slice this process owns under mesh-aligned
    assignment."""
    return partitions_for_process(topic, num_partitions, process_index(), process_count())


def pod_consumer(
    topic: str,
    num_partitions: int,
    group_id: str,
    *,
    transport: Callable[..., Any] | None = None,
    assignment: Sequence[TopicPartition] | str | None = "mesh",
    **consumer_kwargs: Any,
):
    """Build this process's consumer.

    ``assignment='mesh'`` (default): static slice via ``pod_partitions``:
    deterministic and rebalance-free, right when the process count is
    fixed. ``assignment=None``: join the consumer group and let the broker
    assign (elastic, survives process replacement). ``transport`` defaults
    to the kafka-python adapter; pass ``functools.partial(MemoryConsumer,
    broker)`` for tests."""
    if transport is None:
        from torchkafka_tpu_torch.source.kafka import KafkaConsumer

        transport = KafkaConsumer
    if assignment == "mesh":
        assignment = pod_partitions(topic, num_partitions)
    return transport(topic, group_id=group_id, assignment=assignment, **consumer_kwargs)


class BarrierWatchdog:
    """Wraps a CommitBarrier; fires ``on_timeout`` if one barrier call
    hangs.

    Default action logs CRITICAL and, when ``exit_on_timeout``, terminates
    the process with ``exit_code``: a restart from the last commit is
    strictly better than a wedged collective (nothing was committed, so no
    data is lost; the group/checkpoint resume path takes over)."""

    def __init__(
        self,
        barrier: CommitBarrier | None = None,
        *,
        timeout_s: float = 300.0,
        first_grace_s: float | None = None,
        on_timeout: Callable[[], None] | None = None,
        exit_on_timeout: bool = False,
        exit_code: int = 42,
    ) -> None:
        self._barrier = barrier if barrier is not None else CommitBarrier()
        self._timeout_s = timeout_s
        # The FIRST barrier call legitimately includes start-up skew (one
        # process may build kernels or load weights for minutes while its
        # peers wait at the barrier): a steady-state timeout there would
        # exit-42 a healthy job into a crash loop. Default grace: 6x the
        # timeout, floor 1800 s.
        self._first_grace_s = (
            first_grace_s if first_grace_s is not None else max(6 * timeout_s, 1800.0)
        )
        self._first_done = False
        self._exit = exit_on_timeout
        self._exit_code = exit_code
        self._on_timeout = on_timeout
        self.timed_out = False

    def fence(self, wait_for: Any) -> Any:
        """The wrapped barrier's step fence (``CommitToken.commit_async``
        records it on the caller's thread)."""
        return self._barrier.fence(wait_for)

    def _fire(self) -> None:
        self.timed_out = True
        logger.critical(
            "commit barrier exceeded %.0fs — a pod member is likely dead; "
            "nothing was committed (fail-closed), records will re-deliver",
            self._timeout_s,
        )
        if self._on_timeout is not None:
            self._on_timeout()
        if self._exit:  # pragma: no cover - kills the test process
            os._exit(self._exit_code)

    def __call__(self, wait_for: Any = None) -> None:
        timeout = self._timeout_s if self._first_done else self._first_grace_s
        timer = threading.Timer(timeout, self._fire)
        timer.daemon = True
        timer.start()
        try:
            self._barrier(wait_for)
            self._first_done = True
        finally:
            timer.cancel()
