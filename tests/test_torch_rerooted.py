"""The reference's host test files run over the port: each module's source
is loaded with ``torchkafka_tpu`` re-rooted onto ``torchkafka_tpu_torch``
(``_torch_fleet_common.load_rerooted``) and its test classes and functions
are collected here.

- ``test_chaos.py`` (the chaos consumer, a stream under chaos, the
  Prometheus rendering), ``test_source.py`` (the broker and consumer
  group), ``test_shutdown.py`` (the shutdown signal and a SIGTERM drain of
  a port stream in a child process), ``test_commit_async.py``,
  ``test_fuzz_commit.py``, ``test_commit.py`` and ``test_bucket.py``: the
  copied host modules against their own reference cases.
- ``test_journal.py``'s ``TestFleetDrainJournal``: the port's fleet drain
  with journals (sync, prune, drain-timeout escalation) on the CPU.

A reference case that spells a JAX call has it bound to the port's: the
device value a commit waits for is a torch tensor (``test_commit.py``),
the per-width reduction of ``test_bucket.py`` runs eagerly in torch
(``jax.jit`` is the identity), the journal helpers' server default is
the port's CPU server, and the drain script of ``test_shutdown.py``
skips ``force_cpu_devices`` (the JAX package's virtual CPU devices; the
port's stream there never leaves the host)."""

import types

import pytest
import torch

import torchkafka_tpu_torch as ptk
from _torch_fleet_common import load_rerooted
from torchkafka_tpu_torch.serve import StreamingGenerator


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


_chaos = load_rerooted("test_chaos")
TestChaosConsumer = _chaos.TestChaosConsumer
TestStreamUnderChaos = _chaos.TestStreamUnderChaos
TestPrometheusRender = _chaos.TestPrometheusRender

_source = load_rerooted("test_source")
TestBroker = _source.TestBroker
TestConsumerBasics = _source.TestConsumerBasics
TestGroups = _source.TestGroups
TestManualAssignment = _source.TestManualAssignment
TestTimeAndFlowControl = _source.TestTimeAndFlowControl
TestPatternSubscription = _source.TestPatternSubscription
TestLag = _source.TestLag
TestRebalanceListener = _source.TestRebalanceListener

_shutdown = load_rerooted("test_shutdown", replace=[
    ("    from torchkafka_tpu.utils.devices import force_cpu_devices\n"
     "    force_cpu_devices(2)\n", ""),
])
TestShutdownSignal = _shutdown.TestShutdownSignal
TestGracefulDrain = _shutdown.TestGracefulDrain
TestHandlerEdges = _shutdown.TestHandlerEdges

_commit_async = load_rerooted("test_commit_async")
TestCommitAsync = _commit_async.TestCommitAsync

_fuzz = load_rerooted("test_fuzz_commit")
test_random_streams_hold_invariants = _fuzz.test_random_streams_hold_invariants

_commit = load_rerooted("test_commit", replace=[
    ("        import jax.numpy as jnp\n", "        import torch as jnp\n"),
])
TestLedger = _commit.TestLedger
TestBatcher = _commit.TestBatcher
TestCommitToken = _commit.TestCommitToken

_bucket = load_rerooted("test_bucket")
_bucket.jax = types.SimpleNamespace(jit=lambda fn: fn)
_bucket.jnp = types.SimpleNamespace(sum=torch.sum, arange=torch.arange,
                                    asarray=torch.as_tensor)
TestBucketBatcher = _bucket.TestBucketBatcher
TestBucketedStream = _bucket.TestBucketedStream

_journal = load_rerooted("test_journal", replace=[
    ("        from torchkafka_tpu.fleet import ServingFleet\n", ""),
])
# The reference helpers' ``cls=StreamingGenerator`` defaults were bound
# before the loader put the port's server on the CPU: rebind them.
for _fn in (_journal._reference, _journal._kill_run):
    _fn.__defaults__ = tuple(
        _journal.StreamingGenerator if d is StreamingGenerator else d
        for d in _fn.__defaults__
    )
model = _journal.model
TestFleetDrainJournal = _journal.TestFleetDrainJournal
