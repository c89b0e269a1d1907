"""The original torch-kafka surface, ``KafkaDataset`` plus ``auto_commit``,
over the port: the cases of ``test_compat.py`` (the README loop, a crash
mid-loop, the drop contract, the placeholder protocol, commit failures,
the two-worker signal path) with every name of the JAX package re-rooted
onto ``torchkafka_tpu_torch`` (the module's source is loaded with the
package name replaced and its classes are collected here, over a port
broker). The ``torchkafka`` shim stays the JAX distribution's, so its
import case is left out; a port-side counterpart checks the exports."""

import pathlib
import sys
import types

import pytest

import torchkafka_tpu_torch as ptk

_REF = pathlib.Path(__file__).with_name("test_compat.py")
_mod = types.ModuleType("_port_compat")
_mod.__file__ = str(_REF)
sys.modules[_mod.__name__] = _mod
exec(compile(_REF.read_text().replace("torchkafka_tpu", "torchkafka_tpu_torch"),
             str(_REF), "exec"), _mod.__dict__)
assert _mod.tk is ptk

TestSingleProcess = _mod.TestSingleProcess
TestMultiprocessing = _mod.TestMultiprocessing


class TestProtocolEdges(_mod.TestProtocolEdges):
    test_shim_package_imports = None  # the shim names the JAX package


@pytest.fixture
def broker():
    """The port's broker for the re-rooted cases (conftest's is JAX's)."""
    return ptk.InMemoryBroker()


def test_port_compat_exports_the_reference_names():
    from torchkafka_tpu_torch import compat
    from torchkafka_tpu_torch.compat.dataset import KafkaDataset

    assert compat.__all__ == ["KafkaDataset", "auto_commit"]
    assert compat.KafkaDataset is KafkaDataset
    assert "MULTIPROC_SCRIPT" in vars(_mod)
    assert "torchkafka_tpu_torch" in _mod.MULTIPROC_SCRIPT
