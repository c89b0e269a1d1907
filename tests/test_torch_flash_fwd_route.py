"""The rule that picks the port's flash-forward kernel on a CUDA tensor
(``ops/flash.py _route``, which the backward shares), the forward wrapper's counters on the CPU,
and the build key of the kernels that share ``csrc/*.cuh``."""

import re

import pytest
import torch

import chip_smoke
from torchkafka_tpu_torch.ops import _native, flash


@pytest.mark.parametrize(
    "dtype,d,route",
    [
        (torch.bfloat16, 16, "tc"),
        (torch.bfloat16, 64, "tc"),
        (torch.bfloat16, 112, "tc"),
        (torch.bfloat16, 128, "tc"),  # every zoo scale
        (torch.bfloat16, 8, "simt"),  # not a multiple of 16
        (torch.bfloat16, 40, "simt"),
        (torch.bfloat16, 160, "simt"),  # past the tensor-core kernel's 128
        (torch.bfloat16, 256, "simt"),
        (torch.float32, 64, "simt"),
        (torch.float32, 128, "simt"),
    ],
)
def test_route_rule(dtype, d, route):
    assert flash._route(dtype, d) == route


@pytest.mark.parametrize("d,causal", [(16, True), (64, False)])
def test_cpu_tensors_launch_no_kernel(d, causal):
    """On CPU tensors the forward wrapper runs the plain version and counts
    nothing, bf16 at a tensor-core head dim included."""
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(n, 40, d, generator=gen).to(torch.bfloat16) for n in (4, 2, 2))
    kw = dict(causal=causal, n_q_heads=2, n_kv_heads=1)
    fwd = flash.flash_fwd_bhsd
    before = (fwd.launches, fwd.tc_launches)
    o, lse = fwd(q, k, v, **kw)
    assert (fwd.launches, fwd.tc_launches) == before
    ref_o, ref_lse = flash.flash_fwd_plain(q, k, v, **kw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(o, ref_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)


def _fake_csrc(tmp_path):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    return tmp_path


def test_build_key_follows_shared_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source: the library path of each
    ``csrc/<name>.cu`` hashes every ``csrc/*.cuh`` too."""
    monkeypatch.setattr(_native, "CSRC", _fake_csrc(tmp_path))
    first = _native._target("k")
    assert _native._target("k") == first  # unchanged sources load
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _native._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _native._target("k") not in (first, second)


def test_build_key_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "CSRC", _fake_csrc(tmp_path))
    first = _native._target("k")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _native._target("k") != first
    assert first.name.startswith("libk-") and first.parent == _native.BUILD


def test_included_headers_exist():
    """Every quoted include of a kernel source names a header in csrc/."""
    for name in _native.KERNELS:
        src = (_native.CSRC / f"{name}.cu").read_text()
        for header in re.findall(r'#include "([^"]+)"', src):
            assert (_native.CSRC / header).is_file(), (name, header)
    assert "flash_tc.cuh" in (_native.CSRC / "flash_fwd.cu").read_text()
    assert "flash_tc.cuh" in (_native.CSRC / "flash_bwd.cu").read_text()


def test_profile_lists_every_kernel():
    """The on-card profile reports each ``__global__`` kernel of csrc/ by
    name, the new tensor-core forward included."""
    names = set()
    for path in _native.CSRC.glob("*.cu"):
        src = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(\w+)\(", src))
    assert "flash_fwd_tc_kernel" in names
    assert names <= set(chip_smoke.PORT_KERNELS), names - set(chip_smoke.PORT_KERNELS)
