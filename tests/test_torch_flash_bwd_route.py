"""The rule that picks the port's flash-backward kernel on a CUDA tensor
(``ops/flash.py _route``, one rule for both directions), and the wrappers' counters on the CPU."""

import pytest
import torch

from torchkafka_tpu_torch.ops import flash


@pytest.mark.parametrize(
    "dtype,d,route",
    [
        (torch.bfloat16, 16, "tc"),
        (torch.bfloat16, 64, "tc"),
        (torch.bfloat16, 128, "tc"),
        (torch.bfloat16, 112, "tc"),
        (torch.float32, 64, "simt"),
        (torch.float32, 128, "simt"),
        (torch.bfloat16, 40, "simt"),  # not a multiple of 16
        (torch.bfloat16, 8, "simt"),
    ],
)
def test_route_rule(dtype, d, route):
    assert flash._route(dtype, d) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_refuses_head_dims_past_128(dtype):
    """Head dims past the tensor-core kernels' 128 take the CUDA-core
    backward (32-row tiles there), in bf16 and in f32: no refusal below
    ``_D_MAX``."""
    assert flash._route(dtype, 160) == "simt"
    assert flash._route(dtype, 256) == "simt"


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_wrappers_refuse_head_dims_past_256(which):
    """D > 256 still raises, through the wrappers' ``_check``, as the
    forward does."""
    q = torch.zeros(2, 8, 272)
    lse = torch.zeros(2, 8, 1)
    fn = flash.flash_dq_bhsd if which == "dq" else flash.flash_dkv_bhsd
    with pytest.raises(ValueError, match="<= 256"):
        fn(q, q, q, q, lse, lse)


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors the backward wrappers run the plain versions and
    count nothing, bf16 at a tensor-core head dim included."""
    q, k, v, do = (torch.randn(n, 32, 16, generator=torch.Generator().manual_seed(n))
                   .to(torch.bfloat16) for n in (4, 2, 2, 4))
    kw = dict(causal=True, n_q_heads=2, n_kv_heads=1)
    o, lse = flash.flash_fwd_bhsd(q, k, v, **kw)
    before = [(fn.launches, fn.tc_launches)
              for fn in (flash.flash_dq_bhsd, flash.flash_dkv_bhsd)]
    dq, dk, dv = flash.flash_bwd_bhsd(q, k, v, o, lse, do, **kw)
    after = [(fn.launches, fn.tc_launches)
             for fn in (flash.flash_dq_bhsd, flash.flash_dkv_bhsd)]
    assert before == after
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
