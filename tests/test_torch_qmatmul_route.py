"""The rule that picks the port's int8 weight-matmul kernel on a CUDA tensor
(``ops/qmatmul.py _route``), and the wrapper's counters on the CPU."""

import pytest
import torch

from torchkafka_tpu_torch.ops import qmatmul
from torchkafka_tpu_torch.ops.qmatmul import _route, quantized_matmul


@pytest.mark.parametrize(
    "dtype,k,n,aligned,route",
    [
        (torch.bfloat16, 4096, 14336, True, "tc"),  # 8b w_gate
        (torch.bfloat16, 14336, 4096, True, "tc"),  # 8b w_down
        (torch.bfloat16, 4096, 128256, True, "tc"),  # 8b lm_head
        (torch.bfloat16, 512, 256, True, "tc"),
        (torch.float32, 4096, 14336, True, "simt"),  # TF32 would round x
        (torch.float32, 512, 256, True, "simt"),
        (torch.bfloat16, 4096, 4104, True, "simt"),  # N % 16 != 0
        (torch.bfloat16, 4104, 4096, True, "simt"),  # K % 16 != 0
        (torch.bfloat16, 4096, 14336, False, "simt"),  # a misaligned operand
    ],
    ids=["w_gate", "w_down", "lm_head", "k512_n256", "f32_w_gate", "f32_k512",
         "n_ragged", "k_ragged", "misaligned"],
)
def test_route_rule(dtype, k, n, aligned, route):
    assert _route(dtype, k, n, aligned) == route


def test_misaligned_data_ptr_routes_to_the_cuda_cores():
    """A view one bf16 element into its storage is 2 bytes off the
    16-byte copies the tensor-core kernel issues: the wrapper's alignment
    test sends it to the CUDA cores."""
    base = torch.zeros(16 * 512 + 8, dtype=torch.bfloat16)
    x = base[1: 1 + 16 * 512].view(16, 512)
    assert x.data_ptr() % 16 == 2
    assert _route(x.dtype, 512, 256, x.data_ptr() % 16 == 0) == "simt"
    assert _route(x.dtype, 512, 256, base.data_ptr() % 16 == 0) == "tc"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_nothing(dtype):
    """On CPU tensors the wrapper runs the plain version and leaves both
    counters alone, bf16 at a tensor-core shape included."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (512, 256), generator=gen, dtype=torch.int8)
    scale = torch.rand(256, generator=gen) * 0.01
    x = torch.randn(16, 512, generator=gen).to(dtype)
    before = (quantized_matmul.launches, quantized_matmul.tc_launches)
    got = quantized_matmul(x, q, scale)
    assert (quantized_matmul.launches, quantized_matmul.tc_launches) == before
    assert got.dtype == dtype and got.shape == (16, 256)
    assert torch.equal(got, qmatmul.quantized_matmul_plain(x, q, scale[None]))
