"""The port's harness scenarios for the secondary models, on the CPU at
tiny size: 4 (PNG topic → host decode → ResNet-50 inference) and 8
(streaming DLRM training).

- ``tests/test_harness.py``'s cases for 4 and 8 re-rooted onto the port
  (``run_scenario`` with ``device="cpu"``, one run a scenario shared by
  the cases that read it).
- Each carries the JAX scenario's result keys (its CPU run's; the device
  timings that the JAX scenario adds on a TPU the port adds on CUDA), its
  sizes and its assertions: every record committed, nothing dropped, the
  PNG decode native, the loss trending down.
- Without a GPU and without ``device`` both raise the device rule's
  ``RuntimeError``; scenario 20 still raises with its ROADMAP title
  (3 trains over launched ranks: tests/test_torch_pod_train.py).
"""

import pytest
import torch

from _torch_fleet_common import load_rerooted
from torchkafka_tpu_torch.harness import PORTED, run_scenario

_RUNS: dict = {}


def _port(num: int, size: str = "tiny") -> dict:
    assert size == "tiny"
    if num not in _RUNS:
        _RUNS[num] = run_scenario(num, "tiny", device="cpu")
    return _RUNS[num]


_ref = load_rerooted("test_harness")
_ref.run_scenario = _port
test_scenario_8_trains = _ref.test_scenario_8_trains


@pytest.mark.parametrize("num", [4, 8])
def test_scenario_runs_and_reports(num):
    _ref.test_scenario_runs_and_reports(num)


# The JAX scenarios' result keys at tiny size on the CPU.
JAX_KEYS = {
    4: {"batches", "commit", "commit_failures", "compression", "device_infer_ms_per_batch",
        "dlq_delivery_failures", "dropped", "elapsed_s", "host_decode_ms_per_batch", "image",
        "ingest_lag_ms", "native_decode", "png_bytes_avg", "processor_errors", "quarantined",
        "records", "records_per_s", "scenario"},
    8: {"batches", "commit", "commit_failures", "dlq_delivery_failures", "dropped",
        "elapsed_s", "first_loss", "head_loss_mean", "ingest_lag_ms",
        "ingest_only_rows_per_s", "last_loss", "mesh", "ours_rows_per_s", "pair_ratios",
        "params_m", "processor_errors", "quarantined", "record_bytes", "records",
        "records_per_s", "reference_pattern_rows_per_s", "scenario", "step_ms_pure",
        "step_share_pct", "step_slope_ok", "tail_loss_mean", "vs_reference_pattern"},
}


@pytest.mark.parametrize("num", [4, 8])
def test_result_keys_are_the_jax_scenarios(num):
    assert num in PORTED
    assert JAX_KEYS[num] <= set(_port(num))


def test_scenario_4_decodes_and_infers():
    out = _port(4)
    assert out["scenario"] == "4:png-resnet-infer"
    assert out["records"] == 64 and out["batches"] == 8  # 64 PNGs, batch 8
    assert out["image"] == "png 64x64->64"
    assert out["native_decode"] is True
    assert 1.5 < out["compression"] < 2.5  # a real compressed payload
    assert out["host_decode_ms_per_batch"] > 0 and out["device_infer_ms_per_batch"] > 0
    assert "conv_mfu_pct" not in out  # the chained device timing is the card's


def test_scenario_8_one_device():
    out = _port(8)
    assert out["scenario"] == "8:streaming-ctr"
    assert out["mesh"] == {"data": 1}
    assert out["records"] == 24 * 4  # 24 steps of the one-device batch 4
    assert out["record_bytes"] == 4 * (1 + 4 + 3)
    assert out["step_slope_ok"] is False and out["step_ms_pure"] is None  # CUDA only
    assert out["ingest_only_rows_per_s"] > 0 and out["vs_reference_pattern"] > 0


def test_h100_peak_beside_the_hbm_rate():
    from torchkafka_tpu_torch.serve import H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_GBS

    assert H100_PEAK_BF16_FLOPS == 989e12 and H100_PEAK_HBM_GBS == 3350.0


@pytest.mark.parametrize("num", [4, 8])
def test_device_rule_without_cuda(monkeypatch, num):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(num, "tiny")


def test_scenario_20_serves_on_a_one_process_mesh():
    """Scenario 20 in one process: the mesh is one rank (the one-process
    group it starts, and ends), and the fleet serves and commits every
    record with the radix cache hitting (its four-rank run is
    tests/test_torch_serve_mesh.py's)."""
    was_up = torch.distributed.is_initialized()
    out = run_scenario(20, "tiny", device="cpu")
    assert torch.distributed.is_initialized() == was_up
    assert out["mesh"] == {"data": 1, "tp": 1}
    assert out["records"] == 24 and out["coverage_complete"] and out["committed_complete"]
    assert out["cache"]["hits"] > 0
