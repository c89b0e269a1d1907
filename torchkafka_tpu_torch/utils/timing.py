"""Device timing of a train step: CUDA events and the two-point slope.

Port of ``torchkafka_tpu/utils/timing.py``. Timing "run K steps, divide by
K" carries any constant per-window cost (the host's first enqueue, the
final synchronise) in every estimate; timing TWO window lengths and taking
the slope cancels the constant term. Here each window is timed by CUDA
events around K eager steps, so the number is device time once the host
keeps ahead of the card, and host-bound time where it cannot (the slope
then reports what the loop actually sustains).
"""

from __future__ import annotations

import statistics


def device_step_seconds(
    step_fn, params, opt_state, *batch_args,
    k_short: int = 2, k_long: int = 8, repeats: int = 3,
) -> tuple[float, bool]:
    """Seconds per train step on the card: (step_s, ok).

    ``step_fn(params, opt, *batch_args) -> (params, opt, loss)`` (the
    ``make_train_step`` shape). The port's step updates ``params`` and
    ``opt_state`` in place, so every timed step trains the model further;
    the JAX package's jitted loop left its inputs untouched. The batch
    must live on a CUDA device: this is a device measurement and refuses
    to time the CPU."""
    import torch

    tensors = [a for a in batch_args if isinstance(a, torch.Tensor)]
    if not tensors or not all(t.is_cuda for t in tensors):
        raise ValueError("device_step_seconds times CUDA steps only")

    def window(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        nonlocal params, opt_state
        start.record()
        for _ in range(k):
            params, opt_state, _loss = step_fn(params, opt_state, *batch_args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    window(k_short)  # warm: allocator, kernel builds, optimizer state
    shorts, longs = [], []
    for _ in range(repeats):  # interleaved: drift can't flip the slope
        shorts.append(window(k_short))
        longs.append(window(k_long))
    step_s, _overhead, ok = two_point_slope(
        statistics.median(shorts), statistics.median(longs), k_short, k_long
    )
    return step_s, ok


def two_point_slope(
    t_short: float, t_long: float, k_short: int, k_long: int
) -> tuple[float, float, bool]:
    """(per_iteration_s, overhead_s, ok).

    ``ok`` is False when the slope degenerates (t_long <= t_short): the
    timing drifted between the two windows by more than the work
    separating them, and nothing numeric can honestly be derived — callers
    must FLAG the measurement, not publish the floored values. The floored
    per-iteration value is still returned so callers can avoid division by
    zero while reporting the failure.
    """
    if k_long <= k_short:
        raise ValueError("k_long must exceed k_short")
    slope = (t_long - t_short) / (k_long - k_short)
    ok = slope > 0
    per_iter = max(slope, 1e-9)
    overhead = max(t_short - k_short * per_iter, 0.0)
    return per_iter, overhead, ok
