"""Profiler hooks: named spans for ingest and serving, and the lag gauge.

Port of ``torchkafka_tpu/utils/tracing.py``. On the card the profiler is
``torch.profiler`` (CUPTI); these helpers put the host loops' named
stages on its timeline as ``record_function`` ranges:

    with tracing.trace_session("/tmp/trace"):
        for i, (batch, token) in enumerate(stream):
            with tracing.step_span(i):
                params, opt, loss = step_fn(params, opt, batch.data, None)
                token.commit(wait_for=loss)
    # then open /tmp/trace/trace.json in chrome://tracing or Perfetto

Span names for the serving stages live here too, so a recipe and the
server agree on them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch

# Serving span names (one place, so the README recipe and serve.py agree).
SPAN_ADMIT = "tk_serve:admit"
SPAN_CHUNK_PACK = "tk_serve:chunk_pack"
SPAN_TICK = "tk_serve:tick"
SPAN_SYNC = "tk_serve:sync"
SPAN_COMMIT = "tk_serve:commit"


@contextlib.contextmanager
def trace_session(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host and, where present, CUDA activity)
    and write its Chrome trace to ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def step_span(step: int):
    """Annotate one training/inference step on the trace timeline."""
    return torch.profiler.record_function(f"tk_step:{step}")


def span(name: str):
    """Annotate an arbitrary host-side region (e.g. 'decode', 'commit')."""
    return torch.profiler.record_function(name)


def ingest_lag_ms(
    record_timestamp_ms: int,
    now_ms: float | None = None,
    clock: Callable[[], float] | None = None,
) -> float:
    """End-to-end lag: record append time -> now. The streaming SLO metric
    (how far behind the head of the topic the consumer is running).

    ``clock`` returns SECONDS on the same timeline record timestamps are
    stamped from (epoch seconds for real brokers) — inject a manual clock
    and lag becomes exactly testable instead of wall-clock-dependent;
    ``now_ms`` overrides both."""
    if now_ms is None:
        now_ms = (clock() if clock is not None else time.time()) * 1e3
    return max(0.0, now_ms - record_timestamp_ms) if record_timestamp_ms else 0.0
