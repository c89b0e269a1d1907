"""Record-lifecycle observability (torchkafka_tpu_torch/obs).

Copy of ``torchkafka_tpu/obs/__init__.py`` (jax-free), its imports re-rooted onto
``torchkafka_tpu_torch``.

The reference has zero instrumentation (PAPER.md §5 tracing row) and the
repo's pre-existing metrics are four counter bags that can say *how many*
but never *where the time went for one record*. This package closes that
gap with three cooperating layers:

- ``trace`` — per-record lifecycle tracing keyed by the identity the whole
  repo already uses, ``(topic, partition, offset)``: typed span events at
  every stage boundary (polled → QoS-admitted → prefill-queued →
  chunk-scheduled → slot-active/first-token → token ticks → finished →
  committed, plus the warm-resume / journal-served / DLQ / deferral
  branches), through an injectable monotonic clock so same-seed chaos
  replays produce identical traces — the repo's differential style applied
  to observability itself. Bounded ring-buffer sink, JSONL export.
- ``slo`` — histograms DERIVED from the trace stream: time-to-first-token,
  inter-token latency, admission queue wait, end-to-end poll→commit,
  labeled by lane / tenant key / replica and pooled fleet-wide with the
  same sample-window merge the commit-latency percentiles use.
- ``burn`` — burn-rate overload detection over the windowed SLO view:
  per-scope error-budget burn over fast/slow trailing windows, a typed
  ok → warning → burning → shedding state machine whose transitions ride
  the trace stream, per-tenant goodput accounting, and the overload hook
  the fleet's AdmissionQueue consumes to prefer deferral over collapse.
- ``exporter`` — one pull-based Prometheus/OpenMetrics HTTP endpoint
  (stdlib ``http.server``, opt-in) exposing every metrics class through
  the shared renderer instead of four ad-hoc ``render_prometheus`` call
  sites.
"""

from torchkafka_tpu_torch.obs.burn import BurnRateMonitor, SLOTarget
from torchkafka_tpu_torch.obs.exporter import MetricsExporter
from torchkafka_tpu_torch.obs.slo import SLOHistograms, pooled_slo_summary
from torchkafka_tpu_torch.obs.trace import (
    STAGES,
    ObsConfig,
    RecordTrace,
    RecordTracer,
    TraceEvent,
)

__all__ = [
    "BurnRateMonitor",
    "MetricsExporter",
    "ObsConfig",
    "RecordTrace",
    "RecordTracer",
    "SLOHistograms",
    "SLOTarget",
    "STAGES",
    "TraceEvent",
    "pooled_slo_summary",
]
