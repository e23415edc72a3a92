"""Observability for the port: host-side span tracing, typed metrics,
live export, program accounting and the flight recorder.

The port of ``zookeeper_tpu/observability`` (its own copy: nothing here
imports the JAX package). Everything is zero-cost until opted in: with
tracing off, no endpoint and no recorder, a serving dispatch adds no
device synchronisation and no launch, and the wall time observed is
the dispatch's existing readback.

- ``trace`` — ``span()``/``event()`` into a bounded ring buffer with a
  Chrome trace-event exporter: host phases (batcher coalescing, engine
  dispatches, the decode scheduler's speculative windows) open in
  Perfetto beside the ``torch.profiler`` device trace.
- ``registry`` — Counter/Gauge/Histogram instruments behind a typed
  name table; ``ServingMetrics``, ``DecodeMetrics`` and the
  process-wide gauges record into it.
- ``export`` — Prometheus text exposition + a stdlib HTTP
  ``/metrics``-``/statusz``-``/trace``-``POST /debugz`` endpoint
  (``ServingConfig.metrics_port`` / ``LMServingConfig.metrics_port``
  opt in).

The device-side half:

- ``ledger`` — the process-global program ledger: each program a
  serving engine warms (a bucket's forward, a prefill bucket, the
  decode step, a verify window) or a training run first runs (a step
  shape, a fused slab shape), its FLOPs and bytes counted from the
  layer shapes, its first-run wall time; feeds ``zk_serve_mfu`` /
  ``zk_decode_mbu`` / ``zk_train_mfu`` and the ``/statusz``
  ``programs`` section.
- ``watchdog`` — EWMA+MAD step-time anomaly detection over the
  dispatch duration stream (``step_time_anomaly`` events + counters).
- ``device`` — the ``zk-device-probe`` poller of the caching
  allocator's counters behind the live ``zk_hbm_*`` gauges.
- ``peaks`` — the NVIDIA data-sheet peaks the gauges and the
  profiler's roofline divide by.

The request-scoped half:

- ``requests`` — monotone rid minting + the bounded per-service
  ``RequestLog`` of terminal request summaries; rids tag trace records
  and render as Chrome flow events.
- ``recorder`` — the anomaly-triggered ``FlightRecorder``: watchdog
  anomalies, recompiles, worker crashes and manual ``POST /debugz``
  dump a rate-limited, bounded-retention bundle (trace ring + exposition
  text + ledger + statusz + RequestLog tails + manifest).

The JAX package's ``LedgeredExecutable`` (its ``jax.jit`` compile-seam
wrapper) and ``cost_analysis_dict`` (XLA's cost analysis) have no
counterpart: eager PyTorch compiles nothing ahead of time, and the
ledger's counts come from shapes.
"""

from zookeeper_tpu_torch.observability import trace
from zookeeper_tpu_torch.observability.device import DeviceProbe, device_memory_stats
from zookeeper_tpu_torch.observability.export import ObservabilityServer, render_prometheus
from zookeeper_tpu_torch.observability.ledger import (
    ProgramLedger,
    cost_flops,
    default_ledger,
    mfu,
)
from zookeeper_tpu_torch.observability.recorder import FlightRecorder
from zookeeper_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from zookeeper_tpu_torch.observability.requests import RequestLog, next_rid
from zookeeper_tpu_torch.observability.trace import (
    Tracer,
    event,
    export_chrome_trace,
    span,
    to_chrome_trace,
)
from zookeeper_tpu_torch.observability.watchdog import StepTimeWatchdog

__all__ = [
    "Counter",
    "DeviceProbe",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObservabilityServer",
    "ProgramLedger",
    "RequestLog",
    "StepTimeWatchdog",
    "Tracer",
    "cost_flops",
    "default_ledger",
    "default_registry",
    "device_memory_stats",
    "event",
    "export_chrome_trace",
    "mfu",
    "next_rid",
    "render_prometheus",
    "span",
    "to_chrome_trace",
    "trace",
]
