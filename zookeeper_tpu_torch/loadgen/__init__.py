"""Trace-driven load generation and replay, the port of
``zookeeper_tpu.loadgen``.

``traces`` makes seeded arrival traces (Poisson bursts, diurnal ramps,
heavy-tailed prompt and output lengths, multi-turn sessions over a
shared prefix) and turns recorded ``RequestLog`` JSON back into a
trace; ``harness`` replays a trace against a serving target (a
``DecodeScheduler``, a ``MicroBatcher``, a ``FleetRouter`` over worker
processes, a callable), optionally under a ``FaultPlan``, and reports an
:class:`SLOReport`. Every sampled value derives from ``AugRng(seed,
request_index, FIELD_STREAM)``: the same seed gives the same trace as
the JAX package's, byte for byte.
"""

from zookeeper_tpu_torch.loadgen.harness import ReplayOutcome, SLOReport, replay
from zookeeper_tpu_torch.loadgen.traces import (
    Trace,
    TraceRequest,
    diurnal_ramp,
    from_request_log,
    poisson_burst,
    session_mix,
)

__all__ = [
    "ReplayOutcome",
    "SLOReport",
    "Trace",
    "TraceRequest",
    "diurnal_ramp",
    "from_request_log",
    "poisson_burst",
    "replay",
    "session_mix",
]
