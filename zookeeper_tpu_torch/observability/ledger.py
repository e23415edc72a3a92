"""The program ledger: per-program cost accounting for a live process.

PyTorch runs eagerly, so there is no compiled executable to account.
The port's "program" is what a serving engine's warm-up makes ready:

- a ``(bucket, mesh)`` forward of ``InferenceEngine`` (kind
  ``serve_forward``);
- a ``(prefill bucket, seq bucket)`` prefill of ``DecodeEngine``
  (``prefill``), its warm-extend width grid (``prefill_extend``), the
  decode step (``decode_step``), each verify window ``verify_step/w{N}``
  under speculation, the copy-on-write page copy (``copy_page``) and
  the transfer gather and scatter (``gather_pages``, ``scatter_pages``);
  a speculative draft engine's programs carry its ``ledger_prefix``
  (``draft_decode_step``...);
- a ``TrainingExperiment`` step at one batch shape (``train_step``) and
  a fused slab at one slab shape (``multi_step``, ``attrs["steps"]`` its
  number of steps), made per run, as the JAX loop compiles its steps
  per run.

A program's "compile ms" is the wall time of its FIRST run, ended by a
device synchronisation: the kernel build and load, cuDNN's algorithm
choice and the caching allocator's growth all land there. Its FLOPs and
bytes are COUNTED from the layer shapes once, at that first run, never
timed: ``2*M*N*K`` for every conv, dense layer and matmul (packed, int8
or float alike), ``4 * head_dim`` per (query, key) pair and head for
attention (:class:`ContractionFlops`; a train step three times its
forward); bytes are the weights read once plus the inputs, outputs
and KV rows the program touches. A first run after the engine's
``warmup()`` is a serving stall the bucket ladder was meant to prevent:
the engines count it (``zk_serving_recompiles_total``).

- :class:`ProgramLedger` — a process-global, thread-safe, bounded
  record of every program a process warmed: kind, identity key, counted
  FLOPs and bytes, first-run wall time, dispatches. Every record bumps
  ``zk_compiles_total{kind=}`` / ``zk_compile_ms_total{kind=}`` in the
  default registry and renders as the ``/statusz`` ``programs`` section.
- :func:`mfu` / :func:`mbu` — FLOPs (bytes) / time / peak with total
  guards: the gauge math for ``zk_serve_mfu`` and ``zk_decode_mbu``
  (peaks from ``observability.peaks``).
- :func:`cost_flops` / :func:`cost_bytes` — a ledgered program's counted
  FLOPs or bytes, None when unknown.

The JAX package's ``LedgeredExecutable`` (a ``jax.jit`` wrapper doing
the AOT lower + compile) and ``cost_analysis_dict`` (XLA's cost
analysis) have no counterpart here: nothing is compiled ahead of time,
and the counts come from shapes.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry

__all__ = [
    "ContractionFlops",
    "ProgramLedger",
    "ProgramRecord",
    "cost_bytes",
    "cost_flops",
    "default_ledger",
    "mbu",
    "mfu",
    "recompile_counter",
]


def _count(value: Any) -> Optional[float]:
    """A finite, non-negative count as a float, else None."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if value == value and 0 <= value != float("inf") else None


@dataclass
class ProgramRecord:
    """One warmed program's ledger row."""

    kind: str
    key: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    #: The JAX ledger's AOT lowering time: nothing is lowered here.
    lower_ms: Optional[float] = None
    #: The first run's wall time, synchronised.
    compile_ms: Optional[float] = None
    memory: Dict[str, float] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)
    #: Monotonic registration ordinal (process lifetime order).
    ordinal: int = 0
    #: Wall-clock registration time (time.time(); for /statusz only).
    recorded_at: float = 0.0
    dispatches: int = 0

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind,
            "key": self.key,
            "ordinal": self.ordinal,
            "dispatches": self.dispatches,
        }
        if self.flops is not None:
            out["flops"] = self.flops
        if self.bytes_accessed is not None:
            out["bytes_accessed"] = self.bytes_accessed
        if self.lower_ms is not None:
            out["lower_ms"] = round(self.lower_ms, 3)
        if self.compile_ms is not None:
            out["compile_ms"] = round(self.compile_ms, 3)
        if self.memory:
            out["memory"] = dict(self.memory)
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class ProgramLedger:
    """Thread-safe, bounded record of every program this process warmed.
    Appends are cheap (first runs are rare by construction); readers
    snapshot under the lock. ``max_records`` bounds memory (the oldest
    rows are evicted — their counters survive in the registry totals)."""

    def __init__(self, max_records: int = 512, registry=None) -> None:
        self._lock = threading.Lock()
        self._records: List[ProgramRecord] = []
        self._max_records = int(max_records)
        self._ordinal = 0
        self._registry = registry

    def _reg(self):
        return self._registry if self._registry is not None else default_registry()

    def record(
        self,
        kind: str,
        key: str,
        *,
        flops: Optional[float] = None,
        bytes_accessed: Optional[float] = None,
        compile_ms: Optional[float] = None,
        memory: Optional[Dict[str, float]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> ProgramRecord:
        """Register one warmed program. Counts that are not finite and
        non-negative are recorded as unknown (None). Never raises on a
        registry conflict — the dispatch that warmed it must not."""
        rec = ProgramRecord(
            kind=str(kind),
            key=str(key),
            flops=_count(flops),
            bytes_accessed=_count(bytes_accessed),
            compile_ms=compile_ms,
            memory=dict(memory or {}),
            attrs=dict(attrs or {}),
            recorded_at=time.time(),
        )
        with self._lock:
            self._ordinal += 1
            rec.ordinal = self._ordinal
            self._records.append(rec)
            if len(self._records) > self._max_records:
                del self._records[: len(self._records) - self._max_records]
        try:
            reg = self._reg()
            reg.counter(
                "zk_compiles_total",
                help="programs warmed (ledger-recorded), by kind",
                labels={"kind": rec.kind},
            ).inc()
            if compile_ms is not None:
                reg.counter(
                    "zk_compile_ms_total",
                    help="cumulative first-run wall time, by kind",
                    labels={"kind": rec.kind},
                ).inc(max(0.0, float(compile_ms)))
        except Exception:  # registry conflicts must not kill a dispatch
            pass
        if _trace.enabled():
            _trace.event(
                "program_compiled",
                attrs={
                    "kind": rec.kind,
                    "key": rec.key,
                    "compile_ms": (
                        round(compile_ms, 1) if compile_ms is not None else None
                    ),
                },
            )
        return rec

    def entries(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records)

    def latest(self, kind: Optional[str] = None) -> Optional[ProgramRecord]:
        """Newest record (of ``kind``, when given)."""
        with self._lock:
            for rec in reversed(self._records):
                if kind is None or rec.kind == kind:
                    return rec
        return None

    def total_compile_ms(self) -> float:
        with self._lock:
            return sum(r.compile_ms or 0.0 for r in self._records)

    def as_status(self) -> Dict[str, Any]:
        """The ``/statusz`` ledger section: per-program rows (newest
        first, capped) + totals."""
        with self._lock:
            records = list(self._records)
        return {
            "programs": [r.as_dict() for r in reversed(records)][:64],
            "count": len(records),
            "total_compile_ms": round(sum(r.compile_ms or 0.0 for r in records), 1),
        }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_DEFAULT = ProgramLedger()


def default_ledger() -> ProgramLedger:
    """The process-global ledger every engine records into (``/statusz``
    renders it whole)."""
    return _DEFAULT


def recompile_counter():
    """``zk_serving_recompiles_total`` in the default registry: a
    program's first run on a serving path after ``warmup()``. The
    engines register it at bind, so it renders (0) before any stall."""
    return default_registry().counter(
        "zk_serving_recompiles_total",
        help="post-warmup first runs of a program on the request path (each one is "
        "a serving stall)",
    )


class ContractionFlops:
    """Forward hooks counting ``2*M*N*K`` over ``module``'s contraction
    layers while the context is open: a conv (``Conv``, ``QuantConv``,
    ``QuantConvND``) contributes ``2 * out.numel() * prod(kernel_size) *
    (in_channels / groups)``, a dense layer (``Dense``, ``QuantDense``,
    the LM's ``_Linear``) ``2 * out.numel() * in_features``, whatever path
    (packed, int8, float) computes it, and the LM's weight-tied head ``2 *
    logits.numel() * d_model``. ``flops`` holds the sum. ``pair_flops``
    counts each LM block's causal attention: ``4 * head_dim`` per (query,
    key) pair with the key at or before the query, per head.

    A train step's FLOPs (:meth:`train_step_flops`) are the forward's
    contractions times 3 (the backward computes two products of each
    forward one's size: the input's gradient and the weight's) plus the
    attention at ``12 * head_dim`` a pair and head (4 forward, 8
    backward: the flash backward recomputes the scores and takes dV, dP,
    dQ and dK)."""

    def __init__(self, module: Any) -> None:
        from zookeeper_tpu_torch.models.transformer import TransformerLMModule, _Block, _Linear
        from zookeeper_tpu_torch.ops.layers import Conv, Dense, QuantConv, QuantConvND, QuantDense

        self.flops = 0
        self.pair_flops = 0
        self._module = module
        self._convs = (Conv, QuantConv, QuantConvND)
        self._denses = (Dense, QuantDense, _Linear)
        self._blocks = _Block
        self._heads = TransformerLMModule
        self._handles = []

    def _hook(self, layer, inputs, out) -> None:
        x = inputs[0]
        if isinstance(layer, self._blocks):
            b, s = int(x.shape[0]), int(x.shape[1])
            heads = layer.num_heads // (layer._tp_attn.size if layer._tp_attn is not None else 1)
            self.pair_flops += 4 * layer.head_dim * heads * b * (s * (s + 1) // 2)
            return
        if isinstance(layer, self._heads):
            k = int(layer.d_model)
        elif isinstance(layer, self._convs):
            k = int(np.prod(layer.kernel_size)) * (int(x.shape[-1]) // int(layer.groups))
        else:
            k = int(x.shape[-1])
        self.flops += 2 * int(out.numel()) * k

    def train_step_flops(self) -> int:
        """The counted forward as a train step: ``3 * flops + 3 *
        pair_flops`` (see the class docstring)."""
        return 3 * self.flops + 3 * self.pair_flops

    def __enter__(self) -> "ContractionFlops":
        kinds = self._convs + self._denses + (self._blocks, self._heads)
        self._handles = [m.register_forward_hook(self._hook)
                         for m in self._module.modules() if isinstance(m, kinds)]
        return self

    def __exit__(self, *exc) -> bool:
        for handle in self._handles:
            handle.remove()
        self._handles = []
        return False


def cost_flops(program: Any) -> Optional[float]:
    """A ledgered program's counted FLOPs (a :class:`ProgramRecord`, or
    anything with a ``flops`` attribute), or None when unknown."""
    return _count(getattr(program, "flops", None))


def cost_bytes(program: Any) -> Optional[float]:
    """A ledgered program's counted bytes, or None when unknown."""
    return _count(getattr(program, "bytes_accessed", None))


# -- MFU / MBU gauge math ------------------------------------------------


def mfu(
    flops: Optional[float],
    seconds: Optional[float],
    peak_flops: Optional[float],
) -> Optional[float]:
    """Model FLOPs utilization: ``flops / seconds / peak``. Returns None
    unless every input is a positive finite number — a gauge update must
    never raise, and a nonsense ratio (0-time, unknown count) must render
    as "unknown" (the gauges publish -1), not as 0% or infinity."""
    try:
        flops, seconds, peak_flops = float(flops), float(seconds), float(peak_flops)
    except (TypeError, ValueError):
        return None
    if not (flops > 0 and seconds > 0 and peak_flops > 0):
        return None
    value = flops / seconds / peak_flops
    return value if value == value and value != float("inf") else None


def mbu(
    bytes_accessed: Optional[float],
    seconds: Optional[float],
    peak_bytes_per_sec: Optional[float],
) -> Optional[float]:
    """Memory-bandwidth utilization: ``bytes / seconds / bandwidth`` —
    the roofline lens for memory-bound programs (a decode step reads the
    weights and the live KV rows every token; its MFU is low by
    construction). Same totality contract as :func:`mfu`. The decode
    engine passes each dispatch's counted bytes (the weights once plus
    the live K/V rows and their scales, ``DecodeEngine._step_bytes``):
    the bytes the step must read, so the ratio cannot pass 1 on a card
    that meets its data-sheet bandwidth — unlike the JAX gauge, whose
    bytes come from XLA's static analysis of the full buffers (an upper
    bound)."""
    return mfu(bytes_accessed, seconds, peak_bytes_per_sec)
