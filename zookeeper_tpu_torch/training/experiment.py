"""Experiment components: the configurable training loop and the eval
of an export.

The port of ``zookeeper_tpu/training/experiment.py``'s ``Experiment``,
``TrainingExperiment`` and ``EvalExperiment``::

    loader.batches() --prefetch--> device tensors
    state = TrainState(module, optimizer state, EMA)
    for epoch: for batch: state, metrics = train_step(state, batch)

One host readback per epoch (or per ``log_every`` steps) pulls the
step metrics. ``unroll > 1`` is the fused loop: slabs of ``unroll``
stacked batches through ``training.step.build_multi_step`` (one CUDA
graph replay a slab on the card), the metrics read back per slab only
when a ``log_every`` step falls in it. ``run()`` returns ``{"train":
[...], "validation": [...]}``, one dict of metric means per epoch
(``skipped_steps``, under a
``nan_policy``, summed). The training recipe's options are the JAX
loop's: the flip ratio, the parameter EMA (validation and the export
use it), ``nan_policy``, ``remat``, ``validate_every``, early stopping,
the model summary and ``export_model_to`` (a model-only export,
``training.checkpoint``).

Checkpoint and resume: ``checkpointer`` saves the state on a step and
epoch cadence, and a rerun restores the newest restorable step before
its first step and replays the (seed, epoch)-fixed pipeline from
``step % steps_per_epoch``, an exact mid-epoch resume. ``guard`` turns
SIGTERM/SIGINT (or a ``FaultPlan`` kill) into one synchronous save at the
next step boundary and a ``Preempted`` exit, which
``resilience.run_with_recovery`` resumes from. Under
``run_with_recovery(coordinator=...)`` over several processes the
boundary runs the group drain: a host whose guard tripped publishes a
stop flag, and every host exits, saved, at the first boundary at or past
the flag's step plus ``group_drain_margin_steps``.

The tools around a run: ``writer`` (``training.metrics``) gets the
``train/`` scalars at each ``log_every`` readback and the
``train_epoch/``/``val/`` scalars at each epoch's end, ``metrics_file``
one JSON record per epoch, and ``profile_dir`` a ``torch.profiler``
trace of a few steady-state steps of the first epoch
(``training.profiling``).

Data and sequence parallelism: ``partitioner`` (``parallel``) names the
mesh over the ranks, each rank's share of every global batch and the
collectives of the step; ``runtime`` forms the process group (from
``torch.distributed.run``'s environment, or an explicit coordinator).
Each rank runs on its own card (``cuda:LOCAL_RANK``; gloo CPU ranks with
``device=cpu``). Rank 0 alone logs, writes the metrics, the profile,
the checkpoints and the export; validation metrics are averaged over the
ranks. Under partition rules (``FsdpPartitioner``, a ``MeshPartitioner``
with a ``model`` axis, ``SequenceParallelPartitioner.tp``) each rank
holds its blocks of the sharded state (``parallel.shards``); the eval,
the checkpoints and the export gather them. Without a launcher there is
no group and no collective: the run is the single-card run, to the bit.

Observability (``observability``), as the JAX loop wires it: with
``trace_export`` set the run records host spans (``data_wait``,
``dispatch``, ``readback``, ``checkpoint``, with their step and slab,
beside the checkpointer's, the async writer's and the guard's) and
writes them as Chrome trace-event JSON at teardown, also when the run
raises; ``metrics_port >= 0`` serves ``/metrics`` and ``/statusz`` over
the default and the experiment's registry (``obs_registry``) with the
``zk_hbm_*`` probe, for the run's lifetime; ``flight_recorder_dir`` arms
a flight recorder, left installed after the run so the supervisor's
restarts bundle too. Always on: each epoch publishes
``zk_train_steps_total``, ``zk_train_epoch``, ``zk_train_<metric>`` and
``zk_val_<metric>``; each step shape (``train_step``) or slab shape
(``multi_step``, ``attrs["steps"]`` its size) is a ledger program,
counted and synchronised at its first run; each readback feeds the
``train_step`` watchdog and ``zk_train_step_time_ms``, ``zk_train_mfu``
(the program's FLOPs a step over the measured step time over the bf16
peak; -1 while unknown) and, for ``binary_compute="int8"`` models,
``zk_train_mfu_int8``; each iteration feeds the ``train_dispatch``
watchdog. Checkpoint saves, profiler windows and validation are marked
as stalls, so neither watchdog reads them as stragglers. A NaN halt
notifies the flight recorder before it raises. With all of it off, a
would-be span costs one flag check: no torch operator, no
synchronisation. The one synchronisation a run adds is at its first
step (the step program's first run; ``run_with_recovery`` reads the
same mark as the restore latency).
"""

import json
import logging
import math
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from zookeeper_tpu_torch.core import ComponentField, Field, component, pretty_print
from zookeeper_tpu_torch.data.pipeline import DataLoader
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.observability import DeviceProbe, ObservabilityServer
from zookeeper_tpu_torch.observability import ledger as _ledger
from zookeeper_tpu_torch.observability import peaks as _peaks
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import MetricsRegistry, default_registry
from zookeeper_tpu_torch.observability.watchdog import StepTimeWatchdog
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN
from zookeeper_tpu_torch.parallel import DistributedRuntime, Partitioner, SingleDevicePartitioner
from zookeeper_tpu_torch.parallel.distributed import local_device
from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.resilience.faults import NonFiniteLossError, Preempted
from zookeeper_tpu_torch.resilience.guard import PreemptionGuard
from zookeeper_tpu_torch.training.checkpoint import (
    Checkpointer,
    export_trees,
    load_inference_model,
    load_into_module,
    save_model,
)
from zookeeper_tpu_torch.training.metrics import CompositeMetricsWriter, MetricsWriter
from zookeeper_tpu_torch.training.optimizer import Adam, Optimizer
from zookeeper_tpu_torch.training.profiling import (
    ProfileWindow,
    format_breakdown,
    op_time_breakdown,
    slab_annotation,
)
from zookeeper_tpu_torch.training.state import TrainState
from zookeeper_tpu_torch.training.step import (
    NAN_POLICIES,
    REMAT_POLICIES,
    build_multi_step,
    make_eval_step,
    make_train_step,
    smoothed_softmax_cross_entropy,
)

logger = logging.getLogger(__name__)


@component
class Experiment:
    """Abstract experiment: subclasses implement run()."""

    def run(self) -> Any:
        raise NotImplementedError("Experiment subclasses must implement run().")


def _data_wait_iter(iterable, name: str = "data_wait"):
    """Each ``next()`` of a batch or slab iterator as a ``data_wait``
    span: the time the training thread waited on the input pipeline
    (near zero when the loop is compute-bound). One flag check and a
    generator hop a batch while tracing is off."""
    it = iter(iterable)
    while True:
        with _trace.span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


class _StepProgram:
    """A train step (``kind="train_step"``) or a fused slab
    (``"multi_step"``) as ledger programs: the first call at each input
    shape runs under the FLOP-counting hooks
    (``observability.ledger.ContractionFlops``: a step's FLOPs are its
    forward's contractions times 3 plus ``12 * head_dim`` per causal
    attention pair and head), ends in a device synchronisation and lands
    one ledger row with its wall time (for a slab, ``attrs["steps"]`` is
    its number of steps: the FLOPs divisor of ``zk_train_mfu``). Later
    calls at a known shape count a dispatch. ``ledger_entry`` is the row
    of the last call's shape. On the card the first slab of a
    ``MultiStep`` is its eager warm-up, so that row's wall time is the
    warm-up's; the capture follows at the next slab of the shape
    (``MultiStep.graphs[...].capture_s``)."""

    def __init__(self, fn, kind: str, prefix: str):
        self.fn = fn
        self.kind = kind
        self.prefix = prefix
        self.programs: Dict[tuple, Any] = {}
        self.ledger_entry = None

    def __call__(self, state: TrainState, batch):
        key = tuple(v.shape for v in batch.values())
        entry = self.programs.get(key)
        if entry is None:
            return self._first_run(state, batch, key)
        entry.dispatches += 1
        self.ledger_entry = entry
        return self.fn(state, batch)

    def _first_run(self, state: TrainState, batch, key):
        first = next(iter(batch.values()))
        counter = _ledger.ContractionFlops(state.module)
        t0 = time.perf_counter()
        with counter:
            out = self.fn(state, batch)
        if first.device.type == "cuda":
            torch.cuda.synchronize(first.device)
        compile_ms = (time.perf_counter() - t0) * 1e3
        shape = "x".join(str(d) for d in first.shape)
        attrs = {"steps": int(first.shape[0])} if self.kind == "multi_step" else {}
        entry = _ledger.default_ledger().record(
            self.kind, f"{self.prefix}/{shape}/{str(first.dtype).replace('torch.', '')}",
            flops=counter.train_step_flops(), compile_ms=compile_ms,
            attrs={"partitioner": self.prefix, **attrs})
        entry.dispatches += 1
        self.programs[key] = entry
        self.ledger_entry = entry
        return out


def _host_means(accum: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per-key means over the steps of a list of metric dicts (a step's
    0-d tensors, or a slab's ``[k]``), read back in one device-to-host
    copy; ``skipped_steps`` is a count, summed."""
    if not accum:
        return {}
    keys = list(accum[0])
    stacked = torch.stack([torch.cat([m[k].to(torch.float32).reshape(-1) for m in accum])
                           for k in keys])
    host = stacked.to(torch.float64).cpu()
    return {k: float(host[i].sum() if k == "skipped_steps" else host[i].mean())
            for i, k in enumerate(keys)}


def run_weighted_eval(loader, split, eval_step, state, device, epoch=0, *,
                      sharding=None, replicas=None) -> Dict[str, float]:
    """Eval loop: per-batch metric means weighted by the batch's example
    count, accumulated on the device, read back once. ``{}`` when the
    split yields no batches. Under a partitioner each rank scores its
    share of every batch (``sharding``) and the weighted sums and counts
    are summed over the ranks (``replicas``), so every rank returns the
    means over the whole split."""
    accum = None
    examples = 0
    for batch in loader.batches(split, device=device, epoch=epoch, training=False,
                                sharding=sharding):
        n = int(batch["target"].shape[0])
        m = eval_step(state, batch)
        weighted = {k: v.to(torch.float64) * n for k, v in m.items()}
        accum = weighted if accum is None else {k: accum[k] + weighted[k] for k in accum}
        examples += n
    if replicas is not None and accum is not None:
        keys = list(accum)
        sums = torch.stack([accum[k] for k in keys]
                           + [torch.tensor(float(examples), dtype=torch.float64, device=device)])
        replicas.sum_([sums])
        host = sums.cpu()
        return {k: float(host[i]) / float(host[-1]) for i, k in enumerate(keys)}
    if not examples:
        return {}
    return {k: float(v.cpu()) / examples for k, v in accum.items()}


@component
class TrainingExperiment(Experiment):
    """Supervised-classification training loop. ``batch_size`` set here
    is inherited by the loader through scoped field inheritance."""

    loader: DataLoader = ComponentField(DataLoader)
    model: Model = ComponentField()
    optimizer: Optimizer = ComponentField(Adam)
    #: The mesh over the ranks and each rank's share (``parallel``); the
    #: ImageNet and LM tasks default to ``DataParallelPartitioner``.
    partitioner: Partitioner = ComponentField(SingleDevicePartitioner)
    #: Forms the process group (a no-op without a launcher).
    runtime: DistributedRuntime = ComponentField(DistributedRuntime)
    checkpointer: Checkpointer = ComponentField(Checkpointer)
    #: Preemption safety: while training runs, SIGTERM/SIGINT set a flag
    #: checked at each step boundary; the loop then saves once,
    #: synchronously, and raises ``Preempted``. ``guard.enabled=False``
    #: keeps the signals' default effect.
    guard: PreemptionGuard = ComponentField(PreemptionGuard)
    #: Where the scalars go; off until a leg is configured, e.g.
    #: ``writer.jsonl.path=m.jsonl writer.tensorboard.log_dir=tb``.
    writer: MetricsWriter = ComponentField(CompositeMetricsWriter)

    epochs: int = Field(1)
    batch_size: int = Field(32)
    seed: int = Field(0)
    #: The fused loop: the train steps run in slabs of ``unroll``
    #: consecutive batches, stacked on the host and staged with one copy
    #: a tensor, through ``training.step.build_multi_step`` (one CUDA
    #: graph replay a slab on the card). The same steps on the same
    #: batches as the eager loop (1), to the bit; the metrics stay on
    #: the card until a ``log_every`` step's slab ends or the epoch
    #: does. Step-cadence checkpoints, ``log_every`` lines, preemption
    #: and the profiler window move to slab ends. Costs ``unroll`` batches
    #: of device memory a slab (times the ``loader.prefetch`` in flight).
    unroll: int = Field(1)
    #: Cap on steps per epoch; -1 = the full epoch.
    steps_per_epoch: int = Field(-1)
    validate: bool = Field(True)
    #: Validate on epochs where ``(epoch + 1) % validate_every == 0``; on
    #: the others nothing validation-derived happens (early stopping's
    #: patience counts validated epochs).
    validate_every: int = Field(1)
    #: Report the per-step sign-flip share of the binary kernels (larq's
    #: FlipRatio) in the train metrics.
    track_flip_ratio: bool = Field(False)
    #: Label smoothing of the loss (0 = off); validation scores the same
    #: smoothed loss.
    label_smoothing: float = Field(0.0)
    #: Also report top-5 accuracy in validation (needs >= 5 classes).
    track_top5: bool = Field(False)
    #: Save a model-only export (parameters and BatchNorm statistics) here
    #: after training (``training.checkpoint.save_model``): the EMA
    #: weights when ``ema_decay`` is on.
    export_model_to: Optional[str] = Field(None)
    #: The parameters' exponential moving average (0 = off): kept by the
    #: step, scored by validation, shipped by ``export_model_to``.
    ema_decay: float = Field(0.0)
    #: "ignore", "skip" (a non-finite step keeps the pre-step state, on the
    #: card; epochs report the summed ``skipped_steps``) or "halt" (skip,
    #: then raise ``NonFiniteLossError`` at the next readback).
    nan_policy: str = Field("ignore")
    #: Rematerialization policy: "none", "dots", "full" or "quant"
    #: (``training.step.make_train_step``).
    remat: str = Field("none")
    #: Keras ``EarlyStopping``: stop when this metric (of validation when
    #: the dataset has a split, else of the train epoch) has not improved
    #: by ``early_stop_min_delta`` for ``early_stop_patience`` scored
    #: epochs. None disables.
    early_stop_metric: Optional[str] = Field(None)
    early_stop_patience: int = Field(3)
    early_stop_min_delta: float = Field(0.0)
    #: "auto" ("loss" in the name -> min, else max), "min" or "max".
    early_stop_mode: str = Field("auto")
    #: Print the quantization-aware parameter summary (``models.summary``,
    #: read from a model built on the meta device) before training.
    print_model_summary: bool = Field(False)
    #: Steps between progress lines; 0 = epoch lines only.
    log_every: int = Field(0)
    verbose: bool = Field(True)
    #: One JSON record per epoch (``{"epoch": N, ..., "val_*": ...}``),
    #: appended; ``writer.jsonl.path`` is the step-keyed form.
    metrics_file: Optional[str] = Field(None)
    #: A ``torch.profiler`` trace of a few steady-state steps of the first
    #: epoch is written here, and its breakdown logged.
    profile_dir: Optional[str] = Field(None)
    #: Where the model trains: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")
    #: The group drain's margin in steps: the gap between a stop flag's
    #: boundary and the group's agreed exit. It must exceed the hosts'
    #: boundary skew (one slab, bounded by the boundary's device sync)
    #: plus the shared storage's flag-visibility lag; 0 = 4 x ``unroll``.
    group_drain_margin_steps: int = Field(0)
    #: Host span tracing: the run's spans and events (the loop's
    #: ``data_wait``/``dispatch``/``readback``/``checkpoint`` and every
    #: subsystem's) are written here as Chrome trace-event JSON at
    #: teardown, to open in Perfetto beside ``profile_dir``'s device
    #: trace. None = tracing stays off (one flag check a would-be span).
    trace_export: Optional[str] = Field(None)
    #: ``/metrics`` (Prometheus text), ``/statusz`` and ``/trace`` on this
    #: port while the run is alive: -1 = off, 0 = an ephemeral port
    #: (logged, and ``self.obs_server.port``).
    metrics_port: int = Field(-1)
    #: A ``FlightRecorder`` writing here is installed for the run: watchdog
    #: anomalies, NaN halts, fault injections and supervisor restarts
    #: each dump a bundle (trace ring, metrics text, program ledger,
    #: statusz, manifest). It stays installed after the run, so the
    #: restarts of ``run_with_recovery`` bundle too. None = off.
    flight_recorder_dir: Optional[str] = Field(None)
    #: The least seconds between two bundles (``POST /debugz`` bypasses it).
    flight_recorder_interval_s: float = Field(30.0)

    @Field
    def num_classes(self) -> int:
        return int(self.loader.dataset.resolved_num_classes())

    def _log(self, msg: str) -> None:
        if self.verbose and self.partitioner.is_chief:
            print(msg, flush=True)

    def _log_profile_breakdown(self, steps: int) -> None:
        """The captured window's breakdown, best effort: a trace of a CPU
        run holds no device kernels."""
        if not self.verbose:
            return
        try:
            self._log(format_breakdown(op_time_breakdown(self.profile_dir, steps=max(1, steps))))
        except (OSError, ValueError) as e:
            logger.warning("profile breakdown unavailable: %s", e)

    def _abort_profile(self) -> None:
        """Close an open profiler window (an exception mid-window must not
        leave the profiler running)."""
        window = getattr(self, "_profile_window", None)
        if window is not None:
            self._profile_window = None
            window.abort()

    def _open_profile(self, device: torch.device) -> None:
        self._profile_window = ProfileWindow(self.profile_dir, device)
        self._profile_window.start()
        self._obs_mark_stall()

    def _close_profile(self, steps: int) -> None:
        window, self._profile_window = self._profile_window, None
        window.stop()
        self._obs_mark_stall()
        self._log_profile_breakdown(steps)

    # -- observability ----------------------------------------------------

    @property
    def obs_registry(self) -> MetricsRegistry:
        """The experiment's registry (the epoch mirrors, the watchdogs, the
        live gauges), rendered at ``/metrics`` when ``metrics_port`` is
        set."""
        reg = getattr(self, "_obs_registry", None)
        if reg is None:
            reg = MetricsRegistry()
            self._obs_registry = reg
        return reg

    def _publish_epoch_observability(self, epoch: int, steps_trained: int,
                                     epoch_metrics: Dict[str, float],
                                     vmetrics: Optional[Dict[str, float]]) -> None:
        """The epoch's metrics as gauges for a live scrape. Never raises: a
        metric name colliding with an instrument of another type loses its
        mirror with a warning, not the run."""
        reg = self.obs_registry
        try:
            reg.counter("zk_train_steps_total", help="train steps completed this run"
                        ).inc(steps_trained)
            reg.gauge("zk_train_epoch", help="last completed epoch").set(epoch + 1)
            for k, v in epoch_metrics.items():
                reg.gauge(f"zk_train_{k}").set(v)
            for k, v in (vmetrics or {}).items():
                reg.gauge(f"zk_val_{k}").set(v)
        except Exception as e:
            logger.warning("epoch observability mirror skipped: %s", e)

    def _obs_status(self) -> Dict[str, Any]:
        """The run's ``/statusz`` section."""
        return {"model": type(self.model).__name__, "epochs": int(self.epochs),
                "batch_size": int(self.batch_size), "unroll": int(self.unroll)}

    def _setup_observability(self) -> None:
        """Start what the fields ask for: tracing, the endpoint with the
        device probe, the flight recorder (kept installed after the run;
        the same experiment rerun by ``run_with_recovery`` reuses it)."""
        if self.trace_export:
            # A tracer enabled by someone else outlives this run.
            self._trace_enabled_here = not _trace.enabled()
            _trace.enable()
        if self.metrics_port >= 0:
            server = ObservabilityServer([default_registry(), self.obs_registry],
                                         port=self.metrics_port,
                                         status_providers={"training": self._obs_status})
            server.start()
            self.obs_server = server
            # An eager first poll: zk_hbm_* render from the first scrape.
            probe = DeviceProbe()
            probe.poll_once()
            probe.start()
            self.obs_probe = probe
            self._log(f"observability endpoint: {server.url}/metrics")
        if self.flight_recorder_dir:
            rec = getattr(self, "flight_recorder", None)
            if rec is None or rec.directory != self.flight_recorder_dir:
                rec = _recorder.arm(
                    self.flight_recorder_dir,
                    registries=[default_registry(), self.obs_registry],
                    status_providers={"training": self._obs_status},
                    min_interval_s=self.flight_recorder_interval_s,
                )
                self.flight_recorder = rec
            _recorder.install(rec)

    def _finish_host_trace(self) -> None:
        """Write the Chrome trace and put tracing back as it was."""
        if self.trace_export and _trace.enabled():
            n = _trace.export_chrome_trace(self.trace_export)
            self._log(f"host trace: {n} events -> {self.trace_export} (open in Perfetto)")
            if self.profile_dir is not None:
                self._log(
                    f"paired trace artifacts: host spans {self.trace_export} (Chrome JSON) "
                    f"+ device trace {self.profile_dir} (torch.profiler Chrome JSON) — "
                    "load both in Perfetto and align on wall time")
            if getattr(self, "_trace_enabled_here", False):
                _trace.disable()

    def _stop_obs_server(self) -> None:
        server = getattr(self, "obs_server", None)
        if server is not None:
            self.obs_server = None
            server.stop()
        probe = getattr(self, "obs_probe", None)
        if probe is not None:
            self.obs_probe = None
            probe.stop()

    def _watchdog(self, stream: str):
        """The stream's anomaly watchdog (made at its first use, counting
        in ``obs_registry``; a 5 ms excess floor: host jitter on a fast
        step is no anomaly)."""
        dogs = getattr(self, "_watchdogs", None)
        if dogs is None:
            dogs = self._watchdogs = {}
        dog = dogs.get(stream)
        if dog is None:
            dog = dogs[stream] = StepTimeWatchdog(stream, min_excess_s=0.005,
                                                  registry=self.obs_registry)
        return dog

    def _obs_reset_timers(self) -> None:
        self._obs_timer = {"iter_t": None, "iter_dirty": False, "sync_t": None,
                           "sync_step": None, "sync_dirty": False}
        self._mfu_peaks = None

    def _obs_mark_stall(self, sync: bool = True) -> None:
        """The current intervals hold a deliberate stall (a save, a
        profiler window, validation): the watchdogs skip them.
        ``sync=False`` marks only the dispatch stream (a readback inflates
        its iteration but is the sync stream's clean boundary)."""
        timer = getattr(self, "_obs_timer", None)
        if timer is not None:
            timer["iter_dirty"] = True
            if sync:
                timer["sync_dirty"] = True

    def _obs_iteration_end(self, k: int, global_step: int) -> None:
        """An iteration (``k`` steps dispatched) ended: its wall time a
        step feeds the ``train_dispatch`` watchdog (data wait and host
        dispatch; the card runs behind)."""
        timer = self._obs_timer
        t = time.perf_counter()
        prev, timer["iter_t"] = timer["iter_t"], t
        if timer["iter_dirty"]:
            timer["iter_dirty"] = False
            return
        if prev is not None:
            self._watchdog("train_dispatch").observe((t - prev) / max(1, k), step=global_step)

    def _obs_sync_point(self, global_step: int, program: Any) -> None:
        """A readback just completed every step up to ``global_step``: the
        time a step since the previous one feeds the ``train_step``
        watchdog and the live gauges."""
        timer = getattr(self, "_obs_timer", None)
        if timer is None:
            return
        t = time.perf_counter()
        prev_t, prev_step = timer["sync_t"], timer["sync_step"]
        timer["sync_t"], timer["sync_step"] = t, global_step
        if timer["sync_dirty"]:
            timer["sync_dirty"] = False
            return
        if prev_t is None or prev_step is None or global_step <= prev_step:
            return
        per_step = (t - prev_t) / (global_step - prev_step)
        self._watchdog("train_step").observe(per_step, step=global_step)
        self._publish_mfu(per_step, program)

    def _publish_mfu(self, per_step_seconds: float, program: Any) -> None:
        """``zk_train_step_time_ms``, ``zk_train_mfu`` and, for int8
        models, ``zk_train_mfu_int8``: the program's counted FLOPs a step
        (a ``multi_step`` row's over its own ``steps``, the slab it was
        counted on, not the configured ``unroll``) over the step time over
        the reference peak; -1 while unknown."""
        reg = self.obs_registry
        reg.gauge("zk_train_step_time_ms",
                  help="measured steady-state seconds/step (readback-bounded)"
                  ).set(per_step_seconds * 1e3)
        entry = getattr(program, "ledger_entry", None)
        flops = getattr(entry, "flops", None)
        if flops is not None and entry.kind == "multi_step":
            flops = flops / max(1, int(entry.attrs.get("steps", self.unroll)))
        peaks = getattr(self, "_mfu_peaks", None)
        if peaks is None:
            peaks = self._mfu_peaks = (
                _peaks.reference_peak_flops()[0],
                _peaks.reference_int8_peak_flops()[0]
                if getattr(self.model, "binary_compute", None) == "int8" else None)
        value = _ledger.mfu(flops, per_step_seconds, peaks[0])
        reg.gauge("zk_train_mfu", help="ledger FLOPs / measured step time / reference bf16 "
                  "peak (-1 = count or timing unavailable)", initial=-1
                  ).set(value if value is not None else -1)
        if peaks[1] is not None:
            value8 = _ledger.mfu(flops, per_step_seconds, peaks[1])
            reg.gauge("zk_train_mfu_int8", help="the same step against the int8 peak",
                      initial=-1).set(value8 if value8 is not None else -1)

    def _steps_per_epoch(self) -> int:
        spe = self.loader.steps_per_epoch("train")
        if self.steps_per_epoch > 0:
            spe = min(spe, self.steps_per_epoch)
        return spe

    def build_state(self, device: torch.device) -> TrainState:
        """Build and initialize the module from ``seed`` on ``device``,
        the optimizer over the run's steps, and the EMA when on. The
        partitioner wires itself into the model first
        (``prepare_model``: the sequence-parallel attention)."""
        input_shape = self.loader.preprocessing.input_shape
        self.partitioner.prepare_model(self.model)
        module = self.model.build(input_shape, self.num_classes)
        self.model.initialize(module, seed=self.seed)
        module.to(device)
        tx = self.optimizer.build(total_steps=max(1, self._steps_per_epoch() * self.epochs))
        return TrainState.create(module, tx, ema=self.ema_decay > 0)

    def _train_step_kwargs(self) -> Dict[str, Any]:
        """The ``make_train_step`` wiring, which subclasses extend."""
        return {
            "loss_fn": smoothed_softmax_cross_entropy(self.label_smoothing),
            "flip_ratio_pattern": BINARY_KERNEL_PATTERN if self.track_flip_ratio else None,
            "ema_decay": self.ema_decay if self.ema_decay > 0 else None,
            "remat": self.remat,
            "nan_policy": self.nan_policy,
            "replicas": self.partitioner.replicas(),
        }

    def _train_step_fn(self):
        return make_train_step(**self._train_step_kwargs())

    def _validate_config(self) -> None:
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay={self.ema_decay} is outside [0, 1): 0 disables "
                "EMA; 1.0 would freeze the average at initialization "
                "forever (common typo for 0.999)."
            )
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r} unknown; choose none/dots/full/quant.")
        if self.unroll < 1:
            raise ValueError(
                f"unroll={self.unroll} must be >= 1 (1 = eager per-step "
                "loop; N fuses N steps per dispatch)."
            )
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy={self.nan_policy!r} unknown; choose ignore/skip/halt.")
        if self.early_stop_mode not in ("auto", "min", "max"):
            raise ValueError(
                f"early_stop_mode={self.early_stop_mode!r} unknown; choose auto/min/max."
            )
        if self.validate_every < 1:
            raise ValueError(
                f"validate_every={self.validate_every} must be >= 1; "
                "set validate=False to disable validation."
            )
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(f"label_smoothing={self.label_smoothing} outside [0, 1).")
        if self.track_top5 and self.num_classes < 5:
            raise ValueError(
                f"track_top5=True needs >= 5 classes (dataset has {self.num_classes})."
            )
        ck = self.checkpointer
        if ck.save_every_epochs < 0 or ck.save_every_steps < 0:
            raise ValueError(
                "checkpointer.save_every_epochs/save_every_steps must be "
                ">= 0 (0 disables that cadence)."
            )
        ck._validate_mode()
        if ck.save_every_steps > 0 and ck.keep_best_metric is not None:
            raise ValueError(
                "checkpointer.save_every_steps is incompatible with "
                "keep_best_metric: mid-epoch saves carry no fresh "
                "rankable metrics (best-ranking pins every save to a "
                "metric). Use one or the other."
            )
        if self.group_drain_margin_steps < 0:
            raise ValueError(
                f"group_drain_margin_steps={self.group_drain_margin_steps}"
                " must be >= 0 (0 = auto: 4 x unroll)."
            )

    def _step_save_due(self, epoch: int, step_idx: int, spe: int) -> bool:
        """Whether the step-cadence save fires after this step. On an
        epoch's last step it defers to the epoch save only when that one
        fires this epoch (one step is never saved twice); otherwise the
        cadence holds, so the work lost stays bounded by N steps."""
        ck = self.checkpointer
        if not (ck.enabled and ck.save_every_steps > 0):
            return False
        if (epoch * spe + step_idx + 1) % ck.save_every_steps != 0:
            return False
        epoch_save_fires = ck.save_every_epochs > 0 and (epoch + 1) % ck.save_every_epochs == 0
        return step_idx + 1 < spe or not epoch_save_fires

    def _mark_first_step(self, global_step: int) -> None:
        """Time the end of this run's first train step, or slab, which is
        its step program's first run and so ended in the run's one added
        device synchronisation (``_StepProgram``): ``run_with_recovery``
        reads it as the restore latency, and it starts the step-time
        stream, so a ``log_every=0`` run still publishes ``zk_train_mfu``
        at its epoch's readback."""
        if self.first_step_at is None:
            self.first_step_at = time.perf_counter()
            timer = getattr(self, "_obs_timer", None)
            if timer is not None:
                timer["sync_t"] = self.first_step_at
                timer["sync_step"] = int(global_step)
                timer["sync_dirty"] = False

    def _group_process_index(self) -> int:
        """This host's index for the fault legs: the group coordinator's
        when one is wired, else the process group's rank (0 without one)."""
        coord = getattr(self, "group_coordinator", None)
        if coord is not None:
            return int(coord.process_index)
        import torch.distributed as dist

        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def _group_drain_margin(self) -> int:
        """Steps between a stop flag's boundary and the group's exit
        (``group_drain_margin_steps``, or 4 x ``unroll``)."""
        if self.group_drain_margin_steps > 0:
            return int(self.group_drain_margin_steps)
        return 4 * max(1, int(self.unroll))

    def _group_stop_due(self, global_step: int) -> bool:
        """The group boundary: a host whose guard tripped publishes a stop
        flag (when no drain is under way) instead of exiting; every host
        sees the flags at a later boundary, and the group exits at the
        first boundary at or past the newest flag's step plus the margin:
        one stop step, the same state saved by every host. A host never
        waits here (a peer may be waiting on its next dispatch). True when
        this boundary is the exit."""
        coord = self.group_coordinator
        pid = int(coord.process_index)
        flags = coord.poll_flags("preempt")
        if self.guard.preempted and not flags and self._group_flag_step is None:
            # This host starts the drain.
            coord.publish_flag("preempt", {"origin": pid, "step": int(global_step),
                                           "signal": self.guard.received_signal})
            self._group_flag_step = int(global_step)
            self.guard.request_preemption(signum=self.guard.received_signal, origin=pid)
            flags = coord.poll_flags("preempt")
        if not flags:
            return False
        if self.guard.preemption_origin is None:
            # Join the drain, recording who started it.
            first = min(flags, key=lambda f: int(f["origin"]))
            self.guard.request_preemption(
                signum=self.guard.received_signal or first.get("signal"),
                origin=int(first["origin"]))
        stop_step = max(int(f["step"]) for f in flags) + self._group_drain_margin()
        return int(global_step) >= stop_step

    def _boundary_check(self, state: TrainState, global_step: int) -> None:
        """Preemption check at a step boundary, where ``state`` is an exact
        resume point. A ``FaultPlan``'s ``kill_at_step`` (or this host's
        ``kill_process_at_step``) trips the flag a real SIGTERM does. On
        preemption: the guard's one synchronous save, then ``Preempted``
        (teardown still runs). With a group coordinator wired, the group
        drain decides the boundary (``_group_stop_due``)."""
        plan = faults.active()
        coord = getattr(self, "group_coordinator", None)
        if plan is not None and plan.kill_due(
                global_step, self._group_process_index()
                if plan.kill_process_at_step is not None or coord is not None else 0):
            self.guard.request_preemption()
        if coord is not None and coord.process_count > 1:
            # Bound the hosts' skew to one slab: this host passes the
            # boundary only once its card has run the slab that made
            # ``state`` (the drain margin's no-deadlock argument). The
            # step counter of a graph replay is on the card: read after.
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            if not self._group_stop_due(global_step):
                return
        elif not self.guard.preempted:
            return
        saved, self.save_wait_ms = self.guard.preemption_save(
            self.checkpointer, state, global_step)
        self._log(
            f"preemption requested (signal "
            f"{self.guard.received_signal or 'injected/manual'}); exiting at "
            f"step {global_step} ({'checkpoint saved' if saved else 'NO checkpoint'})"
        )
        raise Preempted(global_step, saved, self.guard.received_signal)

    def _teardown(self) -> None:
        """Uninstall the guard, close an open profiler window, wait on the
        checkpoint writer, flush the metrics writer (flush, not close:
        ``run()`` may be called again), write the host trace and stop the
        endpoint. Every step runs; a failure while
        an exception is already in flight is logged and suppressed, so the
        original error propagates; with none in flight the first failure
        propagates."""
        self.guard.uninstall()
        pending = sys.exc_info()[1]
        first: Optional[BaseException] = None
        for what, fn in (
            ("profiler.stop", self._abort_profile),
            ("checkpointer.wait", self.checkpointer.wait),
            ("writer.flush", self.writer.flush),
            ("trace.export", self._finish_host_trace),
            ("obs_server.stop", self._stop_obs_server),
        ):
            try:
                fn()
            except Exception as e:
                if pending is None and first is None:
                    first = e
                else:
                    logger.warning(
                        "teardown %s failed (%s); suppressed so the original "
                        "exception propagates", what, e,
                    )
        if first is not None:
            raise first

    def _log_step_scalars(self, step_idx: int, spe: int, global_step: int,
                          row: Dict[str, float]) -> None:
        """A ``log_every`` step's line and ``train/`` scalars."""
        self._log(
            f"  step {step_idx + 1}/{spe} "
            f"loss={row['loss']:.4f} acc={row['accuracy']:.4f}"
        )
        if self.partitioner.is_chief:
            self.writer.write_scalars(global_step, {f"train/{k}": v for k, v in row.items()})

    def _check_halt(self, host: Dict[str, float], global_step: int) -> None:
        """``nan_policy="halt"``: raise when a step of the metrics just read
        back was skipped, after a ``nan_halt`` notice to the flight
        recorder (the trace ring around the NaN step is the evidence the
        supervisor's restore discards)."""
        if self.nan_policy == "halt" and host.get("skipped_steps", 0.0) > 0:
            skipped = int(host["skipped_steps"])
            _recorder.notify("nan_halt", step=global_step, attrs={"skipped_steps": skipped})
            raise NonFiniteLossError(global_step, skipped)

    def _print_summary(self) -> None:
        from zookeeper_tpu_torch.models.summary import meta_module, model_summary

        input_shape = self.loader.preprocessing.input_shape
        dtype = self.loader.preprocessing.input_dtype
        self._log(str(model_summary(
            meta_module(self.model, input_shape, self.num_classes), input_shape,
            input_dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        )))

    def _setup_ranks(self) -> torch.device:
        """Form the group (when launched as ranks), build the mesh, and
        return this rank's device."""
        self.runtime.initialize(self.device)
        self.partitioner.setup()
        return local_device(self.device)

    def run(self) -> Dict[str, List[Dict[str, float]]]:
        self._validate_config()
        device = self._setup_ranks()
        self._device = device
        if self.checkpointer.enabled and self.checkpointer.sharded_per_host:
            # Build (and purge the stale files of) the restore agreement's
            # coordinator now, behind the group's rendezvous, not at the
            # first restore, where a slow peer's stale files could show.
            self.checkpointer._coordinator()
        self._log(pretty_print(self))
        if self.print_model_summary:
            self._print_summary()
        # Per-run probes read by run_with_recovery, and the group drain's
        # flag (at most one published a run).
        self.first_step_at = None
        self.save_wait_ms = None
        self._profile_window = None
        self._group_flag_step = None
        partitioner = self.partitioner
        self.checkpointer.set_replicas(
            partitioner.replicas() if self.checkpointer.enabled else None, partitioner.is_chief)
        try:
            # Up before the state is built, so the build and the restore
            # can be scraped; inside the try, so a half-failed setup (a
            # busy port) is torn down.
            self._setup_observability()
            state = partitioner.shard_state(self.build_state(device))
            state = self.checkpointer.restore_state(state)
            partitioner.check_same_step(state.step)
            state, history = self._train(state, device)
        finally:
            self._teardown()
        if self.export_model_to:
            trees = export_trees(state.module, state.ema_params if self.ema_decay > 0 else None,
                                 state.shards)
            if partitioner.is_chief:
                save_model(self.export_model_to, *trees)
        self.final_state = state
        return history

    def _run_eager_epoch(self, train_step, state, batches, accum, epoch, spe, start_b,
                         profiling, p_start, p_stop, device):
        """One epoch of the eager loop, a step a batch; returns ``(state,
        steps_trained)``."""
        ck = self.checkpointer
        for step_idx, batch in enumerate(batches, start=start_b):
            global_step = epoch * spe + step_idx + 1
            if profiling and step_idx == p_start:
                self._open_profile(device)
            plan = faults.active()
            if plan is not None:
                plan.mark_nan_dispatch(global_step - 1)
            with _trace.span("dispatch", step=global_step - 1):
                state, metrics = train_step(state, batch)
            accum.append(metrics)
            self._mark_first_step(global_step)
            if profiling and step_idx == p_stop:
                profiling = False
                self._close_profile(p_stop - p_start + 1)
            if self._step_save_due(epoch, step_idx, spe):
                with _trace.span("checkpoint", step=global_step):
                    ck.save(state)
                self._obs_mark_stall()
            if self.log_every and (step_idx + 1) % self.log_every == 0:
                # The step's scalars ride the readback log_every already
                # pays for.
                with _trace.span("readback", step=global_step):
                    row = _host_means([metrics])
                self._obs_mark_stall(sync=False)
                self._obs_sync_point(global_step, train_step)
                self._check_halt(row, global_step)
                self._log_step_scalars(step_idx, spe, global_step, row)
            self._boundary_check(state, global_step)
            self._obs_iteration_end(1, global_step)
        return state, len(accum)

    def _run_fused_epoch(self, multi_step, state, slabs, accum, epoch, spe, start_b,
                         profiling, p_start, p_stop, device):
        """One epoch of the fused loop, a ``multi_step`` call a slab;
        returns ``(state, steps_trained)``.

        The eager loop's semantics, step for step: a mid-slab resume is
        the first slab's first step; the metrics of each slab stay on the
        card, read back once per slab that holds a ``log_every`` step,
        which logs the eager loop's per-step values (and checks
        ``nan_policy="halt"``). Slab ends are the fused loop's boundaries:
        a step-cadence save fires at the end of the slab holding the due
        step, preemption (and ``FaultPlan.kill_at_step``) is checked
        there, and the profiler window covers whole slabs, from the first
        slab starting at or after ``p_start`` (or the epoch's last slab)
        to the one holding ``p_stop``. The ``dispatch``, ``checkpoint``
        and ``readback`` spans carry the slab's index."""
        step_idx = start_b
        trace_first = start_b
        for slab_idx, slab in enumerate(slabs):
            k = int(next(iter(slab.values())).shape[0])
            first = epoch * spe + step_idx
            if profiling and self._profile_window is None and (
                    step_idx >= p_start or step_idx + k >= spe):
                self._open_profile(device)
                trace_first = step_idx
            plan = faults.active()
            if plan is not None:
                plan.mark_nan_dispatch(first, k)
            with slab_annotation(slab_idx, num_steps=k), _trace.span(
                    "dispatch", step=first, slab=slab_idx):
                state, metrics = multi_step(state, slab)
            accum.append(metrics)
            self._mark_first_step(first + k)
            if profiling and self._profile_window is not None and step_idx + k > p_stop:
                profiling = False
                self._close_profile(step_idx + k - trace_first)
            if any(self._step_save_due(epoch, s, spe) for s in range(step_idx, step_idx + k)):
                with _trace.span("checkpoint", step=first + k, slab=slab_idx):
                    self.checkpointer.save(state)
                self._obs_mark_stall()
            bounds = [s for s in range(step_idx, step_idx + k)
                      if self.log_every and (s + 1) % self.log_every == 0]
            if bounds:
                # One readback for the slab; each step's values are the
                # ones the eager loop logs.
                with _trace.span("readback", step=first + k, slab=slab_idx):
                    host = {name: v.to(torch.float32).to(torch.float64).cpu()
                            for name, v in metrics.items()}
                self._obs_mark_stall(sync=False)
                self._obs_sync_point(first + k, multi_step)
                self._check_halt({"skipped_steps": float(host["skipped_steps"].sum())}
                                 if "skipped_steps" in host else {}, first + k)
                for s in bounds:
                    self._log_step_scalars(s, spe, epoch * spe + s + 1,
                                           {name: float(v[s - step_idx])
                                            for name, v in host.items()})
            step_idx += k
            self._boundary_check(state, epoch * spe + step_idx)
            self._obs_iteration_end(k, epoch * spe + step_idx)
        return state, step_idx - start_b

    def _train(self, state: TrainState, device: torch.device):
        """The epochs from the restored ``state``; returns ``(state,
        history)``."""
        step_fn = self._train_step_fn()
        # Built per run, after the restore: a graph captures the state's
        # tensors as they are now.
        self.multi_step = build_multi_step(step_fn) if self.unroll > 1 else None
        # The ledger's programs, per run as the JAX loop compiles its step.
        prefix = type(self.partitioner).__name__
        if self.multi_step is None:
            program = _StepProgram(step_fn, "train_step", prefix)
        else:
            program = _StepProgram(self.multi_step, "multi_step", prefix)
        eval_step = make_eval_step(
            smoothed_softmax_cross_entropy(self.label_smoothing),
            use_ema=self.ema_decay > 0, top5=self.track_top5,
        )
        spe = self._steps_per_epoch()
        start_step = state.step
        start_epoch = start_step // max(1, spe)
        # Steps already trained in the resumed epoch: its permutation is
        # (seed, epoch)-fixed, so skipping them resumes exactly.
        resume_step = start_step % max(1, spe)
        if start_step > 0:
            self._log(
                f"resumed from checkpoint at step {start_step} (epoch {start_epoch}"
                + (f", step {resume_step} within it" if resume_step else "") + ")"
            )
        history: Dict[str, List[Dict[str, float]]] = {"train": [], "validation": []}
        has_val_split = self.validate and self.loader.dataset.validation() is not None
        es_best: Optional[float] = None
        es_stale = 0
        es_minimize = self.early_stop_mode == "min" or (
            self.early_stop_mode == "auto" and self.early_stop_metric is not None
            and "loss" in self.early_stop_metric
        )
        ck = self.checkpointer
        self._obs_reset_timers()
        # From here to teardown, SIGTERM/SIGINT mean "save and exit at the
        # next step boundary".
        self.guard.install()
        for epoch in range(start_epoch, self.epochs):
            t0 = time.perf_counter()
            accum: List[Dict[str, torch.Tensor]] = []
            # A mid-epoch resume skips the trained prefix of its first
            # epoch; step_idx stays epoch-absolute.
            start_b = resume_step if epoch == start_epoch else 0
            # The profiler window: steps p_start..p_stop (inclusive) of the
            # first epoch this run trains, its warm-up steps left out.
            profiling = (self.profile_dir is not None and epoch == start_epoch
                         and self.partitioner.is_chief)
            p_start = min(start_b + 4, spe - 1)
            p_stop = min(start_b + 14, spe - 1)
            run_epoch = (self._run_eager_epoch if self.multi_step is None
                         else self._run_fused_epoch)
            batches = self.loader.batches(
                "train", device=device, epoch=epoch, start_batch=start_b, max_batches=spe,
                unroll=self.unroll, sharding=self.partitioner.batch_sharding(),
            )
            try:
                state, steps_trained = run_epoch(
                    program, state, _data_wait_iter(batches), accum, epoch, spe, start_b,
                    profiling, p_start, p_stop, device)
            finally:
                # A preemption drops the batch in flight with the loader
                # thread; the rerun restarts the epoch at start_batch.
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            end_step = epoch * spe + start_b + steps_trained
            with _trace.span("readback", step=end_step):
                epoch_metrics = _host_means(accum)  # the epoch's one readback
            self._obs_mark_stall(sync=False)
            self._obs_sync_point(end_step, program)
            self._check_halt(epoch_metrics, end_step)
            dt = time.perf_counter() - t0
            epoch_metrics["examples_per_sec"] = (
                steps_trained * self.loader.batch_size / dt if dt > 0 else 0.0
            )
            # A resumed epoch's train aggregates cover its last steps only.
            partial_epoch = epoch == start_epoch and start_b > 0
            history["train"].append(epoch_metrics)
            line = (
                f"epoch {epoch + 1}/{self.epochs} "
                f"loss={epoch_metrics.get('loss', float('nan')):.4f} "
                f"acc={epoch_metrics.get('accuracy', float('nan')):.4f} "
                f"({epoch_metrics['examples_per_sec']:.0f} ex/s)"
            )
            if partial_epoch:
                line += f" [partial: resumed at step {start_b}]"
            vmetrics = None
            if has_val_split and (epoch + 1) % self.validate_every == 0:
                vmetrics = run_weighted_eval(
                    self.loader, "validation", eval_step, state, device, epoch=epoch,
                    sharding=self.partitioner.batch_sharding(),
                    replicas=self.partitioner.replicas(),
                ) or None
                self._obs_mark_stall()  # validation is a pause, not step time
                if vmetrics is not None:
                    history["validation"].append(vmetrics)
                    line += (
                        f" | val_loss={vmetrics.get('loss', float('nan')):.4f} "
                        f"val_acc={vmetrics.get('accuracy', float('nan')):.4f}"
                    )
            self._log(line)
            if self.metrics_file and self.partitioner.is_chief:
                record = {"epoch": epoch, **epoch_metrics}
                if partial_epoch:
                    record["partial_epoch"] = True
                if vmetrics is not None:
                    record.update({f"val_{k}": v for k, v in vmetrics.items()})
                with open(self.metrics_file, "a") as f:
                    f.write(json.dumps(record) + "\n")
            # Epoch aggregates under their own prefix, so they never share
            # a tag with the per-step train/ scalars at the same step.
            scalars = {f"train_epoch/{k}": v for k, v in epoch_metrics.items()}
            if vmetrics is not None:
                scalars.update({f"val/{k}": v for k, v in vmetrics.items()})
            if self.partitioner.is_chief:
                self.writer.write_scalars((epoch + 1) * spe, scalars)
            self._publish_epoch_observability(epoch, steps_trained, epoch_metrics, vmetrics)
            # Scored: fresh validation when the dataset has a split, else
            # the train epoch (not a partial one: its aggregates are not
            # comparable); None on an epoch that was not validated.
            scored = vmetrics if has_val_split else epoch_metrics
            if partial_epoch and not has_val_split:
                scored = None
            if (ck.enabled and ck.save_every_epochs > 0
                    and (epoch + 1) % ck.save_every_epochs == 0
                    and not (ck.keep_best_metric is not None and scored is None)):
                # Best-ranking saves only on epochs with fresh metrics.
                with _trace.span("checkpoint", step=(epoch + 1) * spe):
                    ck.save(state, metrics=scored)
                self._obs_mark_stall()
            if self.early_stop_metric is not None and scored is not None:
                if self.early_stop_metric not in scored:
                    raise ValueError(
                        f"early_stop_metric={self.early_stop_metric!r} "
                        f"not in epoch metrics {sorted(scored)}."
                    )
                current = float(scored[self.early_stop_metric])
                improved = es_best is None or (
                    es_best - current > self.early_stop_min_delta if es_minimize
                    else current - es_best > self.early_stop_min_delta
                )
                if improved:
                    es_best, es_stale = current, 0
                else:
                    es_stale += 1
                    if es_stale >= self.early_stop_patience:
                        self._log(
                            f"early stop at epoch {epoch + 1}: "
                            f"{self.early_stop_metric} has not improved "
                            f"for {es_stale} scored epoch(s) (best {es_best:.6g})"
                        )
                        break
        return state, history


@component
class EvalExperiment(Experiment):
    """Score a model-only export (``export_model_to``) or a training run's
    ``Checkpointer`` directory (its latest step) on a dataset split.
    The loader keeps the last partial batch (``drop_remainder=False``), so
    the score covers every example of the split; ``split="train"`` reads
    the training data in eval mode (no shuffle, no augmentation)."""

    loader: DataLoader = ComponentField(DataLoader, drop_remainder=False)
    model: Model = ComponentField()
    partitioner: Partitioner = ComponentField(SingleDevicePartitioner)
    runtime: DistributedRuntime = ComponentField(DistributedRuntime)

    #: The ``save_model`` export, or a ``Checkpointer`` directory (the
    #: latest step's EMA or raw weights), to score.
    checkpoint: str = Field()
    #: "auto" (the EMA when the checkpoint carries one), "ema" or "raw"
    #: (``training.checkpoint.select_inference_weights``, shared with
    #: serving, so eval scores what serving ships).
    weights: str = Field("auto")
    split: str = Field("validation")
    batch_size: int = Field(32)
    seed: int = Field(0)
    verbose: bool = Field(True)
    #: Also report top-5 accuracy.
    track_top5: bool = Field(False)
    #: LM metrics derived from the split's weighted-mean cross-entropy:
    #: ``perplexity`` (e^CE) and ``bits_per_token`` (CE / ln 2).
    track_lm_metrics: bool = Field(False)
    #: Where the model runs: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")

    @Field
    def num_classes(self) -> int:
        return int(self.loader.dataset.resolved_num_classes())

    def build_state(self, device: torch.device) -> TrainState:
        """The model built and loaded from ``checkpoint`` (its structure
        checked against the build) on ``device``, as a state with no
        optimizer. The partitioner wires itself into the model first."""
        input_shape = self.loader.preprocessing.input_shape
        self.partitioner.prepare_model(self.model)
        module = self.model.build(input_shape, self.num_classes)
        params_like, state_like = export_trees(module)
        params, model_state = load_inference_model(
            self.checkpoint, weights=self.weights,
            params_like=params_like, model_state_like=state_like,
        )
        load_into_module(module, params, model_state).to(device)
        return TrainState(step=0, module=module, tx=None, opt_state={})

    def run(self) -> Dict[str, float]:
        if self.weights not in ("auto", "ema", "raw"):
            raise ValueError(f"weights={self.weights!r} unknown; choose auto/ema/raw.")
        if self.split not in ("train", "validation"):
            raise ValueError(
                f"split={self.split!r} unknown; datasets here expose "
                "'train' and 'validation'."
            )
        if self.track_top5 and self.num_classes < 5:
            raise ValueError(
                f"track_top5=True needs >= 5 classes (dataset has {self.num_classes})."
            )
        self.runtime.initialize(self.device)
        partitioner = self.partitioner
        partitioner.setup()
        device = local_device(self.device)
        verbose = self.verbose and partitioner.is_chief
        if verbose:
            print(pretty_print(self), flush=True)
        state = partitioner.shard_state(self.build_state(device))
        metrics = run_weighted_eval(
            self.loader, self.split, make_eval_step(top5=self.track_top5), state, device,
            sharding=partitioner.batch_sharding(), replicas=partitioner.replicas(),
        )
        if not metrics:
            raise ValueError(f"Split {self.split!r} produced no batches.")
        if self.track_lm_metrics:
            ce = metrics["loss"]
            metrics["perplexity"] = math.exp(ce)
            metrics["bits_per_token"] = ce / math.log(2.0)
        if verbose:
            line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            print(f"eval[{self.split}] {line}", flush=True)
        return metrics
