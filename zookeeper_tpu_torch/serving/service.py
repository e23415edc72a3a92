"""The serving config tree: one component from model to warm engine.

The port of ``zookeeper_tpu/serving/service.py``'s ``ServingConfig``, a
``@task`` driven by the port's ``key=value`` CLI::

    python -m zookeeper_tpu_torch.serving ServingConfig model=QuickNetLarge \\
        model.compute_dtype=bfloat16 model.binary_compute=xnor_popcount \\
        model.packed_weights=True model.fold_bn=True

``build_service()`` builds the model, loads its weights from
``checkpoint`` (a model-only export or a training run's ``Checkpointer``
directory, ``training.checkpoint``: the EMA or the raw weights as
``weights`` picks them, the tree checked against the built model's
structure) or initializes them from ``seed`` (a packed
model gets the packed form of its float twin, see
``QuickNet.initialize``), binds and warms the engine on ``device`` and
binds the batcher. ``run()`` serves a seeded stream of variable-size
synthetic requests and reports through ``finish_report``: the metrics
snapshot through ``writer`` (``training.metrics``, ``serve/`` scalars)
and one printed JSON line (latency p50/p95/p99, bucket fill, padding
waste, qps). A task that serves other traffic overrides ``run()`` and
reports the same way (``serving.classifier.ServeDigits``).

``partitioner`` serves under a training layout (``parallel``): under
``torchrun`` (``runtime`` forms the group) every rank builds the same
weights, runs the same ``run()`` on the same seeded stream and holds its
share (``InferenceEngine.bind(partitioner=...)``); only the chief
(``partitioner.is_chief``) prints and writes metrics::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m zookeeper_tpu_torch.serving ServingConfig model=QuickNet ... \
        partitioner=DataParallelPartitioner

``watch=True`` serves a live training run: ``checkpoint`` must be a
``Checkpointer`` directory, and a ``CheckpointWatcher`` polls it every
``watch_poll_s`` seconds and swaps each newly finalized step into the
warmed engine (``InferenceEngine.watch_checkpoints``), loaded as the
first load is, so a packed model is built the same way. The newest step
listed before the first load is the watcher's baseline, and its first
poll runs at once: a step that finalized during the load and warm-up is
swapped in then. Teardown stops the watcher; the report's
``watcher_alive`` and ``serving_weights_step`` say whether it still
follows the run. At world size > 1 the chief's watcher leads
(``MicroBatcher.follow``): every rank loads the step the chief listed
before the first load, and each step the chief's watcher finds is
loaded and swapped in by every rank at the same dispatch boundary.

**Observability** (``observability``), off by default. ``metrics_port``
>= 0 starts an ``ObservabilityServer`` (0: an ephemeral port, read back
as ``obs_server.port``) serving ``/metrics`` (every ``zk_serving_*``
series, the engine's ``zk_serve_*`` gauges, the ``zk_hbm_*`` gauges of a
``DeviceProbe`` started with it), ``/statusz`` (the ``serving`` section
of :meth:`status`, the ``requests`` RequestLog tail and the ``programs``
ledger), ``/trace`` and ``POST /debugz``. ``flight_recorder_dir`` arms a
``FlightRecorder`` there (at most one bundle every
``flight_recorder_interval_s`` seconds) for the service's lifetime. A
bind failure (a busy port) tears down what was started. Every exit path
tears down through :func:`run_teardown_steps`: each step runs, and the
first failure is re-raised unless suppressed. Nothing here decides a
dispatch, so these run at any world size.
"""

import json
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from zookeeper_tpu_torch.core import ComponentField, Field, pretty_print, task
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.parallel.distributed import DistributedRuntime
from zookeeper_tpu_torch.parallel.partitioner import Partitioner, SingleDevicePartitioner
from zookeeper_tpu_torch.serving.batcher import MicroBatcher
from zookeeper_tpu_torch.serving.engine import InferenceEngine
from zookeeper_tpu_torch.serving.metrics import ServingMetrics
from zookeeper_tpu_torch.training.metrics import CompositeMetricsWriter, MetricsWriter


def run_teardown_steps(steps, *, suppress: bool = False) -> None:
    """The service-teardown contract ``ServingConfig`` and
    ``LMServingConfig`` share: every step runs even when an earlier one
    raises (a failed watcher stop must not leak the ``/metrics`` port or
    the worker thread), and the FIRST failure is re-raised at the end
    unless ``suppress`` (error paths, where a cleanup failure must not
    mask the original exception)."""
    first: Optional[BaseException] = None
    for step in steps:
        try:
            step()
        except BaseException as e:
            if first is None:
                first = e
    if first is not None and not suppress:
        raise first


class ObservedService:
    """The observability wiring both service configs share: the
    endpoint with its device probe, the flight recorder, and their
    teardown. A subclass has the ``metrics``, ``metrics_port``,
    ``flight_recorder_dir``, ``flight_recorder_interval_s`` and
    ``verbose`` fields, and gives ``_request_log()`` (its RequestLog),
    ``_status_providers()`` and ``_teardown_service(suppress=)``."""

    def _start_observability(self) -> None:
        """Start what the fields ask for, once the service is bound; on a
        failure (a busy port) tear the whole service down (a caller
        catching the error must not inherit live threads), then raise."""
        if self.metrics_port < 0 and not self.flight_recorder_dir:
            return
        try:
            if self.flight_recorder_dir:
                self._start_flight_recorder()
            if self.metrics_port >= 0:
                self._start_obs_server()
        except BaseException:
            self._teardown_service(suppress=True)
            raise

    def _obs_registries(self):
        from zookeeper_tpu_torch.observability.registry import default_registry

        return [default_registry(), self.metrics.registry]

    def _request_log_status(self) -> Dict[str, Any]:
        """The ``requests`` section: the recent terminal-request tail."""
        log = self._request_log()
        return log.as_status() if log is not None else {}

    def _start_flight_recorder(self):
        from zookeeper_tpu_torch.observability import recorder as _recorder

        log = self._request_log()
        rec = _recorder.arm(
            self.flight_recorder_dir, registries=self._obs_registries(),
            status_providers=self._status_providers(), request_logs={log.name: log},
            min_interval_s=self.flight_recorder_interval_s,
        )
        object.__setattr__(self, "flight_recorder", rec)
        if self.verbose:
            print(f"flight recorder armed: {self.flight_recorder_dir} (>= "
                  f"{self.flight_recorder_interval_s:.0f}s between bundles; POST /debugz "
                  "for a manual one)", flush=True)
        return rec

    def _start_obs_server(self):
        from zookeeper_tpu_torch.observability import DeviceProbe, ObservabilityServer

        server = ObservabilityServer(self._obs_registries(), port=self.metrics_port,
                                     status_providers=self._status_providers())
        server.start()
        object.__setattr__(self, "obs_server", server)
        # An eager first poll: the zk_hbm_* gauges render from the first
        # scrape.
        probe = DeviceProbe()
        probe.poll_once()
        probe.start()
        object.__setattr__(self, "obs_probe", probe)
        if self.verbose:
            print(f"observability endpoint: {server.url}/metrics", flush=True)
        return server

    def _obs_teardown_steps(self):
        """Idempotent stops of the endpoint (it holds an OS port: every
        exit path must release it), the probe and the recorder."""
        from zookeeper_tpu_torch.observability import recorder as _recorder

        steps = []
        for name in ("obs_server", "obs_probe"):
            obj = getattr(self, name, None)
            if obj is not None:
                object.__setattr__(self, name, None)
                steps.append(obj.stop)
        rec = getattr(self, "flight_recorder", None)
        if rec is not None:
            object.__setattr__(self, "flight_recorder", None)
            steps.append(lambda: _recorder.disarm(rec))
        return steps


@task
class ServingConfig(ObservedService):
    """Serve a seeded synthetic request stream through the engine and
    batcher, and report latency percentiles, bucket fill and qps."""

    model: Model = ComponentField()
    #: The layout to serve under (the training one); the default is one
    #: card.
    partitioner: Partitioner = ComponentField(SingleDevicePartitioner)
    #: Forms the process group under a launcher (``torchrun``).
    runtime: DistributedRuntime = ComponentField(DistributedRuntime)
    engine: InferenceEngine = ComponentField(InferenceEngine)
    batcher: MicroBatcher = ComponentField(MicroBatcher)
    metrics: ServingMetrics = ComponentField(ServingMetrics)
    #: Where the serving scalars go (``writer.jsonl.path=...`` /
    #: ``writer.tensorboard.log_dir=...``); off until configured.
    writer: MetricsWriter = ComponentField(CompositeMetricsWriter)

    #: The deployment artifact: a ``save_model`` export or a
    #: ``Checkpointer`` directory (its latest step). None serves weights
    #: initialized from ``seed``.
    checkpoint: Optional[str] = Field(None)
    #: "auto" serves the EMA when the checkpoint carries one, "ema"
    #: requires it, "raw" the training parameters
    #: (``training.checkpoint.select_inference_weights``).
    weights: str = Field("auto")

    #: Per-example input geometry (NHWC images).
    height: int = Field(224)
    width: int = Field(224)
    channels: int = Field(3)
    num_classes: int = Field(1000)
    #: Seeds the weights and the request stream.
    seed: int = Field(0)
    #: Where the model runs: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")
    #: Run every bucket once before serving.
    warmup: bool = Field(True)
    #: Hot-swap each newly finalized step of a live ``Checkpointer``
    #: directory (``checkpoint``) into the warmed engine; ``weights``
    #: picks EMA or raw for the swaps as for the first load.
    watch: bool = Field(False)
    #: The watcher's poll interval, seconds.
    watch_poll_s: float = Field(2.0)
    #: ``run()``'s stream: how many requests, and the largest request.
    requests: int = Field(64)
    max_request: int = Field(8)
    verbose: bool = Field(True)
    #: The live endpoint's port: -1 off, 0 an ephemeral port
    #: (``obs_server.port``).
    metrics_port: int = Field(-1)
    #: Where the flight recorder writes its bundles; None: off.
    flight_recorder_dir: Optional[str] = Field(None)
    #: Least seconds between two bundles (``POST /debugz`` bypasses it).
    flight_recorder_interval_s: float = Field(30.0)

    @property
    def input_shape(self):
        return (self.height, self.width, self.channels)

    def build_service(self):
        """Build the model and load or initialize its weights, bind and
        warm the engine, bind the batcher. Returns ``(engine, batcher)``."""
        if self.weights not in ("auto", "ema", "raw"):
            raise ValueError(f"weights={self.weights!r} unknown; choose auto/ema/raw.")
        if self.requests < 0 or self.max_request < 1:
            raise ValueError(
                f"requests={self.requests} must be >= 0 and "
                f"max_request={self.max_request} >= 1."
            )
        self.runtime.initialize(self.device)
        module = self.model.build(self.input_shape, self.num_classes)
        # The watcher's baseline, listed before the load: the load binds at
        # least this step, so a step finalizing meanwhile stays newer and
        # the first poll swaps it in. In a group every rank takes the
        # chief's and loads that step.
        watch_baseline = None
        if self.watch and self.checkpoint:
            from zookeeper_tpu_torch.training.checkpoint import finalized_steps

            steps = finalized_steps(self.checkpoint)
            watch_baseline = distributed.broadcast_from_chief(steps[-1] if steps else None)
        if self.checkpoint:
            from zookeeper_tpu_torch.training.checkpoint import (
                export_trees,
                load_inference_model,
                load_into_module,
            )

            params_like, state_like = export_trees(module)
            params, model_state = load_inference_model(
                self.checkpoint, weights=self.weights,
                params_like=params_like, model_state_like=state_like,
                **({"step": watch_baseline}
                   if watch_baseline is not None and distributed.world_size() > 1 else {}),
            )
            load_into_module(module, params, model_state)
        else:
            self.model.initialize(module, seed=self.seed)
        self.partitioner.setup()
        self.engine.bind(
            module, self.input_shape, dtype=self.model.dtype(), device=self.device,
            partitioner=self.partitioner,
        )
        if self.warmup:
            self.engine.warmup()
        self.batcher.bind(self.engine, metrics=self.metrics)
        if self.watch:
            if not self.checkpoint:
                raise ValueError(
                    "watch=True needs checkpoint= pointing at a live Checkpointer "
                    "directory to stream steps from."
                )
            led = distributed.chief_led(self.engine)
            watcher = self.engine.watch_checkpoints(
                self.checkpoint, weights=self.weights, poll_interval_s=self.watch_poll_s,
                metrics=self.metrics, initial_step=watch_baseline, start=not led)
            if led:
                # Every rank follows; only the chief's watcher polls.
                self.batcher.follow(watcher)
                if self.partitioner.is_chief:
                    watcher.poll_once()
                    watcher.start()
            object.__setattr__(self, "watcher", watcher)
        self._start_observability()
        return self.engine, self.batcher

    def _request_log(self):
        return self.batcher.request_log

    def _status_providers(self):
        return {"serving": self.status, "requests": self._request_log_status}

    def _teardown_service(self, *, suppress: bool = False) -> None:
        """Every exit path's teardown (``run_teardown_steps``): the
        watcher, the endpoint and its probe, the recorder, the batcher."""
        watcher = getattr(self, "watcher", None)
        steps = [watcher.stop] if watcher is not None else []
        run_teardown_steps(steps + self._obs_teardown_steps() + [self.batcher.close],
                           suppress=suppress)

    def status(self) -> Dict[str, Any]:
        """The serving vitals an operator checks before trusting the
        metrics (the ``/statusz`` ``serving`` section): warmed buckets
        and post-warm-up first forwards, the queue, the live weights'
        step and whether the watcher still follows the run (None without
        one)."""
        watcher = getattr(self, "watcher", None)
        return {
            "model": type(self.model).__name__,
            "weights": self.weights,
            "batch_buckets": [int(b) for b in self.engine.batch_buckets],
            "compiles": self.engine.warmed_buckets,
            "recompiles_detected": self.engine.recompiles_detected,
            "queue_rows": self.batcher.queue_rows,
            "packed_deployment": self.engine.packed_deployment,
            "watcher_alive": watcher.alive if watcher is not None else None,
            "serving_weights_step": self.metrics.weights_step,
        }

    def request_stream(self) -> Iterator[np.ndarray]:
        """The seeded stream ``run()`` serves: ``requests`` float32 NHWC
        requests of 1..``max_request`` rows."""
        rng = np.random.default_rng(self.seed)
        for _ in range(self.requests):
            n = int(rng.integers(1, self.max_request + 1))
            yield rng.normal(size=(n, *self.input_shape)).astype(np.float32)

    def finish_report(
        self,
        *,
        warm_compiles: int,
        n_requests: int,
        dt: float,
        writer_extra: Optional[Dict[str, float]] = None,
        result_extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """The one reporting path, shared with the serving tasks that
        override ``run()``: the metrics snapshot (and ``qps`` and
        ``writer_extra``) through the writer, then one result printed as a
        JSON line and returned; closes the batcher. ``warm_compiles`` is
        the engine's ``warmed_buckets`` before traffic: the port's
        counterpart of a compile is a bucket's first run."""
        try:
            qps = n_requests / dt if dt > 0 else 0.0
            chief = self.partitioner.is_chief
            extra = {"qps": qps, **(writer_extra or {})}
            if chief:
                snapshot = self.metrics.emit(self.writer, step=0, extra=extra)
                self.writer.flush()
            else:
                snapshot = self.metrics.snapshot()
            device = self.engine.device
            compiles = self.engine.warmed_buckets
            result = {
                **{k: round(float(v), 4) for k, v in snapshot.items()},
                "model": type(self.model).__name__,
                "weights": self.weights,
                "device": (
                    torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
                ),
                "batch_buckets": [int(b) for b in self.engine.batch_buckets],
                "warmed_buckets": compiles,
                "compiles": compiles,
                "recompiles_after_warmup": compiles - warm_compiles,
                "requests": n_requests,
                "qps": round(qps, 1),
                **({"watcher_alive": self.status()["watcher_alive"]}
                   if getattr(self, "watcher", None) is not None else {}),
                **(result_extra or {}),
            }
            if self.verbose and chief:
                print(json.dumps(result), flush=True)
        finally:
            self._teardown_service()
        return result

    def run(self) -> Dict[str, Any]:
        """Serve the stream, check every answer's shape and finiteness,
        report (``finish_report``)."""
        if self.verbose and self.partitioner.is_chief:
            print(pretty_print(self), flush=True)
        engine, batcher = self.build_service()
        try:
            warm_compiles = engine.warmed_buckets
            pending = []
            rows = 0
            t0 = time.perf_counter()
            for x in self.request_stream():
                pending.append((x.shape[0], batcher.submit(x)))
                rows += x.shape[0]
            batcher.flush()
            dt = time.perf_counter() - t0
            for n, handle in pending:
                out = handle.result()
                if out.shape != (n, self.num_classes) or not np.isfinite(out).all():
                    raise RuntimeError(
                        f"bad answer: shape {out.shape} (want {(n, self.num_classes)}), "
                        f"finite={bool(np.isfinite(out).all())}"
                    )
        except BaseException:
            self._teardown_service(suppress=True)
            raise
        rows_per_sec = rows / dt if dt > 0 else 0.0
        return self.finish_report(
            warm_compiles=warm_compiles, n_requests=self.requests, dt=dt,
            writer_extra={"rows_per_sec": rows_per_sec},
            result_extra={"rows_per_sec": rows_per_sec},
        )
