"""Bucketed inference engine over a bound ``nn.Module``.

The port of ``zookeeper_tpu/serving/engine.py``'s ``InferenceEngine``.
Request batches are padded with zero rows up to the smallest of a few
batch *buckets*, so the card only ever sees a handful of shapes (the
kernels' launch geometry, cuDNN's algorithm choice and the caching
allocator's blocks settle once per bucket at ``warmup()``), and the
padding rows are sliced back off. Inference is row-independent
(BatchNorm uses running statistics), so a request's rows give the same
answer whichever bucket they ride in.

Under a partitioner (``bind(..., partitioner=...)``) the module serves in
the layout it trained with (``Partitioner.plan_variables``: the
tensor-parallel layers on their channel blocks, FSDP's shards gathered
for each dispatch and freed after, so between requests a rank holds only
its shards), and each bucket follows its plan (``compile_forward``): a
bucket whose rows divide the data-axis product runs each rank on its
share of the rows and gathers the outputs over the data group, any other
runs replicated; ``infer`` returns every row on every rank. The engine is
collective when the partitioner spans several ranks: every rank must
make the same dispatches (the synchronous ``MicroBatcher`` on the same
stream does), and each dispatch checks that they agree.

**Hot weight swaps.** ``swap_weights`` replaces the served weights (the
export trees, ``{flax path: tensor}``) in place after checking them
against the bound structure, leaf shapes and dtypes (``serving.weights``;
under a partitioner each rank keeps its block through the plan ``bind``
cut it with). A dispatch and a swap exclude each other, so every batch
is served wholly by one weight version. :class:`CheckpointWatcher`
(``watch_checkpoints``) follows a live training run: it polls a
``Checkpointer`` directory for newly finalized steps
(``training.checkpoint.finalized_steps``) and swaps each one in,
loaded as a service's first load is (``load_inference_model``).

**Programs and the ledger.** A ``(bucket, mesh)`` pair's first forward
is its "program" (``observability.ledger``): it runs under forward hooks
that count ``2*M*N*K`` for every conv and dense layer (packed, int8 or
float alike), ends in a device synchronisation, and lands one
``serve_forward`` ledger row with the counted FLOPs, the bytes (weights,
input and output once) and its wall time. After ``warmup()`` a first
forward at an unwarmed pair is a serving stall: it counts
``zk_serving_recompiles_total``, emits ``recompile_detected`` and
notifies the flight recorder. ``observe_dispatch(rows, seconds)`` (the
``MicroBatcher``, after each readback) feeds the ``serve_dispatch``
watchdog and publishes ``zk_serve_dispatch_ms``,
``zk_serve_dispatch_rows``, ``zk_serve_mfu`` (the bucket's counted FLOPs
over the wall time over the card's bf16 peak) and ``zk_serve_mfu_int8``
(over the int8 peak; -1 unless the deployment is packed). A warmed
pair's forward adds host arithmetic only: no synchronisation, no
launch. Not ported yet (ROADMAP.md): sequence buckets.
"""

import contextlib
import logging
import os
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability import ledger as _ledger
from zookeeper_tpu_torch.observability import peaks as _peaks
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.serving import weights as _weights

logger = logging.getLogger(__name__)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@component
class InferenceEngine:
    """Bucketed forward passes over a bound model. ``infer(x)`` serves one
    assembled batch of at most ``max_batch`` rows; coalescing and
    splitting live in :class:`~zookeeper_tpu_torch.serving.batcher.\
MicroBatcher`."""

    #: Padded batch sizes, ascending. The largest is the engine's max
    #: dispatch size (the batcher splits bigger requests).
    batch_buckets: Sequence[int] = Field((1, 8, 32, 128))

    def bind(
        self,
        module: nn.Module,
        input_shape: Sequence[int],
        *,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
        partitioner: Any = None,
    ) -> "InferenceEngine":
        """Attach the model to serve: moved to ``device`` and put in eval
        mode. ``input_shape`` is the per-example shape (no batch dim);
        ``dtype`` the dtype inputs are sent to the card in.
        ``partitioner`` (default: one card) serves under a training
        layout; every rank binds the same weights."""
        buckets = tuple(int(b) for b in self.batch_buckets)
        if not buckets or any(b < 1 for b in buckets) or list(buckets) != sorted(
            set(buckets)
        ):
            raise ValueError(
                f"batch_buckets={self.batch_buckets!r} must be a non-empty, "
                "strictly-ascending tuple of positive sizes."
            )
        if partitioner is None:
            from zookeeper_tpu_torch.parallel.partitioner import SingleDevicePartitioner

            partitioner = SingleDevicePartitioner()
        partitioner.setup()
        device = distributed.local_device(device)
        object.__setattr__(self, "_swap_layout", None)  # taken at the first swap
        object.__setattr__(self, "_swap_lock", threading.Lock())
        module = module.to(device).eval()
        object.__setattr__(self, "_module", module)
        object.__setattr__(self, "_partitioner", partitioner)
        object.__setattr__(self, "_plan", partitioner.plan_variables(module))
        object.__setattr__(self, "_mesh_key", tuple(partitioner.mesh_sizes.items()))
        object.__setattr__(self, "_forward_plans", {})
        object.__setattr__(self, "_input_shape", tuple(int(s) for s in input_shape))
        object.__setattr__(self, "_dtype", dtype)
        object.__setattr__(self, "_device", device)
        object.__setattr__(self, "_warmed", set())
        # Ledger rows by (bucket, mesh); warmup() ends the warm-up window.
        object.__setattr__(self, "_programs", {})
        object.__setattr__(self, "_warm_done", False)
        object.__setattr__(self, "_recompiles_detected", 0)
        object.__setattr__(self, "_last_program", None)
        _ledger.recompile_counter()
        # The dispatch gauges render from the first scrape (-1 = unknown);
        # handles, since observe_dispatch sets them once a dispatch. The
        # peaks resolve once: the card and the packing (a swap keeps the
        # structure) do not change under a bound engine.
        reg = default_registry()
        object.__setattr__(self, "_dispatch_gauges", (
            reg.gauge("zk_serve_dispatch_ms",
                      help="last coalesced dispatch wall time (readback-bounded)"),
            reg.gauge("zk_serve_dispatch_rows",
                      help="occupied (pre-padding) rows of the last coalesced dispatch — "
                      "goodput context for the padded-bucket MFU"),
            reg.gauge("zk_serve_mfu", initial=-1,
                      help="last dispatch: counted FLOPs / wall time / bf16 peak (-1 = "
                      "unknown)"),
            reg.gauge("zk_serve_mfu_int8", initial=-1,
                      help="last packed-deployment dispatch: counted FLOPs / wall time / "
                      "int8 peak (-1 = not a packed deployment, or unknown)"),
        ))
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        object.__setattr__(self, "_mfu_peaks", (
            _peaks.reference_peak_flops(kind)[0],
            _peaks.reference_int8_peak_flops(kind)[0] if self.packed_deployment else None))
        return self

    @property
    def collective(self) -> bool:
        """Whether the engine's partitioner spans several ranks: every
        rank must then make the same dispatches."""
        return getattr(self, "_partitioner", None) is not None and \
            self._partitioner.process_span() > 1

    def forward_plan(self, bucket: int):
        """The bucket's :class:`~zookeeper_tpu_torch.parallel.ForwardPlan`
        (``Partitioner.compile_forward``), made once per bucket."""
        self._require_bound()
        plan = self._forward_plans.get(bucket)
        if plan is None:
            plan = self._partitioner.compile_forward(batch_rows=bucket)
            self._forward_plans[bucket] = plan
        return plan

    def _require_bound(self) -> None:
        if getattr(self, "_module", None) is None:
            raise RuntimeError(
                "InferenceEngine is not bound: call engine.bind(module, "
                "input_shape) before warmup()/infer()."
            )

    def swap_weights(self, params: Any, model_state: Any = None) -> None:
        """Replace the served weights in place, with no rebind. The new
        trees must match the bound ones in structure, leaf shapes and
        dtypes (``ValueError`` otherwise, before anything changes). A swap
        waits for the dispatch in flight, so each batch is served wholly
        by one version."""
        self._require_bound()
        if self._swap_layout is None:
            object.__setattr__(self, "_swap_layout",
                               _weights.weight_layout(self._module, self._plan))
        _weights.check_swap(self._swap_layout, params, model_state, "warmed buckets")
        with self._swap_lock, _trace.span("weight_swap"):
            _weights.load_weights(self._module, self._plan, params, model_state)

    def watch_checkpoints(self, directory: str, *, weights: str = "ema",
                          poll_interval_s: float = 2.0, metrics: Any = None,
                          start: bool = True,
                          initial_step: Optional[int] = None) -> "CheckpointWatcher":
        """Serve a live training run: poll ``directory`` (a
        ``Checkpointer`` tree) for newly finalized steps and swap each one
        in. ``weights`` picks EMA or raw as the cold loaders do;
        ``metrics`` (a ``ServingMetrics``) records ``weight_swaps``,
        ``weight_swap_ms`` and ``serving_weights_step``;
        ``initial_step`` marks that step as live already (the caller
        bound its weights), so start-up does not load it again.
        ``start=False`` returns the watcher unstarted, for
        ``poll_once``. With ``start=True`` the first poll runs on the
        calling thread, so a configuration error (``weights="ema"``
        against a run without an EMA, a structure mismatch) raises here
        rather than on the daemon thread. A directory that does not
        exist yet is a warning, not an error."""
        self._require_bound()
        if not os.path.isdir(os.path.expanduser(directory)):
            logger.warning(
                "watch_checkpoints: %r does not exist (yet); polling continues — if "
                "this path is misspelled, no checkpoint will ever stream in", directory)
        watcher = CheckpointWatcher(self, directory, weights=weights,
                                    poll_interval_s=poll_interval_s, metrics=metrics,
                                    initial_step=initial_step)
        if start:
            watcher.poll_once()
            watcher.start()
        return watcher

    @property
    def device(self) -> torch.device:
        self._require_bound()
        return self._device

    @property
    def packed_deployment(self) -> bool:
        """True when the bound module holds bit-packed kernels."""
        self._require_bound()
        return any(name.endswith("kernel_packed") for name, _ in self._module.named_buffers())

    @property
    def max_batch(self) -> int:
        return max(int(b) for b in self.batch_buckets)

    @property
    def warmed_buckets(self) -> int:
        """Buckets run at least once (by ``warmup()`` or traffic)."""
        return len(getattr(self, "_warmed", ()))

    @property
    def recompiles_detected(self) -> int:
        """First forwards at an unwarmed ``(bucket, mesh)`` after
        ``warmup()`` (each one stalled its requests), mirrored to
        ``zk_serving_recompiles_total`` and a ``recompile_detected``
        event as they happen."""
        return getattr(self, "_recompiles_detected", 0)

    @property
    def programs(self) -> dict:
        """This engine's ledger rows by ``(bucket, mesh)``."""
        return dict(getattr(self, "_programs", {}))

    def bucket_for(self, n: int) -> int:
        """Smallest batch bucket holding ``n`` rows."""
        if n < 1:
            raise ValueError(f"batch of {n} rows is not servable.")
        for b in self.batch_buckets:
            if int(b) >= n:
                return int(b)
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket {self.max_batch}; "
            "split it (MicroBatcher does this automatically) or widen "
            "batch_buckets."
        )

    def warmup(self) -> int:
        """Run every bucket once on zeros so no request pays a first-shape
        cost (kernel build and load, cuDNN algorithm choice, allocator
        growth). Returns the number of warmed buckets."""
        self._require_bound()
        for bucket in self.batch_buckets:
            self.infer(np.zeros((int(bucket), *self._input_shape), np.float32))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        # From here on, a first forward on the request path is a stall.
        object.__setattr__(self, "_warm_done", True)
        return self.warmed_buckets

    def _note_recompile(self, bucket: int) -> None:
        """A post-warm-up first forward on the request path: counted,
        traced, logged and handed to the flight recorder."""
        object.__setattr__(self, "_recompiles_detected", self._recompiles_detected + 1)
        _ledger.recompile_counter().inc()
        attrs = {"bucket": bucket, "seq_bucket": None, "dtype": _dtype_name(self._dtype)}
        _trace.event("recompile_detected", attrs=attrs)
        _recorder.notify("recompile_detected", attrs=attrs)
        logger.warning(
            "post-warmup first forward on the request path (bucket=%d, dtype=%s): "
            "requests are stalling on it — widen or rewarm the bucket ladder",
            bucket, _dtype_name(self._dtype))

    def _first_run(self, bucket: int, x: torch.Tensor, forward) -> torch.Tensor:
        """A program's first forward: counted (FLOPs from the layers,
        bytes from the shapes), synchronised, timed and ledgered."""
        during_dispatch = self._warm_done
        gathered = set() if self._plan is None else set(self._plan.gathered)
        weight_bytes = sum(
            (self._plan.numel(name, p) if name in gathered else p.numel()) * p.element_size()
            for name, p in self._module.named_parameters())
        weight_bytes += sum(b.numel() * b.element_size() for b in self._module.buffers())
        counter = _ledger.ContractionFlops(self._module)
        t0 = time.perf_counter()
        with counter:
            out = forward()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        compile_ms = (time.perf_counter() - t0) * 1e3
        nbytes = weight_bytes + x.numel() * x.element_size() + out.numel() * out.element_size()
        mesh = "x".join(f"{k}:{v}" for k, v in self._mesh_key) or "1"
        record = _ledger.default_ledger().record(
            "serve_forward",
            f"{type(self._partitioner).__name__}/mesh={mesh}/b{bucket}/{_dtype_name(self._dtype)}",
            flops=counter.flops, bytes_accessed=nbytes, compile_ms=compile_ms,
            attrs={"bucket": bucket, "seq_bucket": None, "during_dispatch": during_dispatch},
        )
        self._programs[(bucket, self._mesh_key)] = record
        return out

    def observe_dispatch(self, rows: int, seconds: float) -> None:
        """Record one completed, readback-bounded dispatch (the
        ``MicroBatcher`` calls this after its ``.cpu()``; ``infer``
        returns before the card finishes): feed the ``serve_dispatch``
        watchdog and publish ``zk_serve_dispatch_ms``,
        ``zk_serve_dispatch_rows`` (occupied rows before padding),
        ``zk_serve_mfu`` and ``zk_serve_mfu_int8``. The FLOPs are the last
        dispatched bucket's ledger row: the card runs the padded bucket,
        so bucket FLOPs over wall time is the hardware's utilization, and
        the rows gauge says how far request goodput sits from it.
        ``zk_serve_mfu_int8`` divides by the int8 peak and is -1 unless
        the deployment is packed; both render always (-1 = unknown)."""
        if seconds <= 0:
            return
        dog = getattr(self, "_dispatch_watchdog", None)
        if dog is None:
            from zookeeper_tpu_torch.observability.watchdog import StepTimeWatchdog

            # A 5 ms excess floor: host jitter on a sub-ms cadence is no
            # anomaly.
            dog = StepTimeWatchdog("serve_dispatch", min_excess_s=0.005)
            object.__setattr__(self, "_dispatch_watchdog", dog)
        dog.observe(seconds)
        ms, dispatch_rows, gauge, gauge8 = self._dispatch_gauges
        ms.set(seconds * 1e3)
        dispatch_rows.set(max(0, int(rows)))
        peak, peak8 = self._mfu_peaks
        flops = _ledger.cost_flops(self._last_program)
        for g, value in ((gauge, _ledger.mfu(flops, seconds, peak)),
                         (gauge8, _ledger.mfu(flops, seconds, peak8))):
            g.set(value if value is not None else -1)

    def infer(self, x: Any) -> torch.Tensor:
        """Forward one batch ``[n, *input_shape]`` (n <= ``max_batch``):
        pad with zero rows to the bucket, run, slice the padding off.
        Returns a tensor on the engine's device; the caller decides when
        to pay the readback (the batcher does one per dispatch)."""
        self._require_bound()
        x = torch.as_tensor(np.asarray(x)).to(self._dtype)
        if tuple(x.shape[1:]) != self._input_shape:
            raise ValueError(
                f"request rows have shape {tuple(x.shape[1:])}, the engine "
                f"serves {self._input_shape}."
            )
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if self.collective:
            distributed.check_same_dispatch((0, bucket, n, 0), "InferenceEngine")
        if bucket != n:
            x = torch.cat([x, x.new_zeros((bucket - n, *self._input_shape))])
        plan = self.forward_plan(bucket)
        weights = (contextlib.nullcontext() if self._plan is None
                   else self._plan.gathered_weights(self._module))

        def forward():
            with weights, plan.activation_scope():
                return self._module(plan.take(x).to(self._device))

        # Keyed by bucket and mesh, as the JAX engine's compile cache is.
        key = (bucket, self._mesh_key)
        first = key not in self._warmed
        if first and self._warm_done:
            self._note_recompile(bucket)
        with torch.inference_mode(), self._swap_lock, _trace.span(
                "engine_infer", attrs={"rows": int(n), "bucket": bucket}
                if _trace.enabled() else None):
            out = self._first_run(bucket, x, forward) if first else forward()
            out = plan.assemble(out)[:n]
        self._warmed.add(key)
        record = self._programs.get(key)
        if record is not None:
            record.dispatches += 1
        object.__setattr__(self, "_last_program", record)
        return out

    def __call__(self, x: Any) -> torch.Tensor:
        return self.infer(x)


class CheckpointWatcher:
    """Follow a training run's ``Checkpointer`` directory and swap each
    newly finalized step into a live :class:`InferenceEngine`.

    Discovery lists finalized steps only (a torn async write or a crash
    mid-save is never served). A step that vanishes between listing and
    loading (retention racing the poll), or a finalized step that cannot
    be read, is skipped with a warning and retried at the next poll; a
    configuration error (a structure mismatch, ``weights="ema"`` without
    an EMA) stops the watcher and counts ``watcher_stopped``.
    ``poll_once()`` is the deterministic unit; ``start()`` runs it on a
    daemon thread every ``poll_interval_s``; ``stop()`` is idempotent."""

    def __init__(self, engine: InferenceEngine, directory: str, *, weights: str = "ema",
                 poll_interval_s: float = 2.0, metrics: Any = None,
                 initial_step: Optional[int] = None) -> None:
        if weights not in ("auto", "ema", "raw"):
            raise ValueError(f"weights={weights!r} unknown; choose auto/ema/raw.")
        if poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s={poll_interval_s} must be > 0.")
        self._engine = engine
        self._directory = directory
        self._weights = weights
        self._poll_interval_s = float(poll_interval_s)
        self._metrics = metrics
        self._current_step: Optional[int] = (
            int(initial_step) if initial_step is not None else None)
        if initial_step is not None and metrics is not None:
            metrics.record_weights_step(int(initial_step))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._swaps = 0
        self._poll_lock = threading.Lock()

    @property
    def current_step(self) -> Optional[int]:
        """The training step whose weights are live (None until a swap,
        or ``initial_step``)."""
        return self._current_step

    @property
    def swaps(self) -> int:
        return self._swaps

    @property
    def alive(self) -> bool:
        """Whether the daemon poller still follows the directory (False
        after ``stop()`` or a fatal error)."""
        thread = self._thread
        return thread is not None and thread.is_alive() and not self._stop.is_set()

    def poll_once(self) -> Optional[int]:
        """One poll: when a finalized step newer than ``current_step``
        exists, load it and swap it in. Returns the newly live step, or
        None (nothing new, or the newest step could not be loaded)."""
        with self._poll_lock:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> Optional[int]:
        from zookeeper_tpu_torch.training import checkpoint as ckpt

        steps = ckpt.finalized_steps(self._directory)
        if not steps:
            return None
        newest = steps[-1]
        if self._current_step is not None and newest <= self._current_step:
            return None
        t0 = time.perf_counter()
        try:
            params, model_state = ckpt.load_inference_model(
                self._directory, weights=self._weights, step=newest)
        except ckpt.CheckpointUnreadableError as e:
            logger.warning("checkpoint watcher: step %d could not be loaded (%s); "
                           "retrying at the next poll", newest, e)
            return None
        except ValueError:
            self._record_fatal_stop()
            raise
        except Exception as e:
            logger.warning("checkpoint watcher: step %d could not be loaded (%s); "
                           "retrying at the next poll", newest, e)
            return None
        try:
            self._engine.swap_weights(params, model_state)
        except ValueError:
            self._record_fatal_stop()
            raise
        if self._engine.device.type == "cuda":
            torch.cuda.synchronize(self._engine.device)
        swap_ms = (time.perf_counter() - t0) * 1e3
        self._current_step = newest
        self._swaps += 1
        _trace.event("ckpt_hot_swap", step=newest, attrs={"swap_ms": round(swap_ms, 3)})
        if self._metrics is not None:
            self._metrics.record_weight_swap(swap_ms, newest)
        logger.info("serving weights hot-swapped to training step %d (%.1f ms)",
                    newest, swap_ms)
        return newest

    def _record_fatal_stop(self) -> None:
        """Stop over a configuration error; the metric lands before the
        flag turns ``alive`` false."""
        if self._metrics is not None:
            self._metrics.record_watcher_stopped()
        self._stop.set()

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:
                    logger.error("checkpoint watcher stopped: %s", e)
                    if not self._stop.is_set():
                        self._record_fatal_stop()
                    return
                self._stop.wait(self._poll_interval_s)

        self._thread = threading.Thread(target=loop, name="zk-ckpt-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None
