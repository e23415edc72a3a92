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
(``(bucket, sequence bucket, dtype, mesh)`` with sequence buckets) is
its "program" (``observability.ledger``): it runs under forward hooks
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
launch.

**Sequence buckets** (``seq_buckets``, for token models bound with an
integer ``dtype``): axis 1 of a request is right-padded with zeros to
the smallest sequence bucket holding it, so the card sees ``(batch
bucket, sequence bucket)`` pairs only, and ``warmup()`` runs every pair
(``compile_count`` is then ``len(batch_buckets) * len(seq_buckets)``).
Padding keeps the real positions' answers only under causal attention;
a model that attends both ways serves at exact lengths. The ledger rows,
the warmed set, the FLOPs behind ``zk_serve_mfu`` and the dispatch guard
are keyed by the pair (with the dtype and the mesh). Whether output
axis 1 follows the sequence, so that ``infer`` slices it back to the
request's length, is decided once per sequence bucket by the shapes of
the pair's first forward and of one more forward at batch 1 one
position shorter (the JAX engine traces both abstractly; the kernel
wrappers cannot run on meta tensors). A pooled ``[batch, classes]``
head whose class count equals a sequence bucket therefore keeps every
class.
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
    #: Sequence-length buckets for token inputs (empty: no sequence
    #: padding). Right-padding keeps the answers only under causal
    #: attention; a model that attends both ways serves at exact lengths.
    seq_buckets: Sequence[int] = Field(())

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
        ``dtype`` the dtype inputs are sent to the card in (token models
        pass ``torch.int32``).
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
        seq_buckets = tuple(int(s) for s in self.seq_buckets)
        if seq_buckets and list(seq_buckets) != sorted(set(seq_buckets)):
            raise ValueError(f"seq_buckets={self.seq_buckets!r} must be strictly ascending.")
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
        # Whether output axis 1 follows the sequence, by sequence bucket.
        object.__setattr__(self, "_out_tracks_seq", {})
        # Ledger rows by (bucket, seq bucket, dtype, mesh); warmup() ends
        # the warm-up window.
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
    def compile_count(self) -> int:
        """Programs run so far (the JAX engine's compile-cache misses):
        after ``warmup()`` exactly ``len(batch_buckets) * max(1,
        len(seq_buckets))``, and serving warmed pairs does not move it."""
        return len(getattr(self, "_warmed", ()))

    #: The port's earlier name of ``compile_count``: the pairs run at least
    #: once (by ``warmup()`` or traffic).
    warmed_buckets = compile_count

    @property
    def recompiles_detected(self) -> int:
        """First forwards at an unwarmed ``(bucket, mesh)`` after
        ``warmup()`` (each one stalled its requests), mirrored to
        ``zk_serving_recompiles_total`` and a ``recompile_detected``
        event as they happen."""
        return getattr(self, "_recompiles_detected", 0)

    @property
    def programs(self) -> dict:
        """This engine's ledger rows by ``(bucket, seq_bucket, dtype,
        mesh)`` (``seq_bucket`` None without sequence buckets)."""
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

    def _seq_bucket_for(self, seq: int) -> int:
        """Smallest sequence bucket holding ``seq`` positions."""
        for s in self.seq_buckets:
            if int(s) >= seq:
                return int(s)
        raise ValueError(
            f"sequence length {seq} exceeds the largest seq bucket "
            f"{max(int(s) for s in self.seq_buckets)}; widen seq_buckets."
        )

    def buckets_of(self, x: Any) -> tuple:
        """``(bucket, seq_bucket)`` a batch ``x`` runs at (``seq_bucket``
        None without sequence buckets)."""
        shape = np.shape(x)
        seq_bucket = None
        if self.seq_buckets:
            if len(shape) < 2:
                raise ValueError(
                    "seq_buckets configured but the input has no sequence "
                    f"axis (shape {tuple(shape)})."
                )
            seq_bucket = self._seq_bucket_for(int(shape[1]))
        return self.bucket_for(int(shape[0])), seq_bucket

    def _bucket_shape(self, bucket: int, seq_bucket: Optional[int]) -> tuple:
        if seq_bucket is None:
            return (bucket, *self._input_shape)
        return (bucket, seq_bucket, *self._input_shape[1:])

    def warmup(self) -> int:
        """Run every bucket (every ``(bucket, seq_bucket)`` pair) once on
        zeros so no request pays a first-shape cost (kernel build and
        load, cuDNN algorithm choice, allocator growth). Returns the
        number of warmed pairs."""
        self._require_bound()
        seqs = tuple(int(s) for s in self.seq_buckets) or (None,)
        for bucket in self.batch_buckets:
            for seq in seqs:
                self.infer(np.zeros(self._bucket_shape(int(bucket), seq), np.float32))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        # From here on, a first forward on the request path is a stall.
        object.__setattr__(self, "_warm_done", True)
        return self.warmed_buckets

    def _note_recompile(self, bucket: int, seq_bucket: Optional[int]) -> None:
        """A post-warm-up first forward on the request path: counted,
        traced, logged and handed to the flight recorder."""
        object.__setattr__(self, "_recompiles_detected", self._recompiles_detected + 1)
        _ledger.recompile_counter().inc()
        attrs = {"bucket": bucket, "seq_bucket": seq_bucket, "dtype": _dtype_name(self._dtype)}
        _trace.event("recompile_detected", attrs=attrs)
        _recorder.notify("recompile_detected", attrs=attrs)
        logger.warning(
            "post-warmup first forward on the request path (bucket=%d, seq=%s, dtype=%s): "
            "requests are stalling on it — widen or rewarm the bucket ladder",
            bucket, seq_bucket, _dtype_name(self._dtype))

    def _tracks_seq(self, seq_bucket: int, out: torch.Tensor) -> bool:
        """Whether output axis 1 follows the sequence: ``out`` (the pair's
        first forward) against one forward at batch 1 and ``seq_bucket -
        1`` positions, made once per sequence bucket. Every rank makes it
        at the same dispatch, so a collective forward stays in step."""
        tracks = self._out_tracks_seq.get(seq_bucket)
        if tracks is None:
            probe_seq = max(1, seq_bucket - 1)
            plan = self.forward_plan(1)
            x = torch.zeros(self._bucket_shape(1, probe_seq), dtype=self._dtype)
            weights = (contextlib.nullcontext() if self._plan is None
                       else self._plan.gathered_weights(self._module))
            with weights, plan.activation_scope():
                probe = plan.assemble(self._module(plan.take(x).to(self._device)))
            a, b = tuple(out.shape), tuple(probe.shape)
            tracks = len(a) >= 2 and len(b) >= 2 and a[1] != b[1]
            self._out_tracks_seq[seq_bucket] = tracks
        return tracks

    def _first_run(self, bucket: int, seq_bucket: Optional[int], x: torch.Tensor,
                   forward) -> torch.Tensor:
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
        seq = f"s{seq_bucket}" if seq_bucket is not None else ""
        record = _ledger.default_ledger().record(
            "serve_forward",
            f"{type(self._partitioner).__name__}/mesh={mesh}/b{bucket}{seq}/"
            f"{_dtype_name(self._dtype)}",
            flops=counter.flops, bytes_accessed=nbytes, compile_ms=compile_ms,
            attrs={"bucket": bucket, "seq_bucket": seq_bucket,
                   "during_dispatch": during_dispatch},
        )
        self._programs[self._key(bucket, seq_bucket)] = record
        return out

    def _key(self, bucket: int, seq_bucket: Optional[int]) -> tuple:
        """A program's key, as the JAX engine's compile cache keys it."""
        return (bucket, seq_bucket, _dtype_name(self._dtype), self._mesh_key)

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
        pad with zero rows to the bucket (and, with sequence buckets, axis
        1 with zeros to the sequence bucket), run, slice the padding off.
        Returns a tensor on the engine's device; the caller decides when
        to pay the readback (the batcher does one per dispatch)."""
        self._require_bound()
        x = torch.as_tensor(np.asarray(x)).to(self._dtype)
        bucket, seq_bucket = self.buckets_of(x)
        # The per-example shape, but for the sequence axis a bucket pads.
        fixed = 2 if seq_bucket is not None else 1
        if tuple(x.shape[fixed:]) != self._input_shape[fixed - 1:]:
            raise ValueError(
                f"request rows have shape {tuple(x.shape[1:])}, the engine "
                f"serves {self._input_shape}."
            )
        n = x.shape[0]
        orig_seq = x.shape[1] if seq_bucket is not None else None
        if self.collective:
            distributed.check_same_dispatch(
                (0, bucket, n, 0) if seq_bucket is None else (0, bucket, n, seq_bucket, orig_seq),
                "InferenceEngine")
        if seq_bucket is not None and seq_bucket != orig_seq:
            x = torch.cat([x, x.new_zeros((n, seq_bucket - orig_seq, *x.shape[2:]))], dim=1)
        if bucket != n:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        plan = self.forward_plan(bucket)
        weights = (contextlib.nullcontext() if self._plan is None
                   else self._plan.gathered_weights(self._module))

        def forward():
            with weights, plan.activation_scope():
                return self._module(plan.take(x).to(self._device))

        # Keyed as the JAX engine's compile cache is: the bucket pair, the
        # dtype and the mesh.
        key = self._key(bucket, seq_bucket)
        first = key not in self._warmed
        if first and self._warm_done:
            self._note_recompile(bucket, seq_bucket)
        attrs = None
        if _trace.enabled():
            attrs = {"rows": int(n), "bucket": bucket}
            if seq_bucket is not None:
                attrs["seq_bucket"] = seq_bucket
        with torch.inference_mode(), self._swap_lock, _trace.span("engine_infer", attrs=attrs):
            out = plan.assemble(self._first_run(bucket, seq_bucket, x, forward) if first
                                else forward())
            if seq_bucket is not None and self._tracks_seq(seq_bucket, out) \
                    and orig_seq != seq_bucket:
                out = out[:, :orig_seq]
            out = out[:n]
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
    daemon thread every ``poll_interval_s``; ``stop()`` is idempotent.

    Under chief-led dispatch (``MicroBatcher.follow``) the chief's watcher
    only proposes each new step to its batcher, and every rank's
    dispatch thread loads it and swaps it in at the same dispatch
    boundary (``apply_step``); a follower's watcher never polls."""

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
        # Chief-led dispatch: the batcher followed, whether this rank's
        # polls propose (the chief) and the step last proposed.
        self._dispatcher: Any = None
        self._proposes = False
        self._proposed: Optional[int] = None

    def _follow(self, dispatcher, *, propose: bool) -> None:
        self._dispatcher = dispatcher
        self._proposes = bool(propose)

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
        if self._stop.is_set():
            return False
        if self._dispatcher is not None and not self._proposes:
            return True  # a follower follows through its batcher
        thread = self._thread
        return thread is not None and thread.is_alive()

    def poll_once(self) -> Optional[int]:
        """One poll: when a finalized step newer than ``current_step``
        exists, load it and swap it in. Returns the newly live step, or
        None (nothing new, or the newest step could not be loaded)."""
        with self._poll_lock:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> Optional[int]:
        from zookeeper_tpu_torch.training import checkpoint as ckpt

        if self._dispatcher is not None and not self._proposes:
            return None  # a follower: the chief's records carry the steps
        steps = ckpt.finalized_steps(self._directory)
        if not steps:
            return None
        newest = steps[-1]
        if self._current_step is not None and newest <= self._current_step:
            return None
        if self._dispatcher is not None:
            if self._proposed is None or newest > self._proposed:
                self._proposed = newest
                self._dispatcher._propose_step(newest)
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
        return self._swap_in(newest, (params, model_state), t0)

    def apply_step(self, step: int, link) -> Optional[int]:
        """Chief-led dispatch: load ``step`` and swap it in, on every rank
        from its dispatch thread at the boundary the chief's record names.
        The ranks agree over ``link`` that every load succeeded, so all
        swap or none does (the chief's watcher then proposes the step
        again at its next poll). Returns the newly live step or None."""
        from zookeeper_tpu_torch.training import checkpoint as ckpt

        t0 = time.perf_counter()
        trees = None
        try:
            trees = ckpt.load_inference_model(self._directory, weights=self._weights, step=step)
        except Exception as e:
            logger.warning("checkpoint watcher: step %d could not be loaded (%s); the "
                           "chief proposes it again at its next poll", step, e)
        if not link.agree(trees is not None):
            self._proposed = None
            return None
        try:
            return self._swap_in(int(step), trees, t0, ", chief-led")
        except ValueError as e:
            logger.error("checkpoint watcher stopped: %s", e)
            return None

    def _swap_in(self, step: int, trees, t0: float, how: str = "") -> int:
        """Swap the loaded ``trees`` in as ``step`` (a configuration error
        stops the watcher and raises), then time, trace, count and log the
        swap from ``t0``, the start of its load. Returns ``step``."""
        try:
            self._engine.swap_weights(*trees)
        except ValueError:
            self._record_fatal_stop()
            raise
        if self._engine.device.type == "cuda":
            torch.cuda.synchronize(self._engine.device)
        swap_ms = (time.perf_counter() - t0) * 1e3
        self._current_step = step
        self._swaps += 1
        _trace.event("ckpt_hot_swap", step=step, attrs={"swap_ms": round(swap_ms, 3)})
        if self._metrics is not None:
            self._metrics.record_weight_swap(swap_ms, step)
        logger.info("serving weights hot-swapped to training step %d (%.1f ms%s)",
                    step, swap_ms, how)
        return step

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
