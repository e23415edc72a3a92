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

Not ported yet (ROADMAP.md): sequence buckets, hot weight swaps and the
checkpoint watcher, and the program ledger / MFU gauges.
"""

import contextlib
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.parallel import distributed


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
        return self.warmed_buckets

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
        with torch.inference_mode():
            with weights, plan.activation_scope():
                out = self._module(plan.take(x).to(self._device))
            out = plan.assemble(out)[:n]
        # Keyed by bucket and mesh, as the JAX engine's compile cache is.
        self._warmed.add((bucket, self._mesh_key))
        return out

    def __call__(self, x: Any) -> torch.Tensor:
        return self.infer(x)
