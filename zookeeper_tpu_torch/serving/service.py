"""The serving config tree: one component from model to warm engine.

The port of ``zookeeper_tpu/serving/service.py``'s ``ServingConfig``, a
``@task`` driven by the port's ``key=value`` CLI::

    python -m zookeeper_tpu_torch.serving ServingConfig model=QuickNetLarge \\
        model.compute_dtype=bfloat16 model.binary_compute=xnor_popcount \\
        model.packed_weights=True model.fold_bn=True

``build_service()`` builds the model, initializes its weights from
``seed`` (a packed model gets the packed form of its float twin, see
``QuickNet.initialize``), binds and warms the engine on ``device`` and
binds the batcher. ``run()`` serves a seeded stream of variable-size
synthetic requests and prints one JSON line of serving metrics.
Checkpoint loading waits (ROADMAP.md): the JAX package's checkpoints are
an orbax format.
"""

import json
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch

from zookeeper_tpu_torch.core import ComponentField, Field, pretty_print, task
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.serving.batcher import MicroBatcher
from zookeeper_tpu_torch.serving.engine import InferenceEngine
from zookeeper_tpu_torch.serving.metrics import ServingMetrics


@task
class ServingConfig:
    """Serve a seeded synthetic request stream through the engine and
    batcher, and report latency percentiles, bucket fill and qps."""

    model: Model = ComponentField()
    engine: InferenceEngine = ComponentField(InferenceEngine)
    batcher: MicroBatcher = ComponentField(MicroBatcher)
    metrics: ServingMetrics = ComponentField(ServingMetrics)

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
    #: ``run()``'s stream: how many requests, and the largest request.
    requests: int = Field(64)
    max_request: int = Field(8)
    verbose: bool = Field(True)

    @property
    def input_shape(self):
        return (self.height, self.width, self.channels)

    def build_service(self):
        """Build and initialize the model, bind and warm the engine, bind
        the batcher. Returns ``(engine, batcher)``."""
        if self.requests < 0 or self.max_request < 1:
            raise ValueError(
                f"requests={self.requests} must be >= 0 and "
                f"max_request={self.max_request} >= 1."
            )
        module = self.model.build(self.input_shape, self.num_classes)
        self.model.initialize(module, seed=self.seed)
        self.engine.bind(
            module, self.input_shape, dtype=self.model.dtype(), device=self.device
        )
        if self.warmup:
            self.engine.warmup()
        self.batcher.bind(self.engine, metrics=self.metrics)
        return self.engine, self.batcher

    def request_stream(self) -> Iterator[np.ndarray]:
        """The seeded stream ``run()`` serves: ``requests`` float32 NHWC
        requests of 1..``max_request`` rows."""
        rng = np.random.default_rng(self.seed)
        for _ in range(self.requests):
            n = int(rng.integers(1, self.max_request + 1))
            yield rng.normal(size=(n, *self.input_shape)).astype(np.float32)

    def run(self) -> Dict[str, Any]:
        """Serve the stream, check every answer's shape and finiteness,
        print and return one JSON-able result."""
        if self.verbose:
            print(pretty_print(self), flush=True)
        engine, batcher = self.build_service()
        try:
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
        finally:
            batcher.close()
        device = engine.device
        result = {
            **self.metrics.snapshot(),
            "model": type(self.model).__name__,
            "device": (
                torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            ),
            "batch_buckets": [int(b) for b in self.engine.batch_buckets],
            "warmed_buckets": engine.warmed_buckets,
            "requests": self.requests,
            "rows_per_sec": rows / dt if dt > 0 else 0.0,
            "qps": self.requests / dt if dt > 0 else 0.0,
        }
        if self.verbose:
            print(json.dumps(result), flush=True)
        return result
