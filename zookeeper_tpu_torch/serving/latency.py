"""Serving-engine latency as a task, the port of
``examples/latency_bench.py``'s ``LatencyBench``::

    python -m zookeeper_tpu_torch.serving LatencyBench model=QuickNet \\
        model.compute_dtype=bfloat16
    python -m zookeeper_tpu_torch.serving LatencyBench model=BinaryNet \\
        "model.features=(128,128,256,256)" "model.dense_units=(512,)" \\
        model.binary_compute=xnor model.packed_weights=True \\
        height=32 width=32 num_classes=10 checkpoint=/tmp/cifar_packed batch_size=8

The model (from an export or a ``Checkpointer`` directory, else seeded)
is bound to an ``InferenceEngine`` with one bucket of ``batch_size``,
warmed, and timed with ``training.benchmark.measure_serving_latency``:
chains of back-to-back ``infer`` dispatches ended by one host readback,
the marginal over two chain lengths (the mean) and short chains (p50,
p99). It prints one JSON line: ``model``, ``batch_size``,
``ms_per_inference``, ``p50_ms``, ``p99_ms``, ``params_mib`` and
``compiles`` (the engine's warmed buckets: the port's counterpart of a
compiled shape).
"""

import json
from typing import Optional

import numpy as np

from zookeeper_tpu_torch.core import ComponentField, Field, configure, task
from zookeeper_tpu_torch.models import Model
from zookeeper_tpu_torch.serving.engine import InferenceEngine
from zookeeper_tpu_torch.training.benchmark import measure_serving_latency
from zookeeper_tpu_torch.training.checkpoint import (
    export_trees,
    load_inference_model,
    load_into_module,
)
from zookeeper_tpu_torch.training.experiment import Experiment


@task
class LatencyBench(Experiment):
    """Time the serving engine's forward of a model, optionally from a
    checkpoint."""

    model: Model = ComponentField()
    #: A ``save_model``/``ConvertPacked`` export or a ``Checkpointer``
    #: directory; seeded weights when None.
    checkpoint: Optional[str] = Field(None)
    #: "auto" (the EMA when the checkpoint has one), "ema" or "raw".
    weights: str = Field("auto")
    batch_size: int = Field(1)
    height: int = Field(224)
    width: int = Field(224)
    channels: int = Field(3)
    num_classes: int = Field(1000)
    #: The long chain's length (the short chain is a third of it).
    chain_length: int = Field(48)
    rounds: int = Field(4)
    seed: int = Field(0)
    #: Where the model runs: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")

    def run(self) -> dict:
        input_shape = (self.height, self.width, self.channels)
        module = self.model.build(input_shape, self.num_classes)
        if self.checkpoint:
            params_like, state_like = export_trees(module)
            params, model_state = load_inference_model(
                self.checkpoint, weights=self.weights,
                params_like=params_like, model_state_like=state_like,
            )
            load_into_module(module, params, model_state)
        else:
            self.model.initialize(module, seed=self.seed)
        params_bytes = sum(t.numel() * t.element_size() for t in export_trees(module)[0].values())

        engine = InferenceEngine()
        configure(engine, {"batch_buckets": (self.batch_size,)}, name="engine")
        engine.bind(module, input_shape, dtype=self.model.dtype(), device=self.device)
        engine.warmup()  # first-shape costs outside the timed window

        rng = np.random.default_rng(self.seed)
        x = rng.normal(size=(self.batch_size, *input_shape)).astype(np.float32)
        n2 = max(2, self.chain_length)
        n1 = max(1, n2 // 3)
        mean_s, p50_s, p99_s = measure_serving_latency(
            engine, x, n1=n1, n2=n2, rounds=self.rounds,
            percentile_samples=max(4, self.rounds * 2),
        )
        # Pathological jitter can invert the marginal: floor, never negative.
        seconds = max(mean_s, 1e-9)
        result = {
            "model": type(self.model).__name__,
            "batch_size": self.batch_size,
            "ms_per_inference": round(seconds * 1e3, 4),
            "p50_ms": round(p50_s * 1e3, 4),
            "p99_ms": round(p99_s * 1e3, 4),
            "params_mib": round(params_bytes / 2**20, 2),
            "compiles": engine.warmed_buckets,
        }
        print(json.dumps(result), flush=True)
        return result
