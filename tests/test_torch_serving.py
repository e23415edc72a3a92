"""The port's serving stack: ServingConfig end to end on the CPU, and the
MicroBatcher's coalescing against the JAX package's batcher.

The batcher comparison drives both batchers with the same request
sequence in front of the same recording engine double, and requires the
same dispatches (rows per dispatch and bucket), the same delivered rows
and the same metrics.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.serving import MicroBatcher as JaxMicroBatcher
from zookeeper_tpu.serving import ServingMetrics as JaxServingMetrics
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.serving import (
    DeadlineExpiredError,
    MicroBatcher,
    RejectedError,
    ServingConfig,
    ServingMetrics,
)

SMALL = {
    "model": "QuickNet",
    "model.blocks_per_section": (1, 1, 1, 1),
    "model.section_features": (32, 32, 64, 64),
    "model.binary_compute": "xnor_popcount",
    "model.packed_weights": True,
    "model.fold_bn": True,
    "engine.batch_buckets": (1, 4),
    "height": 16, "width": 16, "num_classes": 10,
    "requests": 7, "max_request": 6, "seed": 3,
    "device": "cpu", "verbose": False,
}


def _service(**overrides):
    import zookeeper_tpu_torch.models  # noqa: F401  (registers QuickNet)

    cfg = ServingConfig()
    configure(cfg, {**SMALL, **overrides})
    return cfg


def test_serving_config_run_reports():
    result = _service().run()
    assert result["requests"] == 7
    assert result["warmed_buckets"] == 2
    assert result["device"] == "cpu"
    assert result["latency_p99_ms"] >= result["latency_p50_ms"] > 0
    assert 0 < result["bucket_fill_mean"] <= 1


@pytest.mark.parametrize("binary_compute", ["xnor_popcount", "xnor"])
def test_served_answers_equal_direct_infer(binary_compute):
    """Every answer of the seeded stream (coalesced, split across the
    4-row bucket, padded) equals the engine's own forward of that
    request's rows. Tolerance, not bitwise: on the CPU the fp convs and
    the head pick their kernels by batch size, so a row rounds a little
    differently in a 4-row bucket than alone (the binary convs are exact
    either way)."""
    cfg = _service(**{"model.binary_compute": binary_compute})
    engine, batcher = cfg.build_service()
    stream = list(cfg.request_stream())
    assert any(x.shape[0] > engine.max_batch for x in stream)  # splits happen
    handles = [batcher.submit(x) for x in stream]
    batcher.flush()
    for x, handle in zip(stream, handles):
        got = handle.result()
        assert got.shape == (x.shape[0], 10) and np.isfinite(got).all()
        want = np.concatenate([
            engine.infer(x[i : i + 1]).numpy() for i in range(x.shape[0])
        ])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5 * np.abs(want).max())
    batcher.close()


def test_engine_pads_to_buckets_row_independently():
    cfg = _service()
    engine, _ = cfg.build_service()
    assert [engine.bucket_for(n) for n in (1, 2, 4)] == [1, 4, 4]
    with pytest.raises(ValueError, match="largest bucket"):
        engine.bucket_for(5)
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32)
    out = engine.infer(x)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 10)
    assert engine.packed_deployment


# -- batcher semantics against the JAX batcher --------------------------------


class RecordingEngine:
    """Engine double: a row-wise function, recording each dispatch."""

    batch_buckets = (1, 4, 8)
    max_batch = 8

    def __init__(self, as_torch: bool):
        self.as_torch = as_torch
        self.dispatches = []

    def bucket_for(self, n):
        return next(b for b in self.batch_buckets if b >= n)

    def infer(self, x):
        self.dispatches.append((x.shape[0], self.bucket_for(x.shape[0])))
        out = np.stack([x.sum(axis=1), x.max(axis=1)], axis=1).astype(np.float32)
        return torch.from_numpy(out) if self.as_torch else out


def _drive(batcher_cls, metrics_cls, configure_fn, as_torch, sizes, **conf):
    engine = RecordingEngine(as_torch)
    metrics = metrics_cls()
    configure_fn(metrics, {}, name="metrics")
    batcher = batcher_cls()
    configure_fn(batcher, dict(conf), name="batcher")
    batcher.bind(engine, metrics=metrics)
    rng = np.random.default_rng(len(sizes))
    requests = [rng.normal(size=(n, 5)).astype(np.float32) for n in sizes]
    handles = [batcher.submit(x) for x in requests]
    batcher.flush()
    results = [h.result() for h in handles]
    return engine.dispatches, results, metrics.totals, metrics.snapshot()


@pytest.mark.parametrize(
    "sizes,conf",
    [
        ([3, 1, 11, 4, 2, 7, 1, 5], {}),  # oversized split + partial bucket
        ([29], {}),  # 8 + 8 + 8 + 5
        ([3], {}),  # one partial bucket
        ([5, 6, 7, 2], {"max_queue_rows": 12}),  # backpressure drains inline
    ],
)
def test_batcher_coalescing_matches_jax(sizes, conf):
    got = _drive(MicroBatcher, ServingMetrics, configure, True, sizes, **conf)
    want = _drive(JaxMicroBatcher, JaxServingMetrics, jax_configure, False, sizes, **conf)
    assert got[0] == want[0]  # same (rows, bucket) per dispatch, in order
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    for key in ("requests", "rows", "dispatches"):
        assert got[2][key] == want[2][key]
    for key in ("bucket_fill_mean", "padding_waste_mean", "queue_depth_mean"):
        assert got[3][key] == pytest.approx(want[3][key])


def test_batcher_shedding_and_deadlines():
    engine = RecordingEngine(as_torch=True)
    batcher = MicroBatcher()
    configure(batcher, {"shed_above_rows": 6}, name="batcher")
    batcher.bind(engine)
    first = batcher.submit(np.ones((5, 5), np.float32))
    with pytest.raises(RejectedError):
        batcher.submit(np.ones((2, 5), np.float32))
    expired = batcher.submit(np.ones((1, 5), np.float32), deadline_ms=0)
    batcher.flush()
    assert first.result().shape == (5, 2)
    with pytest.raises(DeadlineExpiredError):
        expired.result()
    assert engine.dispatches == [(5, 8)]  # the expired request never ran


def test_batcher_async_mode_serves():
    engine = RecordingEngine(as_torch=True)
    batcher = MicroBatcher()
    configure(batcher, {"synchronous": False, "max_delay_ms": 1.0}, name="batcher")
    batcher.bind(engine)
    try:
        xs = [np.full((n, 5), n, np.float32) for n in (3, 9, 2)]
        handles = [batcher.submit(x) for x in xs]
        for x, h in zip(xs, handles):
            np.testing.assert_array_equal(h.result(timeout=10)[:, 0], x.sum(axis=1))
    finally:
        batcher.close()
    assert batcher._worker is None
