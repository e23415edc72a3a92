"""The port's program ledger, flight recorder and device probe: ledger
records and status against the JAX package's for the same programs,
``mfu``/``mbu`` totality, the counted FLOPs of a small model and of the
LM's programs held to hand counts, the recorder's bundles against the
JAX recorder's for the same trigger sequence, and the probe's ``-1``
gauges on the CPU. Every thread is stopped and joined."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import math
import os

import numpy as np
import pytest
import torch
from torch import nn

from zookeeper_tpu.observability import ledger as jax_ledger
from zookeeper_tpu.observability import recorder as jax_recorder
from zookeeper_tpu.observability import registry as jax_registry
from zookeeper_tpu.observability import requests as jax_requests
from zookeeper_tpu.observability import trace as jax_trace
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.observability import (
    device,
    ledger,
    recorder,
    registry,
    requests,
    trace,
)
from zookeeper_tpu_torch.observability.export import render_prometheus
from zookeeper_tpu_torch.ops.layers import Conv, Dense, QuantConv, QuantDense
from zookeeper_tpu_torch.serving import InferenceEngine

import torch_decode_features as F


class _Compiled:
    """What the JAX ledger reads from a compiled executable."""

    def __init__(self, flops, nbytes):
        self._analysis = {"flops": flops, "bytes accessed": nbytes}

    def cost_analysis(self):
        return self._analysis

    def memory_analysis(self):
        raise RuntimeError("no memory analysis")


#: (kind, key, flops, bytes, compile ms, attrs) of a few programs.
PROGRAMS = (
    ("serve_forward", "SingleDevicePartitioner/b1/float32", 2.5e9, 8e6, 12.3456, {"bucket": 1}),
    ("prefill", "SingleDevicePartitioner/mesh=1/prefill/b1s16", 1e8, 5e5, 3.0, {"slots": 3}),
    ("decode_step", "SingleDevicePartitioner/mesh=1/decode_step", float("nan"), -4.0, None, {}),
    ("draft_decode_step", "x/draft_decode_step", 7.0, None, 0.5, {"slots": 3}),
)


def test_ledger_records_and_status_equal_jax():
    got_reg, want_reg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    got = ledger.ProgramLedger(max_records=3, registry=got_reg)
    want = jax_ledger.ProgramLedger(max_records=3, registry=want_reg)
    for kind, key, flops, nbytes, ms, attrs in PROGRAMS:
        got.record(kind, key, flops=flops, bytes_accessed=nbytes, compile_ms=ms, attrs=attrs)
        want.record(kind, key, compiled=_Compiled(flops, nbytes), compile_ms=ms, attrs=attrs)
    assert got.as_status() == want.as_status()
    assert [r.as_dict() for r in got.entries()] == [r.as_dict() for r in want.entries()]
    assert got.latest("prefill").key == want.latest("prefill").key
    assert got.latest("serve_forward") is None  # evicted past max_records
    assert got.total_compile_ms() == pytest.approx(want.total_compile_ms())
    # The same series and samples (the help text says "warmed", not "compiled").
    samples = [[ln for ln in render_prometheus([r]).splitlines() if not ln.startswith("# HELP")]
               for r in (got_reg, want_reg)]
    assert samples[0] == samples[1]
    row = got.latest("decode_step")
    assert row.flops is None and row.bytes_accessed is None  # nan, negative: unknown
    assert ledger.cost_flops(got.latest("prefill")) == 1e8
    assert ledger.cost_bytes(row) is None and ledger.cost_flops(object()) is None
    got.clear()
    assert got.as_status()["count"] == 0


@pytest.mark.parametrize("args", [
    (1e12, 1.0, 1e15), (1e12, 0.0, 1e15), (None, 1.0, 1e15), (1e12, None, 1e15),
    (1e12, 1.0, None), ("x", 1.0, 1.0), (float("nan"), 1.0, 1.0), (1.0, float("inf"), 1.0),
    (float("inf"), 1.0, 1.0), (-1.0, 1.0, 1.0), (1e300, 1e-300, 1e-300), (5, 2, 10),
])
def test_mfu_and_mbu_are_total_like_jax(args):
    for fn in ("mfu", "mbu"):
        got, want = getattr(ledger, fn)(*args), getattr(jax_ledger, fn)(*args)
        assert got == want or (got is not None and math.isclose(got, want))


class _Tiny(nn.Module):
    """Conv 3->8 (3x3) on 6x6, a binary conv 8->16 (3x3, stride 2), a
    dense 144->10 and a binary dense 10->4, NHWC."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 8, (3, 3))
        self.qconv = QuantConv(8, 16, (3, 3), strides=(2, 2), input_quantizer="ste_sign",
                               kernel_quantizer="ste_sign")
        self.dense = Dense(144, 10)
        self.qdense = QuantDense(10, 4, input_quantizer="ste_sign",
                                 kernel_quantizer="ste_sign")
        gen = torch.Generator().manual_seed(0)
        for m in (self.conv, self.qconv, self.dense, self.qdense):
            m.reset_parameters(gen)

    def forward(self, x):
        y = self.qconv(self.conv(x))
        return self.qdense(self.dense(y.reshape(y.shape[0], -1)))


def test_counted_flops_of_a_small_model_match_a_hand_count():
    engine = InferenceEngine()
    configure(engine, {"batch_buckets": (1, 4)}, name="engine")
    module = _Tiny()
    engine.bind(module, (6, 6, 3), device="cpu")
    assert engine.warmup() == 2
    weights = sum(p.numel() * 4 for p in module.parameters())
    for b in (1, 4):
        hand = 2 * (b * 6 * 6 * 8 * 9 * 3 + b * 3 * 3 * 16 * 9 * 8 + b * 10 * 144 + b * 4 * 10)
        row = engine.programs[(b, None, "float32", ())]
        assert row.kind == "serve_forward" and row.flops == hand
        assert row.bytes_accessed == weights + b * 6 * 6 * 3 * 4 + b * 4 * 4
        assert row.compile_ms > 0 and row.attrs == {
            "bucket": b, "seq_bucket": None, "during_dispatch": False}
        assert row in ledger.default_ledger().entries()
    engine.infer(np.zeros((3, 6, 6, 3), np.float32))
    assert engine.programs[(4, None, "float32", ())].dispatches == 2 and engine.recompiles_detected == 0


def test_counted_flops_of_the_lm_programs_match_a_hand_count():
    _, _, mod = F.build_lm()
    engine = F.port_engine(mod, **F.PAGED, prefill_buckets=(1, 2))
    engine.warmup()
    engine.warmup_verify(3)
    d, layers, heads = mod.d_model, mod.num_layers, mod.num_heads
    d_ff = mod.blocks[0].up.weight.shape[0]
    per_token = layers * 2 * (4 * d * d + 2 * d * d_ff) + 2 * d * F.VOCAB
    per_pair = 4 * (d // heads) * heads * layers
    rows = {key.split("mesh=1/")[1]: rec for key, rec in
            ((r.key, r) for r in engine.programs.values())}
    assert set(rows) == {"prefill/b1s8", "prefill/b1s16", "prefill/b2s8", "prefill/b2s16",
                         "prefill_extend/b1w8", "prefill_extend/b1w16", "prefill_extend/b2w8",
                         "prefill_extend/b2w16", "decode_step", "copy_page", "verify_step/w3"}
    for pb in (1, 2):
        for sb in (8, 16):
            assert rows[f"prefill/b{pb}s{sb}"].flops == \
                pb * sb * per_token + pb * sb * (sb + 1) // 2 * per_pair
            # The warm-up's extend lanes hold no valid row: dense layers only.
            assert rows[f"prefill_extend/b{pb}w{sb}"].flops == pb * sb * per_token
    slots = int(engine.slots)
    assert rows["decode_step"].flops == slots * per_token + slots * per_pair  # lengths 0
    assert rows["verify_step/w3"].flops == 3 * slots * per_token + slots * (3 + 3) * per_pair
    assert rows["copy_page"].flops == 0
    # The warm-up's bytes: the weights once plus the rows a dispatch reads.
    lengths = np.zeros(slots, np.int32)
    assert rows["decode_step"].bytes_accessed == engine._step_bytes(lengths)
    assert engine.decode_mbu_for(0.001) == pytest.approx(
        engine._step_bytes(lengths) / 0.001 / 3.35e12)
    assert engine.decode_mbu_for(0.001, program="nope") == -1.0
    assert engine.recompiles_detected == 0 and engine.compile_count == len(rows)


def _recorder_ops(mods, directory):
    """One trigger sequence through ``mods``' recorder, a fresh tracer
    and registry of the same package. Returns what both must agree on."""
    rec_mod, reg_mod, trace_mod, req_mod = mods
    prior = trace_mod.get_tracer()
    trace_mod.install(trace_mod.Tracer(64))
    try:
        reg = reg_mod.MetricsRegistry()
        reg.counter("zk_test_total", help="t").inc(3)
        log = req_mod.RequestLog("svc")
        log.append(11, "crashed", rows=2, detail="WorkerCrashedError")
        with trace_mod.span("request_submit", rid=11):
            pass
        trace_mod.event("request_complete", rid=11)
        rec = rec_mod.FlightRecorder(directory, registries=[reg], keep=2,
                                     status_providers={"svc": lambda: {"alive": True}},
                                     request_logs={"svc": log}, min_interval_s=30.0,
                                     synchronous=True)
        paths = [
            rec.trigger("worker_crash", step=5, attrs={"error": "boom"}),
            rec.trigger("step_time_anomaly"),  # rate-limited
            rec.trigger("manual", force=True),  # bypasses, and does not arm
            rec.trigger("recompile_detected"),  # still limited by the first
        ]
        counts = (rec.bundles_written, rec.bundles_suppressed)
        # A restarted process extends the series; retention keeps 2.
        again = rec_mod.FlightRecorder(directory, registries=[reg], keep=2, min_interval_s=0.0,
                                       synchronous=True)
        paths.append(again.trigger("x y/z"))
    finally:
        trace_mod.install(prior)
    out = {"written": [None if p is None else os.path.basename(p) for p in paths],
           "counts": counts, "on_disk": [os.path.basename(b) for b in again.bundles()],
           "bundles": {}}
    for path in again.bundles():
        files = sorted(os.listdir(path))
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        statusz = json.load(open(os.path.join(path, "statusz.json")))
        doc = json.load(open(os.path.join(path, "trace.json")))
        out["bundles"][os.path.basename(path)] = {
            "files": files,
            "manifest_keys": sorted(manifest),
            "manifest": {k: manifest[k] for k in ("bundle_format", "seq", "trigger", "files")},
            "metrics.prom": open(os.path.join(path, "metrics.prom")).read(),
            "statusz_keys": sorted(statusz),
            "statusz_metrics": statusz["metrics"],
            "statusz_svc": statusz.get("svc"),
            "requestlog": json.load(open(os.path.join(path, "requestlog.json"))),
            "programs_keys": sorted(json.load(open(os.path.join(path, "programs.json")))),
            "trace": [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
                      for e in doc["traceEvents"]],
        }
    return out


def test_recorder_bundles_equal_jax(tmp_path):
    got = _recorder_ops((recorder, registry, trace, requests), str(tmp_path / "port"))
    want = _recorder_ops((jax_recorder, jax_registry, jax_trace, jax_requests),
                         str(tmp_path / "jax"))
    assert got == want
    assert got["written"] == ["bundle-000001-worker_crash", None, "bundle-000002-manual", None,
                              "bundle-000003-x_y_z"]
    assert got["counts"] == (2, 2)
    assert got["on_disk"] == ["bundle-000002-manual", "bundle-000003-x_y_z"]
    manifest = json.load(open(tmp_path / "port" / "bundle-000003-x_y_z" / "manifest.json"))
    assert set(manifest["metadata"]) == {"git_commit", "python", "torch", "cuda", "devices"}


@pytest.fixture
def no_global_recorder():
    prior = recorder.get_recorder()
    recorder.uninstall()
    yield
    recorder.uninstall()
    if prior is not None:
        recorder.install(prior)


def test_recorder_async_writer_install_and_disarm(tmp_path, no_global_recorder):
    reg = registry.MetricsRegistry()
    rec = recorder.FlightRecorder(str(tmp_path / "b"), registries=[reg], min_interval_s=0.0)
    assert recorder.get_recorder() is None
    recorder.notify("ignored")  # no recorder: a no-op
    recorder.install(rec)
    other = recorder.FlightRecorder(str(tmp_path / "other"))
    try:
        recorder.notify("decode_worker_crash", attrs={"failed_streams": 2})
        assert rec.flush(timeout=10)
        assert [os.path.basename(b) for b in rec.bundles()] == ["bundle-000001-decode_worker_crash"]
        recorder.disarm(other)  # not the installed one: stays
        assert recorder.get_recorder() is rec
    finally:
        recorder.disarm(rec)
    assert recorder.get_recorder() is None
    assert rec._worker is None  # the writer thread was joined
    counted = registry.default_registry().as_flat_dict()
    assert counted["zk_flight_bundles_total{trigger=decode_worker_crash}"] >= 1
    armed = recorder.arm(str(tmp_path / "armed"), registries=[reg])
    try:
        assert recorder.get_recorder() is armed and armed.synchronous
        assert armed.trigger("manual") is not None
    finally:
        recorder.disarm(armed)


def test_device_probe_on_the_cpu_publishes_the_sentinel():
    assert device.device_memory_stats() == []
    reg = registry.MetricsRegistry()
    probe = device.DeviceProbe(interval_s=0.05, registry=reg)
    assert probe.poll_once() == []
    text = render_prometheus([reg])
    for name in ("zk_hbm_bytes_in_use", "zk_hbm_peak_bytes_in_use", "zk_hbm_bytes_limit"):
        assert f'{name}{{device="0"}} -1' in text
    probe.start()
    try:
        assert probe.alive
    finally:
        probe.stop()
    assert not probe.alive
    with pytest.raises(ValueError):
        device.DeviceProbe(interval_s=0)
