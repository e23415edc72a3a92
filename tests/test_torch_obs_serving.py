"""Observability on the port's two serving paths against the JAX
package's: the same seeded requests through both packages' batchers and
decode schedulers give the same RequestLog outcomes, the same per-rid
trace flows and the same time-free metric values; results with
observability on equal results with it off; both services' endpoints
serve a ``/metrics`` whose every line parses with the required series,
and a ``/statusz`` with the ``serving``/``decode``, ``requests`` and
``programs`` sections (the JAX scrape smoke's checks, less the overload
guard's); recompiles are detected and bundled. Every server binds port
0; every server, probe, recorder and worker is stopped and joined."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import os
import re
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.observability import recorder as jax_recorder
from zookeeper_tpu.observability import trace as jax_trace
from zookeeper_tpu.observability.export import render_prometheus as jax_render
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu.serving import MicroBatcher as JaxMicroBatcher
from zookeeper_tpu.serving import ServingMetrics as JaxServingMetrics
from zookeeper_tpu.serving import WorkerCrashedError as JaxWorkerCrashedError
from zookeeper_tpu.serving.decode import DecodeMetrics as JaxDecodeMetrics
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.observability import recorder, trace
from zookeeper_tpu_torch.observability.export import render_prometheus
from zookeeper_tpu_torch.observability.ledger import default_ledger
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.serving import (
    MicroBatcher,
    ServingConfig,
    ServingMetrics,
    WorkerCrashedError,
)
from zookeeper_tpu_torch.serving.decode import DecodeMetrics, LMServingConfig
from zookeeper_tpu_torch.serving.service import run_teardown_steps

LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")

PORT = {"trace": trace, "recorder": recorder, "faults": faults, "FaultPlan": FaultPlan,
        "crashed": WorkerCrashedError, "configure": configure, "render": render_prometheus}
JAX = {"trace": jax_trace, "recorder": jax_recorder, "faults": jax_faults,
       "FaultPlan": JaxFaultPlan, "crashed": JaxWorkerCrashedError,
       "configure": jax_configure, "render": jax_render}


@pytest.fixture(autouse=True)
def _quiet_globals():
    """No tracer or recorder leaks between tests, in either package."""
    saved = [(m["trace"].get_tracer(), m["recorder"].get_recorder()) for m in (PORT, JAX)]
    for m in (PORT, JAX):
        m["trace"].install(None)
        m["recorder"].uninstall()
    yield
    for m, (tracer, rec) in zip((PORT, JAX), saved):
        m["trace"].install(tracer)
        m["recorder"].uninstall()
        if rec is not None:
            m["recorder"].install(rec)


def _flows(tracer, base):
    """Per relative rid: its records' names in ring order, and its Chrome
    flow phases."""
    names = {}
    for rec in tracer.snapshot():
        if rec["rid"] is not None:
            names.setdefault(rec["rid"] - base, []).append(rec["name"])
    return names


def _log(log, base):
    """The RequestLog tail without timestamps, rids relative."""
    return [{**{k: v for k, v in r.items() if not k.endswith("_ns")}, "rid": r["rid"] - base,
             "dispatched": r["dispatch_ns"] is not None} for r in log.tail(256)]


def _samples(registries, render=render_prometheus):
    """Every sample line of an exposition, sorted (registration order and
    help text aside)."""
    return sorted(ln for ln in render(registries).splitlines()
                  if ln and not ln.startswith("#"))


# -- the classifier path ------------------------------------------------------


class RecordingEngine:
    """Engine double: a row-wise function of the rows (a tensor for the
    port's batcher, an array for the JAX package's)."""

    batch_buckets = (1, 4, 8)
    max_batch = 8

    def __init__(self, as_torch: bool):
        self.as_torch = as_torch

    def bucket_for(self, n):
        return next(b for b in self.batch_buckets if b >= n)

    def infer(self, x):
        out = np.stack([x.sum(axis=1), x.max(axis=1)], axis=1).astype(np.float32)
        return torch.from_numpy(out) if self.as_torch else out


def _batcher_run(pkg, batcher_cls, metrics_cls, asynchronous=False):
    """The same requests through ``pkg``'s batcher: three served, one
    shed, one expired; async: one crashed, then one served."""
    from zookeeper_tpu.observability.requests import next_rid as jax_next
    from zookeeper_tpu_torch.observability.requests import next_rid as port_next

    tracer = pkg["trace"].Tracer()
    pkg["trace"].install(tracer)
    base = (port_next if pkg is PORT else jax_next)() + 1
    metrics = metrics_cls()
    pkg["configure"](metrics, {}, name="metrics")
    batcher = batcher_cls()
    conf = ({"synchronous": False, "max_delay_ms": 1.0} if asynchronous
            else {"shed_above_rows": 10})
    pkg["configure"](batcher, conf, name="batcher")
    batcher.bind(RecordingEngine(pkg is PORT), metrics=metrics)
    rng = np.random.default_rng(3)
    outcomes = []
    try:
        if asynchronous:
            with pkg["faults"].injected(pkg["FaultPlan"](serving_worker_crash=1)):
                handle = batcher.submit(rng.normal(size=(2, 5)).astype(np.float32))
                with pytest.raises(pkg["crashed"]):
                    handle.result(timeout=30)
            outcomes.append(batcher.submit(np.ones((3, 5), np.float32)).result(timeout=30))
        else:
            handles = [batcher.submit(rng.normal(size=(n, 5)).astype(np.float32))
                       for n in (3, 6)]
            with pytest.raises(Exception, match="shed"):
                batcher.submit(np.ones((2, 5), np.float32))
            expired = batcher.submit(np.ones((1, 5), np.float32), deadline_ms=0)
            batcher.flush()
            outcomes = [h.result() for h in handles]
            with pytest.raises(TimeoutError):
                expired.result()
            outcomes.append(batcher.submit(np.ones((9, 5), np.float32)).result())
    finally:
        batcher.close()
        pkg["trace"].install(None)
    return {"log": _log(batcher.request_log, base), "flows": _flows(tracer, base),
            "totals": metrics.totals,
            "samples": [ln for ln in _samples([metrics.registry], pkg["render"])
                        if "latency" not in ln],
            "status": {k: v for k, v in batcher.request_log.as_status().items() if k != "tail"},
            "outputs": outcomes}


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async_crash"])
def test_batcher_request_log_flows_and_metrics_equal_jax(asynchronous):
    got = _batcher_run(PORT, MicroBatcher, ServingMetrics, asynchronous)
    want = _batcher_run(JAX, JaxMicroBatcher, JaxServingMetrics, asynchronous)
    for g, w in zip(got.pop("outputs"), want.pop("outputs")):
        np.testing.assert_array_equal(g, w)
    assert got == want
    if asynchronous:
        assert [r["outcome"] for r in got["log"]] == ["crashed", "ok"]
        assert got["flows"][0] == ["request_enqueue", "request_complete"]
    else:
        assert [r["outcome"] for r in got["log"]] == \
            ["shed", "deadline_expired", "ok", "ok", "ok"]  # expired at planning
        assert got["flows"][0] == ["request_enqueue", "request_dispatch", "request_complete"]


SMALL = {
    "model": "QuickNet", "model.blocks_per_section": (1, 1, 1, 1),
    "model.section_features": (32, 32, 64, 64), "model.binary_compute": "xnor_popcount",
    "model.packed_weights": True, "model.fold_bn": True, "engine.batch_buckets": (1, 4),
    "height": 16, "width": 16, "num_classes": 10, "requests": 5, "max_request": 6,
    "seed": 3, "device": "cpu", "verbose": False,
}


def _service(**overrides):
    import zookeeper_tpu_torch.models  # noqa: F401  (registers QuickNet)

    cfg = ServingConfig()
    configure(cfg, {**SMALL, **overrides})
    return cfg


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _scrape(port, required=()):
    body = _get(port, "/metrics")
    samples = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
    assert samples and all(LINE.match(s) for s in samples), [s for s in samples
                                                             if not LINE.match(s)][:5]
    for name in required:
        assert name in body, name
    values = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1]) for ln in samples}
    return body, values, json.loads(_get(port, "/statusz"))


def _obs_threads():
    """The endpoint, probe and recorder threads alive now (the JAX
    package's carry the same names: compare against a set taken
    before)."""
    return {t for t in threading.enumerate()
            if t.name in ("zk-obs-http", "zk-device-probe", "zk-flight-recorder")}


def test_classifier_answers_equal_with_observability_on(tmp_path):
    """The scrape smoke on the classifier path: every line parses, every
    ServingMetrics series and the engine's gauges render, /statusz has its
    sections; the answers equal an observability-off service's bit for
    bit; the teardown releases the port and joins every thread."""
    before = _obs_threads()
    answers = {}
    for label, extra in (("off", {}), ("on", {"metrics_port": 0, "flight_recorder_dir":
                                               str(tmp_path / "bundles")})):
        if label == "on":
            trace.enable()
        cfg = _service(**extra)
        engine, batcher = cfg.build_service()
        handles = [batcher.submit(x) for x in cfg.request_stream()]
        batcher.flush()
        answers[label] = [h.result() for h in handles]
        if label == "on":
            port = cfg.obs_server.port
            body, values, status = _scrape(port, (
                "zk_hbm_bytes_in_use", "zk_serve_mfu", "zk_serve_mfu_int8",
                "zk_serve_dispatch_ms", "zk_serve_dispatch_rows", "zk_serving_recompiles_total",
                "zk_compiles_total", "zk_serving_latency_ms_bucket"))
            for inst in cfg.metrics.registry.collect():
                assert inst.name in body
            assert values["zk_serving_requests"] == 5 and values["zk_serve_mfu_int8"] > 0
            assert values['zk_hbm_bytes_in_use{device="0"}'] == -1  # no card
            assert status["serving"]["recompiles_detected"] == 0
            assert status["serving"]["compiles"] == 2 and status["serving"]["packed_deployment"]
            assert status["requests"]["by_outcome"] == {"ok": 5}
            assert status["flight_recorder"]["installed"] is True
            keys = {row["key"] for row in status["programs"]["programs"]}
            assert {rec.key for rec in engine.programs.values()} <= keys
            names = [r["name"] for r in trace.get_tracer().snapshot()]
            for name in ("request_enqueue", "serve_dispatch", "engine_infer",
                         "request_dispatch", "request_complete", "program_compiled"):
                assert name in names, name
        cfg.finish_report(warm_compiles=engine.warmed_buckets, n_requests=5, dt=0.1)
        trace.install(None)
    assert cfg.obs_server is None and cfg.obs_probe is None and recorder.get_recorder() is None
    assert _obs_threads() <= before
    for a, b in zip(answers["off"], answers["on"]):
        np.testing.assert_array_equal(a, b)


def test_run_with_metrics_port_tears_down():
    """ServingConfig.run() with the endpoint on: the loop serves and the
    report tears the endpoint down."""
    cfg = _service(metrics_port=0)
    assert cfg.run()["requests"] == 5
    assert getattr(cfg, "obs_server", None) is None


def test_recompile_is_detected_bundled_and_reported(tmp_path):
    cfg = _service(**{"metrics_port": 0, "flight_recorder_dir": str(tmp_path / "b"),
                      "flight_recorder_interval_s": 0.0, "warmup": False})
    tracer = trace.enable()
    engine, batcher = cfg.build_service()
    try:
        counter = [i for i in default_registry().collect()
                   if i.name == "zk_serving_recompiles_total"][0]
        base = counter.value
        engine.infer(np.zeros((2, 16, 16, 3), np.float32))  # before warm-up: no stall
        assert engine.recompiles_detected == 0
        assert engine.warmup() == 2
        engine.infer(np.zeros((3, 16, 16, 3), np.float32))  # bucket 4: warmed
        assert engine.recompiles_detected == 0
        # A bucket the warm-up never covered, as the JAX test reaches it:
        # through the engine's private cache seam.
        engine._warmed.discard(engine._key(4, None))
        engine.infer(np.zeros((3, 16, 16, 3), np.float32))
        assert engine.recompiles_detected == 1 and counter.value == base + 1
        events = [r for r in tracer.snapshot() if r["name"] == "recompile_detected"]
        assert len(events) == 1 and events[0]["attrs"]["bucket"] == 4
        assert default_ledger().latest("serve_forward").attrs["during_dispatch"] is True
        bundles = cfg.flight_recorder.bundles()
        assert len(bundles) == 1 and bundles[0].endswith("recompile_detected")
        _, values, _ = _scrape(cfg.obs_server.port)
        assert values["zk_serving_recompiles_total"] == base + 1
    finally:
        cfg._teardown_service()


def test_observe_dispatch_publishes_the_gauges():
    cfg = _service()
    engine, _ = cfg.build_service()
    reg = default_registry()
    engine.infer(np.zeros((4, 16, 16, 3), np.float32))
    flops = engine.programs[engine._key(4, None)].flops
    engine.observe_dispatch(3, 0.05)
    assert reg.gauge("zk_serve_dispatch_ms").value == pytest.approx(50.0)
    assert reg.gauge("zk_serve_dispatch_rows").value == 3
    assert reg.gauge("zk_serve_mfu").value == pytest.approx(flops / 0.05 / 989.4e12)
    assert reg.gauge("zk_serve_mfu_int8").value == pytest.approx(flops / 0.05 / 1978.9e12)
    engine.observe_dispatch(3, 0.0)  # degenerate: ignored, never raises
    engine.observe_dispatch(3, -1.0)
    assert engine._dispatch_watchdog.ewma_seconds == pytest.approx(0.05)
    unpacked = _service(**{"model.packed_weights": False, "model.fold_bn": False,
                           "model.binary_compute": "mxu"})
    engine2, _ = unpacked.build_service()
    engine2.infer(np.zeros((1, 16, 16, 3), np.float32))
    engine2.observe_dispatch(1, 0.01)
    assert reg.gauge("zk_serve_mfu_int8").value == -1  # not a packed deployment
    assert reg.gauge("zk_serve_mfu").value > 0
    cfg._teardown_service()
    unpacked._teardown_service()


def test_bind_failure_tears_down_what_was_started(tmp_path):
    before = _obs_threads()
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        cfg = _service(**{"metrics_port": busy.getsockname()[1],
                          "flight_recorder_dir": str(tmp_path / "b"),
                          "batcher.synchronous": False})
        with pytest.raises(OSError):
            cfg.build_service()
    finally:
        busy.close()
    assert recorder.get_recorder() is None and getattr(cfg, "obs_server", None) is None
    assert cfg.batcher._worker is None and _obs_threads() <= before


def test_teardown_runs_every_step_and_reraises_the_first():
    ran = []

    def step(name, fail=False):
        def run():
            ran.append(name)
            if fail:
                raise RuntimeError(name)
        return run

    with pytest.raises(RuntimeError, match="b"):
        run_teardown_steps([step("a"), step("b", True), step("c", True), step("d")])
    assert ran == ["a", "b", "c", "d"]
    run_teardown_steps([step("e", True)], suppress=True)
    assert ran[-1] == "e"


# -- the metrics components against the JAX package's ------------------------------


def _serving_metrics_ops(m):
    m.record_queue_depth(3)
    m.record_request(5.0, 3)
    m.record_request(7.5, 1)
    m.record_dispatch(3, 4)
    m.record_rejected()
    m.record_deadline_expired()
    m.record_worker_restart()
    m.record_weights_step(2)
    m.record_weight_swap(120.0, 5)
    m.record_watcher_stopped()
    return m


def _decode_metrics_ops(m):
    m.record_ttft(30.0)
    m.record_prefill(12.0, 2)
    m.record_first_tokens(2)
    m.record_decode_step(4.0, 2)
    m.record_itl(4.1)
    m.record_prefill_chunks(3, 6.0)
    m.record_prefill_finish(1, [9.0])
    m.record_spec_window(8, 5, [3, 2], 7.0, 7)
    m.record_occupancy(2, 3, 1, 5)
    m.record_pool(11, 0.25)
    m.record_transfer(4, 4096, 0.7)
    m.record_rejected()
    m.record_deadline_expired()
    m.record_worker_restart()
    m.record_weight_swap(9)
    return m


@pytest.mark.parametrize("ops,port_cls,jax_cls", [
    (_serving_metrics_ops, ServingMetrics, JaxServingMetrics),
    (_decode_metrics_ops, DecodeMetrics, JaxDecodeMetrics),
], ids=["serving", "decode"])
def test_metrics_series_and_values_equal_jax(ops, port_cls, jax_cls):
    got, want = port_cls(), jax_cls()
    configure(got, {}, name="metrics")
    jax_configure(want, {}, name="metrics")
    ops(got)
    ops(want)
    assert _samples([got.registry]) == _samples([want.registry], jax_render)
    assert {(i.name, i.kind) for i in got.registry.collect()} == \
        {(i.name, i.kind) for i in want.registry.collect()}
    assert got.totals == want.totals
    assert got.snapshot() == pytest.approx(want.snapshot())
    assert got.weights_step == want.weights_step
    got.reset()
    want.reset()
    assert _samples([got.registry]) == _samples([want.registry], jax_render)


# -- the decode path ----------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


def _decode_run(port, lm, case):
    """Seeded prompts through ``port``'s scheduler: two shed, one
    expired, streams finished by their budget and one by the token
    limit."""
    from zookeeper_tpu.observability.requests import next_rid as jax_next
    from zookeeper_tpu_torch.observability.requests import next_rid as port_next

    pkg = PORT if port else JAX
    jmod, params, mod = lm
    conf = {"paged": {**F.PAGED}, "chunked": {**F.PAGED, "prefill_chunk_tokens": 4},
            "speculative": {**F.PAGED}, "plain": {}}[case]
    engine = F.port_engine(mod, **conf) if port else F.jax_engine(jmod, params, **conf)
    spec = None
    if case == "speculative":
        draft = F.build_lm({**F.GEOMETRY, "num_layers": 1}, seed=1)
        spec = (F.port_spec(engine, draft[2], 2) if port
                else F.jax_spec(engine, draft[0], draft[1], 2))
    tracer = pkg["trace"].Tracer()
    pkg["trace"].install(tracer)
    base = (port_next if port else jax_next)() + 1
    sched_cls, metrics_cls = ((F.DecodeScheduler, F.DecodeMetrics) if port
                              else (F.JaxScheduler, F.JaxMetrics))
    metrics = metrics_cls()
    pkg["configure"](metrics, {}, name="metrics")
    sched = sched_cls()
    pkg["configure"](sched, {"shed_above": 4}, name="sched")
    sched.bind(engine, metrics=metrics, speculative=spec)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, F.VOCAB, size=int(n)).astype(np.int32)
               for n in (5, 16, 3, 9, 12, 7)]
    streams, shed = [], 0
    try:
        for i, p in enumerate(prompts):
            try:
                streams.append(sched.submit(p, max_new_tokens=6 if i != 1 else 60,
                                            deadline_ms=0 if i == 2 else None))
            except Exception as e:  # the shed one
                assert "shed" in str(e)
                shed += 1
        sched.drain()
        tokens = [s.tokens_so_far.tolist() for s in streams]
    finally:
        sched.close()
        pkg["trace"].install(None)
    return {"log": _log(sched.request_log, base), "flows": _flows(tracer, base),
            "tokens": tokens, "shed": shed, "totals": metrics.totals,
            "status": {k: v for k, v in sched.request_log.as_status().items() if k != "tail"}}


@pytest.mark.parametrize("case", ["plain", "paged", "chunked", "speculative"])
def test_decode_request_log_flows_and_metrics_equal_jax(lm, case):
    got = _decode_run(True, lm, case)
    want = _decode_run(False, lm, case)
    assert got == want
    outcomes = [r["outcome"] for r in got["log"]]
    assert sorted(outcomes) == ["deadline_expired", "ok", "ok", "ok", "shed", "shed"]
    ok = [r for r in got["log"] if r["outcome"] == "ok"]
    assert {r["detail"].split()[0] for r in ok} <= {"length", "capacity"}
    assert all(r["role"] == "decode" and r["dispatched"] for r in ok)
    flows = list(got["flows"].values())
    assert ["decode_request_enqueue", "decode_request_dispatch"] == flows[0][:2]
    if case == "speculative":
        assert any("spec_accept" in f for f in flows)
        assert all("spec=" in r["detail"] for r in ok)


def test_decode_crash_bundle_correlates_rids(lm, tmp_path):
    _, _, mod = lm
    engine = F.port_engine(mod, **F.PAGED)
    engine.warmup()
    metrics = DecodeMetrics()
    configure(metrics, {}, name="metrics")
    sched = F.DecodeScheduler()
    configure(sched, {}, name="sched")
    sched.bind(engine, metrics=metrics)
    trace.install(trace.Tracer())
    rec = recorder.arm(str(tmp_path / "bundles"), registries=[metrics.registry],
                       request_logs={"decode": sched.request_log}, min_interval_s=0.0)
    try:
        streams = [sched.submit(np.arange(1, 4 + i, dtype=np.int32), max_new_tokens=8)
                   for i in range(4)]
        sched._pump()  # admitted and decoding when the crash fires
        with faults.injected(FaultPlan(decode_worker_crash=1)):
            with pytest.raises(WorkerCrashedError):
                sched.drain()
    finally:
        recorder.disarm(rec)
        sched.close()
    victims = {s.rid for s in streams}
    assert all(isinstance(s.error, WorkerCrashedError) for s in streams)
    (bundle,) = rec.bundles()
    assert bundle.endswith("decode_worker_crash")
    tail = json.load(open(os.path.join(bundle, "requestlog.json")))["decode"]["tail"]
    assert {r["rid"] for r in tail if r["outcome"] == "crashed"} == victims
    doc = json.load(open(os.path.join(bundle, "trace.json")))
    assert victims <= {e["id"] for e in doc["traceEvents"] if e.get("cat") == "rid"}
    manifest = json.load(open(os.path.join(bundle, "manifest.json")))
    assert manifest["trigger"]["attrs"] == {"error": "WorkerCrashedError", "failed_streams": 4}


def test_decode_engine_notes_a_post_warmup_first_run(lm):
    _, _, mod = lm
    engine = F.port_engine(mod, **F.PAGED, ledger_prefix="draft_")
    tracer = trace.enable()
    engine.warmup()
    engine.warmup_verify(3)  # grid growth inside a warm-up: not a stall
    assert engine.recompiles_detected == 0
    engine.verify(np.zeros((3, 5), np.int32), np.zeros(3, np.int32))
    assert engine.recompiles_detected == 1
    events = [r for r in tracer.snapshot() if r["name"] == "recompile_detected"]
    assert [e["attrs"]["program"] for e in events] == ["draft_verify_step/w5"]
    assert all(k.startswith("draft_") for k in engine.programs)
    assert default_ledger().latest("draft_verify_step").key.endswith("draft_verify_step/w5")


LM_TINY = {
    "model.num_layers": 2, "model.d_model": 32, "model.num_heads": 4, "seq_len": 64,
    "vocab_size": 61, "engine.slots": 2, "engine.seq_buckets": (8,), "engine.page_size": 4,
    "engine.kv_layout": "paged", "speculative.enabled": True, "speculative.k": 2,
    "speculative.draft_model.num_layers": 1, "speculative.draft_model.d_model": 32,
    "speculative.draft_model.num_heads": 4, "engine.prefill_chunk_tokens": 4,
    "requests": 5, "max_prompt": 8, "new_tokens": 4, "device": "cpu", "verbose": False,
}


def test_lm_service_scrape_smoke_and_tokens_equal_off(tmp_path):
    """The decode half of the scrape smoke (paged, speculative, chunked):
    every zk_decode_* series and the feature families render, the decode
    section carries the operator numbers, the programs are ledgered; the
    run's tokens equal an observability-off run's."""
    before = _obs_threads()
    off = LMServingConfig()
    configure(off, dict(LM_TINY))
    off.run()
    on = LMServingConfig()
    configure(on, {**LM_TINY, "metrics_port": 0, "flight_recorder_dir": str(tmp_path / "b")})
    trace.enable()
    engine, scheduler = on.build_service()
    try:
        streams = [scheduler.submit(p, max_new_tokens=on.new_tokens)
                   for p in on.prompts(min(on.max_prompt, engine.max_prompt))]
        scheduler.drain()
        for a, b in zip(off.outputs, (s.result() for s in streams)):
            np.testing.assert_array_equal(a, b)
        body, values, status = _scrape(on.obs_server.port, (
            "zk_decode_tokens_total", "zk_decode_ttft_ms_bucket", "zk_decode_token_ms_bucket",
            "zk_decode_slot_occupancy", "zk_decode_kv_pages_in_use", "zk_decode_queue_depth",
            "zk_decode_kv_bytes", "zk_decode_mbu", "zk_spec_draft_tokens_total",
            "zk_spec_accepted_tokens_total", "zk_spec_acceptance_rate",
            "zk_spec_accept_length_bucket", "zk_kv_pool_free_pages", "zk_prefix_cache_hit_rate",
            "zk_decode_itl_ms_bucket", "zk_prefill_chunks_total", "zk_prefill_stall_ms_bucket",
            "zk_transfer_bytes", "zk_hbm_bytes_in_use", "zk_serving_recompiles_total"))
        for inst in on.metrics.registry.collect():
            assert inst.name in body
        decode = status["decode"]
        for key in ("active_slots", "queue_depth", "kv_pages_in_use", "recompiles_detected",
                    "kv_cache_bytes", "kv_bytes_per_slot", "decode_mbu", "decode_attention",
                    "kv_layout", "kv_pool", "speculative", "chunked_prefill", "compiles"):
            assert key in decode, key
        assert decode["recompiles_detected"] == 0 and decode["kv_layout"] == "paged"
        pool = decode["kv_pool"]
        assert pool["used_pages"] + pool["free_pages"] == pool["num_pages"]
        assert decode["speculative"]["enabled"] and decode["speculative"]["proposed_tokens"] > 0
        assert decode["speculative"]["draft_recompiles_detected"] == 0
        assert decode["chunked_prefill"]["enabled"] and values["zk_prefill_chunks_total"] > 0
        assert values["zk_decode_kv_bytes"] == engine.kv_cache_nbytes or \
            values["zk_decode_kv_bytes"] > 0  # the draft binds after the teacher
        assert status["requests"]["by_outcome"] == {"ok": 5}
        keys = {row["key"] for row in status["programs"]["programs"]}
        assert {rec.key for rec in engine.programs.values()} <= keys
        assert any("draft_" in k for k in keys)
    finally:
        on._teardown_service()
        trace.install(None)
    assert on.obs_server is None and recorder.get_recorder() is None
    assert _obs_threads() <= before
    again = LMServingConfig()
    configure(again, {**LM_TINY, "metrics_port": 0})
    result = again.run()  # run() keeps the endpoint up to its report, then tears down
    assert result["generated_tokens"] > 0 and again.obs_server is None


def test_disaggregated_handoff_flow_and_roles():
    from zookeeper_tpu_torch.serving import DisaggServingConfig

    cfg = DisaggServingConfig()
    configure(cfg, {**{k: v for k, v in LM_TINY.items() if not k.startswith("speculative")
                       and k != "engine.prefill_chunk_tokens"},
                    "prefill_engine.seq_buckets": (8,), "prefill_engine.page_size": 4})
    tracer = trace.enable()
    try:
        cfg.run()
    finally:
        trace.install(None)
    log = cfg.scheduler.request_log.tail()
    assert [r["outcome"] for r in log] == ["ok"] * 5
    assert all(r["role"] in ("decode", "prefill") for r in log)
    flows = {}
    for rec in tracer.snapshot():
        if rec["rid"] is not None:
            flows.setdefault(rec["rid"], []).append(rec["name"])
    handed = [f for f in flows.values() if "disagg_decode_admit" in f]
    assert handed
    for names in handed:
        assert names[:2] == ["decode_request_enqueue", "disagg_prefill_dispatch"]
        assert names.index("disagg_prefill_park") < names.index("page_transfer") < \
            names.index("disagg_decode_admit") < names.index("decode_stream_finish")
