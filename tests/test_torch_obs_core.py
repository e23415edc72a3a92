"""The port's observability core against the JAX package's: the same
operation sequences through both packages' ``registry``, ``trace``,
``requests``, ``export``, ``peaks`` (the shared logic, tables passed
explicitly) and ``watchdog`` give the same exposition text, the same
Chrome trace records (timestamps excluded), the same RequestLog
summaries and status, and the same anomaly decisions and EWMA values.
Every server binds port 0 and is stopped; every thread is joined."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from zookeeper_tpu.observability import export as jax_export
from zookeeper_tpu.observability import peaks as jax_peaks
from zookeeper_tpu.observability import registry as jax_registry
from zookeeper_tpu.observability import requests as jax_requests
from zookeeper_tpu.observability import trace as jax_trace
from zookeeper_tpu.observability import watchdog as jax_watchdog
from zookeeper_tpu_torch.observability import export, peaks, registry, requests, trace, watchdog

PACKAGES = {
    "jax": (jax_registry, jax_trace, jax_requests, jax_export, jax_watchdog),
    "port": (registry, trace, requests, export, watchdog),
}


def _registry_ops(reg_mod):
    """One operation sequence over a fresh registry of ``reg_mod``."""
    reg = reg_mod.MetricsRegistry(max_label_variants=3)
    c = reg.counter("zk_test_requests_total", help="requests served")
    c.inc()
    c.inc(4)
    g = reg.gauge("zk_test_weights_step", help="live step", initial=-1)
    g.set(7)
    g.inc(0.5)
    reg.gauge("zk_test_untouched", initial=-1)
    h = reg.histogram("zk_test_latency_ms", help="latency")
    for v in (0.2, 0.5, 3.0, 3.0, 70.0, 1e6):
        h.observe(v)
    r = reg.histogram("zk_test_fill", buckets=reg_mod.DEFAULT_RATIO_BUCKETS)
    r.observe(0.25)
    for i in range(5):  # two past the cap: detached, counted as dropped
        reg.gauge("zk_test_split", labels={"split": f"s{i}"}).set(i)
    reg.counter("zk_test_odd name!", labels={"q": 'a"b\\c\nd'}).inc(2)
    reg.counter("zk_test_requests_total").inc()  # get-or-create: the same series
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("zk_test_requests_total")
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("zk_test_latency_ms", buckets=(1.0, 2.0))
    with pytest.raises(ValueError, match="monotone"):
        c.inc(-1)
    return reg


def test_registry_exposition_and_flat_view_equal_jax():
    got = _registry_ops(registry)
    want = _registry_ops(jax_registry)
    assert export.render_prometheus([got]) == jax_export.render_prometheus([want])
    assert got.as_flat_dict() == want.as_flat_dict()
    for g, w in zip(got.collect(), want.collect()):
        g.reset()
        w.reset()
    assert export.render_prometheus([got]) == jax_export.render_prometheus([want])


@pytest.mark.parametrize("bad", [(), (2.0, 1.0), (1.0, 1.0), (1.0, float("inf"))])
def test_histogram_bounds_refused_alike(bad):
    for mod in (registry, jax_registry):
        with pytest.raises(ValueError, match="strictly"):
            mod.Histogram("h", buckets=bad)


def _trace_ops(trace_mod, requests_mod):
    """Spans, events and rid-tagged records on one thread of a fresh
    tracer; rids are relative so the two packages' counters compare."""
    tracer = trace_mod.Tracer(capacity=64)
    base = requests_mod.next_rid()
    a, b = base + 1, base + 2
    with tracer.span("dispatch", step=3, slab=1, attrs={"rows": 4}, rid=a):
        tracer.event("enqueue", attrs={"q": 1}, rid=b)
    tracer.event("enqueue", rid=a)
    with tracer.span("infer", attrs={"bucket": 8}):
        pass
    tracer.event("complete", step=9, rid=a)
    tracer.event("complete", rid=b)
    tracer.event("alone", rid=base + 99)  # one record: no flow arrow
    return tracer, base


def _time_free(doc, base):
    out = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid")}
        if "rid" in ev.get("args", {}):
            ev["args"] = {**ev["args"], "rid": ev["args"]["rid"] - base}
        if ev.get("cat") == "rid":
            ev["id"] -= base
        out.append(ev)
    return out


def test_chrome_trace_records_and_flows_equal_jax():
    got, gbase = _trace_ops(trace, requests)
    want, wbase = _trace_ops(jax_trace, jax_requests)
    g = _time_free(trace.to_chrome_trace(got), gbase)
    w = _time_free(jax_trace.to_chrome_trace(want), wbase)
    assert g == w
    phases = [e["ph"] for e in g if e.get("cat") == "rid"]
    assert phases == ["s", "f", "s", "t", "f"]  # rid b closes first in the ring
    # Snapshot keeps the ring, drain empties it; both read the same records.
    assert len(got.snapshot()) == len(got) == 7
    drained = got.drain()
    assert len(drained) == 7 and len(got) == 0
    assert [r["name"] for r in drained] == [r["name"] for r in want.drain()]


def test_tracing_off_is_the_shared_noop(tmp_path):
    prior = trace.get_tracer()
    trace.install(None)
    try:
        assert trace.span("x", rid=1) is trace.span("y")  # the one shared no-op
        trace.event("ignored")
        assert trace.to_chrome_trace()["traceEvents"] == []
        tracer = trace.enable(capacity=2)
        assert trace.enable(capacity=99) is tracer  # first enable wins
        for i in range(3):
            trace.event(f"e{i}")
        assert [r["name"] for r in tracer.snapshot()] == ["e1", "e2"]  # bounded ring
        path = tmp_path / "t.json"
        assert trace.export_chrome_trace(str(path)) == 3  # thread row + 2
        assert json.loads(path.read_text())["displayTimeUnit"] == "ms"
    finally:
        trace.install(prior)


def _request_log_ops(requests_mod):
    log = requests_mod.RequestLog("serving", capacity=3)
    base = requests_mod.next_rid()
    for i, outcome in enumerate(["ok", "shed", "ok", "deadline_expired", "crashed"]):
        log.append(base + i, outcome, enqueue_ns=10 * i, dispatch_ns=None if i % 2 else 10 * i + 1,
                   complete_ns=10 * i + 5, rows=i + 1, bucket=4 if i != 1 else None,
                   tokens=3 if i == 4 else None, slot=i if i > 2 else None, weights_step=-1,
                   detail=None if outcome == "ok" else outcome.upper(),
                   role="decode" if i == 4 else None)
    return log, base


def _relative(summary, base):
    return {**summary, "rid": summary["rid"] - base}


def test_request_log_summaries_and_status_equal_jax():
    got, gbase = _request_log_ops(requests)
    want, wbase = _request_log_ops(jax_requests)
    gs, ws = got.as_status(tail=2), want.as_status(tail=2)
    assert [_relative(r, gbase) for r in gs.pop("tail")] == \
        [_relative(r, wbase) for r in ws.pop("tail")]
    assert gs == ws and gs["recorded_total"] == 5 and len(got) == 3
    assert got.tail(0) == [] and got.find(gbase) is None  # evicted
    assert _relative(got.find(gbase + 4), gbase) == _relative(want.find(wbase + 4), wbase)
    assert requests.OUTCOMES == jax_requests.OUTCOMES
    got.clear()
    assert got.total == 0 and got.as_status()["by_outcome"] == {}


def test_next_rid_is_monotone_across_threads():
    seen = []

    def mint():
        seen.extend(requests.next_rid() for _ in range(500))

    threads = [threading.Thread(target=mint) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(set(seen)) == 2000  # never reused
    assert requests.next_rid() > max(seen)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_endpoint_routes_equal_jax():
    """Both servers on port 0 over registries of the same operations:
    the same /metrics body, the same /statusz sections with a provider
    that raises reported, not a 500; /trace, /healthz, 404 and a /debugz
    with no recorder installed (503)."""
    bodies = {}
    for name, (reg_mod, _, _, exp_mod, _) in PACKAGES.items():
        reg = _registry_ops(reg_mod)

        def broken():
            raise RuntimeError("provider bug")

        server = exp_mod.ObservabilityServer([reg], port=0, status_providers={
            "ok": lambda: {"x": 1}, "broken": broken}).start()
        try:
            base = server.url
            metrics = _get(base + "/metrics")
            status_code, statusz = _get(base + "/statusz")
            statusz = json.loads(statusz)
            bodies[name] = {
                "metrics": metrics,
                "statusz_code": status_code,
                "sections": sorted(statusz),
                "ok": statusz["ok"],
                "broken": "provider bug" in statusz["broken"]["error"],
                "flat": statusz["metrics"],
                "trace": _get(base + "/trace")[0],
                "health": _get(base + "/healthz"),
                "missing": _get(base + "/nope")[0],
            }
            req = urllib.request.Request(base + "/debugz", data=b"", method="POST")
            try:
                urllib.request.urlopen(req, timeout=10)
                bodies[name]["debugz"] = 200
            except urllib.error.HTTPError as e:
                bodies[name]["debugz"] = e.code
        finally:
            server.stop()
        assert server.port is None
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"]["statusz_code"] == 200 and bodies["port"]["debugz"] == 503
    assert bodies["port"]["broken"] and bodies["port"]["missing"] == 404


TABLE = {"h100": 989.4, "h100 pcie": 756.5, "a100": 312.0}


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "nvidia a100-sxm4-80gb", "NVIDIA L4", "", None,
])
def test_datasheet_match_is_the_shared_longest_substring_rule(kind):
    assert peaks._match_datasheet_table(kind, TABLE) == \
        jax_peaks._match_datasheet_table(kind, TABLE)


@pytest.mark.parametrize("attempts", [
    [180e12, 182e12, 250e12], [1.0, 2.0], [1.0, 1.01, 5.0, 5.02], [3.0], [1.0, 1.02, 1.04, 9.0],
    [1.0, 1.04, 1.08, 1.12], [0, -1, 2.0, 2.01],
])
def test_peak_attempt_aggregation_equals_jax(attempts):
    def run(mod):
        try:
            return mod.aggregate_peak_attempts(attempts)
        except ValueError as e:
            return type(e)
    assert run(peaks) == run(jax_peaks)


@pytest.mark.parametrize("raw", [None, "", "abc", "-5", "nan", "inf", "2e12"])
def test_env_override_parsing_equals_jax(raw):
    env = {} if raw is None else {"X": raw}
    assert peaks._env_peak(env, "X") == jax_peaks._env_peak(env, "X")


def test_port_peak_tables_resolve_nvidia_rows_and_stay_total():
    assert peaks.reference_peak_flops("NVIDIA H100 80GB HBM3") == (989.4e12, "datasheet")
    assert peaks.reference_int8_peak_flops("NVIDIA H100 80GB HBM3") == (1978.9e12, "datasheet")
    assert peaks.reference_hbm_bandwidth("NVIDIA H100 80GB HBM3") == (3.35e12, "datasheet")
    assert peaks.reference_peak_flops("NVIDIA H100 PCIe")[0] == 756.5e12  # longest match
    # No card here: the first card's name is unknown, the H100 SXM rows answer.
    assert peaks.resolve_device_kind() is None
    assert peaks.reference_hbm_bandwidth() == (3.35e12, "fallback_h100")
    assert peaks.reference_peak_flops(env={"ZK_BENCH_PEAK_FLOPS": "1e15"}) == (1e15, "env")
    assert peaks.reference_peak_flops(env={"ZK_BENCH_PEAK_FLOPS": "x"})[1] == "fallback_h100"
    with pytest.raises(ValueError, match="measurement failure"):
        peaks.check_peak_against_datasheet(1.1e15, "NVIDIA H100 80GB HBM3")
    peaks.check_peak_against_datasheet(1.1e15, "some future card")  # unknown passes


def _durations():
    rng = np.random.default_rng(7)
    series = list(0.010 + rng.normal(0, 0.0004, 60))
    for i in (20, 21, 40):
        series[i] = 0.05  # stragglers
    series[30] = 0.0101  # within the excess floor
    return series + [0.03] * 15 + [-1.0]  # a level shift, then a bad sample


@pytest.mark.parametrize("conf", [{}, {"min_excess_s": 0.02}, {"threshold": 3.0, "min_ratio": 1.2,
                                                               "window": 8, "warmup": 2}])
def test_watchdog_decisions_and_ewma_equal_jax(conf):
    results = {}
    for name, (reg_mod, _, _, _, dog_mod) in PACKAGES.items():
        reg = reg_mod.MetricsRegistry()
        seen = []
        dog = dog_mod.StepTimeWatchdog("serve_dispatch", registry=reg,
                                       on_anomaly=lambda *a: seen.append(a), **conf)
        flags, ewmas = [], []
        for i, s in enumerate(_durations()):
            flags.append(dog.observe(s, step=i))
            ewmas.append(dog.ewma_seconds)
        results[name] = (flags, ewmas, dog.anomalies, seen, reg.as_flat_dict())
    assert results["port"] == results["jax"]
    assert any(results["port"][0])


@pytest.mark.parametrize("bad", [{"alpha": 0.0}, {"window": 3}, {"warmup": 0}, {"min_ratio": 0.5}])
def test_watchdog_refuses_bad_settings_alike(bad):
    for mod in (watchdog, jax_watchdog):
        with pytest.raises(ValueError):
            mod.StepTimeWatchdog("s", registry=registry.MetricsRegistry(), **bad)
