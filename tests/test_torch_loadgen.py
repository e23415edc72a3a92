"""The port's ``loadgen`` against the JAX package's: every trace generator
at several seeds and knob settings, field for field and as saved JSON,
byte for byte; ``from_request_log`` on the same records; ``replay``
against a callable, a ``MicroBatcher`` stand-in with a RequestLog and a
guarded ``LMServingConfig``, with the same outcome counts, ``ok_tokens``,
retries, SLO violations and tokens (wall times left out). Every
comparison is exact."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import dataclasses
import time

import numpy as np
import pytest

import zookeeper_tpu.loadgen as jl
import zookeeper_tpu.serving as js
import zookeeper_tpu_torch.loadgen as pl
import zookeeper_tpu_torch.serving as ps
from zookeeper_tpu.loadgen.harness import _classify as jax_classify
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu_torch.loadgen.harness import _classify
from zookeeper_tpu_torch.resilience import FaultPlan, faults

from torch_serving_pair import as_list, export_jax_weights, jax_service, port_service


def as_dicts(trace):
    return [dataclasses.asdict(r) for r in trace.requests]


GENERATORS = {
    "poisson_burst": [
        {},
        dict(base_rate_rps=35.0, burst_rate_rps=300.0, base_s=0.5, burst_s=0.7,
             cooldown_s=0.4, vocab=1024, prompt_len=64, max_prompt_len=2048, new_tokens=64,
             max_new_tokens=64, deadline_ms=4000.0),
        dict(tail_alpha=0.8, new_tokens=1, max_new_tokens=40, name="heavy"),
    ],
    "diurnal_ramp": [
        {},
        dict(peak_rate_rps=250.0, trough_frac=0.3, duration_s=2.5, cycles=2.0, vocab=17,
             deadline_ms=50.0),
        dict(trough_frac=0.0, cycles=0.5, tail_alpha=3.0),
    ],
    "session_mix": [
        {},
        dict(sessions=4, turns=3, shared_prefix_len=1024, turn_tokens=128, vocab=1024,
             new_tokens=32, max_new_tokens=32),
        dict(sessions=1, turns=5, rate_rps=7.0, deadline_ms=10.0, name="one"),
    ],
}
CASES = [(gen, i) for gen, knobs in GENERATORS.items() for i in range(len(knobs))]


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("gen,knob", CASES, ids=[f"{g}-{i}" for g, i in CASES])
def test_traces_equal_jax_field_for_field(gen, knob, seed, tmp_path):
    kw = GENERATORS[gen][knob]
    want = getattr(jl, gen)(seed, **kw)
    got = getattr(pl, gen)(seed, **kw)
    assert as_dicts(got) == as_dicts(want) and len(got.requests) > 0
    assert (got.name, got.seed, got.duration_ms, got.phases(), got.stats()) == (
        want.name, want.seed, want.duration_ms, want.phases(), want.stats())
    want.save(str(tmp_path / "jax.json"))
    got.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = pl.Trace.load(str(tmp_path / "jax.json"))
    assert as_dicts(back) == as_dicts(want) and back.name == want.name


def test_generator_refusals_match_jax():
    for gen, kw in (("poisson_burst", dict(base_rate_rps=0)),
                    ("diurnal_ramp", dict(peak_rate_rps=0)),
                    ("diurnal_ramp", dict(trough_frac=1.5)),
                    ("session_mix", dict(sessions=0)), ("session_mix", dict(turns=0))):
        with pytest.raises(ValueError):
            getattr(jl, gen)(1, **kw)
        with pytest.raises(ValueError):
            getattr(pl, gen)(1, **kw)


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_from_request_log_equals_jax(seed):
    rng = np.random.default_rng(seed)
    base = 5_000_000_000
    records = []
    for rid in range(1, 30):
        rec = {"rid": rid, "enqueue_ns": base + int(rng.integers(0, 2_000_000_000))}
        if rng.uniform() < 0.1:
            rec["enqueue_ns"] = None
        if rng.uniform() < 0.7:
            rec["rows"] = int(rng.integers(0, 20))
        if rng.uniform() < 0.7:
            rec["tokens"] = int(rng.integers(0, 12))
        records.append(rec)
    kw = dict(seed=seed, vocab=int(rng.integers(3, 100)), default_new_tokens=5,
              deadline_ms=None if seed else 25.0)
    assert as_dicts(pl.from_request_log(records, **kw)) == as_dicts(
        jl.from_request_log(records, **kw))
    assert pl.from_request_log([], seed=1).requests == []


def test_from_request_log_of_a_port_request_log():
    """A port service's RequestLog tail (its JSON as ``/statusz`` serves
    it) rebuilds the same trace in both packages."""
    from zookeeper_tpu_torch.observability.requests import RequestLog

    log = RequestLog("decode")
    for rid in range(8):
        log.append(rid, "ok", enqueue_ns=1_000_000 * (3 * rid + rid % 2),
                   complete_ns=10**9, tokens=rid + 1, rows=rid)
    records = log.as_status()["tail"]
    assert as_dicts(pl.from_request_log(records, seed=3)) == as_dicts(
        jl.from_request_log(records, seed=3))


def test_classification_covers_the_taxonomy_like_jax():
    pairs = [(None, None), (ps.RejectedError("q"), js.RejectedError("q")),
             (ps.PredictedMissError("m"), js.PredictedMissError("m")),
             (ps.DeadlineExpiredError("l"), js.DeadlineExpiredError("l")),
             (ps.WorkerCrashedError("c"), js.WorkerCrashedError("c")),
             (ps.FleetUnavailableError("u"), js.FleetUnavailableError("u")),
             (RuntimeError("?"), RuntimeError("?"))]
    got = [_classify(p) for p, _ in pairs]
    assert got == [jax_classify(j) for _, j in pairs]
    assert got == ["ok", "shed", "shed", "deadline_expired", "crashed", "unavailable",
                   "error"]


def tiny_trace(pkg, **kw):
    kw.setdefault("base_rate_rps", 200)
    kw.setdefault("burst_rate_rps", 400)
    kw.setdefault("base_s", 0.1)
    kw.setdefault("burst_s", 0.1)
    kw.setdefault("cooldown_s", 0.1)
    return pkg.poisson_burst(1, **kw)


def report_view(report):
    """Everything of a report but wall times."""
    return {
        "trace": report.trace, "seed": report.seed, "outcomes": report.outcomes,
        "ok_tokens": report.ok_tokens, "retried_total": report.retried_total,
        "violations": report.violations,
        "results": [(o.index, o.rid, o.phase, o.session, o.outcome, o.ttft_ms, o.tokens,
                     o.retried, o.error) for o in report.results],
        "per_phase": {p: (s["requests"], s["ok"], s["ttft_ms"], sorted(s["latency_ms"]))
                      for p, s in report.per_phase.items()},
        "as_dict": {k: v for k, v in report.as_dict().items()
                    if k not in ("wall_s", "goodput_tokens_per_sec", "per_phase")},
    }


def callable_target(serving, salt):
    """A deterministic callable: tokens and TTFT from the request, and
    each error class of ``serving`` (either package's module) raised at
    fixed indices."""
    errors = {0: serving.RejectedError, 3: serving.PredictedMissError,
              5: serving.DeadlineExpiredError, 8: serving.WorkerCrashedError,
              13: serving.FleetUnavailableError, 21: KeyError}

    def target(req):
        if req.index in errors:
            raise errors[req.index]("injected")
        return (len(req.prompt) + req.max_new_tokens + salt) % 7 + 1, 0.5 * (req.index % 9)

    return target


@pytest.mark.parametrize("concurrency", [1, 3, 8])
def test_replay_against_a_callable_equals_jax(concurrency):
    want = jl.replay(tiny_trace(jl), callable_target(js, concurrency),
                     concurrency=concurrency, slo_ttft_ms=2.9)
    got = pl.replay(tiny_trace(pl), callable_target(ps, concurrency),
                    concurrency=concurrency, slo_ttft_ms=2.9)
    assert report_view(got) == report_view(want)
    assert set(got.outcomes) == {"ok", "shed", "deadline_expired", "crashed", "unavailable",
                                 "error"}
    assert got.violations and got.goodput_tokens_per_sec > 0


class FakePending:
    def __init__(self, rid, rows):
        self.rid = rid
        self._rows = rows

    def result(self, timeout=None):
        return np.zeros((self._rows, 1), np.float32)


class FakeLog:
    def __init__(self):
        self.details = {}

    def find(self, rid):
        return None if rid not in self.details else {"rid": rid, "detail": self.details[rid]}


class FakeBatcherTarget:
    """The ``submit`` + ``flush`` duck type (the open loop) with router-
    style ``retried=N`` details in its RequestLog, shedding past a rid."""

    def __init__(self, serving, shed_from=10**9):
        self.serving = serving
        self.shed_from = shed_from
        self.request_log = FakeLog()
        self._next_rid = 100

    def submit(self, x, deadline_ms=None):
        if self._next_rid >= self.shed_from:
            raise self.serving.RejectedError("queue full")
        rid = self._next_rid
        self._next_rid += 1
        if rid % 2 == 0:
            self.request_log.details[rid] = f"ok replica=w1 retried={rid % 3}"
        return FakePending(rid, int(np.asarray(x).shape[0]))

    def flush(self):
        pass


@pytest.mark.parametrize("shed_from", [10**9, 103])
def test_open_loop_retries_and_sheds_equal_jax(shed_from):
    kw = dict(base_s=0.05, burst_s=0.0, cooldown_s=0.0)
    want = jl.replay(tiny_trace(jl, **kw), FakeBatcherTarget(js, shed_from))
    got = pl.replay(tiny_trace(pl, **kw), FakeBatcherTarget(ps, shed_from))
    assert report_view(got) == report_view(want)
    assert got.retried_total > 0


def test_replay_installs_and_always_clears_the_plan():
    plan = FaultPlan(delay_forward_ms={"w9": 1})
    observed = []

    def target(req):
        observed.append(faults.active() is plan)
        return 1, None

    trace = tiny_trace(pl, base_s=0.02, burst_s=0.0, cooldown_s=0.0)
    pl.replay(trace, target, fault_plan=plan)
    assert observed and all(observed) and faults.active() is None

    def boom(req):
        raise KeyboardInterrupt  # a hard abort is a terminal outcome too

    report = pl.replay(trace, boom, fault_plan=plan)
    assert set(report.outcomes) == {"error"} and faults.active() is None
    # The JAX package's plan type is not the port's: nothing crosses.
    assert not isinstance(JaxFaultPlan(), FaultPlan)


def test_slo_violations_fire_the_flight_recorder(monkeypatch):
    from zookeeper_tpu_torch.observability import recorder as _recorder

    seen = []
    monkeypatch.setattr(_recorder, "notify",
                        lambda kind, step=None, attrs=None: seen.append((kind, attrs)))
    trace = tiny_trace(pl)
    slow = {trace.requests[0].index, trace.requests[1].index}
    report = pl.replay(trace, lambda req: (4, 500.0 if req.index in slow else 0.5),
                       slo_ttft_ms=100.0)
    assert {v["index"] for v in report.violations} == slow
    assert [kind for kind, _ in seen] == ["slo_violation"] * 2
    assert all("ttft_ms=500.0" in a["breached"][0] for _, a in seen)


def test_mode_concurrency_and_pacing():
    with pytest.raises(ValueError, match="mode"):
        pl.replay(tiny_trace(pl), lambda r: (1, None), mode="bogus")
    with pytest.raises(ValueError, match="concurrency"):
        pl.replay(tiny_trace(pl), lambda r: (1, None), concurrency=0)
    # A target the open loop cannot drive fails each request, terminally.
    report = pl.replay(tiny_trace(pl), object(), mode="open_loop")
    assert set(report.outcomes) == {"error"}
    assert {o.error for o in report.results} == {"TypeError"}
    trace = pl.session_mix(3, sessions=2, turns=2, rate_rps=40.0)
    t0 = time.perf_counter()
    pl.replay(trace, lambda r: (1, None), time_scale=1.0, concurrency=8)
    assert (time.perf_counter() - t0) * 1e3 >= trace.duration_ms * 0.5
    t0 = time.perf_counter()
    pl.replay(trace, lambda r: (1, None), concurrency=8)
    assert (time.perf_counter() - t0) * 1e3 < trace.duration_ms * 0.5


def test_replay_against_the_port_batcher():
    """The open loop against a real port ``MicroBatcher``: every request
    ok, its rows delivered."""
    import torch

    from zookeeper_tpu_torch.core import configure

    class Doubler:
        max_batch = 8

        def bucket_for(self, rows):
            return self.max_batch

        def infer(self, x):
            return torch.from_numpy(np.asarray(x) * 2)

    batcher = ps.MicroBatcher()
    configure(batcher, {}, name="batcher")
    batcher.bind(Doubler())
    trace = pl.poisson_burst(4, base_s=0.1, burst_s=0.05, cooldown_s=0.05)
    report = pl.replay(trace, batcher)
    assert report.outcomes == {"ok": len(trace.requests)}
    assert report.ok_tokens == sum(len(r.prompt) for r in trace.requests)
    assert report.results[0].rid == batcher.request_log.tail(len(trace.requests))[0]["rid"]


# -- replay through the guarded LMServingConfig on both packages -------------

GUARD_CONF = {"guard.enabled": True, "guard.min_samples": 1, "guard.alpha": 0.01,
              "guard.brownout_after": 3, "guard.brownout_release": 2,
              "guard.brownout_max_new_tokens": 2}


class Recording:
    """A stream-scheduler target (``submit`` + ``drain``) that keeps each
    admitted stream, so the tokens can be compared, not only counted."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.request_log = scheduler.request_log
        self.streams = {}

    def submit(self, prompt, **kw):
        stream = self.scheduler.submit(prompt, **kw)
        self.streams[stream.rid] = stream
        return stream

    def drain(self):
        self.scheduler.drain()


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    jsvc, jsched = jax_service(GUARD_CONF)
    psvc, psched = port_service(export_jax_weights(jsvc, tmp_path_factory.mktemp("w")),
                                GUARD_CONF)
    yield (jsvc, jsched), (psvc, psched)
    jsvc._teardown_service(suppress=True)
    psvc._teardown_service(suppress=True)


def lm_trace(pkg, seed, deadline):
    return pkg.poisson_burst(seed, base_rate_rps=40, burst_rate_rps=200, base_s=0.1,
                             burst_s=0.05, cooldown_s=0.1, vocab=61, prompt_len=3,
                             max_prompt_len=40, new_tokens=2, max_new_tokens=6,
                             deadline_ms=deadline)


def lm_replay(pkg, svc, sched, seed, deadline):
    """Two replays of one trace: without the guard's pressure (no
    deadlines) and with deadlines the seeded estimate says every queued
    request misses."""
    svc.guard.observe_service(5_000.0, 1)
    target = Recording(sched)
    report = pkg.replay(lm_trace(pkg, seed, deadline), target)
    view = report_view(report)
    first = min(target.streams) if target.streams else 0
    view["results"] = [r[:1] + ((r[1] - first) if r[1] is not None else None,) + r[2:]
                       for r in view["results"]]
    tokens = {rid - first: as_list(s.result()) for rid, s in target.streams.items()
              if s.error is None}
    status = sched.status()["guardrails"]
    return view, tokens, status["brownout_active"], status["guard"]["brownout"]


@pytest.mark.parametrize("seed,deadline", [(2, None), (3, 3_000.0), (4, 3_000.0)])
def test_replay_through_the_guarded_service_equals_jax(services, seed, deadline):
    (jsvc, jsched), (psvc, psched) = services
    want = lm_replay(jl, jsvc, jsched, seed, deadline)
    got = lm_replay(pl, psvc, psched, seed, deadline)
    # The rids differ by the package's counter: compared from the first.
    for view in (got[0], want[0]):
        view["per_phase"] = {p: s[:2] for p, s in view["per_phase"].items()}
        view["results"] = [r[:5] + r[6:] for r in view["results"]]  # no TTFT (wall time)
    assert got == want
    outcomes = got[0]["outcomes"]
    if deadline is None:
        assert outcomes == {"ok": sum(outcomes.values())}
    else:
        assert outcomes["shed"] > 0 and outcomes["ok"] >= 1
