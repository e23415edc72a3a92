"""The port's overload guardrails against the JAX package's: the circuit
breaker, the guard's estimators and decisions and the brown-out on the
same sequences of observations and an injected clock; the guarded
``MicroBatcher``, ``DecodeScheduler`` and ``LMServingConfig`` shedding the
same requests, applying the brown-out at the same steps and emitting the
same tokens; the scheduler adopting a given rid.

Every comparison is exact. Where a service feeds its guard real wall
times, the guard is seeded with a per-unit service time far past every
deadline and a small ``alpha``, so each decision follows the queue alone
and both packages decide alike whatever the host's timings."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.observability.export import render_prometheus as jax_render
from zookeeper_tpu.serving import MicroBatcher as JaxBatcher
from zookeeper_tpu.serving import guardrails as jg
from zookeeper_tpu.serving.decode import DecodeScheduler as JaxScheduler
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.observability.export import render_prometheus
from zookeeper_tpu_torch.serving import MicroBatcher
from zookeeper_tpu_torch.serving import guardrails as pg
from zookeeper_tpu_torch.serving.decode import DecodeScheduler

from torch_decode_features import build_lm, jax_engine, port_engine
from torch_serving_pair import as_list, export_jax_weights, jax_service, port_service, prompt


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


BREAKERS = (
    dict(key="w0", failure_threshold=3, cooldown_s=5.0, jitter_frac=0.5, seed=0),
    dict(key="w1", failure_threshold=1, latency_threshold_ms=50.0, latency_window=2,
         cooldown_s=0.5, jitter_frac=0.0, seed=3),
    dict(key="replica-7", failure_threshold=0, latency_threshold_ms=10.0, latency_window=1,
         cooldown_s=2.0, jitter_frac=1.5, seed=11),
)


def breaker_state(b):
    return (b.status(), b.state, b.state_code(), b.open_until, b.routable())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("conf", BREAKERS, ids=lambda c: c["key"])
def test_breaker_walk_matches_jax(conf, seed):
    """A seeded walk of successes (fast and slow), failures, clock moves,
    probe claims and resets: the same states, cooldowns and claims."""
    rng = np.random.default_rng(seed)
    jclock, pclock = FakeClock(), FakeClock()
    jb = jg.CircuitBreaker(clock=jclock, **conf)
    pb = pg.CircuitBreaker(clock=pclock, **conf)
    probes = 0
    for _ in range(400):
        op = int(rng.integers(10))
        if op < 3:
            latency = float(rng.uniform(0.0, 100.0))
            jb.record_success(latency)
            pb.record_success(latency)
        elif op < 5:
            jb.record_failure()
            pb.record_failure()
        elif op < 7:
            jclock.t = pclock.t = jclock.t + float(rng.uniform(0.0, 4.0))
        elif op < 9:
            claimed = jb.try_probe()
            assert pb.try_probe() == claimed
            probes += claimed
        elif rng.uniform() < 0.3:
            jb.reset()
            pb.reset()
        assert breaker_state(pb) == breaker_state(jb)
    assert probes > 0 and pb.opened_total > 1


def test_breaker_rejects_the_configs_jax_rejects():
    for bad in (dict(failure_threshold=-1), dict(latency_window=0), dict(cooldown_s=0.0),
                dict(jitter_frac=-0.1)):
        with pytest.raises(ValueError):
            jg.CircuitBreaker(**bad)
        with pytest.raises(ValueError):
            pg.CircuitBreaker(**bad)


def guard_pair(**conf):
    conf = {"enabled": True, **conf}
    j = jg.OverloadGuard()
    jax_configure(j, dict(conf), name="guard")
    p = pg.OverloadGuard()
    configure(p, dict(conf), name="guard")
    return j.bind(), p.bind()


GUARDS = (
    dict(),
    dict(alpha=0.5, min_samples=1, headroom=1.5),
    dict(alpha=1.0, min_samples=2, headroom=0.7, brownout_after=2, brownout_release=3,
         brownout_max_new_tokens=3),
    dict(alpha=0.1, min_samples=3, brownout_after=1, brownout_release=1),
)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("conf", GUARDS, ids=str)
def test_guard_decisions_match_jax(conf, seed):
    """A seeded walk of service and wait observations, admissions (empty
    queue, no deadline, tight and loose deadlines) and applied brown-out
    transitions: the same ``(admitted, predicted_ms)`` bit for bit, the
    same status, snapshot and ``zk_guard_*`` exposition."""
    rng = np.random.default_rng(seed)
    j, p = guard_pair(**conf)
    assert p.status() == j.status()
    for _ in range(300):
        op = int(rng.integers(8))
        if op < 2:
            ms, units = float(rng.uniform(0.0, 200.0)), int(rng.integers(0, 9))
            j.observe_service(ms, units)
            p.observe_service(ms, units)
        elif op < 3:
            ms = float(rng.exponential(40.0))
            j.observe_wait(ms)
            p.observe_wait(ms)
        elif op < 7:
            queued = int(rng.integers(0, 40)) if rng.uniform() < 0.8 else 0
            units = int(rng.integers(1, 20))
            deadline = None if rng.uniform() < 0.15 else float(rng.uniform(0.0, 3000.0))
            got = p.admit(queued_units=queued, request_units=units, deadline_ms=deadline)
            assert got == j.admit(queued_units=queued, request_units=units,
                                  deadline_ms=deadline)
            assert p.predicted_ms(queued, units) == j.predicted_ms(queued, units)
        else:
            active = bool(rng.integers(2))
            j.record_brownout_applied(active)
            p.record_brownout_applied(active)
        assert p.brownout_engaged == j.brownout_engaged
        assert p.samples == j.samples
    assert p.status() == j.status()
    assert p.snapshot() == j.snapshot()
    assert render_prometheus([p.registry]) == jax_render([j.registry])


def test_guard_rejects_and_refuses_like_jax():
    for bad in (dict(alpha=0.0), dict(alpha=1.5), dict(min_samples=0), dict(headroom=0.0),
                dict(brownout_max_new_tokens=0)):
        with pytest.raises(ValueError):
            guard_pair(**bad)
    j, p = jg.OverloadGuard(), pg.OverloadGuard()
    assert p.status() == j.status() == {"enabled": False, "bound": False}
    for guard in (j, p):
        with pytest.raises(RuntimeError, match="not bound"):
            guard.admit(queued_units=1, request_units=1, deadline_ms=1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brownout_hysteresis_matches_jax(seed):
    rng = np.random.default_rng(seed)
    engage, release = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    j, p = jg.BrownOut(engage, release), pg.BrownOut(engage, release)
    for _ in range(200):
        shed = bool(rng.uniform() < 0.5)
        j.note(shed)
        p.note(shed)
        assert p.status() == j.status()
    assert p.engaged_total == j.engaged_total > 0
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            jg.BrownOut(*bad)
        with pytest.raises(ValueError):
            pg.BrownOut(*bad)


def test_predicted_miss_is_a_rejected_error():
    from zookeeper_tpu_torch.serving import RejectedError
    from zookeeper_tpu_torch.serving.batcher import outcome_of

    assert issubclass(pg.PredictedMissError, RejectedError)
    assert outcome_of(pg.PredictedMissError("x")) == "shed"


# -- the guarded services ------------------------------------------------------


class TinyEngine:
    """The surface a MicroBatcher needs: doubles its input (a tensor for
    the port's batcher, an array for the JAX one)."""

    max_batch = 8

    def __init__(self, port):
        self.port = port

    def bucket_for(self, rows):
        return self.max_batch

    def infer(self, x):
        return torch.from_numpy(np.asarray(x) * 2) if self.port else np.asarray(x) * 2


def seeded(guard):
    """A guard whose per-unit service estimate dwarfs every deadline here;
    with alpha 0.01 real wall times barely move it."""
    guard.observe_service(5_000.0, 1)
    return guard


def outcome(fn):
    try:
        return fn(), None
    except Exception as e:
        return None, type(e).__name__


@pytest.mark.parametrize("seed", [0, 1])
def test_guarded_batcher_sheds_like_jax(seed):
    """Seeded submits (rows, deadlines or none) and flushes through both
    guarded batchers: the same sheds (``PredictedMissError``), results,
    RequestLog outcomes, and the same count of observations fed back."""
    rng = np.random.default_rng(seed)
    jguard, pguard = (seeded(g) for g in guard_pair(alpha=0.01, min_samples=1,
                                                    brownout_after=2, brownout_release=2))
    jb, pb = JaxBatcher(), MicroBatcher()
    jax_configure(jb, {"synchronous": True}, name="batcher")
    configure(pb, {"synchronous": True}, name="batcher")
    jb.bind(TinyEngine(False), guard=jguard)
    pb.bind(TinyEngine(True), guard=pguard)
    pending = []
    for i in range(40):
        if rng.uniform() < 0.2:
            jb.flush()
            pb.flush()
            continue
        x = rng.normal(size=(int(rng.integers(1, 6)), 3)).astype(np.float32)
        deadline = None if rng.uniform() < 0.3 else 2_000.0
        jr, je = outcome(lambda: jb.submit(x, deadline_ms=deadline))
        pr, pe = outcome(lambda: pb.submit(x, deadline_ms=deadline))
        assert pe == je
        if jr is not None:
            pending.append((jr, pr))
        assert pguard.brownout_engaged == jguard.brownout_engaged
    jb.flush()
    pb.flush()
    for jr, pr in pending:
        np.testing.assert_array_equal(pr.result(), jr.result())
    jlog, plog = jb.request_log.tail(100), pb.request_log.tail(100)
    assert [r["outcome"] for r in plog] == [r["outcome"] for r in jlog]
    assert [(r["detail"] or "").split()[0] for r in plog if r["outcome"] == "shed"] == \
        [(r["detail"] or "").split()[0] for r in jlog if r["outcome"] == "shed"]
    assert any(r["outcome"] == "shed" for r in plog)
    assert pguard.samples == jguard.samples
    pst, jst = pguard.status(), jguard.status()
    for key in ("predicted_miss_total", "admitted_total", "brownout", "samples"):
        assert pst[key] == jst[key]


@pytest.fixture(scope="module")
def lm():
    return build_lm()


def guarded_scheduler(port, engine, guard):
    sched = DecodeScheduler() if port else JaxScheduler()
    (configure if port else jax_configure)(sched, {}, name="sched")
    return sched.bind(engine, guard=guard)


def brownout_walk(sched, guard, port):
    """The JAX brown-out test's walk, recorded: the predicted-miss shed
    engages the guard, the posture flips only with the slots drained,
    admitted streams are capped while it holds, and release restores full
    budgets."""
    p = np.arange(1, 5, dtype=np.int32)
    seen = []
    status = lambda: sched.status()["guardrails"]  # noqa: E731
    inflight = sched.submit(p, max_new_tokens=8)
    sched._step_once()
    queued = sched.submit(p, max_new_tokens=8)
    seen.append(outcome(lambda: sched.submit(p, max_new_tokens=8, deadline_ms=1.0))[1])
    seen.append(guard.brownout_engaged)
    sched._step_once()
    seen.append(status()["brownout_active"])
    seen += [as_list(inflight.result()), as_list(queued.result())]
    sched._step_once()
    seen.append(status()["brownout_active"])
    seen.append(as_list(sched.submit(p, max_new_tokens=8).result()))
    guard.admit(queued_units=0, request_units=1, deadline_ms=None)
    seen.append(guard.brownout_engaged)
    sched._step_once()
    seen.append(status()["brownout_active"])
    seen.append(as_list(sched.submit(p, max_new_tokens=8).result()))
    seen.append(render_prometheus([guard.registry]) if port else jax_render([guard.registry]))
    log = sched.request_log.tail(10)
    seen.append([(r["rid"] - log[0]["rid"], r["outcome"], r["tokens"]) for r in log])
    return seen


def test_scheduler_brownout_walk_matches_jax(lm):
    jmod, params, mod = lm
    conf = dict(alpha=0.01, min_samples=1, brownout_after=1, brownout_release=2,
                brownout_max_new_tokens=2)
    jguard, pguard = (seeded(g) for g in guard_pair(**conf))
    want = brownout_walk(guarded_scheduler(False, jax_engine(jmod, params), jguard),
                         jguard, False)
    got = brownout_walk(guarded_scheduler(True, port_engine(mod), pguard), pguard, True)
    # The gauges of the EWMAs read wall times: compare the other series.
    strip = lambda text: [line for line in text.splitlines()  # noqa: E731
                          if "ewma" not in line and "predicted_ms" not in line]
    assert "zk_guard_brownout_active 0" in got[-2]
    got[-2], want[-2] = strip(got[-2]), strip(want[-2])
    assert got == want
    # The shed engaged it, the drained step applied it, a capped stream,
    # then release and a full budget again.
    assert got[:3] == ["PredictedMissError", True, False] and got[5] is True
    assert len(got[6]) == 2 and got[7:9] == [False, False] and len(got[9]) == 8


def test_scheduler_chunked_shed_counts_chunks_like_jax(lm):
    """Under chunked prefill the queued work counts the prompt chunks
    owed; both packages shed the same submits at the same deadline."""
    jmod, params, mod = lm
    engines = (jax_engine(jmod, params, kv_layout="paged", prefill_chunk_tokens=4),
               port_engine(mod, kv_layout="paged", prefill_chunk_tokens=4))
    results = []
    for port, engine in zip((False, True), engines):
        guard = pg.OverloadGuard() if port else jg.OverloadGuard()
        (configure if port else jax_configure)(
            guard, {"enabled": True, "min_samples": 1, "alpha": 0.01}, name="guard")
        guard.bind()
        guard.observe_service(100.0, 1)  # 100 ms a unit
        sched = guarded_scheduler(port, engine, guard)
        seen = []
        sched.submit(np.arange(1, 16, dtype=np.int32), max_new_tokens=2)
        sched._step_once()  # one chunk of four committed
        for deadline in (2_000.0, 1_200.0, 900.0, 700.0):
            seen.append(outcome(lambda: sched.submit(np.arange(1, 9, dtype=np.int32),
                                                     max_new_tokens=3,
                                                     deadline_ms=deadline))[1])
        sched.drain()
        seen.append(guard.status()["predicted_miss_total"])
        results.append(seen)
    assert results[1] == results[0]
    assert None in results[0] and "PredictedMissError" in results[0]


def test_submit_adopts_the_given_rid_like_jax(lm):
    """``submit(rid=...)``: the stream, its RequestLog row and its trace
    events carry the caller's rid, in both packages."""
    from zookeeper_tpu.observability import trace as jax_trace
    from zookeeper_tpu_torch.observability import trace as port_trace

    jmod, params, mod = lm
    rows = []
    for port, engine in ((False, jax_engine(jmod, params)), (True, port_engine(mod))):
        trace = port_trace if port else jax_trace
        prior = trace._TRACER
        trace.install(trace.Tracer(4096))
        try:
            sched = guarded_scheduler(port, engine, None)
            stream = sched.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3,
                                  rid=424242)
            minted = sched.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
            sched.drain()
            events = [e for e in trace.to_chrome_trace()["traceEvents"]
                      if (e.get("args") or {}).get("rid") == 424242]
        finally:
            trace.install(prior)
        rec = sched.request_log.find(424242)
        rows.append((stream.rid, rec["outcome"], rec["tokens"], minted.rid != 424242,
                     sorted({e["name"] for e in events})))
    assert rows[1] == rows[0]
    assert rows[0][0] == 424242 and "decode_stream_finish" in rows[0][4]


# -- LMServingConfig with the guard on both packages -------------------------

GUARD_CONF = {"guard.enabled": True, "guard.min_samples": 1, "guard.alpha": 0.01,
              "guard.brownout_after": 2, "guard.brownout_release": 2,
              "guard.brownout_max_new_tokens": 2}


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    jsvc, jsched = jax_service(GUARD_CONF)
    psvc, psched = port_service(export_jax_weights(jsvc, tmp_path_factory.mktemp("w")),
                                GUARD_CONF)
    yield (jsvc, jsched), (psvc, psched)
    jsvc._teardown_service(suppress=True)
    psvc._teardown_service(suppress=True)


def service_walk(svc, sched):
    """Bursts of submits with deadlines between drains: the first of a
    burst is admitted into the empty queue, the rest predicted to miss
    (brown-out engaged), drained submits then capped, and no-deadline
    admits releasing it. Returns what each submit and drain gave."""
    seeded(svc.guard)
    seen = []
    for burst in range(4):
        streams = []
        for i in range(3 if burst < 2 else 1):
            stream, err = outcome(lambda: sched.submit(
                prompt(10 * burst + i, 5 + i), max_new_tokens=6,
                deadline_ms=None if burst == 3 else 3_000.0))
            seen.append(err)
            if stream is not None:
                streams.append(stream)
        sched.drain()
        seen.append([as_list(s.result()) for s in streams])
        seen.append(sched.status()["guardrails"]["brownout_active"])
        seen.append(svc.guard.brownout_engaged)
    st = svc.guard.status()
    seen.append((st["predicted_miss_total"], st["admitted_total"], st["brownout"]))
    seen.append(sorted(svc._status_providers()))
    return seen


def test_guarded_lm_service_matches_jax(services):
    (jsvc, jsched), (psvc, psched) = services
    want = service_walk(jsvc, jsched)
    got = service_walk(psvc, psched)
    assert got == want
    assert "PredictedMissError" in got and "guardrails" in got[-1]
    assert got[-2][2]["engaged_total"] >= 1
