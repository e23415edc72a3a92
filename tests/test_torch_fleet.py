"""The port's fleet router against the JAX package's, and a real CPU fleet
of port worker processes.

1. Routing: seeded scenarios (sessions, shared-prefix prompts, replica
   deaths and revivals, health checks, load, breaker clocks, retries, the
   FaultPlan kill leg, a router rebuilt from its ``state_path``) drive
   both routers over in-process stub transports; every response, error,
   status, session pin, breaker state, RequestLog row, metrics snapshot
   and ``zk_fleet_*`` exposition (routing wall times aside) is the JAX
   router's.
2. Two port worker processes (``spawn_fleet_workers``, on the CPU, on the
   JAX service's weights) behind the router give the JAX service's tokens
   and a warm turn 2; the kill leg leaves every request terminal with the
   retried ones equal to the oracle and no page held; the gray leg walks
   the breaker open, half-open, closed.
3. The serving and loadgen exports, ``ServeFleet`` and the FaultPlan fleet
   legs.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import os
import time
import urllib.request

import numpy as np
import pytest

import zookeeper_tpu.loadgen as jax_loadgen
import zookeeper_tpu.serving as jax_serving
import zookeeper_tpu_torch.loadgen as port_loadgen
import zookeeper_tpu_torch.serving as port_serving
from zookeeper_tpu.observability.export import render_prometheus as jax_render
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.observability.export import render_prometheus
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.serving.fleet_worker import spawn_fleet_workers, stop_fleet_workers

from torch_serving_pair import LM_CONF, as_list, export_jax_weights, jax_service


def test_every_serving_and_loadgen_name_resolves_in_the_port():
    for jax_pkg, port_pkg in ((jax_serving, port_serving), (jax_loadgen, port_loadgen)):
        missing = [n for n in jax_pkg.__all__ if not hasattr(port_pkg, n)]
        assert not missing, f"{port_pkg.__name__} lacks {missing}"
        assert sorted(port_pkg.__all__) == sorted(jax_pkg.__all__)


# -- 1. routing against the JAX router ----------------------------------------


class StubFleet:
    """In-process stand-in for N workers: echoes the prompt plus a token
    made from it, records every payload, fails like a dead socket when
    killed."""

    def __init__(self, serving, n):
        self.calls = []
        self.dead = set()
        self.replicas = [serving.ReplicaHandle(f"w{i}", f"stub://w{i}/generate")
                         for i in range(n)]

    def transport(self, replica, payload, timeout_s):
        if replica.worker_id in self.dead:
            raise ConnectionError(f"{replica.worker_id} is dead")
        self.calls.append((replica.worker_id, dict(payload)))
        if payload["tokens"][0] == 60:
            return {"error": "prompt refused", "type": "ValueError"}
        tail = [sum(payload["tokens"]) % 61, payload["max_new_tokens"]]
        return {"rid": payload["rid"], "worker_id": replica.worker_id,
                "tokens": list(payload["tokens"][-2:]) + tail, "ttft_ms": 1.0,
                "shared_tokens": 3, "finish_reason": "length"}

    def health(self, replica, timeout_s):
        return replica.worker_id not in self.dead

    def kill(self, replica):
        self.dead.add(replica.worker_id)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


ROUTERS = {
    "affinity": dict(n=3),
    "retries": dict(n=2, max_retries=2, breaker_failures=1, breaker_cooldown_s=5.0,
                    breaker_seed=7),
    "round_robin": dict(n=3, policy="round_robin", max_retries=1, breaker_failures=2,
                        breaker_cooldown_s=2.0, breaker_jitter_frac=0.0),
    "gray": dict(n=2, breaker_latency_ms=1e-6, breaker_latency_window=1,
                 breaker_cooldown_s=3.0, breaker_jitter_frac=0.25, max_retries=1),
    "restart": dict(n=3, max_retries=1, state=True),
}


def make_router(serving, conf, clock, state_path, replicas=None, stub=None):
    conf = dict(conf)
    n = conf.pop("n")
    use_state = conf.pop("state", False)
    stub = stub or StubFleet(serving, n)
    router = serving.FleetRouter(
        replicas or stub.replicas, page_size=4, transport=stub.transport,
        health_probe=stub.health, kill_replica=stub.kill, breaker_clock=clock,
        sleep=lambda s: None, state_path=state_path if use_state else None, **conf)
    if "breaker_latency_ms" in conf:
        # Only w0 is gray: every real call passes the 1 ns threshold.
        for r in router.replicas[1:]:
            r.breaker.latency_threshold_ms = 0.0
    return router, stub


def response_view(resp):
    return (resp.rid, resp.worker_id, as_list(resp.tokens), resp.ttft_ms, resp.shared_tokens,
            resp.finish_reason, resp.affinity_hit, resp.rerouted, resp.predicted_shared)


def router_view(router):
    snap = {k: v for k, v in router.metrics.snapshot().items()
            if not k.startswith("fleet_route_ms")}
    log = [{k: v for k, v in r.items() if not k.endswith("_ns")}
           for r in router.request_log.tail(1000)]
    status = router.status()
    # Each package writes its own file: compare the names.
    status["state_path"] = status["state_path"] and os.path.basename(status["state_path"])
    return status, dict(router._sessions), snap, log, [
        (r.healthy, r.outstanding, r.routed_total, r.index.nodes, r._scrape is None)
        for r in router.replicas]


def exposition(text):
    return [line for line in text.splitlines() if "zk_fleet_route_ms" not in line]


def prompt_families(rng):
    bases = [rng.integers(1, 60, size=int(rng.integers(6, 18))).tolist() for _ in range(4)]
    return bases


class Side:
    """One package's router, stub, clock, plan and state file."""

    def __init__(self, serving, faults_mod, plan_cls, conf, state_path):
        self.serving, self.faults, self.plan_cls = serving, faults_mod, plan_cls
        self.conf, self.state_path = conf, state_path
        self.clock = FakeClock()
        self.router, self.stub = make_router(serving, conf, self.clock, state_path)

    def apply(self, op):
        kind = op[0]
        if kind == "submit":
            _, tokens, session, new, rid, kill_at = op
            try:
                if kill_at is not None:
                    with self.faults.injected(self.plan_cls(fleet_replica_kill_at=kill_at)):
                        resp = self.router.submit(tokens, session=session,
                                                  max_new_tokens=new, rid=rid)
                else:
                    resp = self.router.submit(tokens, session=session, max_new_tokens=new,
                                              rid=rid)
                return response_view(resp)
            except Exception as e:
                return type(e).__name__
        if kind == "kill":
            self.stub.dead.add(f"w{op[1]}")
        elif kind == "revive":
            self.stub.dead.discard(f"w{op[1]}")
        elif kind == "health":
            return self.router.check_health()
        elif kind == "load":
            self.router.replicas[op[1] % len(self.router.replicas)].outstanding = op[2]
        elif kind == "clock":
            self.clock.t += op[1]
        elif kind == "restart":
            plan = self.plan_cls(fleet_router_restart_at=1)
            with self.faults.injected(plan):
                assert plan.take_fleet_router_restart()
                assert not plan.take_fleet_router_restart()
            self.router.close()
            saved = None
            if os.path.exists(self.state_path):
                with open(self.state_path) as f:
                    saved = f.read()
            self.router, _ = make_router(self.serving, self.conf, self.clock, self.state_path,
                                         replicas=[self.serving.ReplicaHandle(
                                             r.worker_id, r.generate_url)
                                             for r in self.router.replicas],
                                         stub=self.stub)
            return saved
        return None


def scenario(seed, n, with_restart):
    rng = np.random.default_rng(seed)
    bases = prompt_families(rng)
    ops = []
    for i in range(120):
        u = rng.uniform()
        if u < 0.6:
            base = bases[int(rng.integers(len(bases)))]
            tokens = base[:int(rng.integers(1, len(base) + 1))] + rng.integers(
                1, 60, size=int(rng.integers(0, 5))).tolist()
            if rng.uniform() < 0.03:
                tokens = [60] + tokens  # the worker answers with an error body
            session = None if rng.uniform() < 0.4 else f"s{int(rng.integers(4))}"
            kill_at = int(rng.integers(1, 3)) if rng.uniform() < 0.05 else None
            ops.append(("submit", tokens, session, int(rng.integers(1, 9)), 5000 + i, kill_at))
        elif u < 0.67:
            ops.append(("kill", int(rng.integers(n))))
        elif u < 0.77:
            ops.append(("revive", int(rng.integers(n))))
        elif u < 0.85:
            ops.append(("health",))
        elif u < 0.9:
            ops.append(("load", int(rng.integers(n)), int(rng.integers(0, 4))))
        elif u < 0.97 or not with_restart:
            ops.append(("clock", float(rng.uniform(0.0, 4.0))))
        else:
            ops.append(("restart",))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(ROUTERS))
def test_routing_matches_the_jax_router(name, seed, tmp_path):
    conf = ROUTERS[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_side = Side(jax_serving, jax_faults, JaxFaultPlan, conf,
                    str(tmp_path / "jax" / "fleet.json"))
    port_side = Side(port_serving, faults, FaultPlan, conf, str(tmp_path / "port" / "fleet.json"))
    outcomes = []
    try:
        for op in scenario(seed, conf["n"], name == "restart"):
            got, want = port_side.apply(op), jax_side.apply(op)
            assert got == want, op
            assert router_view(port_side.router) == router_view(jax_side.router), op
            outcomes.append(got)
        assert exposition(render_prometheus([port_side.router.metrics.registry])) == \
            exposition(jax_render([jax_side.router.metrics.registry]))
        assert port_side.stub.calls == jax_side.stub.calls
    finally:
        jax_side.router.close()
        port_side.router.close()
    kinds = {o if isinstance(o, str) else "ok" for o in outcomes
             if isinstance(o, (str, tuple))}
    assert "ok" in kinds and len(kinds) > 1  # some submits fail too


def test_router_rejects_the_configs_jax_rejects():
    for serving in (jax_serving, port_serving):
        stub = StubFleet(serving, 1)
        with pytest.raises(ValueError, match="policy"):
            serving.FleetRouter(stub.replicas, page_size=4, policy="random")
        with pytest.raises(ValueError, match="at least one"):
            serving.FleetRouter([], page_size=4)
        with pytest.raises(ValueError, match="duplicate"):
            serving.FleetRouter([serving.ReplicaHandle("w0", "u"),
                                 serving.ReplicaHandle("w0", "u")], page_size=4)
        with pytest.raises(ValueError, match="max_retries"):
            serving.FleetRouter(stub.replicas, page_size=4, max_retries=-1)


def test_router_observability_endpoint_and_trace():
    from zookeeper_tpu_torch.observability import trace

    router, stub = make_router(port_serving, dict(n=2), None, None)
    prior = trace._TRACER
    trace.install(trace.Tracer(1024))
    try:
        router.submit(list(range(1, 9)), session="s1", rid=5005)
        routes = [e for e in trace.to_chrome_trace()["traceEvents"]
                  if e.get("name") == "fleet_route"]
        assert routes[0]["args"]["rid"] == 5005 and routes[0]["args"]["replica"] == "w0"
        server = router.start_observability(port=0)
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert r.read() == b"ok\n"
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            body = r.read().decode()
        for series in ("zk_fleet_routed_total", "zk_fleet_rerouted_total",
                       "zk_fleet_worker_crashes_total", "zk_fleet_replica_healthy",
                       "zk_fleet_replicas", "zk_fleet_sessions", "zk_fleet_route_ms",
                       "zk_fleet_retries_total"):
            assert series in body, series
        with urllib.request.urlopen(base + "/statusz", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["fleet"]["policy"] == "affinity" and doc["fleet"]["sessions"] == 1
        assert doc["requests"]["service"] == "fleet"
    finally:
        trace.install(prior)
        router.close()
    assert router.obs_server is None


def test_fault_plan_fleet_legs_fire_once_like_jax():
    for plan_cls in (JaxFaultPlan, FaultPlan):
        kill = plan_cls(fleet_replica_kill_at=2)
        assert [kill.take_fleet_replica_kill() for _ in range(4)] == [False, True, False, False]
        restart = plan_cls(fleet_router_restart_at=2)
        assert [restart.take_fleet_router_restart() for _ in range(3)] == [False, True, False]
        delay = plan_cls(delay_forward_ms={"w0": 25})
        assert delay.take_delay_forward("w1") == 0
        assert delay.take_delay_forward("w0") == 25
        assert delay.take_delay_forward("w0") == 0
        assert plan_cls().take_delay_forward("w0") == 0
        assert not plan_cls().take_fleet_replica_kill()
        assert not plan_cls().take_fleet_router_restart()


def test_fleet_legs_mark_the_trace():
    from zookeeper_tpu_torch.observability import trace

    prior = trace._TRACER
    trace.install(trace.Tracer(256))
    try:
        FaultPlan(fleet_replica_kill_at=1).take_fleet_replica_kill()
        FaultPlan(fleet_router_restart_at=1).take_fleet_router_restart()
        FaultPlan(delay_forward_ms={"w0": 1}).take_delay_forward("w0")
        kinds = [e["args"]["kind"] for e in trace.to_chrome_trace()["traceEvents"]
                 if e.get("name") == "fault_injected"]
    finally:
        trace.install(prior)
    assert kinds == ["fleet_replica_kill_at", "fleet_router_restart_at", "delay_forward_ms"]


# -- 2. a real fleet of port worker processes on the CPU ----------------------

NEW_TOKENS = 6


def fleet_prompts():
    """Two sessions of two turns, turn 2 extending turn 1 (the JAX fleet
    test's conversation set)."""
    rng = np.random.default_rng(3)
    sessions = {}
    for sid in ("sA", "sB"):
        t1 = rng.integers(1, 60, size=20).tolist()
        sessions[sid] = [t1, t1 + rng.integers(1, 60, size=9).tolist()]
    return sessions


@pytest.fixture(scope="module")
def jax_lm(tmp_path_factory):
    svc, sched = jax_service()
    yield svc, sched, export_jax_weights(svc, tmp_path_factory.mktemp("weights"))
    svc._teardown_service(suppress=True)


def jax_tokens(sched, prompts):
    return [as_list(sched.submit(np.asarray(p, np.int32), max_new_tokens=n).result())
            for p, n in prompts]


def worker_conf(weights, **extra):
    return {**LM_CONF, "device": "cpu", "checkpoint": weights, **extra}


def statusz(worker):
    with urllib.request.urlopen("http://127.0.0.1:%d/statusz" % worker["metrics_port"],
                                timeout=10) as r:
        return json.loads(r.read().decode())


def pool_idle(worker):
    """The worker's pool holds no page for a stream: every page is free
    or the prefix cache's, none leaked; and its scraped free pages agree."""
    pool = statusz(worker)["decode"]["kv_pool"]
    with urllib.request.urlopen("http://127.0.0.1:%d/metrics" % worker["metrics_port"],
                                timeout=10) as r:
        free = [float(line.split()[-1]) for line in r.read().decode().splitlines()
                if line.startswith("zk_kv_pool_free_pages ")]
    return (pool["leaked"] == 0 and pool["free_pages"] + pool["prefix_nodes"]
            == pool["num_pages"] and free == [pool["free_pages"]])


def test_cpu_fleet_gives_the_oracle_tokens_warm_turns_and_survives_a_kill(
        jax_lm, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, jsched, weights = jax_lm
    sessions = fleet_prompts()
    order = [(sid, turn) for turn in range(2) for sid in sessions]
    want = jax_tokens(jsched, [(sessions[s][t], NEW_TOKENS) for s, t in order])
    workers = spawn_fleet_workers(str(tmp_path), 2, config=worker_conf(weights))
    router = None
    try:
        router = port_serving.FleetRouter(
            [port_serving.ReplicaHandle.from_worker(w) for w in workers],
            page_size=LM_CONF["engine.page_size"], max_retries=2, retry_backoff_s=0.01,
            breaker_failures=1, breaker_cooldown_s=30.0)
        got, traced = [], 314159
        for sid, turn in order:
            resp = router.submit(sessions[sid][turn], session=sid, max_new_tokens=NEW_TOKENS,
                                 rid=traced if (sid, turn) == ("sA", 0) else None)
            got.append(as_list(resp.tokens))
            if turn == 1:
                assert resp.affinity_hit and resp.worker_id == router.session_pin(sid)
                assert resp.shared_tokens >= len(sessions[sid][0]) - 1
        assert got == want
        # The router's rid is in the worker's own RequestLog.
        wid = router.request_log.find(traced)["detail"].split("replica=")[1].split()[0]
        worker = next(w for w in workers if w["worker_id"] == wid)
        assert traced in [e["rid"] for e in statusz(worker)["requests"]["tail"]]

        # The kill leg: a session-mix trace, the replica of the 3rd routed
        # request SIGKILLed before its forward; retries under the same rid.
        trace = port_loadgen.session_mix(17, sessions=2, turns=2, shared_prefix_len=8,
                                         turn_tokens=4, vocab=61, new_tokens=NEW_TOKENS,
                                         max_new_tokens=NEW_TOKENS)
        oracle = jax_tokens(jsched, [(r.prompt, r.max_new_tokens) for r in trace.requests])
        tokens = {}

        def target(req):
            resp = router.submit(np.asarray(req.prompt, np.int32), session=req.session,
                                 max_new_tokens=req.max_new_tokens)
            tokens[req.index] = as_list(resp.tokens)
            return len(tokens[req.index]), resp.ttft_ms

        report = port_loadgen.replay(trace, target,
                                     fault_plan=FaultPlan(fleet_replica_kill_at=3),
                                     concurrency=2)
        assert report.total == len(trace.requests)
        assert report.outcomes == {"ok": len(trace.requests)}
        assert [tokens[r.index] for r in trace.requests] == oracle
        assert router.retries_total >= 1
        dead = [r for r in router.replicas if not r.healthy]
        live = [r for r in router.replicas if r.healthy]
        assert len(dead) == 1 and dead[0].breaker.state == "open"
        assert live[0].breaker.state == "closed"
        assert pool_idle(next(w for w in workers if w["worker_id"] == live[0].worker_id))
    finally:
        if router is not None:
            router.close()
        stop_fleet_workers(workers)


def test_cpu_fleet_gray_failure_walks_the_breaker(jax_lm, tmp_path, monkeypatch):
    """w0 stalls one forward by 1.5 s and stays healthy: its breaker opens
    on the slow answer (past 1 s; an answer here takes tens of ms),
    routing avoids it, the half-open probe (fast again: the stall is
    one-shot) closes it; every answer the same."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, jsched, weights = jax_lm
    workers = spawn_fleet_workers(str(tmp_path), 2, config=worker_conf(
        weights, faults={"delay_forward_ms": {"w0": 1500}}))
    router = None
    try:
        router = port_serving.FleetRouter(
            [port_serving.ReplicaHandle.from_worker(w) for w in workers],
            page_size=LM_CONF["engine.page_size"], policy="round_robin",
            breaker_latency_ms=1000.0, breaker_latency_window=1, breaker_cooldown_s=0.5,
            breaker_jitter_frac=0.0)
        prompt = np.arange(1, 11, dtype=np.int32)
        reference = jax_tokens(jsched, [(prompt, NEW_TOKENS)])[0]
        states = []
        b0 = router._by_id["w0"].breaker
        for _ in range(4):
            assert as_list(router.submit(prompt, max_new_tokens=NEW_TOKENS).tokens) == reference
            if b0.state == "open":
                break
        states.append(b0.state)
        router.check_health()
        assert router._by_id["w0"].healthy  # liveness never saw it
        for _ in range(2):
            resp = router.submit(prompt, max_new_tokens=NEW_TOKENS)
            assert resp.worker_id == "w1" and as_list(resp.tokens) == reference
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if b0.routable():
                states.append("due")
                break
            time.sleep(0.05)
        resp = router.submit(prompt, max_new_tokens=NEW_TOKENS)
        states.append((resp.worker_id, b0.state))
        assert as_list(resp.tokens) == reference
        assert states == ["open", "due", ("w0", "closed")]
        assert b0.probes_total == 1 and b0.opened_total == 1
    finally:
        if router is not None:
            router.close()
        stop_fleet_workers(workers)


def test_serve_fleet_task_on_the_cpu(monkeypatch, capsys):
    """``ServeFleet device=cpu``: the JAX example's result line, warm
    later turns under affinity."""
    from zookeeper_tpu_torch.serving.serve_fleet import ServeFleet

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    task = ServeFleet()
    configure(task, {"device": "cpu", "sessions": 2, "num_layers": 1, "d_model": 32,
                     "shared_tokens": 24, "new_tokens": 4, "verbose": False}, name="fleet")
    result = task.run()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert set(result) == {
        "policy", "replicas", "sessions", "turns", "requests", "generated_tokens",
        "tokens_per_sec", "routed_total", "affinity_hits", "rerouted", "healthy_replicas",
        "warm_shared_tokens", "turn1_ttft_p50_ms", "route_ms_p50", "warm_ttft_p50_ms"}
    assert result["affinity_hits"] == 2 and result["routed_total"] == 4
    assert result["warm_shared_tokens"] and all(x > 0 for x in result["warm_shared_tokens"])
    assert result["generated_tokens"] == 16 and result["healthy_replicas"] == 2
