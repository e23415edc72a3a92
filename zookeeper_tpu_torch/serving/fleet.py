"""Fleet serving: a prefix-affinity router over decode replicas.

The port of ``zookeeper_tpu/serving/fleet.py``. A :class:`FleetRouter`
fronts worker processes, each an ``LMServingConfig`` with the paged KV
pool and the radix prefix cache behind a small HTTP seam
(``serving.fleet_worker.spawn_fleet_workers`` starts them, on the card
or, with ``device=cpu``, on the CPU):

- **Prefix affinity**: one pageless
  :class:`~zookeeper_tpu_torch.serving.decode.prefix_key.PrefixIndex` a
  replica (the chunking and keying of the replica's own
  ``RadixPrefixCache``, shared code) predicts how much of a prompt each
  replica holds warm; the prompt goes to the warmest, and when nobody is
  warm, to the least loaded (the router's in-flight count, then the
  ``zk_decode_queue_depth`` and ``zk_kv_pool_free_pages`` scraped from
  each replica's live ``/metrics``). ``policy="round_robin"`` rotates
  instead.
- **Sessions**: ``submit(session=...)`` pins a conversation to its
  replica, so a later turn re-enters that replica's cache; the pins
  persist to ``state_path`` (written atomically), so a restarted router
  keeps them.
- **Health and failures**: ``/healthz``-probed replicas; a transport
  failure marks the replica dead (its index drops: a restarted worker is
  cold), fails the request with ``WorkerCrashedError`` or, with
  ``max_retries``, re-routes it under the same rid; each replica's
  ``serving.guardrails.CircuitBreaker`` opens on failures or on slow
  answers and lets one half-open probe through after its cooldown.
  ``FaultPlan.fleet_replica_kill_at`` and ``fleet_router_restart_at``
  are the chaos coordinates.
- **Observability across processes**: the router mints the rid
  (``observability.requests.next_rid``) and the worker's scheduler
  adopts it (``submit(rid=...)``), so the router's ``RequestLog("fleet")``
  and its ``fleet_route`` events join the worker's log on the rid.
  :class:`FleetMetrics` renders the ``zk_fleet_*`` family and
  :meth:`FleetRouter.status` is the ``fleet`` section of ``/statusz``.

The transport is pluggable: the default POSTs JSON to a worker's
``/generate``; tests inject in-process transports.
"""

import json
import logging
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import (
    DEFAULT_MS_BUCKETS,
    MetricsRegistry,
)
from zookeeper_tpu_torch.observability.requests import RequestLog, next_rid
from zookeeper_tpu_torch.serving.batcher import WorkerCrashedError
from zookeeper_tpu_torch.serving.decode.prefix_key import PrefixIndex
from zookeeper_tpu_torch.serving.guardrails import CircuitBreaker

logger = logging.getLogger(__name__)

__all__ = [
    "FleetMetrics",
    "FleetResponse",
    "FleetRouter",
    "FleetUnavailableError",
    "ReplicaHandle",
]


class FleetUnavailableError(RuntimeError):
    """No healthy replica is left to route to (every worker dead or
    none configured) — the fleet-level analogue of a dead worker."""


class FleetResponse:
    """One routed generation: the worker's reply plus the routing
    decision that produced it (the per-request affinity audit trail)."""

    __slots__ = (
        "rid",
        "worker_id",
        "tokens",
        "ttft_ms",
        "shared_tokens",
        "finish_reason",
        "affinity_hit",
        "rerouted",
        "predicted_shared",
    )

    def __init__(
        self,
        *,
        rid: int,
        worker_id: str,
        tokens: np.ndarray,
        ttft_ms: Optional[float],
        shared_tokens: int,
        finish_reason: Optional[str],
        affinity_hit: bool,
        rerouted: bool,
        predicted_shared: int,
    ) -> None:
        self.rid = rid
        self.worker_id = worker_id
        self.tokens = tokens
        self.ttft_ms = ttft_ms
        self.shared_tokens = shared_tokens
        self.finish_reason = finish_reason
        self.affinity_hit = affinity_hit
        self.rerouted = rerouted
        self.predicted_shared = predicted_shared


class ReplicaHandle:
    """One worker the router fronts: its endpoints, liveness, the
    router-side load estimate, and its pageless prefix index."""

    def __init__(
        self,
        worker_id: str,
        generate_url: str,
        obs_url: Optional[str] = None,
        pid: Optional[int] = None,
    ) -> None:
        self.worker_id = str(worker_id)
        self.generate_url = generate_url
        self.obs_url = obs_url
        self.pid = pid
        self.healthy = True
        #: Router-side in-flight request count (the load term no
        #: scrape can race).
        self.outstanding = 0
        self.routed_total = 0
        self.index: Optional[PrefixIndex] = None  # attached by router
        #: Per-replica circuit breaker (attached by the router; None
        #: until then).
        self.breaker: Optional[CircuitBreaker] = None
        # Last /metrics scrape: (monotonic ts, queue_depth, free_pages).
        # Invalidated on every health-state TRANSITION so routing never
        # prefers a corpse (or a cold revival) on cached numbers.
        self._scrape: Optional[tuple] = None

    @classmethod
    def from_worker(cls, worker: Dict[str, Any]) -> "ReplicaHandle":
        """Build from a ``spawn_fleet_workers`` ready document."""
        return cls(
            worker["worker_id"],
            "http://127.0.0.1:%d/generate" % worker["generate_port"],
            obs_url="http://127.0.0.1:%d" % worker["metrics_port"],
            pid=worker.get("pid"),
        )


def _http_transport(
    replica: ReplicaHandle, payload: Dict[str, Any], timeout_s: float
) -> Dict[str, Any]:
    """Default transport: POST JSON to the worker's ``/generate``."""
    req = urllib.request.Request(
        replica.generate_url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def _http_health(replica: ReplicaHandle, timeout_s: float) -> bool:
    """Default health probe: the cheap ``/healthz`` liveness endpoint
    (constant body, no registry lock — the router pays nothing like
    the full ``/metrics`` exposition cost per probe)."""
    if replica.obs_url is None:
        return replica.healthy
    try:
        with urllib.request.urlopen(
            replica.obs_url + "/healthz", timeout=timeout_s
        ) as resp:
            return resp.status == 200
    except (urllib.error.URLError, OSError):
        return False


def _default_kill(replica: ReplicaHandle) -> None:
    """Chaos hook: SIGKILL the replica's OS process (a real process
    death, not a simulation)."""
    if replica.pid is None:
        raise RuntimeError(
            f"replica {replica.worker_id} has no pid to kill; inject a "
            "kill_replica hook for in-process transports."
        )
    os.kill(int(replica.pid), signal.SIGKILL)


class FleetMetrics:
    """The ``zk_fleet_*`` family on its own registry (attach it to an
    :class:`~zookeeper_tpu_torch.observability.export.ObservabilityServer`
    next to the default registry, like ``DecodeMetrics.registry``):
    per-replica routed / affinity-hit counters + health gauges,
    fleet-wide re-route / crash counters, a routing-decision latency
    histogram, and session/replica-count gauges."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self._routed: Dict[str, Any] = {}
        self._affinity: Dict[str, Any] = {}
        self._healthy: Dict[str, Any] = {}
        self._breaker: Dict[str, Any] = {}
        self._rerouted = self.registry.counter(
            "zk_fleet_rerouted_total",
            help="sessions re-routed cold off a dead replica",
        )
        self._crashes = self.registry.counter(
            "zk_fleet_worker_crashes_total",
            help="requests failed by a replica death mid-flight",
        )
        self._retries = self.registry.counter(
            "zk_fleet_retries_total",
            help="rid-preserving re-routes of requests that failed "
            "before their first token",
        )
        self._replicas = self.registry.gauge(
            "zk_fleet_replicas", help="configured replicas"
        )
        self._sessions = self.registry.gauge(
            "zk_fleet_sessions", help="live session pins"
        )
        self._route_ms = self.registry.histogram(
            "zk_fleet_route_ms",
            buckets=DEFAULT_MS_BUCKETS,
            help="routing-decision latency (choose + index update)",
        )
        # Exact-percentile window next to the fixed-bucket histogram
        # (the DecodeMetrics posture).
        self._route_samples: List[float] = []

    def _per_replica(self, table, name, help_, worker_id, cls="counter"):
        inst = table.get(worker_id)
        if inst is None:
            factory = (
                self.registry.counter
                if cls == "counter"
                else self.registry.gauge
            )
            inst = factory(name, help=help_, labels={"replica": worker_id})
            table[worker_id] = inst
        return inst

    def record_routed(
        self, worker_id: str, *, affinity_hit: bool, route_ms: float
    ) -> None:
        self._per_replica(
            self._routed,
            "zk_fleet_routed_total",
            "requests routed to this replica",
            worker_id,
        ).inc()
        if affinity_hit:
            self._per_replica(
                self._affinity,
                "zk_fleet_affinity_hits_total",
                "requests routed by warm-prefix affinity or session pin",
                worker_id,
            ).inc()
        self._route_ms.observe(float(route_ms))
        self._route_samples.append(float(route_ms))
        if len(self._route_samples) > 4096:
            del self._route_samples[:2048]

    def record_rerouted(self) -> None:
        self._rerouted.inc()

    def record_worker_crash(self) -> None:
        self._crashes.inc()

    def record_retry(self) -> None:
        self._retries.inc()

    def record_breaker_state(self, worker_id: str, code: float) -> None:
        """Per-replica breaker gauge: 0 closed, 0.5 half-open, 1 open."""
        self._per_replica(
            self._breaker,
            "zk_fleet_breaker_state",
            "circuit breaker state (0 closed, 0.5 half-open, 1 open)",
            worker_id,
            cls="gauge",
        ).set(float(code))

    def record_health(self, worker_id: str, healthy: bool) -> None:
        self._per_replica(
            self._healthy,
            "zk_fleet_replica_healthy",
            "1 = replica passed its last health probe",
            worker_id,
            cls="gauge",
        ).set(1.0 if healthy else 0.0)

    def set_replicas(self, n: int) -> None:
        self._replicas.set(float(n))

    def set_sessions(self, n: int) -> None:
        self._sessions.set(float(n))

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "fleet_rerouted_total": self._rerouted.value,
            "fleet_worker_crashes_total": self._crashes.value,
            "fleet_retries_total": self._retries.value,
        }
        for wid, inst in self._routed.items():
            out[f"fleet_routed_total_{wid}"] = inst.value
        for wid, inst in self._affinity.items():
            out[f"fleet_affinity_hits_total_{wid}"] = inst.value
        if self._route_samples:
            out["fleet_route_ms_p50"] = float(
                np.percentile(self._route_samples, 50)
            )
            out["fleet_route_ms_p99"] = float(
                np.percentile(self._route_samples, 99)
            )
        return out


class FleetRouter:
    """The front door (see module docstring). Thread-safe: routing
    state mutates under one lock; worker POSTs run outside it (the
    scheduler's dispatch-outside-the-lock discipline), so concurrent
    submitters only serialize on the DECISION, never on generation."""

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        *,
        page_size: int,
        policy: str = "affinity",
        state_path: Optional[str] = None,
        request_timeout_s: float = 120.0,
        health_timeout_s: float = 2.0,
        scrape_ttl_s: float = 1.0,
        metrics: Optional[FleetMetrics] = None,
        transport: Optional[Callable[..., Dict[str, Any]]] = None,
        health_probe: Optional[Callable[..., bool]] = None,
        kill_replica: Optional[Callable[[ReplicaHandle], None]] = None,
        max_retries: int = 0,
        retry_backoff_s: float = 0.05,
        breaker_failures: int = 3,
        breaker_latency_ms: float = 0.0,
        breaker_latency_window: int = 3,
        breaker_cooldown_s: float = 5.0,
        breaker_jitter_frac: float = 0.5,
        breaker_seed: int = 0,
        breaker_clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ) -> None:
        if policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"policy={policy!r}: expected 'affinity' or 'round_robin'."
            )
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica.")
        ids = [r.worker_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica worker_ids: {ids}")
        self.replicas: List[ReplicaHandle] = list(replicas)
        self.page_size = int(page_size)
        self.policy = policy
        self.state_path = state_path
        self.request_timeout_s = float(request_timeout_s)
        self.health_timeout_s = float(health_timeout_s)
        self.scrape_ttl_s = float(scrape_ttl_s)
        self.metrics = metrics if metrics is not None else FleetMetrics()
        self._transport = transport or _http_transport
        self._health_probe = health_probe or _http_health
        self._kill_replica_hook = kill_replica or _default_kill
        if max_retries < 0 or retry_backoff_s < 0:
            raise ValueError(
                f"max_retries={max_retries} and retry_backoff_s="
                f"{retry_backoff_s} must be >= 0."
            )
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._sleep = sleep or time.sleep
        self.request_log = RequestLog("fleet")
        self._lock = threading.RLock()
        self._by_id = {r.worker_id: r for r in self.replicas}
        for r in self.replicas:
            r.index = PrefixIndex(self.page_size)
            # One breaker per replica;
            # breaker_failures=0 + breaker_latency_ms=0 leaves it
            # permanently closed (trip conditions disabled).
            r.breaker = CircuitBreaker(
                key=r.worker_id,
                failure_threshold=breaker_failures,
                latency_threshold_ms=breaker_latency_ms,
                latency_window=breaker_latency_window,
                cooldown_s=breaker_cooldown_s,
                jitter_frac=breaker_jitter_frac,
                seed=breaker_seed,
                clock=breaker_clock,
            )
        #: session -> worker_id pins (the continuity contract).
        self._sessions: Dict[str, str] = {}
        self._rr_next = 0
        self.routed_total = 0
        self.affinity_hits_total = 0
        self.rerouted_total = 0
        self.retries_total = 0
        self._obs_server = None
        self._health_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()
        self.metrics.set_replicas(len(self.replicas))
        for r in self.replicas:
            self.metrics.record_health(r.worker_id, r.healthy)
        if state_path and os.path.exists(state_path):
            self._load_state()

    # -- session-pin persistence (router restart recovery) ---------------

    def _load_state(self) -> None:
        """Adopt the previous router's session pins (restart recovery:
        pinned sessions stay on their WARM replica; the prefix indexes
        rebuild lazily from subsequent traffic — until they rewarm,
        unpinned traffic routes by load, which is correct, just cold)."""
        try:
            with open(self.state_path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning(
                "fleet state %s unreadable (%s); starting with no "
                "session pins", self.state_path, e,
            )
            return
        restored = {
            str(sid): str(wid)
            for sid, wid in doc.get("sessions", {}).items()
            if str(wid) in self._by_id
        }
        self._sessions.update(restored)
        self.metrics.set_sessions(len(self._sessions))
        if restored:
            logger.info(
                "fleet router restored %d session pin(s) from %s",
                len(restored), self.state_path,
            )

    def _save_state(self) -> None:
        """Atomic write (tmp + rename) so a router killed mid-save
        leaves the previous pins readable, never a torn file."""
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"sessions": dict(self._sessions)}, f)
        os.replace(tmp, self.state_path)

    # -- health ----------------------------------------------------------

    def check_health(self) -> Dict[str, bool]:
        """Probe every replica's ``/healthz`` once; a replica that
        fails the probe goes unhealthy (its sessions re-route on their
        next turn). Returns ``{worker_id: healthy}``. Call it
        explicitly (deterministic tests) or from the background thread
        (:meth:`start_health_checks`)."""
        out = {}
        for r in self.replicas:
            ok = bool(self._health_probe(r, self.health_timeout_s))
            with self._lock:
                if r.healthy and not ok:
                    self._mark_dead(r)
                elif ok and not r.healthy:
                    # A replica that comes BACK (restarted worker) is
                    # cold: serve it again, predict nothing warm. The
                    # pre-death scrape snapshot and breaker history die
                    # with the old process — a revival must not be
                    # load-ranked (or tripped) on the corpse's numbers.
                    r.healthy = True
                    r.index.clear()
                    r._scrape = None
                    if r.breaker is not None:
                        r.breaker.reset()
                        self.metrics.record_breaker_state(
                            r.worker_id, r.breaker.state_code()
                        )
                    self.metrics.record_health(r.worker_id, True)
                    logger.info(
                        "fleet replica %s healthy again (cold)",
                        r.worker_id,
                    )
            out[r.worker_id] = ok
        return out

    def start_health_checks(self, interval_s: float = 1.0) -> None:
        """Run :meth:`check_health` on a daemon thread every
        ``interval_s`` seconds until :meth:`close`."""
        if self._health_thread is not None:
            return
        self._health_stop.clear()

        def loop():
            while not self._health_stop.wait(interval_s):
                try:
                    self.check_health()
                except Exception:  # probes must never kill the thread
                    logger.exception("fleet health check failed")

        t = threading.Thread(
            target=loop, name="zk-fleet-health", daemon=True
        )
        t.start()
        self._health_thread = t

    def _mark_dead(self, replica: ReplicaHandle) -> None:
        """Caller holds the lock. The replica's index drops (its
        process — and with it every cached page — is gone; a restarted
        one is cold) and its health gauge goes to 0. Session pins are
        NOT dropped here: each re-pins to a survivor on its next turn
        (counted as a re-route), so the metric reflects re-routes that
        actually happened."""
        replica.healthy = False
        replica.index.clear()
        # Drop the cached load scrape WITH the health transition: the
        # TTL would otherwise keep serving the corpse's (often
        # flattering: it stopped queueing when it died) queue-depth
        # snapshot to the load fallback for up to scrape_ttl_s.
        replica._scrape = None
        self.metrics.record_health(replica.worker_id, False)
        logger.warning("fleet replica %s marked dead", replica.worker_id)

    # -- load fallback ---------------------------------------------------

    def _scrape_load(self, replica: ReplicaHandle):
        """Worker-side load terms from its live ``/metrics`` registry
        (``zk_decode_queue_depth``, ``zk_kv_pool_free_pages``), cached
        for ``scrape_ttl_s`` so a routing burst costs one scrape, not
        one per request. Returns ``(queue_depth, free_pages)`` —
        ``(0.0, 0.0)`` when the replica exposes no endpoint or the
        scrape fails (the router-side ``outstanding`` count still
        differentiates load)."""
        now = time.monotonic()
        cached = replica._scrape
        if cached is not None and now - cached[0] < self.scrape_ttl_s:
            return cached[1], cached[2]
        queue_depth, free_pages = 0.0, 0.0
        if replica.obs_url is not None:
            try:
                with urllib.request.urlopen(
                    replica.obs_url + "/metrics",
                    timeout=self.health_timeout_s,
                ) as resp:
                    body = resp.read().decode()
                for line in body.splitlines():
                    if line.startswith("zk_decode_queue_depth "):
                        queue_depth = float(line.split()[-1])
                    elif line.startswith("zk_kv_pool_free_pages "):
                        free_pages = float(line.split()[-1])
            except (urllib.error.URLError, OSError, ValueError):
                pass
        replica._scrape = (now, queue_depth, free_pages)
        return queue_depth, free_pages

    def _load_key(self, replica: ReplicaHandle):
        """Sort key for the load fallback: fewest in-flight + queued
        requests first; ties break toward the most free KV pages (the
        replica with headroom absorbs the next long prompt)."""
        queue_depth, free_pages = self._scrape_load(replica)
        return (replica.outstanding + queue_depth, -free_pages)

    # -- routing ---------------------------------------------------------

    def _route(self, tokens, session: Optional[str]):
        """The routing decision (caller holds no lock; takes it).
        Returns ``(replica, affinity_hit, rerouted, predicted)``."""
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            if not healthy:
                raise FleetUnavailableError(
                    f"no healthy replica left out of "
                    f"{len(self.replicas)} — every worker is dead."
                )
            chosen: Optional[ReplicaHandle] = None
            affinity_hit = False
            rerouted = False
            predicted = 0
            if session is not None and session in self._sessions:
                pinned = self._by_id.get(self._sessions[session])
                pin_ok = (
                    pinned is not None
                    and pinned.healthy
                    and (
                        pinned.breaker is None
                        or pinned.breaker.state
                        == CircuitBreaker.CLOSED
                        # An open-but-due pinned replica may serve its
                        # own probe: session continuity IS the cheapest
                        # probe traffic we have.
                        or pinned.breaker.try_probe()
                    )
                )
                if pin_ok:
                    # Session continuity: the pin IS the affinity —
                    # turn-2+ re-enters this replica's radix cache.
                    chosen = pinned
                    affinity_hit = True
                    predicted = pinned.index.predict(tokens)
                else:
                    # The pinned replica died (or its breaker opened):
                    # this turn re-routes COLD to a survivor and
                    # re-pins there.
                    rerouted = True
                    self.rerouted_total += 1
                    self.metrics.record_rerouted()
            if chosen is None:
                # Half-open probes take absolute priority: exactly one
                # request per cooldown tests a tripped replica, so it
                # must not starve behind closed-breaker candidates.
                chosen = next(
                    (
                        r
                        for r in healthy
                        if r.breaker is not None and r.breaker.try_probe()
                    ),
                    None,
                )
            if chosen is None:
                candidates = [
                    r
                    for r in healthy
                    if r.breaker is None
                    or r.breaker.state == CircuitBreaker.CLOSED
                ]
                if not candidates:
                    raise FleetUnavailableError(
                        f"all {len(healthy)} healthy replicas have open "
                        "circuit breakers — backing off until a "
                        "half-open probe succeeds."
                    )
                if self.policy == "round_robin":
                    chosen = candidates[self._rr_next % len(candidates)]
                    self._rr_next += 1
                else:
                    scored = [
                        (r.index.predict(tokens), r) for r in candidates
                    ]
                    best = max(p for p, _ in scored)
                    if best > 0:
                        # Warm-prefix affinity: the replica predicted
                        # to hold the most of this prompt resident.
                        chosen = max(
                            scored,
                            key=lambda pr: (
                                pr[0],
                                # Ties route by load, cheapest first.
                                tuple(-x for x in self._load_key(pr[1])),
                            ),
                        )[1]
                        affinity_hit = True
                        predicted = best
                    else:
                        # Nobody is warm: pure load fallback.
                        chosen = min(candidates, key=self._load_key)
            if session is not None:
                if self._sessions.get(session) != chosen.worker_id:
                    self._sessions[session] = chosen.worker_id
                    self._save_state()
                self.metrics.set_sessions(len(self._sessions))
            # Predict the replica's FUTURE warm state: the worker
            # inserts this prompt's pages into its radix cache after
            # prefill, so the index observes exactly that.
            chosen.index.observe(tokens)
            chosen.routed_total += 1
            self.routed_total += 1
            if affinity_hit:
                self.affinity_hits_total += 1
            for r in self.replicas:
                if r.breaker is not None:
                    self.metrics.record_breaker_state(
                        r.worker_id, r.breaker.state_code()
                    )
            return chosen, affinity_hit, rerouted, predicted

    def submit(
        self,
        tokens: Any,
        *,
        session: Optional[str] = None,
        max_new_tokens: int = 16,
        rid: Optional[int] = None,
    ) -> FleetResponse:
        """Route one prompt and block for its generation. ``session``
        pins multi-turn conversations to one replica; ``rid`` defaults
        to a freshly-minted router id the WORKER adopts (one id across
        both processes). Raises :class:`WorkerCrashedError` when the
        chosen replica dies mid-request (the caller may resubmit — the
        dead replica is already unhealthy, so the retry re-routes) and
        :class:`FleetUnavailableError` when nobody is left."""
        from zookeeper_tpu_torch.resilience import faults

        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or tokens.shape[0] < 1:
            raise ValueError(
                f"prompt must be a non-empty 1-D int token array, got "
                f"shape {tokens.shape}."
            )
        rid = next_rid() if rid is None else int(rid)
        t_submit_ns = time.perf_counter_ns()
        token_list = [int(x) for x in tokens.tolist()]
        retries = 0
        while True:
            t0 = time.perf_counter()
            chosen, affinity_hit, rerouted, predicted = self._route(
                token_list, session
            )
            route_ms = (time.perf_counter() - t0) * 1e3
            self.metrics.record_routed(
                chosen.worker_id,
                affinity_hit=affinity_hit,
                route_ms=route_ms,
            )
            if _trace.enabled():
                _trace.event(
                    "fleet_route",
                    rid=rid,
                    attrs={
                        "replica": chosen.worker_id,
                        "affinity_hit": affinity_hit,
                        "rerouted": rerouted,
                        "predicted_shared": predicted,
                        "session": session or "",
                        "attempt": retries,
                    },
                )
            plan = faults.active()
            if plan is not None and plan.take_fleet_replica_kill():
                # The chaos coordinate: the chosen
                # replica dies NOW — the forward below finds a dead
                # worker, exactly the mid-request death the contract
                # covers.
                self._kill_replica_hook(chosen)
            with self._lock:
                chosen.outstanding += 1
            t_fwd = time.perf_counter()
            try:
                payload = {
                    "tokens": token_list,
                    "max_new_tokens": int(max_new_tokens),
                    "rid": rid,
                    "session": session,
                }
                body = self._transport(
                    chosen, payload, self.request_timeout_s
                )
            except (urllib.error.URLError, OSError, ConnectionError) as e:
                with self._lock:
                    if chosen.breaker is not None:
                        chosen.breaker.record_failure()
                        self.metrics.record_breaker_state(
                            chosen.worker_id,
                            chosen.breaker.state_code(),
                        )
                    if chosen.healthy:
                        self._mark_dead(chosen)
                self.metrics.record_worker_crash()
                if retries < self.max_retries:
                    # Rid-preserving re-route. Safe at-most-once: this
                    # transport is blocking and non-streaming, so a
                    # connection-level failure means ZERO tokens
                    # reached the caller — nothing was delivered that
                    # a second attempt could duplicate.
                    retries += 1
                    self.retries_total += 1
                    self.metrics.record_retry()
                    if _trace.enabled():
                        _trace.event(
                            "fleet_retry",
                            rid=rid,
                            attrs={
                                "failed_replica": chosen.worker_id,
                                "attempt": retries,
                            },
                        )
                    logger.warning(
                        "fleet rid=%d attempt %d failed on %s — "
                        "retrying (%d/%d)",
                        rid,
                        retries,
                        chosen.worker_id,
                        retries,
                        self.max_retries,
                    )
                    self._sleep(
                        self.retry_backoff_s * (2 ** (retries - 1))
                    )
                    continue
                detail = f"WorkerCrashedError replica={chosen.worker_id}"
                if retries:
                    detail += f" retried={retries}"
                self.request_log.append(
                    rid,
                    "crashed",
                    enqueue_ns=t_submit_ns,
                    complete_ns=time.perf_counter_ns(),
                    detail=detail,
                    role="router",
                )
                raise WorkerCrashedError(
                    f"fleet replica {chosen.worker_id} died mid-request "
                    f"(rid={rid}, retried={retries}): {e}; the replica "
                    "is unhealthy — resubmit to re-route to a survivor."
                ) from e
            finally:
                with self._lock:
                    chosen.outstanding -= 1
            fwd_ms = (time.perf_counter() - t_fwd) * 1e3
            with self._lock:
                if chosen.breaker is not None:
                    # Worker-side error bodies also count as success
                    # here: the replica answered promptly — its
                    # failure is deterministic (bad request), not a
                    # replica-health signal.
                    chosen.breaker.record_success(fwd_ms)
                    self.metrics.record_breaker_state(
                        chosen.worker_id, chosen.breaker.state_code()
                    )
            break
        if "error" in body:
            self.request_log.append(
                rid,
                "error",
                enqueue_ns=t_submit_ns,
                complete_ns=time.perf_counter_ns(),
                detail=f"{body.get('type', 'error')} "
                f"replica={chosen.worker_id}",
                role="router",
            )
            raise RuntimeError(
                f"fleet replica {chosen.worker_id} failed rid={rid}: "
                f"{body.get('type', 'error')}: {body['error']}"
            )
        out = np.asarray(body["tokens"], np.int32)
        self.request_log.append(
            rid,
            "ok",
            enqueue_ns=t_submit_ns,
            complete_ns=time.perf_counter_ns(),
            tokens=int(out.shape[0]),
            detail=(
                f"replica={chosen.worker_id} "
                f"shared={int(body.get('shared_tokens', 0))} "
                f"predicted={predicted}"
                + (f" retried={retries}" if retries else "")
            ),
            role="router",
        )
        return FleetResponse(
            rid=rid,
            worker_id=chosen.worker_id,
            tokens=out,
            ttft_ms=body.get("ttft_ms"),
            shared_tokens=int(body.get("shared_tokens", 0)),
            finish_reason=body.get("finish_reason"),
            affinity_hit=affinity_hit,
            rerouted=rerouted,
            predicted_shared=predicted,
        )

    # -- observability ---------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``/statusz`` fleet section: policy, per-replica health/
        load/affinity state, session pins, routing totals."""
        with self._lock:
            return {
                "policy": self.policy,
                "replicas": [
                    {
                        "worker_id": r.worker_id,
                        "healthy": r.healthy,
                        "outstanding": r.outstanding,
                        "routed_total": r.routed_total,
                        "index_nodes": r.index.nodes if r.index else 0,
                        "generate_url": r.generate_url,
                        "breaker": (
                            r.breaker.status()
                            if r.breaker is not None
                            else None
                        ),
                    }
                    for r in self.replicas
                ],
                "healthy_replicas": sum(
                    1 for r in self.replicas if r.healthy
                ),
                "sessions": len(self._sessions),
                "routed_total": self.routed_total,
                "affinity_hits_total": self.affinity_hits_total,
                "rerouted_total": self.rerouted_total,
                "retries_total": self.retries_total,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "state_path": self.state_path,
            }

    def session_pin(self, session: str) -> Optional[str]:
        """The replica ``session`` is pinned to (None = unpinned)."""
        with self._lock:
            return self._sessions.get(str(session))

    def start_observability(self, port: int = 0):
        """Serve the router's own ``/metrics`` (``zk_fleet_*``) +
        ``/statusz`` (fleet + requests sections) + ``/healthz``."""
        from zookeeper_tpu_torch.observability import ObservabilityServer
        from zookeeper_tpu_torch.observability.registry import default_registry

        server = ObservabilityServer(
            [default_registry(), self.metrics.registry],
            port=port,
            status_providers={
                "fleet": self.status,
                "requests": self.request_log.as_status,
            },
        )
        server.start()
        self._obs_server = server
        return server

    @property
    def obs_server(self):
        return self._obs_server

    def close(self) -> None:
        """Stop the health thread and the observability endpoint (the
        workers are NOT stopped — their lifecycle belongs to whoever
        spawned them)."""
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        if self._obs_server is not None:
            self._obs_server.stop()
            self._obs_server = None
