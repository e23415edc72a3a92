"""Anomaly-triggered flight recorder: dump the evidence while it exists.

The live endpoints (``/metrics``, ``/statusz``, ``/trace``) answer
questions an operator is asking RIGHT NOW; an anomaly at 3am is
forensically dead by the time anyone scrapes — the trace ring has
evicted the bad request's spans and the gauges have moved on. The
``FlightRecorder`` closes that gap: trigger sources fire
:func:`notify` the moment something goes wrong —

- ``StepTimeWatchdog`` anomalies (the serving dispatch watchdog, the
  training loop's ``train_step`` and ``train_dispatch`` streams),
- ``recompile_detected`` (both serving engines: a program first run
  after ``warmup()``),
- ``worker_crash`` / ``decode_worker_crash`` (batcher + scheduler
  crash cleanup),
- ``nan_halt`` (``nan_policy="halt"`` at its readback),
  ``fault_injected`` (a ``FaultPlan`` training leg that fired),
  ``supervisor_restart`` and ``group_restart`` (``run_with_recovery``),
- manual ``POST /debugz`` (``ObservabilityServer``),

— and the recorder writes a self-contained BUNDLE directory joining
every observability layer into one artifact:

- ``trace.json`` — the trace ring as Chrome trace-event JSON, read via
  the non-destructive ``Tracer.snapshot()`` (``drain()`` stays reserved
  for the final teardown export; a bundle must never steal records
  from a concurrent ``/trace`` scrape),
- ``metrics.prom`` — full Prometheus text exposition of the attached
  registries,
- ``programs.json`` — the program ledger's table,
- ``statusz.json`` — every ``/statusz`` section the service exposes,
- ``requestlog.json`` — the per-service ``RequestLog`` tails (the rid
  of the request that crashed IS in here, correlating with its flow
  events in ``trace.json``),
- ``manifest.json`` — the trigger record (kind/step/attrs), the
  injected wall-clock source's timestamp (no traced code reads the
  wall clock — the ``clock`` parameter is the one source), and build
  provenance (:func:`build_metadata`: the checkout's git commit, the
  torch and CUDA versions, the card).

Discipline: triggers are RATE-LIMITED (default >= 30 s between
bundles; a crash loop must not fill the disk) and retention is BOUNDED
(keep the last ``keep`` bundles, oldest deleted). Trigger call sites
sit on crash/alert paths, so ``trigger()`` never raises and, by
default, hands the write to a ``zk-flight-recorder`` daemon thread —
a worker-crash handler holding its scheduler lock is never stalled by
disk IO. ``synchronous=True`` (tests, and the ``/debugz`` manual
trigger) writes inline and returns the bundle path.

With no recorder installed, every :func:`notify` call site costs ONE
module-global read — the same zero-cost-until-opted-in contract as
``trace``.
"""

import json
import logging
import os
import re
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.export import render_prometheus
from zookeeper_tpu_torch.observability.registry import default_registry

__all__ = [
    "FlightRecorder",
    "arm",
    "build_metadata",
    "disarm",
    "get_recorder",
    "install",
    "notify",
    "uninstall",
]

logger = logging.getLogger(__name__)

#: Bundle directory name: ``bundle-<seq>-<kind>`` — seq zero-padded so
#: lexicographic order IS trigger order (retention walks it).
_BUNDLE_RE = re.compile(r"^bundle-(\d{6})-")
_KIND_SAFE = re.compile(r"[^a-zA-Z0-9_.-]")


def _git_commit(root: str) -> Optional[str]:
    """The checkout's commit, read from ``.git`` without running git (a
    bundle is written on crash paths): None outside a git checkout."""
    try:
        with open(os.path.join(root, ".git", "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref: "):
            return head or None
        ref = head[5:]
        path = os.path.join(root, ".git", ref)
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip() or None
        with open(os.path.join(root, ".git", "packed-refs")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and parts[1] == ref:
                    return parts[0]
    except OSError:
        return None
    return None


def build_metadata() -> Dict[str, Any]:
    """Which build wrote a bundle: the checkout's git commit (None
    outside git), the Python, torch and CUDA versions and the visible
    cards' names. Reads no device state (no synchronisation)."""
    import platform

    import torch

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cards = (
        [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if torch.cuda.is_available()
        else []
    )
    return {
        "git_commit": _git_commit(root),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": cards,
    }


class FlightRecorder:
    """Writes rate-limited, bounded-retention debug bundles (see module
    docstring).

    ``registries`` render into ``metrics.prom``; ``status_providers``
    (section name -> zero-arg callable) build ``statusz.json``;
    ``request_logs`` (name -> :class:`RequestLog`) dump their tails.
    ``clock`` is THE wall-clock source (injected — traced code never
    reads wall time itself); rate limiting uses the monotonic clock.
    """

    def __init__(
        self,
        directory: str,
        *,
        registries: Sequence[Any] = (),
        status_providers: Optional[Mapping[str, Callable[[], Any]]] = None,
        request_logs: Optional[Mapping[str, Any]] = None,
        min_interval_s: float = 30.0,
        keep: int = 8,
        synchronous: bool = False,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if min_interval_s < 0:
            raise ValueError(
                f"min_interval_s={min_interval_s} must be >= 0 (0 "
                "disables rate limiting)."
            )
        if keep < 1:
            raise ValueError(f"keep={keep} must be >= 1.")
        self.directory = str(directory)
        self.min_interval_s = float(min_interval_s)
        self.keep = int(keep)
        self.synchronous = bool(synchronous)
        self._clock = clock
        self._registries = list(registries)
        self._providers: Dict[str, Callable[[], Any]] = dict(
            status_providers or {}
        )
        self._request_logs: Dict[str, Any] = dict(request_logs or {})
        self._lock = threading.Lock()
        self._last_mono: Optional[float] = None
        # Seed the sequence from what is already on disk: a restarted
        # process (the crash-loop case this recorder exists for) must
        # extend the bundle series, not overwrite bundle-000001 — and
        # a fresh low seq sorting lexicographically oldest would have
        # _gc() delete the bundle it just wrote.
        self._seq = self._max_seq_on_disk()
        self._last_bundle: Optional[str] = None
        self._written = 0
        self._suppressed = 0
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._inflight = False
        self._stop = threading.Event()

    # -- wiring (services attach their sections after construction) ------

    def add_status_provider(
        self, name: str, provider: Callable[[], Any]
    ) -> None:
        self._providers[str(name)] = provider

    def add_request_log(self, name: str, log: Any) -> None:
        self._request_logs[str(name)] = log

    def add_registry(self, registry: Any) -> None:
        self._registries.append(registry)

    # -- introspection ---------------------------------------------------

    @property
    def last_bundle(self) -> Optional[str]:
        """Path of the newest bundle written by THIS recorder."""
        return self._last_bundle

    @property
    def bundles_written(self) -> int:
        return self._written

    @property
    def bundles_suppressed(self) -> int:
        """Triggers swallowed by the rate limiter."""
        return self._suppressed

    def _max_seq_on_disk(self) -> int:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        seqs = [
            int(m.group(1))
            for m in (_BUNDLE_RE.match(n) for n in names)
            if m is not None
        ]
        return max(seqs, default=0)

    def bundles(self) -> List[str]:
        """Bundle directories on disk, oldest first."""
        try:
            names = sorted(
                n
                for n in os.listdir(self.directory)
                if _BUNDLE_RE.match(n)
            )
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    # -- triggering ------------------------------------------------------

    def trigger(
        self,
        kind: str,
        *,
        step: Optional[int] = None,
        attrs: Optional[Mapping[str, Any]] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Request one bundle for trigger ``kind``. Never raises (the
        call sites are crash/alert paths). Rate-limited unless
        ``force`` (the manual ``/debugz`` trigger). Returns the bundle
        path when written inline (``synchronous=True`` or ``force``),
        else None — the ``zk-flight-recorder`` thread writes it."""
        try:
            with self._lock:
                now = time.monotonic()
                if (
                    not force
                    and self._last_mono is not None
                    and self.min_interval_s > 0
                    and now - self._last_mono < self.min_interval_s
                ):
                    self._suppressed += 1
                    self._count("zk_flight_bundles_suppressed_total")
                    return None
                if not force:
                    # A forced (manual) bundle bypasses the limiter but
                    # must not ARM it: a /debugz poke right before a
                    # crash must not suppress the crash's bundle.
                    self._last_mono = now
                self._seq += 1
                seq = self._seq
            context = (seq, str(kind), step, dict(attrs or {}), self._clock())
            if self.synchronous or force:
                return self._write_guarded(context)
            with self._cv:
                self._queue.append(context)
                self._ensure_worker()
                self._cv.notify_all()
            return None
        except Exception:
            logger.warning("flight-recorder trigger failed", exc_info=True)
            return None

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until queued bundles are written (the deterministic
        wait the CI smoke and tests use). True = drained in time."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(0.05, remaining))
        return True

    def close(self) -> None:
        """Drain pending writes (best effort) and stop the writer
        thread. Safe to call repeatedly."""
        self.flush(timeout=5.0)
        self._stop.set()
        worker = self._worker
        if worker is not None:
            with self._cv:
                self._cv.notify_all()
            worker.join(timeout=5)
            self._worker = None
        self._stop.clear()

    # -- the writer ------------------------------------------------------

    def _ensure_worker(self) -> None:
        # Caller holds _cv.
        worker = self._worker
        if worker is None or not worker.is_alive():
            thread = threading.Thread(
                target=self._worker_loop,
                name="zk-flight-recorder",
                daemon=True,
            )
            self._worker = thread
            thread.start()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(0.1)
                if self._stop.is_set() and not self._queue:
                    return
                context = self._queue.popleft()
                self._inflight = True
            try:
                self._write_guarded(context)
            finally:
                with self._cv:
                    self._inflight = False
                    self._cv.notify_all()

    def _write_guarded(self, context) -> Optional[str]:
        try:
            return self._write_bundle(*context)
        except Exception:
            logger.warning(
                "flight-recorder bundle write failed", exc_info=True
            )
            return None

    def _count(self, name: str, labels: Optional[Dict[str, str]] = None):
        try:
            default_registry().counter(
                name,
                help="flight-recorder bundle accounting",
                labels=labels,
            ).inc()
        except Exception:  # a registry conflict must not kill a trigger
            pass

    def _write_bundle(
        self,
        seq: int,
        kind: str,
        step: Optional[int],
        attrs: Dict[str, Any],
        t_wall: float,
    ) -> str:
        t0 = time.perf_counter()
        safe_kind = _KIND_SAFE.sub("_", kind) or "trigger"
        bundle_dir = os.path.join(
            self.directory, f"bundle-{seq:06d}-{safe_kind}"
        )
        os.makedirs(bundle_dir, exist_ok=True)

        def dump(name: str, payload: Any) -> str:
            path = os.path.join(bundle_dir, name)
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
            return name

        files: List[str] = []
        # Trace ring: snapshot-based (never drain — a concurrent /trace
        # scrape and the teardown export must see the same records).
        files.append(dump("trace.json", _trace.to_chrome_trace()))
        prom_path = os.path.join(bundle_dir, "metrics.prom")
        with open(prom_path, "w") as f:
            f.write(
                render_prometheus(self._registries)
                if self._registries
                else ""
            )
        files.append("metrics.prom")
        try:
            from zookeeper_tpu_torch.observability.ledger import default_ledger

            programs = default_ledger().as_status()
        except Exception as e:
            programs = {"error": repr(e)}
        files.append(dump("programs.json", programs))
        statusz: Dict[str, Any] = {
            "pid": os.getpid(),
            "threads": sorted(t.name for t in threading.enumerate()),
            "metrics": {},
        }
        for registry in self._registries:
            try:
                statusz["metrics"].update(registry.as_flat_dict())
            except Exception as e:
                statusz["metrics"][f"error:{id(registry)}"] = repr(e)
        for name, provider in self._providers.items():
            try:
                statusz[name] = provider()
            except Exception as e:  # one broken section, not no bundle
                statusz[name] = {"error": repr(e)}
        files.append(dump("statusz.json", statusz))
        files.append(
            dump(
                "requestlog.json",
                {
                    name: log.as_status(tail=256)
                    for name, log in self._request_logs.items()
                },
            )
        )
        # Provenance: which build wrote this (best effort — metadata
        # must never be the reason a bundle dies).
        try:
            metadata = build_metadata()
        except Exception as e:
            metadata = {"error": repr(e)}
        manifest = {
            "bundle_format": 1,
            "seq": seq,
            "trigger": {"kind": kind, "step": step, "attrs": attrs},
            "time_unix": t_wall,
            "write_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "metadata": metadata,
            "files": files,
        }
        # Manifest last: its presence marks the bundle complete (the
        # same finalize-ordering idea as the checkpoint protocol).
        dump("manifest.json", manifest)
        self._last_bundle = bundle_dir
        self._written += 1
        self._count("zk_flight_bundles_total", labels={"trigger": kind})
        self._gc()
        logger.warning(
            "flight recorder: bundle %s written (trigger=%s%s)",
            bundle_dir,
            kind,
            f", step={step}" if step is not None else "",
        )
        return bundle_dir

    def _gc(self) -> None:
        """Bounded retention: drop the oldest bundles beyond ``keep``."""
        bundles = self.bundles()
        for path in bundles[: max(0, len(bundles) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)


#: The process-global recorder; None = no recorder (the single flag
#: every trigger site reads).
_RECORDER: Optional[FlightRecorder] = None


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process's flight recorder (replacing any
    prior one). Returns it for chaining."""
    global _RECORDER
    _RECORDER = recorder
    return recorder


def uninstall(recorder: Optional[FlightRecorder] = None) -> None:
    """Remove the global recorder. With ``recorder`` given, remove it
    only if it is still the installed one (a service tearing down must
    not evict a replacement another service already installed)."""
    global _RECORDER
    if recorder is None or _RECORDER is recorder:
        _RECORDER = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def notify(
    kind: str,
    step: Optional[int] = None,
    attrs: Optional[Mapping[str, Any]] = None,
) -> None:
    """Fire a trigger at the installed recorder, if any. ONE global
    read when none is installed — the hook the trigger sources (fault
    injections, crash handlers, the watchdog, the supervisor) call
    unconditionally."""
    recorder = _RECORDER
    if recorder is not None:
        recorder.trigger(kind, step=step, attrs=attrs)


def arm(
    directory: str,
    *,
    registries: Sequence[Any] = (),
    status_providers: Optional[Mapping[str, Callable[[], Any]]] = None,
    request_logs: Optional[Mapping[str, Any]] = None,
    min_interval_s: float = 30.0,
    synchronous: bool = True,
) -> FlightRecorder:
    """Build-and-install in one step — the shared wiring the service
    configs and ``TrainingExperiment`` use, so the construction/install
    sequence cannot fork across them. Synchronous by default: a
    config-armed recorder's triggers are rare and the bundle should
    exist the moment the trigger returns (tests and the CI smoke rely
    on it)."""
    return install(
        FlightRecorder(
            directory,
            registries=registries,
            status_providers=status_providers,
            request_logs=request_logs,
            min_interval_s=min_interval_s,
            synchronous=synchronous,
        )
    )


def disarm(recorder: Optional[FlightRecorder]) -> None:
    """Teardown counterpart of :func:`arm`: evict the global slot only
    if ``recorder`` still owns it, then close its writer."""
    if recorder is not None:
        uninstall(recorder)
        recorder.close()
