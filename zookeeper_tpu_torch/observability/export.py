"""Live export: Prometheus text rendering + a stdlib HTTP endpoint.

The registry (``observability.registry``) holds the numbers; this
module makes them scrapeable from a RUNNING process — the capability
the serving/training stack lacked (metrics previously existed only as
end-of-run JSON lines and TensorBoard files). Two pieces:

- :func:`render_prometheus` — text exposition format 0.0.4 (the format
  every Prometheus-compatible scraper speaks): ``# HELP``/``# TYPE``
  headers, counter/gauge samples, histogram ``_bucket{le=...}`` +
  ``_sum`` + ``_count`` series.
- :class:`ObservabilityServer` — a ``ThreadingHTTPServer`` on a daemon
  thread (``zk-obs-http``) serving:

  - ``/metrics`` — every instrument of every attached registry.
  - ``/statusz`` — one JSON object: uptime, pid, live thread names,
    trace state, the flat scalar view of the registries, plus any
    caller-provided status sections (engine compile counts, queue
    rows, ...).
  - ``/trace`` — the current host-span ring as Chrome trace-event JSON
    (save the response, open in Perfetto) when tracing is enabled.
    Reads through ``Tracer.snapshot()`` (non-destructive): concurrent
    scrapes, flight-recorder bundles and the teardown export all see
    the same ring — ``drain()`` stays reserved for the final teardown.
  - ``POST /debugz`` — the manual flight-recorder trigger: when a
    ``FlightRecorder`` is installed (``observability.recorder``),
    writes one bundle inline (rate limit bypassed — a human asked) and
    returns its path; 503 when none is installed.

Stdlib only, opt-in, and off the hot path by construction: scrapes
read instrument values under their per-instrument locks; recorders
never wait on HTTP. ``port=0`` binds an ephemeral port (tests/CI read
``server.port`` after ``start()``).
"""

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence

from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import (
    Histogram,
    MetricsRegistry,
)

__all__ = ["ObservabilityServer", "render_prometheus"]

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_BAD_CHARS.sub("_", name)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [
        _sanitize(k) + '="' + _escape_label_value(str(v)) + '"'
        for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(
    registries: Sequence[MetricsRegistry],
) -> str:
    """Render every instrument of ``registries`` in Prometheus text
    exposition format 0.0.4. Names are sanitized to the metric-name
    charset. Label variants of one metric name (e.g. a gauge
    registered per split) are grouped under a SINGLE ``# HELP``/``#
    TYPE`` header with their samples contiguous — the parser rejects a
    second TYPE line for a name, which would fail the whole scrape."""
    groups: Dict[str, List[Any]] = {}
    for registry in registries:
        for inst in registry.collect():
            groups.setdefault(_sanitize(inst.name), []).append(inst)
    lines: List[str] = []
    for name, insts in groups.items():
        head = insts[0]
        if head.help:
            lines.append(f"# HELP {name} {head.help}")
        lines.append(f"# TYPE {name} {head.kind}")
        for inst in insts:
            if isinstance(inst, Histogram):
                # One locked read: +Inf bucket, _sum and _count must be
                # mutually consistent or the exposition is spec-invalid.
                cumulative, count, total = inst.collect_state()
                for bound, c in zip(inst.buckets, cumulative):
                    le = 'le="' + _fmt(bound) + '"'
                    lines.append(
                        f"{name}_bucket{_label_str(inst.labels, le)} {c}"
                    )
                le_inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_label_str(inst.labels, le_inf)} "
                    f"{count}"
                )
                lines.append(
                    f"{name}_sum{_label_str(inst.labels)} {_fmt(total)}"
                )
                lines.append(
                    f"{name}_count{_label_str(inst.labels)} {count}"
                )
            else:
                lines.append(
                    f"{name}{_label_str(inst.labels)} {_fmt(inst.value)}"
                )
    return "\n".join(lines) + "\n"


class ObservabilityServer:
    """``/metrics`` + ``/statusz`` (+ ``/trace``) over stdlib HTTP.

    ``registries`` are rendered in order; ``status_providers`` is a
    mapping of section name -> zero-arg callable returning a
    JSON-serializable dict, merged into ``/statusz`` (a provider that
    raises contributes its error string instead of killing the scrape).
    """

    def __init__(
        self,
        registries: Sequence[MetricsRegistry],
        port: int = 0,
        host: str = "127.0.0.1",
        status_providers: Optional[
            Dict[str, Callable[[], Dict[str, Any]]]
        ] = None,
    ) -> None:
        self._registries = list(registries)
        self._requested_port = int(port)
        self._host = host
        self._providers = dict(status_providers or {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.time()

    @property
    def port(self) -> Optional[int]:
        """The bound port (reads back the ephemeral port under
        ``port=0``); None before ``start()``."""
        return (
            self._httpd.server_address[1]
            if self._httpd is not None
            else None
        )

    @property
    def url(self) -> Optional[str]:
        return (
            f"http://{self._host}:{self.port}"
            if self._httpd is not None
            else None
        )

    def add_status_provider(
        self, name: str, provider: Callable[[], Dict[str, Any]]
    ) -> None:
        self._providers[name] = provider

    def render_metrics(self) -> str:
        return render_prometheus(self._registries)

    def render_statusz(self) -> Dict[str, Any]:
        import os

        # One tracer read: a concurrent disable() between an enabled()
        # check and a len(get_tracer()) would be a None deref mid-scrape.
        tracer = _trace.get_tracer()
        status: Dict[str, Any] = {
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self._t_start, 3),
            "threads": sorted(t.name for t in threading.enumerate()),
            "trace_enabled": tracer is not None,
            "trace_spans_buffered": len(tracer) if tracer is not None else 0,
            "metrics": {},
        }
        # Flight-recorder vitals: is the capture mechanism armed, and
        # where did the last bundle land.
        try:
            from zookeeper_tpu_torch.observability import recorder as _recorder

            rec = _recorder.get_recorder()
            status["flight_recorder"] = (
                {
                    "installed": True,
                    "directory": rec.directory,
                    "bundles_written": rec.bundles_written,
                    "bundles_suppressed": rec.bundles_suppressed,
                    "last_bundle": rec.last_bundle,
                }
                if rec is not None
                else {"installed": False}
            )
        except Exception as e:  # a recorder bug must not 500 /statusz
            status["flight_recorder"] = {"error": repr(e)}
        for registry in self._registries:
            status["metrics"].update(registry.as_flat_dict())
        # The program ledger renders on EVERY statusz: which programs
        # were warmed, their counted FLOPs/bytes, and what their first
        # run cost — the device-side complement of the metric view.
        # Import is local (export must stay importable even if the
        # ledger module grows heavier deps).
        try:
            from zookeeper_tpu_torch.observability.ledger import default_ledger

            status["programs"] = default_ledger().as_status()
        except Exception as e:  # a ledger bug must not 500 /statusz
            status["programs"] = {"error": repr(e)}
        for name, provider in self._providers.items():
            try:
                status[name] = provider()
            except Exception as e:  # a broken provider must not 500 /statusz
                status[name] = {"error": repr(e)}
        return status

    def start(self) -> "ObservabilityServer":
        if self._thread is not None and self._thread.is_alive():
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr
                pass

            def _send(self, code, content_type, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            "text/plain; version=0.0.4; charset=utf-8",
                            server.render_metrics().encode(),
                        )
                    elif path == "/statusz":
                        self._send(
                            200,
                            "application/json",
                            json.dumps(server.render_statusz()).encode(),
                        )
                    elif path == "/trace":
                        doc = _trace.to_chrome_trace()
                        self._send(
                            200, "application/json", json.dumps(doc).encode()
                        )
                    elif path in ("/", "/healthz"):
                        self._send(200, "text/plain", b"ok\n")
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except BrokenPipeError:  # scraper hung up mid-response
                    pass

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/debugz":
                        from zookeeper_tpu_torch.observability import (
                            recorder as _recorder,
                        )

                        rec = _recorder.get_recorder()
                        if rec is None:
                            self._send(
                                503,
                                "application/json",
                                json.dumps(
                                    {
                                        "error": "no flight recorder "
                                        "installed (set "
                                        "flight_recorder_dir=)"
                                    }
                                ).encode(),
                            )
                            return
                        # force=True: a human asked — bypass the rate
                        # limit and write inline so the response can
                        # carry the bundle path.
                        bundle = rec.trigger(
                            "manual",
                            attrs={"source": "POST /debugz"},
                            force=True,
                        )
                        self._send(
                            200,
                            "application/json",
                            json.dumps({"bundle": bundle}).encode(),
                        )
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="zk-obs-http",
            daemon=True,
        )
        self._t_start = time.time()
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd, self._thread = None, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)
