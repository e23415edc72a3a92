"""Fleet worker processes: one replica behind HTTP, and their spawning.

The port's own copy of ``run_fleet_worker``, ``spawn_fleet_workers`` and
``stop_fleet_workers`` (the JAX package keeps them in
``zookeeper_tpu/testing.py``). A worker is a real OS process running a
paged ``LMServingConfig`` with the radix prefix cache on (the warm path
the router's affinity protects) behind a stdlib HTTP server:

- ``POST /generate``: JSON ``{tokens, max_new_tokens, rid, session}`` in,
  ``{rid, worker_id, tokens, ttft_ms, shared_tokens, finish_reason}``
  out; the scheduler adopts the router's rid. A failure answers 400 with
  ``{error, type}``.
- ``POST /shutdown``: stop serving and exit.
- the service's live ``/metrics``, ``/statusz`` and ``/healthz`` on an
  ephemeral port of its own.

The model runs on ``device`` of the worker's config, the card unless
``"device": "cpu"`` is passed; a worker asked for the card that finds
none fails before it is ready, and ``spawn_fleet_workers`` raises with
its log tail. A ``"faults"`` key installs a ``FaultPlan`` in the worker
(plans are process-local); the worker fires its ``delay_forward_ms``
leg, a stall of its forward path while ``/healthz`` keeps answering.
Once serving, a worker writes its ready document (``worker_id``,
``pid``, ``generate_port``, ``metrics_port``) atomically; feed it to
``serving.fleet.ReplicaHandle.from_worker``.

A CPU fleet of two tiny workers::

    from zookeeper_tpu_torch.serving.fleet_worker import spawn_fleet_workers
    workers = spawn_fleet_workers(tmpdir, 2, config={"device": "cpu",
                                                     "model.d_model": 32})
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["DEFAULT_WORKER_CONFIG", "run_fleet_worker", "spawn_fleet_workers",
           "stop_fleet_workers"]

#: Each worker's ``LMServingConfig`` before the caller's overrides: the
#: JAX package's worker geometry, with K9 for the prefill attention.
DEFAULT_WORKER_CONFIG: Dict[str, Any] = {
    "model.num_layers": 2,
    "model.d_model": 64,
    "model.num_heads": 4,
    "model.max_seq_len": 128,
    "seq_len": 128,
    "vocab_size": 61,
    "seed": 0,
    "engine.kv_layout": "paged",
    "engine.page_size": 16,
    "engine.slots": 4,
    "engine.seq_buckets": (16, 128),
    "engine.prefill_buckets": (1,),
    "requests": 0,
    "verbose": False,
    "metrics_port": 0,
    "device": "cuda",
}


def run_fleet_worker(worker_id: str, ready_path: str, workdir: str,
                     config_json: str = "{}") -> None:
    """Serve one replica until ``POST /shutdown`` (see the module
    docstring). ``workdir`` is the fleet's working directory (unused by
    the worker itself: its log and ready document live there)."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.resilience import faults
    from zookeeper_tpu_torch.serving.decode import LMServingConfig

    overrides = json.loads(config_json)
    # Every worker receives the same plan and fires only its own keys.
    fault_conf = overrides.pop("faults", None)
    if fault_conf:
        faults.install(faults.FaultPlan(**fault_conf))
    conf = {**DEFAULT_WORKER_CONFIG, **overrides}
    svc = LMServingConfig()
    configure(svc, conf, name=f"fleet_worker_{worker_id}")
    _, scheduler = svc.build_service()
    # One generation at a time a replica: the router's load terms (its
    # in-flight count, the queue depth) stay meaningful.
    gen_lock = threading.Lock()
    stop = threading.Event()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # no stderr line per request
            pass

        def _send(self, code, doc):
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path == "/shutdown":
                self._send(200, {"ok": True})
                stop.set()
                return
            if self.path != "/generate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n).decode())
                plan = faults.active()
                if plan is not None:
                    # Gray failure: the forward stalls, /healthz answers.
                    delay = plan.take_delay_forward(worker_id)
                    if delay:
                        time.sleep(delay / 1e3)
                with gen_lock:
                    stream = scheduler.submit(
                        np.asarray(req["tokens"], np.int32),
                        max_new_tokens=int(req.get("max_new_tokens") or 16),
                        rid=req.get("rid"))
                    out = stream.result(timeout=300.0)
                self._send(200, {
                    "rid": stream.rid,
                    "worker_id": worker_id,
                    "tokens": [int(x) for x in out.tolist()],
                    "ttft_ms": stream.ttft_ms,
                    "shared_tokens": int(stream.shared_tokens),
                    "finish_reason": stream.finish_reason,
                })
            except Exception as e:  # the router reads it as an error body
                self._send(400, {"error": str(e), "type": type(e).__name__})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    doc = {"worker_id": worker_id, "pid": os.getpid(),
           "generate_port": httpd.server_address[1], "metrics_port": svc.obs_server.port}
    tmp = ready_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, ready_path)
    try:
        stop.wait()
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve_thread.join(timeout=5)
        svc._teardown_service(suppress=True)


def spawn_fleet_workers(workdir: str, num_workers: int = 2, config: Optional[dict] = None,
                        timeout_s: float = 300.0,
                        command: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Start ``num_workers`` processes running :func:`run_fleet_worker`
    (ids ``w0``, ``w1``, ...) and wait for every ready document; returns
    them. ``command`` is the argv that runs ``run_fleet_worker`` with the
    four arguments appended (default: this interpreter on this module);
    a harness that counts a worker's kernel launches passes its own entry
    point. Raises with the worker's log tail when one dies before it is
    ready, after killing the others."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    config_json = json.dumps(config or {})
    if command is None:
        command = [sys.executable, "-c",
                   "import sys; from zookeeper_tpu_torch.serving.fleet_worker import "
                   "run_fleet_worker; run_fleet_worker(*sys.argv[1:5])"]
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    procs = []
    for w in range(num_workers):
        worker_id = f"w{w}"
        ready = os.path.join(workdir, f"ready_{worker_id}.json")
        log_path = os.path.join(workdir, f"fleet_log_{worker_id}.txt")
        # A file, not a pipe: a full pipe would stall the worker's loop.
        with open(log_path, "wb") as log_f:
            p = subprocess.Popen([*command, worker_id, ready, workdir, config_json],
                                 env=env, stdout=log_f, stderr=subprocess.STDOUT)
        procs.append((p, worker_id, ready, log_path))
    workers = []
    deadline = time.monotonic() + timeout_s
    try:
        for p, worker_id, ready, log_path in procs:
            while not os.path.exists(ready):
                if p.poll() is not None:
                    with open(log_path, errors="replace") as f:
                        log = f.read()
                    raise RuntimeError(f"fleet worker {worker_id} died before ready "
                                       f"(rc={p.returncode}):\n" + log[-4000:])
                if time.monotonic() > deadline:
                    raise RuntimeError(f"fleet worker {worker_id} not ready within "
                                       f"{timeout_s:.0f}s; log: {log_path}")
                time.sleep(0.1)
            with open(ready) as f:
                workers.append(json.load(f))
    except BaseException:
        for p, *_ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        raise
    return workers


def stop_fleet_workers(workers: Sequence[Dict[str, Any]], timeout_s: float = 30.0) -> None:
    """Stop what :func:`spawn_fleet_workers` started: ``POST /shutdown``
    to each live worker, then reap every process (a worker killed by a
    chaos leg is a zombie until then), killing stragglers at the
    deadline."""
    for w in workers:
        try:
            urllib.request.urlopen(urllib.request.Request(
                "http://127.0.0.1:%d/shutdown" % w["generate_port"], data=b"{}"), timeout=5)
        except (urllib.error.URLError, OSError):
            pass
    deadline = time.monotonic() + timeout_s
    for w in workers:
        pid = w.get("pid")
        if pid is None:
            continue
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break  # reaped already, or not ours
            if done == pid:
                break
            if time.monotonic() > deadline:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
                try:
                    os.waitpid(pid, 0)
                except ChildProcessError:
                    pass
                break
            time.sleep(0.1)
