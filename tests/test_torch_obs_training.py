"""Training observability in the port against the JAX package.

The twins of ``tests/training/test_training_observability.py`` (its
NaN-halt bundle case is in ``test_torch_obs_recovery.py``), and the
comparison of one tiny run through both packages: the JAX test's
configuration (an Adam ``Mlp`` on 256 ``SyntheticMnist`` examples, batch
32, one epoch of 8 steps, ``log_every=2``, a synchronous save every 4
steps, ``trace_export`` and ``metrics_port=0``, ``/metrics`` scraped from
the first save), eager and fused at ``unroll`` 2, the port from JAX's
built state. Each side runs with a fresh default registry, so the scrape
holds only what the run published. The two must agree on:

- the sequence of span and event names with their ``step`` attributes on
  the training thread, exactly;
- the set of ``zk_*`` series ``/metrics`` serves, apart from the device
  probe's ``device`` labels: JAX's probe labels one series a device of
  the process (the tests' eight XLA CPU devices), the port's one a card
  it touched, or ``device="0"`` at -1 without one; every ``zk_hbm_*``
  family is served by both;
- ``zk_train_epoch`` and ``zk_train_steps_total``, exactly, and
  ``zk_train_loss`` within ``test_torch_training.py``'s experiment
  tolerance (1e-3 relative);
- the kinds of the ledger rows the run recorded and their ``steps``.

Then the step's FLOP count: the tiny LM's ledger row equals its closed
form, and the same ``TrainLM ... metrics_port=0 trace_export=...
flight_recorder_dir=...`` command line runs in both packages on the CPU.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import test_torch_resume_vs_jax as resume
import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)
from zookeeper_tpu import resilience as jax_resilience
from zookeeper_tpu import training as jax_training
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.observability import ledger as jax_ledger
from zookeeper_tpu.observability import recorder as jax_recorder
from zookeeper_tpu.observability import registry as jax_registry
from zookeeper_tpu.observability import trace as jax_trace
from zookeeper_tpu_torch import resilience as port_resilience
from zookeeper_tpu_torch import training as port_training
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import load_flax_train_state
from zookeeper_tpu_torch.observability import ledger as port_ledger
from zookeeper_tpu_torch.observability import recorder as port_recorder
from zookeeper_tpu_torch.observability import registry as port_registry
from zookeeper_tpu_torch.observability import trace as port_trace
from zookeeper_tpu_torch.observability.ledger import ProgramRecord, default_ledger, mfu
from zookeeper_tpu_torch.observability.peaks import reference_peak_flops

ROOT = Path(__file__).resolve().parent.parent

#: ``tests/training/test_training_observability.py``'s ``make_experiment``.
RUN = {
    "loader.dataset": "SyntheticMnist",
    "loader.dataset.num_train_examples": 256,
    "loader.dataset.num_validation_examples": 0,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28,
    "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1,
    "model": "Mlp",
    "model.hidden_units": (32,),
    "batch_size": 32,
    "epochs": 1,
    "validate": False,
    "verbose": False,
}
JAX_ONLY = {"loader.host_index": 0, "loader.host_count": 1, "checkpointer.synchronous": True}
LOSS_RTOL = 1e-3
SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")


class Side:
    """One package's experiment (the port's from JAX's built state) and
    observability modules."""

    def __init__(self, name, start=None):
        self.name, self.start = name, start
        jax = name == "jax"
        self.trace = jax_trace if jax else port_trace
        self.ledger = jax_ledger if jax else port_ledger
        self.registry = jax_registry if jax else port_registry
        self.recorder = jax_recorder if jax else port_recorder
        self.res = jax_resilience if jax else port_resilience

    def experiment(self, tmp, extra=None):
        conf = {**RUN, "checkpointer.directory": str(tmp / self.name / "ckpt"),
                **(extra or {})}
        if self.name == "jax":
            exp = jax_training.TrainingExperiment()
            jax_configure(exp, {**conf, **JAX_ONLY}, name="obs_experiment")
            return exp
        exp = port_training.TrainingExperiment()
        port_configure(exp, {**conf, "device": "cpu"}, name="obs_experiment")
        if self.start is not None:
            start, build = self.start, exp.build_state
            object.__setattr__(exp, "build_state",
                               lambda device: load_flax_train_state(build(device), **start))
        return exp


def jax_start():
    exp = jax_training.TrainingExperiment()
    jax_configure(exp, {**RUN, **JAX_ONLY}, name="obs_experiment")
    return resume._jax_numpy_state(exp.build_state())


def chrome_names_and_steps(path):
    """``[(name, step)]`` of an exported Chrome trace's spans and instants
    on the main thread."""
    doc = json.loads(Path(path).read_text())
    main = {e["tid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["args"].get("name") == "MainThread"}
    return [(e["name"], e.get("args", {}).get("step")) for e in doc["traceEvents"]
            if e["ph"] in ("X", "i") and e["tid"] in main]


def series(body):
    """The ``name{labels}`` of every sample line of an exposition."""
    out = set()
    for line in body.splitlines():
        if line and not line.startswith("#"):
            assert SAMPLE.match(line), line
            out.add(line.rsplit(" ", 1)[0])
    return out


def family(name):
    return name.split("{", 1)[0]


def scrape(server):
    base = f"http://127.0.0.1:{server.port}"
    body = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    status = json.loads(urllib.request.urlopen(base + "/statusz", timeout=30).read())
    return body, status


def run_observed(side, tmp, extra, monkeypatch):
    """One run with ``trace_export`` and ``metrics_port=0``, scraped at its
    first save, under a fresh default registry; what both sides compare."""
    monkeypatch.setattr(side.registry, "_DEFAULT", side.registry.MetricsRegistry())
    trace_path = tmp / f"{side.name}-trace.json"
    exp = side.experiment(tmp, {"log_every": 2, "checkpointer.save_every_steps": 4,
                                "trace_export": str(trace_path), "metrics_port": 0, **extra})
    seen = {}
    orig_save = exp.checkpointer.save

    def save_and_scrape(*a, **k):
        if "body" not in seen and getattr(exp, "obs_server", None) is not None:
            seen["body"], seen["statusz"] = scrape(exp.obs_server)
        return orig_save(*a, **k)

    object.__setattr__(exp.checkpointer, "save", save_and_scrape)
    before = len(side.ledger.default_ledger().entries())
    history = exp.run()
    reg = exp.obs_registry
    return {
        "exp": exp,
        "history": history,
        "trace_path": trace_path,
        "events": chrome_names_and_steps(trace_path),
        "body": seen["body"],
        "statusz": seen["statusz"],
        "epoch": reg.gauge("zk_train_epoch").value,
        "steps_total": reg.counter("zk_train_steps_total").value,
        "loss": reg.gauge("zk_train_loss").value,
        "rows": [(r.kind, r.attrs.get("steps"))
                 for r in side.ledger.default_ledger().entries()[before:]],
        "step_ms": reg.gauge("zk_train_step_time_ms").value,
        "mfu": reg.gauge("zk_train_mfu").value,
        "row": side.ledger.default_ledger().entries()[before:][-1],
        "anomalies": reg.counter("zk_step_time_anomalies_total",
                                 labels={"stream": "train_step"}).value,
        "dispatch_ewma": reg.gauge("zk_step_time_ewma_ms",
                                   labels={"stream": "train_dispatch"}).value,
        "tracing_after": side.trace.enabled(),
        "server_after": getattr(exp, "obs_server", None),
        "probe_after": getattr(exp, "obs_probe", None),
    }


@pytest.fixture(scope="module")
def start():
    return jax_start()


_OBSERVED = {}


def observed(mode, start, tmp_path_factory):
    """``{name: run_observed(...)}`` of one mode ("eager", "fused" at
    ``unroll`` 2) through both packages, run once a module."""
    if mode not in _OBSERVED:
        tmp = tmp_path_factory.mktemp(mode)
        extra = {"unroll": 2} if mode == "fused" else {}
        out = {"mode": mode}
        for side in (Side("jax"), Side("port", start)):
            side.trace.disable()
            with pytest.MonkeyPatch.context() as mp:
                out[side.name] = run_observed(side, tmp, extra, mp)
        _OBSERVED[mode] = out
    return _OBSERVED[mode]


@pytest.fixture(scope="module", params=["eager", "fused"])
def runs(request, start, tmp_path_factory):
    return observed(request.param, start, tmp_path_factory)


@pytest.fixture(scope="module")
def eager(start, tmp_path_factory):
    return observed("eager", start, tmp_path_factory)


@pytest.fixture(scope="module")
def fused(start, tmp_path_factory):
    return observed("fused", start, tmp_path_factory)


# -- the comparison ---------------------------------------------------------------


def test_spans_and_events_equal_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert port["events"] == jax["events"]
    names = [n for n, _ in port["events"]]
    assert {"data_wait", "dispatch", "readback", "checkpoint", "ckpt_sync_save",
            "program_compiled"} <= set(names)


def test_metrics_series_equal_jax_apart_from_the_device_probe(runs):
    port, jax = series(runs["port"]["body"]), series(runs["jax"]["body"])
    probe = {family(s) for s in port | jax if family(s).startswith("zk_hbm_")}
    assert probe == {"zk_hbm_bytes_in_use", "zk_hbm_peak_bytes_in_use", "zk_hbm_bytes_limit"}
    assert {family(s) for s in port if family(s) in probe} == probe
    assert {family(s) for s in jax if family(s) in probe} == probe
    assert ({s for s in port if family(s) not in probe}
            == {s for s in jax if family(s) not in probe})
    assert "zk_prefetch_occupancy{split=\"train\"}" in port
    assert runs["port"]["statusz"]["training"] == runs["jax"]["statusz"]["training"]


def test_epoch_gauges_loss_and_ledger_rows_equal_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert port["epoch"] == jax["epoch"] == 1
    assert port["steps_total"] == jax["steps_total"] == 8
    np.testing.assert_allclose(port["loss"], jax["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["history"]["train"][0]["loss"],
                               jax["history"]["train"][0]["loss"], rtol=LOSS_RTOL)
    want = [("train_step", None)] if runs["mode"] == "eager" else [("multi_step", 2)]
    assert port["rows"] == jax["rows"] == want


# -- the twins of tests/training/test_training_observability.py -------------------


def _spans(doc, name):
    return [e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == name]


def test_fused_run_exports_full_slab_phase_trace(fused):
    run = fused["port"]
    doc = json.loads(run["trace_path"].read_text())
    dispatch = _spans(doc, "dispatch")
    assert [e["args"]["slab"] for e in dispatch] == [0, 1, 2, 3]
    assert all("step" in e["args"] for e in dispatch)
    assert len(_spans(doc, "data_wait")) >= 4
    assert _spans(doc, "readback")
    assert len(_spans(doc, "checkpoint")) == 2
    assert _spans(doc, "ckpt_sync_save")
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    assert not run["tracing_after"]


def test_eager_run_exports_phase_trace(eager):
    doc = json.loads(eager["port"]["trace_path"].read_text())
    assert len(_spans(doc, "dispatch")) == 8
    assert _spans(doc, "data_wait") and _spans(doc, "readback")


def test_trace_export_written_even_when_run_raises(tmp_path):
    side = Side("port")
    trace_path = tmp_path / "host_trace.json"
    exp = side.experiment(tmp_path, {"trace_export": str(trace_path)})
    with port_resilience.faults.injected(port_resilience.FaultPlan(kill_at_step=3)):
        with pytest.raises(port_resilience.Preempted):
            exp.run()
    doc = json.loads(trace_path.read_text())
    assert _spans(doc, "dispatch")
    injected = [e for e in doc["traceEvents"] if e["ph"] == "i" and e["name"] == "fault_injected"]
    assert injected and injected[0]["args"]["kind"] == "kill_at_step"
    assert _spans(doc, "preemption_drain") and _spans(doc, "preemption_save")
    assert not port_trace.enabled()


def test_metrics_endpoint_live_during_run(tmp_path):
    exp = Side("port").experiment(tmp_path, {"epochs": 2, "metrics_port": 0})
    spe = 8
    scraped = {}
    orig_write = exp.writer.write_scalars

    def spy(step, values):
        server = getattr(exp, "obs_server", None)
        if ("body" not in scraped and server is not None
                and any(k.startswith("train_epoch/") for k in values) and step >= 2 * spe):
            scraped["body"], scraped["statusz"] = scrape(server)
        return orig_write(step, values)

    object.__setattr__(exp.writer, "write_scalars", spy)
    exp.run()
    body = scraped["body"]
    assert "zk_train_loss" in body and "zk_train_examples_per_sec" in body
    assert "zk_train_epoch 1" in body
    assert "zk_prefetch_occupancy" in body
    assert scraped["statusz"]["training"]["model"] == "Mlp"
    assert scraped["statusz"]["training"]["epochs"] == 2
    assert getattr(exp, "obs_server", None) is None


def test_prefetch_thread_is_named():
    from zookeeper_tpu_torch.data.pipeline import prefetch_to_device

    seen = {}
    release = threading.Event()

    def slow_source():
        for i in range(4):
            yield {"x": np.array([i])}
            release.wait(1.0)

    it = prefetch_to_device(slow_source(), "cpu", size=1)
    first = next(it)
    deadline = time.perf_counter() + 2.0
    while time.perf_counter() < deadline and "name" not in seen:
        hits = [t.name for t in threading.enumerate() if t.name.startswith("zk-prefetch")]
        if hits:
            seen["name"] = hits[0]
        else:
            time.sleep(0.01)
    release.set()
    for _ in it:
        pass
    assert seen.get("name") == "zk-prefetch"
    assert int(first["x"][0]) == 0


def _count_windows(monkeypatch):
    from zookeeper_tpu_torch.training import profiling

    calls = {"start": 0, "close": 0}
    cls = profiling.ProfileWindow
    real = {n: getattr(cls, n) for n in ("start", "stop", "abort")}

    def start(self):
        calls["start"] += 1
        return real["start"](self)

    def stop(self):
        calls["close"] += 1
        return real["stop"](self)

    def abort(self):
        calls["close"] += self.active
        return real["abort"](self)

    for name, fn in (("start", start), ("stop", stop), ("abort", abort)):
        monkeypatch.setattr(cls, name, fn)
    return calls


def test_profiling_window_closed_on_mid_capture_exception(tmp_path, monkeypatch):
    calls = _count_windows(monkeypatch)
    exp = Side("port").experiment(tmp_path, {"profile_dir": str(tmp_path / "prof")})
    # The eager window is steps 4..7 (8 steps): a kill at step 6 is inside it.
    with port_resilience.faults.injected(port_resilience.FaultPlan(kill_at_step=6)):
        with pytest.raises(port_resilience.Preempted):
            exp.run()
    assert calls == {"start": 1, "close": 1}
    assert exp._profile_window is None


def test_profiling_window_still_closed_on_clean_run(tmp_path, monkeypatch):
    calls = _count_windows(monkeypatch)
    exp = Side("port").experiment(tmp_path, {"profile_dir": str(tmp_path / "prof")})
    exp.run()
    assert calls == {"start": 1, "close": 1}


def test_live_run_publishes_step_time_and_mfu_gauges(runs):
    """The gauge equals the hand computation from its own inputs: the
    ledger row's FLOPs a step, the measured step time, the bf16 peak."""
    run = runs["port"]
    row = run["row"]
    assert run["step_ms"] > 0 and row.dispatches > 0 and row.flops > 0
    per_step = row.flops / (row.attrs["steps"] if row.kind == "multi_step" else 1)
    want = mfu(per_step, run["step_ms"] / 1e3, reference_peak_flops()[0])
    assert run["mfu"] == pytest.approx(want, rel=1e-6)
    assert 0 < run["mfu"] < 1


def test_fused_run_ledgers_multi_step_and_divides_flops_by_unroll(fused):
    row = fused["port"]["row"]
    assert row.kind == "multi_step" and row.attrs["steps"] == 2
    assert row.compile_ms is not None
    step_ms = fused["port"]["step_ms"]
    assert fused["port"]["mfu"] == pytest.approx(
        mfu(row.flops / 2, step_ms / 1e3, reference_peak_flops()[0]), rel=1e-6)


def test_mfu_divides_by_recorded_slab_size_not_configured_unroll(tmp_path):
    exp = Side("port").experiment(tmp_path, {"unroll": 8})

    class FakeProgram:
        ledger_entry = ProgramRecord(kind="multi_step", key="k", flops=9e9, attrs={"steps": 3})

    exp._publish_mfu(0.5, FakeProgram())
    want = mfu(9e9 / 3, 0.5, reference_peak_flops()[0])
    assert exp.obs_registry.gauge("zk_train_mfu").value == pytest.approx(want, rel=1e-6)


def test_steady_run_fires_no_step_anomalies(eager):
    """The eager run (every slab of the fused one reads back, so it has no
    clean dispatch interval, in either package)."""
    assert eager["port"]["anomalies"] == 0
    assert eager["port"]["dispatch_ewma"] > 0


def test_metrics_endpoint_serves_mfu_and_hbm_series(runs):
    body = runs["port"]["body"]
    assert "zk_hbm_bytes_in_use" in body
    samples = [l for l in body.splitlines() if l and not l.startswith("#")]
    assert samples and all(SAMPLE.match(l) for l in samples)
    assert runs["port"]["probe_after"] is None and runs["port"]["server_after"] is None


def test_trace_export_with_profile_dir_logs_paired_artifacts(tmp_path, capsys):
    prof, out = tmp_path / "prof", tmp_path / "host_trace.json"
    exp = Side("port").experiment(tmp_path, {"trace_export": str(out),
                                             "profile_dir": str(prof), "verbose": True})
    exp.run()
    assert json.loads(out.read_text())["traceEvents"]
    text = capsys.readouterr().out
    assert "paired trace artifacts" in text
    assert str(out) in text and str(prof) in text
    assert exp._profile_window is None


# -- the fields on every task -----------------------------------------------------------

OBS_FIELDS = ("trace_export", "metrics_port", "flight_recorder_dir",
              "flight_recorder_interval_s")


@pytest.mark.parametrize("task", ["lm.TrainLM", "imagenet.TrainImageNet", "cifar.TrainCifar",
                                  "mnist.TrainMnist", "imagenet.DistillImageNet"])
def test_every_training_task_takes_the_fields_with_jax_defaults(task):
    """The four fields reach every task that inherits the port's
    ``TrainingExperiment``, with the JAX base class's defaults."""
    import importlib

    module, name = task.split(".")
    cls = getattr(importlib.import_module(f"zookeeper_tpu_torch.training.{module}"), name)
    default = cls()
    port_configure(default, {"device": "cpu"}, name="experiment")
    want = jax_training.TrainingExperiment()
    jax_configure(want, {**RUN, **JAX_ONLY}, name="experiment")
    assert [getattr(default, f) for f in OBS_FIELDS] == [getattr(want, f) for f in OBS_FIELDS]
    exp = cls()
    values = {"trace_export": "/x/trace.json", "metrics_port": 0,
              "flight_recorder_dir": "/x/bundles", "flight_recorder_interval_s": 5.0}
    port_configure(exp, {**values, "device": "cpu"}, name="experiment")
    assert {f: getattr(exp, f) for f in OBS_FIELDS} == values


# -- the step's FLOPs and the LM command line ----------------------------------------

LM = {"layers": 2, "d_model": 32, "heads": 2, "seq": 16, "vocab": 64, "batch": 8}


def lm_args(tmp, package):
    return [f"model.num_layers={LM['layers']}", f"model.d_model={LM['d_model']}",
            f"model.num_heads={LM['heads']}", f"seq_len={LM['seq']}",
            f"loader.dataset.vocab_size={LM['vocab']}", "loader.dataset.num_train_examples=16",
            "loader.dataset.num_validation_examples=0", f"batch_size={LM['batch']}",
            "steps_per_epoch=2", "epochs=1", "validate=False", "log_every=1",
            "metrics_port=0", f"trace_export={tmp / (package + '-trace.json')}",
            f"flight_recorder_dir={tmp / package / 'bundles'}"]


def lm_step_flops():
    """A tiny LM train step's FLOPs in closed form: each layer's four
    ``_Linear`` contractions (qkv ``d x 3d``, proj ``d x d``, up ``d x 4d``,
    down ``4d x d``) and the weight-tied head (``d x vocab``) at ``2 * in *
    out`` a token, times 3 for the backward, plus ``12 * head_dim`` per
    causal (query, key) pair and head."""
    d, tokens = LM["d_model"], LM["batch"] * LM["seq"]
    linear = 2 * tokens * (d * 3 * d + d * d + d * 4 * d + 4 * d * d) * LM["layers"]
    head = 2 * tokens * d * LM["vocab"]
    pairs = LM["batch"] * LM["seq"] * (LM["seq"] + 1) // 2 * LM["heads"] * LM["layers"]
    return 3 * (linear + head) + 12 * (d // LM["heads"]) * pairs


def test_lm_step_flops_match_the_closed_form(tmp_path):
    from zookeeper_tpu_torch.training.lm import TrainLM

    exp = TrainLM()
    port_configure(exp, {
        "model.num_layers": LM["layers"], "model.d_model": LM["d_model"],
        "model.num_heads": LM["heads"], "seq_len": LM["seq"],
        "loader.dataset.vocab_size": LM["vocab"], "loader.dataset.num_train_examples": 16,
        "loader.dataset.num_validation_examples": 0, "batch_size": LM["batch"],
        "steps_per_epoch": 2, "epochs": 1, "validate": False, "log_every": 1,
        "device": "cpu", "verbose": False}, name="experiment")
    before = len(default_ledger().entries())
    exp.run()
    (row,) = default_ledger().entries()[before:]
    assert row.kind == "train_step" and row.dispatches == 2
    assert row.flops == lm_step_flops()
    assert exp.obs_registry.gauge("zk_train_mfu").value > 0


def test_train_lm_command_line_runs_in_both_packages(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    jax_cmd = [sys.executable, str(ROOT / "examples" / "lm_experiment.py"), "TrainLM",
               *lm_args(tmp_path, "jax")]
    port_cmd = [sys.executable, "-m", "zookeeper_tpu_torch.training", "TrainLM", "device=cpu",
                *lm_args(tmp_path, "port")]
    for package, cmd in (("jax", jax_cmd), ("port", port_cmd)):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=env,
                              cwd=str(tmp_path))
        assert proc.returncode == 0, (package, proc.stdout[-2000:], proc.stderr[-2000:])
        assert "observability endpoint: http://" in proc.stdout, package
        doc = json.loads((tmp_path / f"{package}-trace.json").read_text())
        assert len(_spans(doc, "dispatch")) == 2, package
