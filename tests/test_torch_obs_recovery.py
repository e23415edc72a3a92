"""Checkpoint, preemption and recovery observability in the port against
the JAX package.

Each case runs one tiny configuration through both packages
(``test_torch_obs_training.py``'s ``Mlp`` run, 8 steps, the port from
JAX's built state) with a tracer installed for the whole case, so the
supervisor's events between runs are recorded too, and a fresh default
registry. The cases: a mid-run kill and resume under
``run_with_recovery``; a ``nan_at_step`` halt under it with the flight
recorder armed (the twin of
``tests/training/test_training_observability.py``'s bundle case); the
async writer; a torn step the restore walk skips; a 2-host group in one
process (host 1 a stub thread, as ``test_torch_group_recovery.py``); and
the per-host protocol's save, commit and agreed restore
(``test_torch_sharded_checkpoint.py``'s host pairs). The two packages
must agree on:

- the sequence of span and event names with their ``step`` attributes on
  each thread (the training thread, the async writer), exactly;
- the event attributes that name a cause (``fault_injected``'s kind,
  ``restore_skip``'s reason and tier, ``restore_done``'s tier);
- the bundles' trigger names in order, and the group bundle manifest's
  ``origin``;
- the gauges and counters the case moves.

One difference is stated: the port marks ``FaultPlan.nan_at_step`` with
``fault_injected{kind=nan_at_step}`` (and so a flight-recorder bundle)
when it dispatches the NaN step; the JAX package reads that fault while
tracing its step and never marks it. The comparisons drop that one
record and that one bundle from the port's side.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import contextlib
import json
import os
from collections import Counter

import pytest

import test_torch_sharded_checkpoint as sharded
from test_torch_group_recovery import PeerStub
from test_torch_obs_training import Side, jax_start

pytestmark = pytest.mark.chaos

NAN = ("fault_injected", "nan_at_step")


@pytest.fixture(scope="module")
def start():
    return jax_start()


@contextlib.contextmanager
def observed(side):
    """A fresh default registry, a tracer and no flight recorder for the
    case; yields the tracer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(side.registry, "_DEFAULT", side.registry.MetricsRegistry())
        prior = side.recorder.get_recorder()
        side.recorder.uninstall()
        tracer = side.trace.Tracer()
        side.trace.install(tracer)
        try:
            yield tracer
        finally:
            side.trace.install(None)
            side.recorder.uninstall()
            if prior is not None:
                side.recorder.install(prior)


def sequence(tracer, thread="MainThread", drop_nan=False):
    """``[(name, step, cause)]`` of one thread's records; ``cause`` is the
    attribute naming why (a fault's kind, a skip's reason and tier, a
    restore's tier), None elsewhere."""
    out = []
    for r in tracer.snapshot():
        if r["thread_name"] != thread:
            continue
        attrs = r["attrs"] or {}
        if drop_nan and (r["name"], attrs.get("kind")) == NAN:
            continue
        cause = {"fault_injected": ("kind",), "restore_skip": ("reason", "tier"),
                 "restore_done": ("tier",)}.get(r["name"])
        out.append((r["name"], r["step"],
                    tuple(attrs.get(k) for k in cause) if cause else None))
    return out


def bundles(rec, drop_nan=False):
    """``[(trigger kind, trigger attrs)]`` of a recorder's bundles, oldest
    first."""
    out = []
    for path in rec.bundles():
        with open(os.path.join(path, "manifest.json")) as f:
            trigger = json.load(f)["trigger"]
        attrs = trigger.get("attrs") or {}
        if drop_nan and (trigger["kind"], attrs.get("kind")) == NAN:
            continue
        out.append((trigger["kind"], attrs))
    return out


def recover(side, exp, **kw):
    return side.res.run_with_recovery(exp, max_restarts=1, backoff_s=0.0,
                                      sleep=lambda s: None, **kw)


def kill_and_resume(side, tmp):
    exp = side.experiment(tmp, {"checkpointer.save_every_steps": 2})
    with observed(side) as tracer:
        with side.res.faults.injected(side.res.FaultPlan(kill_at_step=3)):
            result = recover(side, exp)
        reg = exp.obs_registry
        return {"restarts": result.restarts, "events": sequence(tracer),
                "steps_total": reg.counter("zk_train_steps_total").value,
                "epoch": reg.gauge("zk_train_epoch").value}


def test_kill_and_resume_events_equal_jax(tmp_path, start):
    want = kill_and_resume(Side("jax"), tmp_path)
    got = kill_and_resume(Side("port", start), tmp_path)
    assert got == want
    names = [n for n, _, _ in got["events"]]
    for name in ("preemption_requested", "preemption_drain", "preemption_save",
                 "ckpt_sync_save", "supervisor_restart", "restore_step", "restore_done",
                 "supervisor_recovered"):
        assert name in names, name
    assert ("fault_injected", 3, ("kill_at_step",)) in got["events"]
    assert got["restarts"] == 1 and got["steps_total"] == 5


def nan_halt(side, tmp, drop_nan):
    exp = side.experiment(tmp, {
        "nan_policy": "halt", "log_every": 1, "checkpointer.save_every_steps": 1,
        "flight_recorder_dir": str(tmp / side.name / "bundles"),
        "flight_recorder_interval_s": 0.0})
    with observed(side) as tracer:
        with side.res.faults.injected(side.res.FaultPlan(nan_at_step=3)):
            result = recover(side, exp)
        rec = exp.flight_recorder
        kinds = [k for k, _ in bundles(rec)]
        nan_bundle = rec.bundles()[kinds.index("nan_halt")]
        with open(os.path.join(nan_bundle, "statusz.json")) as f:
            statusz = json.load(f)
        return {"restarts": result.restarts, "events": sequence(tracer, drop_nan=drop_nan),
                "bundles": bundles(rec, drop_nan=drop_nan), "model": statusz["training"]["model"],
                "prom": os.path.isfile(os.path.join(nan_bundle, "metrics.prom")),
                "all_events": sequence(tracer), "all_bundles": bundles(rec)}


def test_nan_halt_and_recovery_bundles_equal_jax(tmp_path, start):
    want = nan_halt(Side("jax"), tmp_path, drop_nan=False)
    got = nan_halt(Side("port", start), tmp_path, drop_nan=True)
    for key in ("restarts", "events", "bundles", "model", "prom"):
        assert got[key] == want[key], key
    assert got["restarts"] == 1 and got["model"] == "Mlp" and got["prom"]
    kinds = [k for k, _ in got["all_bundles"]]
    assert kinds.count("nan_halt") == 1 and kinds.count("supervisor_restart") == 1
    assert dict(got["all_bundles"])["nan_halt"]["skipped_steps"] >= 1
    # The port's own NaN mark, and the restore after the halt.
    assert ("fault_injected", 3, ("nan_at_step",)) in got["all_events"]
    assert any(n == "restore_done" for n, _, _ in got["all_events"])


def async_saves(side, tmp):
    exp = side.experiment(tmp, {"checkpointer.mode": "async",
                                "checkpointer.save_every_steps": 2})
    with observed(side) as tracer:
        exp.run()
        depth = side.registry.default_registry().gauge("zk_ckpt_queue_depth").value
        return {"main": sequence(tracer), "writer": sequence(tracer, "zk-async-ckpt"),
                "depth": depth}


def test_async_writer_events_equal_jax(tmp_path, start):
    want = async_saves(Side("jax"), tmp_path)
    got = async_saves(Side("port", start), tmp_path)
    assert got == want
    assert [n for n, _, _ in got["main"]].count("ckpt_queued") == 4
    assert [(n, s) for n, s, _ in got["writer"]] == [
        (n, s) for s in (2, 4, 6, 8) for n in ("ckpt_write", "ckpt_finalized")]
    assert got["depth"] == 0


def torn_step(side, tmp):
    exp = side.experiment(tmp, {"checkpointer.save_every_steps": 2})
    plan = side.res.FaultPlan(kill_at_step=4, corrupt_checkpoint_step=4)
    with observed(side) as tracer:
        with side.res.faults.injected(plan):
            result = recover(side, exp)
        return {"restarts": result.restarts, "events": sequence(tracer)}


def test_restore_walk_skips_a_torn_step_like_jax(tmp_path, start):
    want = torn_step(Side("jax"), tmp_path)
    got = torn_step(Side("port", start), tmp_path)
    assert got == want
    skips = [e for e in got["events"] if e[0] == "restore_skip"]
    assert skips and skips[0][1] == 4
    assert [e for e in got["events"] if e[0] == "restore_done"] == [("restore_done", 2, ("local",))]


def group_kill(side, tmp):
    exp = side.experiment(tmp, {
        "checkpointer.save_every_epochs": 0,
        "flight_recorder_dir": str(tmp / side.name / "bundles"),
        "flight_recorder_interval_s": 0.0})
    coord = side.res.FileCoordinator(str(tmp / side.name / "coord"), 0, 2, timeout_s=60.0)
    stub = PeerStub(side, tmp / side.name / "coord", restarts=1).start()
    with observed(side) as tracer:
        with side.res.faults.injected(side.res.FaultPlan(kill_process_at_step={0: 2})):
            result = side.res.run_with_recovery(exp, coordinator=coord, max_restarts=2,
                                                backoff_s=0.0, sleep=lambda s: None)
        stub.join()
        reg = side.registry.default_registry()
        group = [a for k, a in bundles(exp.flight_recorder) if k == "group_restart"]
        return {"restarts": result.restarts, "events": sequence(tracer),
                "bundles": [k for k, _ in bundles(exp.flight_recorder)],
                "origin": [a["origin"] for a in group], "cause": [a["cause"] for a in group],
                "group_restarts": reg.counter("zk_group_restarts_total").value,
                "restore_ms": reg.gauge("zk_group_restore_ms").value > 0}


def test_group_restart_events_metrics_and_bundle_equal_jax(tmp_path, start):
    want = group_kill(Side("jax"), tmp_path)
    got = group_kill(Side("port", start), tmp_path)
    assert got == want
    assert got["restarts"] == 1 and got["origin"] == [0] and got["cause"] == ["Preempted"]
    assert got["group_restarts"] == 1 and got["restore_ms"]
    assert "group_restart" in [n for n, _, _ in got["events"]]


def per_host(side, obs, root):
    """The per-host protocol's events (``side`` a host-pair side of
    ``test_torch_sharded_checkpoint.py``, ``obs`` the same package's
    :class:`Side`): a committed group save and an agreed restore, a
    host's torn finalize, and a commit abandoned for want of host 1's
    half."""
    with observed(obs) as tracer:
        sharded.commit_and_round_trip_both_hosts(side, root + "/a")
        sharded.torn_host_finalize_is_invisible_to_every_host(side, root + "/b")
        (lone, _) = sharded.host_pair(side, root + "/c", host_commit_timeout_s=0.2)
        lone.save(side.state(5.0, 5), step=5)
        every = Counter((r["name"], r["step"], json.dumps(r["attrs"], sort_keys=True))
                        for r in tracer.snapshot())
        finalized = {pid: obs.registry.default_registry().gauge(
            "zk_ckpt_host_finalized", labels={"pid": str(pid)}).value for pid in (0, 1)}
        return {"main": sequence(tracer), "every": every, "finalized": finalized}


def test_per_host_protocol_events_and_gauge_equal_jax(tmp_path):
    want = per_host(sharded.JaxSide, Side("jax"), str(tmp_path / "jax"))
    got = per_host(sharded.PortSide, Side("port"), str(tmp_path / "port"))
    assert got == want
    names = {n for n, _, _ in got["main"]}
    assert {"ckpt_host_finalized", "ckpt_group_committed", "ckpt_group_commit_abandoned",
            "restore_step", "restore_done", "fault_injected"} <= names
    assert got["finalized"] == {0: 5, 1: 1}
