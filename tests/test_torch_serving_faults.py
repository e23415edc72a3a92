"""The serving fault legs and the decode scheduler's staged weight swap,
held to the JAX package.

Each case of JAX's ``test_decode_resilience.py``,
``test_speculative_resilience.py``, the swap cases of
``test_decode_scheduler.py`` and the worker-crash cases of
``test_resilience.py`` runs through both packages on the same LM and
stream (``tests/torch_decode_features.py``; the JAX engines on their
reference attention, built once per module and reset between cases):

- ``decode_worker_crash``: every in-flight and queued stream fails with
  ``WorkerCrashedError``, partial tokens readable and equal to JAX's; one
  restart counted; the next submit serves JAX's tokens (sync and async;
  the dead stream's rows stay invisible to the slot's next occupant);
- ``request_swap``: validated at the call, applied at the first boundary
  with no stream in flight (in-flight streams keep the old weights,
  queued ones get the new), newest wins, a crash keeps a staged swap;
  under speculation the teacher alone is swapped (tokens stay the live
  teacher's greedy ones);
- ``serving_worker_crash``: the ``MicroBatcher`` worker's requests fail
  with ``WorkerCrashedError`` (one and five queued) and the next submit
  serves on a fresh worker.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import copy
import time
import types

import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu.serving import MicroBatcher as JaxMicroBatcher
from zookeeper_tpu.serving import ServingMetrics as JaxServingMetrics
from zookeeper_tpu.serving import WorkerCrashedError as JaxWorkerCrashedError
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.serving import MicroBatcher, ServingMetrics, WorkerCrashedError
from zookeeper_tpu_torch.training.checkpoint import export_trees

SIDES = {
    "port": (configure, F.DecodeScheduler, F.DecodeMetrics, FaultPlan, faults,
             WorkerCrashedError),
    "jax": (jax_configure, F.JaxScheduler, F.JaxMetrics, JaxFaultPlan, jax_faults,
            JaxWorkerCrashedError),
}


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


@pytest.fixture(scope="module")
def lm_b(lm):
    """The second weight set of the swaps: ``(JAX params, port export
    trees, port module)``."""
    params_b, mod_b = F.negated(lm)
    return params_b, export_trees(mod_b), mod_b


@pytest.fixture(scope="module")
def engines(lm):
    jmod, params, mod = lm
    # The port engine swaps into its own module, never the shared one.
    port, ref = F.port_engine(copy.deepcopy(mod), slots=2), F.jax_engine(jmod, params, slots=2)
    port.warmup()
    ref.warmup()
    return {"port": port, "jax": ref}


def sched_of(side, engine, spec=None, **conf):
    configure_, sched_cls, metrics_cls = SIDES[side][:3]
    engine._reset_cache()
    if spec is not None:
        spec.draft_engine._reset_cache()
    metrics = metrics_cls()
    configure_(metrics, {}, name="metrics")
    sched = sched_cls()
    configure_(sched, dict(conf), name="sched")
    sched.bind(engine, metrics=metrics, speculative=spec)
    return sched, metrics


def swap_args(side, lm_b):
    return (lm_b[0], None) if side == "jax" else lm_b[1]


def restore(engines_, lm):
    """The module's weights back in both packages' engines."""
    engines_["port"].swap_weights(*export_trees(lm[2]))
    engines_["jax"].swap_weights(lm[1], None)


# -- decode_worker_crash ----------------------------------------------------------


def test_injected_crash_fails_streams_clean_and_restarts(lm, engines):
    """Sync: an injected loop crash fails the in-flight stream and the
    queued ones (partial tokens readable, the greedy prefix), one restart
    is counted, and the restarted scheduler serves JAX's tokens."""
    p1, p2 = np.arange(1, 6, dtype=np.int32), np.arange(2, 7, dtype=np.int32)
    got = {}
    for side in SIDES:
        _, _, _, plan_cls, fx, crashed = SIDES[side]
        sched, metrics = sched_of(side, engines[side])
        in_flight = sched.submit(p1, max_new_tokens=6)
        sched._pump()
        queued = [sched.submit(p2, max_new_tokens=4) for _ in range(2)]
        with fx.injected(plan_cls(decode_worker_crash=1)):
            with pytest.raises(crashed):
                sched.drain()
        for s in [in_flight] + queued:
            with pytest.raises(crashed):
                s.result()
        got[side] = ([s.tokens_so_far.tolist() for s in [in_flight] + queued],
                     metrics.totals["worker_restarts_total"], sched.active_slots,
                     sched.queue_depth, sched.generate(p1, max_new_tokens=5).tolist())
    assert got["port"] == got["jax"]
    partial = got["port"][0][0]
    assert len(partial) >= 1 and partial == F.greedy(lm[2], p1, len(partial)).tolist()
    assert got["port"][1:4] == (1, 0, 0)


def test_async_worker_crash_restarts_on_next_submit(lm, engines):
    """Async: the worker thread dies on the crash, the pending stream
    fails (never hangs), the next submit starts a fresh worker."""
    p = np.arange(1, 5, dtype=np.int32)
    got = {}
    for side in SIDES:
        _, _, _, plan_cls, fx, crashed = SIDES[side]
        sched, metrics = sched_of(side, engines[side], synchronous=False)
        try:
            with fx.injected(plan_cls(decode_worker_crash=1)):
                doomed = sched.submit(p, max_new_tokens=8)
                with pytest.raises(crashed):
                    doomed.result(timeout=120)
            restarts = metrics.totals["worker_restarts_total"]
            got[side] = (restarts, sched.submit(p, max_new_tokens=4).result(timeout=120).tolist())
        finally:
            sched.close()
    assert got["port"] == got["jax"] and got["port"][0] == 1


def test_crash_keeps_kv_isolation_across_restart(lm, engines):
    """After a crash mid-stream the slot's next occupant does not see the
    dead stream's rows."""
    short = np.array([7, 3], np.int32)
    got = {}
    for side in SIDES:
        _, _, _, plan_cls, fx, crashed = SIDES[side]
        sched, _ = sched_of(side, engines[side])
        victim = sched.submit(np.arange(1, 16, dtype=np.int32), max_new_tokens=16)
        sched._pump()
        sched._pump()
        with fx.injected(plan_cls(decode_worker_crash=1)):
            with pytest.raises(crashed):
                sched.drain()
        assert victim.done
        got[side] = sched.generate(short, max_new_tokens=6).tolist()
    assert got["port"] == got["jax"] == F.greedy(lm[2], short, 6).tolist()


# -- the staged weight swap -------------------------------------------------------


def test_request_swap_validates_eagerly(lm, engines):
    """A tree of another width or depth raises at ``request_swap`` (JAX's
    messages) and nothing is staged."""
    import jax

    _, params, mod = lm
    port_params = export_trees(mod)[0]
    leaf = sorted(port_params)[0]
    wide = ({**port_params, leaf: torch.zeros(7, 3)}, {})
    deep = ({**port_params, "Block_9/extra": torch.zeros(3)}, {})
    jax_wide = jax.tree.map(lambda a: np.zeros((7, 3), np.float32) if a.ndim == 2 else a, params)
    jax_deep = {**params, "Block_9": {"extra": np.zeros(3, np.float32)}}
    for side in SIDES:
        sched, _ = sched_of(side, engines[side])
        for port_args, jparams, match in ((wide, jax_wide, "mismatch"),
                                          (deep, jax_deep, "does not match")):
            args = (jparams, None) if side == "jax" else port_args
            with pytest.raises(ValueError, match=match):
                sched.request_swap(*args)
            with pytest.raises(ValueError, match=match):
                engines[side].check_swap(*args)
        assert not sched.swap_pending


def test_swap_applies_at_drain_boundary_one_version_per_sequence(lm, lm_b, engines):
    """Streams in flight at the request (mid-decode, a third pump after
    it) finish on the old weights, the stream queued after it runs on the
    new; one swap counted; the same tokens as JAX."""
    rng = np.random.default_rng(9)
    p1 = rng.integers(1, F.VOCAB, size=6).astype(np.int32)
    p2 = rng.integers(1, F.VOCAB, size=9).astype(np.int32)
    got = {}
    for side in SIDES:
        sched, metrics = sched_of(side, engines[side])
        s1 = sched.submit(p1, max_new_tokens=8)
        s2 = sched.submit(p2, max_new_tokens=5)
        sched._pump()
        sched._pump()
        sched.request_swap(*swap_args(side, lm_b), step=7)
        sched._pump()
        assert sched.swap_pending and sched.status()["swap_pending"]
        post = sched.submit(p1, max_new_tokens=5)
        sched.drain()
        assert not sched.swap_pending
        got[side] = ([s.result().tolist() for s in (s1, s2, post)],
                     metrics.totals["weight_swaps_total"], metrics.snapshot()["weight_swaps_total"])
    restore(engines, lm)
    assert got["port"] == got["jax"]
    tokens = got["port"][0]
    assert tokens[0] == F.greedy(lm[2], p1, 8).tolist()
    assert tokens[2] == F.greedy(lm_b[2], p1, 5).tolist()
    assert got["port"][1:] == (1, 1.0)


def test_swap_supersede_newest_wins_and_survives_a_crash(lm, lm_b, engines):
    """A second request replaces the first (the module's own weights
    win); a crash while a swap is staged fails the streams, keeps the
    swap, and it applies before the next admission."""
    p = np.arange(1, 7, dtype=np.int32)
    got = {}
    for side in SIDES:
        _, _, _, plan_cls, fx, crashed = SIDES[side]
        sched, _ = sched_of(side, engines[side])
        sched.request_swap(*swap_args(side, lm_b))
        sched.request_swap(*((lm[1], None) if side == "jax" else export_trees(lm[2])))
        sched.drain()
        assert not sched.swap_pending
        newest = sched.generate(np.array([1, 2, 3], np.int32), max_new_tokens=4).tolist()
        victim = sched.submit(p, max_new_tokens=8)
        sched._pump()
        sched.request_swap(*swap_args(side, lm_b))
        with fx.injected(plan_cls(decode_worker_crash=1)):
            with pytest.raises(crashed):
                sched.drain()
        assert victim.done and sched.swap_pending
        got[side] = (newest, sched.generate(p, max_new_tokens=4).tolist())
        assert not sched.swap_pending
    restore(engines, lm)
    assert got["port"] == got["jax"]
    assert got["port"][0] == F.greedy(lm[2], np.array([1, 2, 3]), 4).tolist()
    assert got["port"][1] == F.greedy(lm_b[2], p, 4).tolist()


def test_teacher_swap_mid_speculation_and_crash_into_spec_restart(lm, lm_b):
    """With the teacher as its own draft (every window accepted) a swap
    staged mid-speculation swaps the teacher only: in-flight streams
    finish on the old teacher, the post-swap stream on the new one
    (acceptance drops, tokens stay the live teacher's); a crash mid-
    speculation with a swap staged fails the streams, then the restarted
    schedule speculates against the new teacher. JAX's tokens."""
    jmod, params, mod = lm
    rng = np.random.default_rng(9)
    p1 = rng.integers(1, F.VOCAB, size=6).astype(np.int32)
    p2 = rng.integers(1, F.VOCAB, size=9).astype(np.int32)
    got = {}
    for side in SIDES:
        _, _, _, plan_cls, fx, crashed = SIDES[side]
        if side == "port":
            engine = F.port_engine(copy.deepcopy(mod), slots=2)
            spec = F.port_spec(engine, mod, 3)
        else:
            engine = F.jax_engine(jmod, params, slots=2)
            spec = F.jax_spec(engine, jmod, params, 3)
        sched, metrics = sched_of(side, engine, spec)
        s1 = sched.submit(p1, max_new_tokens=20)
        s2 = sched.submit(p2, max_new_tokens=16)
        sched._pump()
        sched._pump()
        sched.request_swap(*swap_args(side, lm_b), step=31)
        sched._pump()
        assert sched.swap_pending
        post = sched.submit(p1, max_new_tokens=5)
        sched.drain()
        first = ([s.result().tolist() for s in (s1, s2, post)],
                 metrics.totals["weight_swaps_total"])
        engine.swap_weights(*((params, None) if side == "jax" else export_trees(mod)))
        sched, _ = sched_of(side, engine, spec)
        victim = sched.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
        sched._pump()
        sched.request_swap(*swap_args(side, lm_b))
        with fx.injected(plan_cls(decode_worker_crash=1)):
            with pytest.raises(crashed):
                sched.drain()
        assert victim.done and sched.swap_pending
        got[side] = (first, sched.generate(np.arange(1, 7, dtype=np.int32),
                                           max_new_tokens=4).tolist())
        assert not sched.swap_pending
    assert got["port"] == got["jax"]
    tokens = got["port"][0][0]
    assert tokens[0] == F.greedy(mod, p1, 20).tolist()
    assert tokens[2] == F.greedy(lm_b[2], p1, 5).tolist()
    assert got["port"][1] == F.greedy(lm_b[2], np.arange(1, 7), 4).tolist()


# -- serving_worker_crash ------------------------------------------------------


class _Engine:
    """An engine double: rows in, ``[sum, max]`` per row out (a tensor
    for the port's batcher)."""

    batch_buckets = (1, 4, 8)
    max_batch = 8

    def __init__(self, as_torch: bool):
        self.as_torch = as_torch

    def bucket_for(self, n):
        return next(b for b in self.batch_buckets if b >= n)

    def infer(self, x):
        out = np.stack([x.sum(axis=1), x.max(axis=1)], axis=1).astype(np.float32)
        return torch.from_numpy(out) if self.as_torch else out


def _batcher(side):
    conf, batcher_cls, metrics_cls = ((configure, MicroBatcher, ServingMetrics) if side == "port"
                                      else (jax_configure, JaxMicroBatcher, JaxServingMetrics))
    metrics = metrics_cls()
    conf(metrics, {}, name="metrics")
    batcher = batcher_cls()
    conf(batcher, {"synchronous": False, "max_delay_ms": 1.0}, name="batcher")
    batcher.bind(_Engine(side == "port"), metrics=metrics)
    return batcher, metrics


@pytest.mark.parametrize("queued", [1, 5])
def test_batcher_worker_crash_fails_pending_and_restarts(queued):
    """``serving_worker_crash=1``: with one request, or five held until
    the worker starts, every queued request fails with
    ``WorkerCrashedError``, one restart is counted, and a fresh worker
    serves the retry, in both packages."""
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(1 if queued > 1 else 2, 5)).astype(np.float32)
          for _ in range(queued)]
    retry = rng.normal(size=(3, 5)).astype(np.float32)
    got = {}
    for side, plan_cls, fx, crashed in (("port", FaultPlan, faults, WorkerCrashedError),
                                        ("jax", JaxFaultPlan, jax_faults, JaxWorkerCrashedError)):
        batcher, metrics = _batcher(side)
        try:
            with fx.injected(plan_cls(serving_worker_crash=1)):
                if queued > 1:
                    object.__setattr__(batcher, "_worker",
                                       types.SimpleNamespace(is_alive=lambda: True))
                handles = [batcher.submit(x) for x in xs]
                if queued > 1:
                    assert batcher.queue_rows == queued
                    object.__setattr__(batcher, "_worker", None)
                    batcher._ensure_worker()
                for h in handles:
                    deadline = time.perf_counter() + 30
                    while not h.done and time.perf_counter() < deadline:
                        time.sleep(0.005)
                    with pytest.raises(crashed):
                        h.result(timeout=30)
                restarts = metrics.totals["worker_restarts"]
                out = np.asarray(batcher.submit(retry).result(timeout=30))
            got[side] = (restarts, metrics.totals["worker_restarts"], batcher.queue_rows, out)
        finally:
            batcher.close()
    assert got["port"][:3] == got["jax"][:3] == (1, 1, 0)
    np.testing.assert_array_equal(got["port"][3], got["jax"][3])
