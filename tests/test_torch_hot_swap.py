"""Hot weight swaps into a warmed ``InferenceEngine`` and the checkpoint
watcher, held to the JAX package.

Each case of JAX's ``tests/serving/test_hot_swap.py`` runs through both
packages on the same Mlp weights (the JAX init carried into the port
module), each package saving its steps with its own ``Checkpointer``
into its own directory:

- a swap serves what a cold bind of the same weights serves (bitwise in
  the port; JAX's outputs within fp32 rounding), with no bucket warmed
  again; a tree of another width or depth raises JAX's errors;
- the watcher's polls return the same steps as JAX's, and the directories
  list the same finalized steps, through a live run that gains steps, a
  torn async write (never served), a step deleted between listing and
  loading, a torn finalized step, ``initial_step``, a missing directory
  and a fatal error on the daemon thread (``alive`` false,
  ``watcher_stopped`` counted); the ``ServingMetrics`` totals match;
- ``ServingConfig(watch=True)`` over a packed QuickNet (the popcount
  path) swaps a step that lands while it serves: its answers equal a cold
  load of that step bit for bit, and teardown stops the watcher.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import logging
import shutil
import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.serving import CheckpointWatcher as JaxWatcher
from zookeeper_tpu.serving import InferenceEngine as JaxEngine
from zookeeper_tpu.serving import ServingMetrics as JaxMetrics
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.serving import (
    CheckpointWatcher,
    InferenceEngine,
    ServingConfig,
    ServingMetrics,
)
from zookeeper_tpu_torch.training.checkpoint import load_into_module

FEATURES, CLASSES = 6, 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


_BUILT = {}


def build(hidden=(16,), seed=0):
    """``(JAX module, JAX params, port module)`` of an Mlp on the same
    weights (built once per geometry and seed)."""
    key = (tuple(hidden), seed)
    if key not in _BUILT:
        from zookeeper_tpu.models.simple import Mlp as JaxMlp
        from zookeeper_tpu_torch.models.simple import Mlp

        jm = JaxMlp()
        jax_configure(jm, {"hidden_units": tuple(hidden)}, name="model")
        jmod = jm.build((FEATURES,), CLASSES)
        params, _ = jm.initialize(jmod, (FEATURES,), seed=seed)
        pm = Mlp()
        configure(pm, {"hidden_units": tuple(hidden)}, name="model")
        _BUILT[key] = (jmod, params, pm, _flat(params))
    jmod, params, pm, flat = _BUILT[key]
    mod = pm.build((FEATURES,), CLASSES)
    load_into_module(mod, flat, {})
    return jmod, params, mod, flat


def engine_of(side, model):
    jmod, params, mod, _ = model
    if side == "jax":
        engine = JaxEngine()
        jax_configure(engine, {"batch_buckets": (4,)}, name="engine")
        engine.bind(jmod.apply, params, {}, (FEATURES,))
    else:
        engine = InferenceEngine()
        configure(engine, {"batch_buckets": (4,)}, name="engine")
        engine.bind(mod, (FEATURES,), device="cpu")
    engine.warmup()
    return engine


def weights(side, model):
    return (model[1], {}) if side == "jax" else (model[3], {})


def infer(engine, x):
    out = engine.infer(x)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def save_step(side, directory, model, step, **conf):
    """Save ``model``'s weights as training step ``step`` with the
    package's own ``Checkpointer``; returns it (closed)."""
    if side == "jax":
        import jax.numpy as jnp
        import optax

        from zookeeper_tpu.training import Checkpointer, TrainState

        ckpt = Checkpointer()
        jax_configure(ckpt, {"directory": str(directory), "synchronous": True, **conf},
                      name="ckpt")
        state = TrainState.create(apply_fn=model[0].apply, params=model[1], model_state={},
                                  tx=optax.sgd(0.1)).replace(step=jnp.asarray(step))
    else:
        from zookeeper_tpu_torch.training import Checkpointer
        from zookeeper_tpu_torch.training.optimizer import Sgd
        from zookeeper_tpu_torch.training.state import TrainState

        ckpt = Checkpointer()
        configure(ckpt, {"directory": str(directory), **conf}, name="ckpt")
        opt = Sgd()
        configure(opt, {}, name="optimizer")
        tx = opt.build(total_steps=1)
        state = TrainState(step=step, module=model[2], tx=tx,
                           opt_state=tx.init(dict(model[2].named_parameters())))
    ckpt.save(state, step=step)
    ckpt.wait()
    ckpt.close()
    return ckpt


def finalized(side, directory):
    if side == "jax":
        from zookeeper_tpu.training import finalized_steps
    else:
        from zookeeper_tpu_torch.training.checkpoint import finalized_steps
    return finalized_steps(str(directory))


def metrics_of(side):
    m = (JaxMetrics if side == "jax" else ServingMetrics)()
    (jax_configure if side == "jax" else configure)(m, {}, name="metrics")
    return m


SIDES = ("port", "jax")
X = np.random.default_rng(1).normal(size=(4, FEATURES)).astype(np.float32)


def _close(port, jax_out):
    np.testing.assert_allclose(port, jax_out, rtol=0, atol=1e-6 * np.abs(jax_out).max())


# -- swap_weights ------------------------------------------------------------------


def test_swap_weights_bit_identical_no_recompile():
    """A swap serves what a cold bind of the new weights serves, warms
    nothing new, and really takes; the port's outputs are JAX's."""
    m1, m2 = build(seed=0), build(seed=1)
    got = {}
    for side in SIDES:
        engine = engine_of(side, m1)
        warm = engine.warmed_buckets if side == "port" else engine.compile_count
        out1 = infer(engine, X[:3])
        engine.swap_weights(*weights(side, m2))
        out2 = infer(engine, X[:3])
        assert (engine.warmed_buckets if side == "port" else engine.compile_count) == warm
        cold = infer(engine_of(side, m2), X[:3])
        assert np.array_equal(out2, cold) and not np.array_equal(out1, out2)
        got[side] = out2
    _close(got["port"], got["jax"])


def test_swap_weights_rejects_mismatched_trees():
    m1 = build()
    for side in SIDES:
        engine = engine_of(side, m1)
        with pytest.raises(ValueError, match="shape/dtype mismatch"):
            engine.swap_weights(*weights(side, build(hidden=(32,))))
        with pytest.raises(ValueError, match="does not match the bound"):
            engine.swap_weights(*weights(side, build(hidden=(16, 16))))


# -- the watcher --------------------------------------------------------------------


def test_watch_checkpoints_live_swap_matches_cold_load(tmp_path):
    """Polls swap steps 1 then 2 in; each time the live outputs equal a
    cold load of the step (bitwise in the port, JAX's within rounding),
    no bucket is warmed again, and the metrics name the live step."""
    m1, m2, m_init = build(seed=0), build(seed=1), build(seed=2)
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        engine = engine_of(side, m_init)
        metrics = metrics_of(side)
        watch = engine.watch_checkpoints(str(d), weights="raw", metrics=metrics, start=False)
        polls = [watch.poll_once(), watch.poll_once()]
        live1 = infer(engine, X)
        save_step(side, d, m2, 2)
        polls.append(watch.poll_once())
        live2 = infer(engine, X)
        assert np.array_equal(live1, infer(engine_of(side, m1), X))
        assert np.array_equal(live2, infer(engine_of(side, m2), X))
        totals = metrics.totals
        got[side] = (polls, watch.current_step, finalized(side, d), live2,
                     {k: totals[k] for k in ("weight_swaps", "serving_weights_step",
                                             "watcher_stopped")},
                     "weight_swap_ms_mean" in metrics.snapshot())
    assert got["port"][:3] == got["jax"][:3] == ([1, None, 2], 2, [1, 2])
    assert got["port"][4] == got["jax"][4] and got["port"][5] and got["jax"][5]
    _close(got["port"][3], got["jax"][3])


def test_watcher_never_serves_unfinalized_steps(tmp_path):
    """A torn async write of step 2 is invisible: only step 1 is listed
    and served."""
    m1 = build()
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        if side == "jax":
            from zookeeper_tpu.resilience import FaultPlan, faults
        else:
            from zookeeper_tpu_torch.resilience import FaultPlan, faults
        with faults.injected(FaultPlan(kill_during_async_write=2)):
            save_step(side, d, m1, 2, mode="async")
        watch = engine_of(side, m1).watch_checkpoints(str(d), weights="raw", start=False)
        got[side] = (finalized(side, d), watch.poll_once(), watch.poll_once())
    assert got["port"] == got["jax"] == ([1], 1, None)


def test_watcher_tolerates_step_vanishing_between_list_and_load(tmp_path):
    """Retention deleting the newest step between listing and loading:
    that poll is skipped (a warning), the next serves the survivor."""
    m1, m2 = build(seed=0), build(seed=1)
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        save_step(side, d, m2, 2)
        watch = engine_of(side, m1).watch_checkpoints(str(d), weights="raw", start=False)
        if side == "jax":
            from zookeeper_tpu.training import checkpoint as ckpt_mod
        else:
            from zookeeper_tpu_torch.training import checkpoint as ckpt_mod
        orig = ckpt_mod.load_inference_model
        raced = {"done": False}

        def racing_load(path, _orig=orig, _raced=raced, _d=d, **kwargs):
            if kwargs.get("step") == 2 and not _raced["done"]:
                _raced["done"] = True
                shutil.rmtree(str(_d / "2"))
            return _orig(path, **kwargs)

        with mock.patch.object(ckpt_mod, "load_inference_model", racing_load):
            first = watch.poll_once()
        got[side] = (first, raced["done"], watch.poll_once())
    assert got["port"] == got["jax"] == (None, True, 1)


def test_watcher_threaded_start_stop_and_bad_config(tmp_path):
    """The daemon poller swaps the step in with no explicit poll, and
    ``stop()`` is idempotent; an unknown ``weights`` and a zero interval
    raise JAX's errors."""
    m1 = build()
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        engine = engine_of(side, m1)
        watch = engine.watch_checkpoints(str(d), weights="raw", poll_interval_s=0.01)
        try:
            deadline = time.perf_counter() + 30
            while watch.current_step != 1 and time.perf_counter() < deadline:
                time.sleep(0.01)
            assert watch.current_step == 1 and watch.alive
        finally:
            watch.stop()
            watch.stop()
        assert not watch.alive
        cls = JaxWatcher if side == "jax" else CheckpointWatcher
        with pytest.raises(ValueError, match="unknown"):
            cls(engine, str(d), weights="fastest")
        with pytest.raises(ValueError, match="poll_interval_s"):
            cls(engine, str(d), poll_interval_s=0)


def test_watcher_survives_torn_finalized_step(tmp_path):
    """A finalized but torn step is retried, never fatal, and the next
    good step swaps in."""
    m1, m2 = build(seed=0), build(seed=1)
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        save_step(side, d, m2, 2)
        if side == "jax":
            from zookeeper_tpu.resilience import corrupt_checkpoint_dir
        else:
            from zookeeper_tpu_torch.resilience import corrupt_checkpoint_dir
        assert corrupt_checkpoint_dir(str(d / "2")) > 0
        watch = engine_of(side, m1).watch_checkpoints(str(d), weights="raw", start=False)
        first = watch.poll_once()
        stopped = watch._stop.is_set()
        save_step(side, d, m2, 3)
        got[side] = (first, stopped, watch.poll_once())
    assert got["port"] == got["jax"] == (None, False, 3)


def test_watch_start_surfaces_config_errors_at_call_site(tmp_path):
    """``weights="ema"`` against a run without an EMA raises at
    ``watch_checkpoints(start=True)``."""
    m1 = build()
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        with pytest.raises(ValueError, match="no ema_params"):
            engine_of(side, m1).watch_checkpoints(str(d), weights="ema")


def test_watcher_initial_step_and_missing_directory(tmp_path, caplog):
    """``initial_step`` marks the bound step live with no swap counted; a
    newer step swaps. A directory that does not exist yet warns and the
    first save streams in."""
    m1, m2 = build(seed=0), build(seed=1)
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        engine = engine_of(side, m1)
        metrics = metrics_of(side)
        watch = engine.watch_checkpoints(str(d), weights="raw", metrics=metrics, start=False,
                                         initial_step=1)
        first = watch.poll_once()
        at_start = (metrics.totals["weight_swaps"], metrics.totals["serving_weights_step"])
        save_step(side, d, m2, 2)
        second = (watch.poll_once(), metrics.totals["weight_swaps"])
        late = tmp_path / f"{side}_not_yet"
        caplog.clear()
        logger = "zookeeper_tpu.serving.engine" if side == "jax" \
            else "zookeeper_tpu_torch.serving.engine"
        with caplog.at_level(logging.WARNING, logger):
            watch = engine.watch_checkpoints(str(late), weights="raw", start=False)
        warned = any("does not exist" in r.message for r in caplog.records)
        empty = watch.poll_once()
        save_step(side, late, m1, 1)
        got[side] = (first, at_start, second, warned, empty, watch.poll_once())
    assert got["port"] == got["jax"] == (None, (0, 1), (2, 1), True, None, 1)


def test_dead_watcher_is_observable(tmp_path):
    """A run restarted with another architecture into the directory: the
    daemon's swap fails fatally, ``alive`` turns false, ``watcher_stopped``
    is counted and the live step stays frozen."""
    m1, deep = build(), build(hidden=(16, 16))
    got = {}
    for side in SIDES:
        d = tmp_path / side
        save_step(side, d, m1, 1)
        metrics = metrics_of(side)
        watch = engine_of(side, m1).watch_checkpoints(
            str(d), weights="raw", metrics=metrics, poll_interval_s=0.01, initial_step=1)
        alive = watch.alive
        save_step(side, d, deep, 2)
        deadline = time.perf_counter() + 30
        while watch.alive and time.perf_counter() < deadline:
            time.sleep(0.01)
        got[side] = (alive, watch.alive, metrics.totals["watcher_stopped"], watch.current_step)
        watch.stop()
    assert got["port"] == got["jax"] == (True, False, 1, 1)


# -- ServingConfig(watch=True) -------------------------------------------------------


PACKED = {"model": "QuickNet", "model.blocks_per_section": (1, 1, 1, 1),
          "model.section_features": (32, 32, 64, 64), "model.binary_compute": "xnor_popcount",
          "model.packed_weights": True, "model.fold_bn": True, "engine.batch_buckets": (1, 4),
          "height": 16, "width": 16, "num_classes": 10, "weights": "raw", "device": "cpu",
          "verbose": False}


def test_serving_config_watch_swaps_a_packed_model_bit_for_bit(tmp_path):
    """A packed QuickNet served with ``watch=True`` over a ``Checkpointer``
    directory: the step listed before the load is the baseline (no swap
    at start), a step that lands while it serves is swapped in, the
    answers then equal a cold load of that step bit for bit, the status
    follows, and teardown stops the watcher."""
    import zookeeper_tpu_torch.models  # noqa: F401  (registers QuickNet)

    def packed(seed):
        cfg = ServingConfig()
        configure(cfg, dict(PACKED), name="serving")
        module = cfg.model.build(cfg.input_shape, cfg.num_classes)
        cfg.model.initialize(module, seed=seed)
        return (None, None, module, None)

    save_step("port", tmp_path, packed(0), 1)
    cfg = ServingConfig()
    configure(cfg, {**PACKED, "checkpoint": str(tmp_path), "watch": True,
                    "watch_poll_s": 3600.0}, name="serving")
    engine, _ = cfg.build_service()
    try:
        assert cfg.watcher.current_step == 1 and cfg.metrics.totals["weight_swaps"] == 0
        x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32)
        before = engine.infer(x)
        save_step("port", tmp_path, packed(1), 2)
        assert cfg.watcher.poll_once() == 2
        live = engine.infer(x)
        status = cfg.status()
        assert status["watcher_alive"] is True and status["serving_weights_step"] == 2
        assert status["packed_deployment"] is True
    finally:
        cfg._teardown_service()
    assert not cfg.watcher.alive
    cold = ServingConfig()
    configure(cold, {**PACKED, "checkpoint": str(tmp_path)}, name="serving")
    cold_engine, batcher = cold.build_service()
    try:
        assert torch.equal(live, cold_engine.infer(x)) and not torch.equal(before, live)
    finally:
        batcher.close()
    assert cfg.metrics.totals["weight_swaps"] == 1
