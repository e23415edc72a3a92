"""The binary-net recipe end to end in the port, against the JAX package:
train a teacher and export it, distill a binary student from it (Bop,
the EMA, the flip ratio), score and serve the student's export.

- ``TrainMnist``/``DistillMnist``/``EvaluateMnist`` from the same start
  states and the same teacher weights (JAX's teacher export, read back
  and written in the port's format) track the JAX experiments: epoch
  losses within 1e-3 relative, as ``test_three_experiment_steps_track_jax``
  (the gradients agree to ~1e-5; a few steps move the weights by far
  less than the tolerance), eval metrics within 1e-3.
- The export holds JAX's ``save_model`` tree: the same flax paths, shapes
  and dtypes; a mismatched model raises the structure ``ValueError``, an
  empty path or a ``Checkpointer`` directory whose latest step holds no
  state ``CheckpointUnreadableError``.
- ``select_inference_weights`` answers as JAX's in all three modes; the
  train-state converter carries the EMA and Bop's, Momentum's and
  ``MultiSteps``' state both ways, leaf for leaf.
- ``ServingConfig`` serves the export: its logits equal, bit for bit, an
  engine bound to the EMA weights directly.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from zookeeper_tpu import models as jax_models
from zookeeper_tpu import training as jax_training
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.training.checkpoint import load_inference_model as jax_load_inference_model
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch import training as port_training
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import (
    flatten_tree,
    flax_train_state,
    load_flax_train_state,
)
from zookeeper_tpu_torch.resilience import NonFiniteLossError
from zookeeper_tpu_torch.serving.engine import InferenceEngine
from zookeeper_tpu_torch.serving.service import ServingConfig
from zookeeper_tpu_torch.training.checkpoint import (
    CheckpointUnreadableError,
    export_trees,
    load_model,
    save_model,
    select_inference_weights,
)
from zookeeper_tpu_torch.training.mnist import DistillMnist, EvaluateMnist, TrainMnist

STUDENT = {"model.features": (8, 8, 16, 16), "model.dense_units": (32,)}
TEACHER = {"features": (8, 16), "dense_units": (32,)}
MNIST = {
    "loader.dataset": "SyntheticMnist",
    "loader.dataset.num_train_examples": 32,
    "loader.dataset.num_validation_examples": 16,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28,
    "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1,
    "batch_size": 8,
    "seed": 1,
    "verbose": False,
}
JAX_LOADER = {"loader.host_index": 0, "loader.host_count": 1}
TEACHER_RUN = {**MNIST, "model": "SimpleCnn", **{f"model.{k}": v for k, v in TEACHER.items()},
               "optimizer.schedule.base_lr": 1e-3, "epochs": 2, "steps_per_epoch": 2,
               "validate": False}
DISTILL_RUN = {
    **MNIST, "model": "BinaryNet", **STUDENT,
    "teacher": "SimpleCnn", **{f"teacher.{k}": v for k, v in TEACHER.items()},
    "alpha": 0.4, "temperature": 2.0,
    "optimizer": "Bop", "optimizer.fp_optimizer.schedule": "ConstantSchedule",
    "optimizer.fp_optimizer.schedule.base_lr": 1e-3,
    "track_flip_ratio": True, "ema_decay": 0.9, "nan_policy": "skip",
    "epochs": 3, "steps_per_epoch": 1,
}
EVAL_RUN = dict(MNIST)


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _prune(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if v:
                out[k] = v
        elif not isinstance(v, optax.MaskedNode):
            out[k] = np.array(v)
    return out


def _opt_state(s):
    """An optax state as the port's dict under optax's names."""
    if isinstance(s, optax.MultiStepsState):
        return {"mini_step": np.array(s.mini_step), "gradient_step": np.array(s.gradient_step),
                "inner_opt_state": _opt_state(s.inner_opt_state), "acc_grads": _numpy(s.acc_grads)}
    if isinstance(s, optax.MultiTransformState):
        return {k: _opt_state(v) for k, v in s.inner_states.items()}
    if isinstance(s, optax.MaskedState):
        return _opt_state(s.inner_state)
    if hasattr(s, "_fields"):
        return {f: (_prune(v) if isinstance(v, dict) else np.array(v))
                for f, v in zip(s._fields, s)}
    out = {}
    for part in s:
        out.update(_opt_state(part))
    return out


def _jax_numpy_state(state):
    opt = _opt_state(state.opt_state)
    out = {"step": np.array(state.step), "params": _numpy(state.params),
           "model_state": _numpy(state.model_state),
           ("adam" if set(opt) == {"count", "mu", "nu"} else "opt_state"): opt}
    if state.ema_params is not None:
        out["ema_params"] = _numpy(state.ema_params)
    return out


def _from_jax_start(monkeypatch, cls, start):
    build = cls.build_state
    monkeypatch.setattr(cls, "build_state",
                        lambda self, device: load_flax_train_state(build(self, device), **start))


def _torch_flat(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def jax_recipe(tmp_path_factory):
    """The JAX package's recipe: teacher run and export, distill run and
    export, eval of the student's export; with each run's start state."""
    root = tmp_path_factory.mktemp("jax_recipe")
    teacher = jax_training.TrainingExperiment()
    jax_configure(teacher, {**TEACHER_RUN, **JAX_LOADER,
                            "export_model_to": str(root / "teacher")}, name="experiment")
    teacher_start = _jax_numpy_state(teacher.build_state())
    teacher_losses = [e["loss"] for e in teacher.run()["train"]]
    distill = jax_training.DistillationExperiment()
    jax_configure(distill, {**DISTILL_RUN, **JAX_LOADER, "teacher_checkpoint": str(root / "teacher"),
                            "export_model_to": str(root / "student")}, name="experiment")
    distill_start = _jax_numpy_state(distill.build_state())
    history = distill.run()
    evaluate = jax_training.EvalExperiment()
    jax_configure(evaluate, {**EVAL_RUN, **JAX_LOADER, "model": "BinaryNet", **STUDENT,
                             "checkpoint": str(root / "student")}, name="experiment")
    return {"root": root, "teacher_start": teacher_start, "teacher_losses": teacher_losses,
            "distill_start": distill_start, "distill": history, "eval": evaluate.run()}


def test_mnist_recipe_tracks_jax(jax_recipe, tmp_path, monkeypatch):
    # Stage 1: the teacher, from JAX's start state, exported.
    _from_jax_start(monkeypatch, TrainMnist, jax_recipe["teacher_start"])
    teacher = TrainMnist()
    port_configure(teacher, {**TEACHER_RUN, "device": "cpu",
                             "export_model_to": str(tmp_path / "teacher")}, name="experiment")
    got = [e["loss"] for e in teacher.run()["train"]]
    np.testing.assert_allclose(got, jax_recipe["teacher_losses"], rtol=1e-3)
    assert os.path.isfile(tmp_path / "teacher" / "model.pt")

    # Stage 2 distills from JAX's teacher weights, read back from its
    # export and written in the port's format.
    params, model_state = jax_load_inference_model(str(jax_recipe["root"] / "teacher"))
    save_model(str(tmp_path / "jax_teacher"), _torch_flat(params), _torch_flat(model_state))
    _from_jax_start(monkeypatch, DistillMnist, jax_recipe["distill_start"])
    distill = DistillMnist()
    port_configure(distill, {**DISTILL_RUN, "device": "cpu",
                             "teacher_checkpoint": str(tmp_path / "jax_teacher"),
                             "export_model_to": str(tmp_path / "student")}, name="experiment")
    history = distill.run()
    want = jax_recipe["distill"]
    assert len(history["train"]) == len(want["train"]) == 3
    for key in ("loss", "kd_loss"):
        np.testing.assert_allclose([e[key] for e in history["train"]],
                                   [e[key] for e in want["train"]], rtol=1e-3)
    assert [e["skipped_steps"] for e in history["train"]] == [0.0] * 3
    assert all(0.0 <= e["flip_ratio"] <= 1.0 for e in history["train"])
    np.testing.assert_allclose([e["loss"] for e in history["validation"]],
                               [e["loss"] for e in want["validation"]], rtol=1e-3)

    # Stage 3: score the student's export (the EMA weights).
    evaluate = EvaluateMnist()
    port_configure(evaluate, {**EVAL_RUN, "model": "BinaryNet", **STUDENT, "device": "cpu",
                              "checkpoint": str(tmp_path / "student")}, name="experiment")
    metrics = evaluate.run()
    assert set(metrics) == set(jax_recipe["eval"])
    for key, value in jax_recipe["eval"].items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-3, err_msg=key)
    # The export scores as the last validation (the EMA weights, the same
    # statistics) did.
    np.testing.assert_allclose(metrics["loss"], history["validation"][-1]["loss"], rtol=1e-6)


def test_teacher_is_frozen_and_in_eval_mode(tmp_path):
    distill = DistillMnist()
    port_configure(distill, {**DISTILL_RUN, "device": "cpu", "epochs": 1,
                             "allow_random_teacher": True}, name="experiment")
    teacher = distill._teacher_fn()
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    distill.run()
    assert not teacher.training
    assert all(not p.requires_grad and p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_distill_refuses_a_random_teacher_unless_asked():
    distill = DistillMnist()
    port_configure(distill, {**DISTILL_RUN, "device": "cpu"}, name="experiment")
    with pytest.raises(ValueError, match="teacher_checkpoint is not set"):
        distill.run()


def _nan_batches(real):
    def batches(self, split, *args, **kwargs):
        for i, batch in enumerate(real(self, split, *args, **kwargs)):
            if split == "train" and i == 1:
                batch = {**batch, "input": batch["input"] * float("nan")}
            yield batch

    return batches


@pytest.mark.parametrize("nan_policy", ["skip", "halt"])
def test_nan_policy_in_the_experiment(nan_policy, monkeypatch):
    from zookeeper_tpu_torch.data.pipeline import DataLoader

    monkeypatch.setattr(DataLoader, "batches", _nan_batches(DataLoader.batches))
    exp = TrainMnist()
    port_configure(exp, {**TEACHER_RUN, "device": "cpu", "nan_policy": nan_policy,
                         "epochs": 1, "steps_per_epoch": 3}, name="experiment")
    if nan_policy == "halt":
        with pytest.raises(NonFiniteLossError, match="1 step\\(s\\) skipped"):
            exp.run()
        return
    history = exp.run()
    assert history["train"][0]["skipped_steps"] == 1.0
    assert exp.final_state.step == 3
    assert all(torch.isfinite(p).all() for p in exp.final_state.module.parameters())


def test_early_stopping_and_validate_every():
    exp = TrainMnist()
    port_configure(exp, {**TEACHER_RUN, "device": "cpu", "validate": True, "epochs": 6,
                         "steps_per_epoch": 1, "optimizer.schedule.base_lr": 0.0,
                         "validate_every": 2, "early_stop_metric": "loss",
                         "early_stop_patience": 1}, name="experiment")
    history = exp.run()
    # lr 0: nothing improves; validated epochs 2 and 4, the stop at 4.
    assert len(history["train"]) == 4 and len(history["validation"]) == 2


@pytest.mark.parametrize("family,conf,shape", [
    ("SimpleCnn", TEACHER, (28, 28, 1)),
    ("BinaryNet", {"features": (8, 8, 16, 16), "dense_units": (32,)}, (28, 28, 1)),
    ("BiRealNet", {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64)},
     (32, 32, 3)),
    ("RealToBinaryNet", {"blocks_per_section": (1, 1, 1, 1),
                         "section_features": (8, 16, 32, 64)}, (32, 32, 3)),
    ("TransformerLM", {"num_layers": 1, "d_model": 16, "num_heads": 2}, (8,)),
])
def test_export_holds_the_jax_save_model_tree(family, conf, shape, tmp_path):
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(jm, conf, name="model")
    port_configure(pm, conf, name="model")
    classes = 11 if family == "TransformerLM" else 10  # an LM's vocabulary
    jmodule = jm.build(shape, num_classes=classes)
    jparams, jstate = jax.eval_shape(lambda: jm.initialize(jmodule, shape, seed=0))
    want = {"params": traverse_util.flatten_dict(jparams, sep="/"),
            "model_state": traverse_util.flatten_dict(jstate, sep="/")}
    module = pm.build(shape, classes)
    pm.initialize(module, seed=0)
    target = save_model(str(tmp_path / "export"), *export_trees(module))
    saved = torch.load(target, weights_only=True)
    assert set(saved) == {"params", "model_state"}
    for key in ("params", "model_state"):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in saved[key].items()}
        assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in want[key].items()}, key


def test_mismatched_and_unreadable_checkpoints_raise(tmp_path):
    model = port_models.BinaryNet()
    port_configure(model, {"features": (8, 8, 16, 16), "dense_units": (32,)}, name="model")
    save_model(str(tmp_path / "export"), *export_trees(model.build((28, 28, 1), 10)))
    other = port_models.BinaryNet()
    port_configure(other, {"features": (8, 8, 16, 32), "dense_units": (32,)}, name="model")
    with pytest.raises(ValueError, match="does not match the target model structure"):
        load_model(str(tmp_path / "export"), *export_trees(other.build((28, 28, 1), 10)))
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(CheckpointUnreadableError):
            load_model(str(path), {}, {})
    (tmp_path / "run" / "100").mkdir(parents=True)
    with pytest.raises(CheckpointUnreadableError):
        load_model(str(tmp_path / "run"), {}, {})


@pytest.mark.parametrize("weights", ["auto", "ema", "raw", "latest"])
@pytest.mark.parametrize("has_ema", [False, True])
def test_select_inference_weights_answers_as_jax(weights, has_ema):
    params, ema = {"w": 1}, ({"w": 2} if has_ema else None)
    try:
        want = jax_training.select_inference_weights(params, ema, weights)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            select_inference_weights(params, ema, weights)
        assert str(got.value) == str(e)
        return
    assert select_inference_weights(params, ema, weights) is want


@pytest.mark.parametrize("optimizer,conf", [
    ("Bop", {"gamma": 0.1}),
    ("Bop", {"accumulate_steps": 2}),
    ("Momentum", {"nesterov": True}),
    ("Rmsprop", {"momentum": 0.9}),
])
def test_train_state_converter_carries_ema_and_optimizer_state(optimizer, conf):
    shape, model_conf = (28, 28, 1), {"features": (8, 8, 16, 16), "dense_units": (32,)}
    jm = jax_models.BinaryNet()
    jax_configure(jm, model_conf, name="model")
    jmodule = jm.build(shape, num_classes=10)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: jm.initialize(jmodule, shape, seed=1))()
    jopt = getattr(jax_training, optimizer)()
    jax_configure(jopt, conf, name="optimizer")
    jstate = JaxTrainState.create(apply_fn=jmodule.apply, params=params, model_state=model_state,
                                  tx=jopt.build(10), ema=True)
    rng = np.random.default_rng(3)
    # Make every leaf distinct: a state a few steps in.
    jstate = jstate.replace(
        step=jstate.step + 5,
        opt_state=jax.tree.map(lambda a: a + 3 if a.dtype == np.int32 else
                               a + rng.normal(size=a.shape).astype(a.dtype), jstate.opt_state),
        ema_params=jax.tree.map(lambda a: a + 1, jstate.ema_params))
    start = _jax_numpy_state(jstate)
    pm = port_models.BinaryNet()
    port_configure(pm, model_conf, name="model")
    popt = getattr(port_training, optimizer)()
    port_configure(popt, conf, name="optimizer")
    state = port_training.TrainState.create(pm.build(shape, 10), popt.build(10), ema=True)
    load_flax_train_state(state, **start)
    back = flax_train_state(state)
    assert set(back) == set(start)

    def same(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), where

    same(back, start, "")


def test_serving_the_export_gives_the_ema_logits(tmp_path):
    distill = DistillMnist()
    port_configure(distill, {**DISTILL_RUN, "device": "cpu", "epochs": 2,
                             "allow_random_teacher": True,
                             "export_model_to": str(tmp_path / "student")}, name="experiment")
    distill.run()
    state = distill.final_state
    cfg = ServingConfig()
    port_configure(cfg, {"model": "BinaryNet", **STUDENT, "height": 28, "width": 28,
                         "channels": 1, "num_classes": 10, "device": "cpu",
                         "checkpoint": str(tmp_path / "student"), "verbose": False,
                         "engine.batch_buckets": (1, 4)}, name="serving")
    engine, batcher = cfg.build_service()
    batcher.close()
    module = cfg.model.build(cfg.input_shape, 10)
    module.load_state_dict({**state.module.state_dict(), **state.ema_params})
    direct = InferenceEngine()
    port_configure(direct, {"batch_buckets": (1, 4)}, name="engine")
    direct.bind(module, cfg.input_shape, device="cpu")
    x = np.random.default_rng(0).normal(size=(3, 28, 28, 1)).astype(np.float32)
    assert np.array_equal(engine.infer(x), direct.infer(x))
    # The export ships one set of weights (the EMA): "ema" asks for a second.
    strict = ServingConfig()
    port_configure(strict, {"model": "BinaryNet", **STUDENT, "height": 28, "width": 28,
                            "channels": 1, "num_classes": 10, "device": "cpu", "weights": "ema",
                            "checkpoint": str(tmp_path / "student")}, name="serving")
    with pytest.raises(ValueError, match="carries no ema_params"):
        strict.build_service()


def test_recipe_cli_on_the_cpu(tmp_path):
    run = lambda *args: subprocess.run(  # noqa: E731
        [sys.executable, "-m", *args], capture_output=True, text=True, timeout=300, check=True)
    small = ["device=cpu", "loader.dataset.num_train_examples=16",
             "loader.dataset.num_validation_examples=8", "batch_size=8", "epochs=1"]
    student = ["model.features=(8,8,16,16)", "model.dense_units=(32,)"]
    run("zookeeper_tpu_torch.training", "TrainMnist", *small, "model.features=(8,16)",
        f"export_model_to={tmp_path / 'teacher'}")
    out = run("zookeeper_tpu_torch.training", "DistillMnist", *small, *student,
              "teacher.features=(8,16)", f"teacher_checkpoint={tmp_path / 'teacher'}",
              "optimizer=Bop", "track_flip_ratio=True", "ema_decay=0.999", "remat=quant",
              f"export_model_to={tmp_path / 'student'}").stdout
    assert "epoch 1/1" in out
    out = run("zookeeper_tpu_torch.training", "EvaluateMnist", "device=cpu", *student,
              "model=BinaryNet", "loader.dataset.num_validation_examples=8", "batch_size=8",
              f"checkpoint={tmp_path / 'student'}").stdout
    assert "eval[validation]" in out
    out = run("zookeeper_tpu_torch.serving", "ServingConfig", "model=BinaryNet", *student,
              "height=28", "width=28", "channels=1", "num_classes=10", "device=cpu",
              "requests=4", "engine.batch_buckets=(1,4)",
              f"checkpoint={tmp_path / 'student'}").stdout
    assert '"requests": 4' in out


@pytest.mark.parametrize("task,conf", [
    (DistillMnist, {"allow_random_teacher": True}),
    (EvaluateMnist, {"checkpoint": "unused"}),
])
def test_recipe_entry_points_run_on_the_card_by_default(task, conf, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = task()
    port_configure(exp, {"verbose": False, **conf}, name="experiment")
    assert exp.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp.run()


def test_print_model_summary_reads_the_model_on_meta(capsys):
    exp = TrainMnist()
    port_configure(exp, {**TEACHER_RUN, "device": "cpu", "verbose": True, "epochs": 1,
                         "steps_per_epoch": 1, "print_model_summary": True}, name="experiment")
    exp.run()
    out = capsys.readouterr().out
    assert "Conv_0/kernel" in out and "epoch 1/1" in out
