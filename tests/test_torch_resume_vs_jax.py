"""Kill and resume in the port against the JAX package, from the same
seeded start state: each side runs a ``TrainingExperiment`` (an Adam
``Mlp``) or a ``DistillationExperiment`` (the recipe: a ``BinaryNet``
student under Bop + Adam, the EMA, the flip ratio and
``nan_policy=skip`` with ``nan_at_step``, from one teacher's weights)
under ``FaultPlan(kill_at_step=3)`` and ``run_with_recovery``.

- Both sides stop at step 3 with it saved, resume mid-epoch at
  ``start_batch`` 3 (4 steps an epoch) and finish; the per-epoch losses
  agree within 1e-3 relative and the NaN step is skipped on both sides.
- The port's finished state, through ``flax_train_state``, equals JAX's
  (read back from its last checkpoint with orbax) at the tolerances of
  ``test_torch_training.py`` and ``test_torch_step_features.py``: the step
  and every count exactly; each Adam-trained parameter within
  ``LR * 1e-3`` where the run's gradients have an RMS above 1e-6 (read from
  JAX's bias-corrected ``nu``) and within ``LR`` elsewhere; Adam's ``mu``
  and Bop's memory within 1e-4 and ``nu`` within 2e-4 of each leaf's
  largest value; BatchNorm statistics within 2e-5 of it; the binary
  kernels bit for bit; the EMA within the bound of the parameters it
  averages plus 1e-6 relative. The Adam run's step-3 checkpoint is held
  to JAX's the same way, with its paths, shapes and dtypes.
- These bounds hold only where both sides take every decision of the run
  the same way: XLA and oneDNN sum in different orders, so a ReLU input
  within rounding of 0, a binary layer's input within rounding of 0 or
  +-1, or a Bop memory within rounding of the threshold can fall on
  either side. The port's run asserts its margins: every ReLU and binary
  layer input clear by more than 1e-5 (``test_torch_step_features.py``'s
  margin), and every Bop ``|m|`` farther from the threshold, at every
  step, than the memories of the two finished runs are from each other.
  The seeds and the recipe's student are chosen so that the margins hold
  (the student has no binary dense layer: with its 25k memories, no seed
  of 1-40 cleared both margins).
- The bounds are not vacuous: a start state left untrained, zeroed
  moments, a zeroed Bop memory and an EMA replaced by the weights each
  fail them, and so does a port run whose restore zeroes the moments
  (Adam) or Bop's memory (recipe).
- ``start_batch`` gives JAX's ``batch_iterator(start_batch=)`` batches and
  its ``ValueError`` outside ``[0, num_batches)``.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import re

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax import traverse_util

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)
from zookeeper_tpu import training as jax_training
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from zookeeper_tpu.data.source import ArraySource as JaxArraySource
from zookeeper_tpu.models import SimpleCnn as JaxSimpleCnn
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu.resilience import run_with_recovery as jax_run_with_recovery
from zookeeper_tpu.training.checkpoint import save_model as jax_save_model
from zookeeper_tpu_torch import training as port_training
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.data.pipeline import batch_iterator
from zookeeper_tpu_torch.data.source import ArraySource
from zookeeper_tpu_torch.models.convert import (
    flatten_tree,
    flax_train_state,
    load_flax_train_state,
)
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN, QuantConv, QuantDense
from zookeeper_tpu_torch.resilience import FaultPlan, faults, run_with_recovery
from zookeeper_tpu_torch.training import checkpoint as port_checkpoint
from zookeeper_tpu_torch.training.checkpoint import save_model

LR = 1e-3
MNIST = {
    "loader.dataset": "SyntheticMnist",
    "loader.dataset.num_train_examples": 128,
    "loader.dataset.num_validation_examples": 0,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28,
    "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1,
    "batch_size": 32,
    "epochs": 2,
    "steps_per_epoch": 4,
    "validate": False,
    "verbose": False,
}
# The seeds and the student are chosen so that the port's run clears every
# decision by the asserted margins (see the module docstring).
ADAM_RUN = {**MNIST, "seed": 2, "model": "Mlp", "model.hidden_units": (16,),
            "optimizer.schedule.base_lr": LR}
TEACHER = {"features": (8, 16), "dense_units": (32,)}
RECIPE_RUN = {
    **MNIST, "seed": 5, "model": "BinaryNet", "model.features": (8, 8, 16, 16),
    "model.dense_units": (),
    "teacher": "SimpleCnn", **{f"teacher.{k}": v for k, v in TEACHER.items()},
    "alpha": 0.4, "temperature": 2.0,
    "optimizer": "Bop", "optimizer.fp_optimizer.schedule": "ConstantSchedule",
    "optimizer.fp_optimizer.schedule.base_lr": LR,
    "track_flip_ratio": True, "ema_decay": 0.9, "nan_policy": "skip",
}
JAX_ONLY = {"loader.host_index": 0, "loader.host_count": 1, "checkpointer.synchronous": True}
CKPT = {"checkpointer.save_every_steps": 2, "checkpointer.save_every_epochs": 1,
        "checkpointer.max_to_keep": 10}
KILL, NAN = 3, 5
BINARY = re.compile(BINARY_KERNEL_PATTERN)


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


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(_prune(tree)).items()}


def _jax_run(cls, conf, plan):
    exp = cls()
    jax_configure(exp, {**conf, **JAX_ONLY}, name="experiment")
    start = _jax_numpy_state(exp.build_state())
    with jax_faults.injected(plan):
        result = jax_run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    # The finished state as it was saved: orbax restores the last step into
    # a freshly built state.
    fresh = cls()
    jax_configure(fresh, {**conf, **JAX_ONLY}, name="experiment")
    saved = _jax_numpy_state(fresh.checkpointer.restore_state(fresh.build_state()))
    for ck in (exp.checkpointer, fresh.checkpointer):
        ck.close()
    return start, result, saved


def _port_run(cls, conf, plan, start, *, probe=None, after_step=None, fault=None):
    """The port's run from JAX's start state. ``probe(state)`` sees each
    built state, ``after_step(state)`` each trained one, and ``fault(state)``
    is planted right after every restore."""
    build, step_fn = cls.build_state, cls._train_step_fn
    assemble = port_checkpoint.Checkpointer._assemble

    def build_state(self, device):
        state = load_flax_train_state(build(self, device), **start)
        if probe is not None:
            probe(state)
        return state

    def train_step_fn(self):
        step = step_fn(self)

        def run(state, batch):
            state, metrics = step(state, batch)
            after_step(state)
            return state, metrics

        return run

    def faulty_assemble(state, tree):
        assemble(state, tree)
        fault(state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "build_state", build_state)
        if after_step is not None:
            mp.setattr(cls, "_train_step_fn", train_step_fn)
        if fault is not None:
            mp.setattr(port_checkpoint.Checkpointer, "_assemble", staticmethod(faulty_assemble))
        exp = cls()
        port_configure(exp, {**conf, "device": "cpu"}, name="experiment")
        with faults.injected(plan):
            result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    return exp, result


def _assert_same_resume(got, want):
    assert got.restarts == want.restarts == 1
    assert [(type(c).__name__, c.step, c.saved) for c in got.causes] == \
        [(type(c).__name__, c.step, c.saved) for c in want.causes] == [("Preempted", KILL, True)]
    got_h, want_h = got.history["train"], want.history["train"]
    assert len(got_h) == len(want_h) == 2  # epoch 0's last step, then epoch 1
    for g, w in zip(got_h, want_h):
        for key in w:
            if key in ("examples_per_sec", "flip_ratio"):
                continue
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3, err_msg=key)


def _relative(got, want, rtol):
    """``got`` within ``rtol`` of the largest magnitude of ``want``."""
    return np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _misses(got, want, adam):
    """The leaves of the flat state ``got`` outside their bounds around
    ``want`` (see the module docstring); ``adam`` is the prefix of the
    Adam state that trains the non-binary parameters."""
    steps = int(want[f"{adam}/count"])
    out = []
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        group, _, name = k.partition("/")
        if k == "step" or k.endswith("count"):
            ok = int(g) == int(w)
        elif group in ("params", "ema_params") and BINARY.search(name):
            ok = (np.array_equal(g, w) if group == "params"
                  else _relative(g, w, 1e-6))
        elif group in ("params", "ema_params"):
            # Adam moves a weight by about lr * m / sqrt(v): within lr * 1e-3
            # where the run's gradient RMS (the bias-corrected nu) is above
            # 1e-6, within lr where it is near eps.
            rms = np.sqrt(want[f"{adam}/nu/{name}"] / (1 - 0.999 ** steps))
            atol = np.where(rms > 1e-6, LR * 1e-3, LR)
            if group == "ema_params":
                atol = atol + 1e-6 * np.abs(w).max()
            ok = (np.abs(g - w) <= atol).all()
        elif "/mu/" in k or "/gradient_memory/" in k:
            ok = _relative(g, w, 1e-4)
        elif "/nu/" in k:
            ok = _relative(g, w, 2e-4)
        else:
            assert group == "model_state", k
            ok = _relative(g, w, 2e-5)
        if not ok:
            out.append(k)
    return out


def _replaced(flat, prefix, value):
    return {k: (value(k, v) if k.startswith(prefix) else v) for k, v in flat.items()}


def test_adam_kill_and_recover_matches_jax(tmp_path):
    conf = {**ADAM_RUN, **CKPT}
    start, want, saved = _jax_run(
        jax_training.TrainingExperiment,
        {**conf, "checkpointer.directory": str(tmp_path / "jax")}, JaxFaultPlan(kill_at_step=KILL))
    relu_inputs = []

    def probe(state):
        state.module.get_submodule("Dense_0").register_forward_hook(
            lambda _, a, out: relu_inputs.append(out.detach().abs().min().item()))

    exp, got = _port_run(port_training.TrainingExperiment,
                         {**conf, "checkpointer.directory": str(tmp_path / "port")},
                         FaultPlan(kill_at_step=KILL), start, probe=probe)
    steps = 2 * MNIST["steps_per_epoch"]
    assert len(relu_inputs) == steps and min(relu_inputs) > 1e-5, relu_inputs
    _assert_same_resume(got, want)
    final = _flat(flax_train_state(exp.final_state))
    saved = _flat(saved)
    assert {k: v.shape for k, v in final.items()} == {k: v.shape for k, v in saved.items()}
    assert int(final["step"]) == int(saved["adam/count"]) == steps
    assert _misses(final, saved, "adam") == []

    # The bounds fail a start state left untrained and zeroed moments...
    begun = _flat(start)
    assert _misses(_replaced(final, "params/", lambda k, v: begun[k]), saved, "adam")
    for moment in ("adam/mu/", "adam/nu/"):
        assert _misses(_replaced(final, moment, lambda k, v: 0 * v), saved, "adam")

    # ...and a resume whose restore zeroes the moments.
    def zero_moments(state):
        for key in ("mu", "nu"):
            for t in state.opt_state[key].values():
                t.zero_()

    faulty, _ = _port_run(port_training.TrainingExperiment,
                          {**conf, "checkpointer.directory": str(tmp_path / "faulty")},
                          FaultPlan(kill_at_step=KILL), start, fault=zero_moments)
    assert _misses(_flat(flax_train_state(faulty.final_state)), saved, "adam")

    # The step-3 checkpoint: JAX's as orbax wrote it, the port's through a
    # restore into a fresh state, in JAX's layout.
    with ocp.StandardCheckpointer() as ckptr:
        jax_step = ckptr.restore(str(tmp_path / "jax" / str(KILL) / "default"))
    fresh = port_training.TrainingExperiment()
    port_configure(fresh, {**conf, "device": "cpu", "checkpointer.directory":
                           str(tmp_path / "port")}, name="experiment")
    ck = fresh.checkpointer
    state = fresh.build_state(torch.device("cpu"))
    ck._assemble(state, ck._read_checked(KILL, "local", state))
    port_step = flax_train_state(state)
    assert port_step["step"] == KILL
    adam = jax_step["opt_state"][0]
    want_tree = {"step": jax_step["step"], "params": jax_step["params"],
                 "model_state": jax_step["model_state"], "adam": adam}
    got_tree = {"step": port_step["step"], "params": port_step["params"],
                "model_state": port_step["model_state"], "adam": port_step["adam"]}
    kinds = lambda t: {k: (v.shape, str(v.dtype)) for k, v in _flat(t).items()}  # noqa: E731
    assert kinds(got_tree) == kinds(want_tree)
    assert int(adam["count"]) == int(port_step["adam"]["count"]) == KILL
    assert _misses(_flat(got_tree), _flat(want_tree), "adam") == []


def test_recipe_kill_and_recover_matches_jax(tmp_path):
    """The recipe state: Bop's memory and count and Adam's moments and count
    under their split, the EMA, the flip ratio, and a NaN at step counter 5
    skipped after the resume on both sides."""
    teacher = JaxSimpleCnn()
    jax_configure(teacher, TEACHER, name="teacher")
    module = teacher.build((28, 28, 1), 10)
    params, model_state = teacher.initialize(module, (28, 28, 1), seed=3)
    jax_save_model(str(tmp_path / "jax_teacher"), params, model_state)
    flat = lambda t: {k: torch.from_numpy(np.array(v))  # noqa: E731
                      for k, v in traverse_util.flatten_dict(t, sep="/").items()}
    save_model(str(tmp_path / "port_teacher"), flat(params), flat(model_state))

    start, want, saved = _jax_run(
        jax_training.DistillationExperiment,
        {**RECIPE_RUN, **CKPT, "teacher_checkpoint": str(tmp_path / "jax_teacher"),
         "checkpointer.directory": str(tmp_path / "jax")},
        JaxFaultPlan(kill_at_step=KILL, nan_at_step=NAN))
    port_conf = {**RECIPE_RUN, **CKPT, "teacher_checkpoint": str(tmp_path / "port_teacher")}
    binary_inputs, memories = [], []

    def probe(state):
        for m in state.module.modules():
            if isinstance(m, (QuantConv, QuantDense)) and m.in_q is not None:
                m.register_forward_pre_hook(lambda _, a: binary_inputs.append(
                    min(a[0].abs().min().item(), (a[0].abs() - 1).abs().min().item())))

    def after_step(state):
        memories.append({k: t.clone() for k, t in state.opt_state["binary"]["gradient_memory"]
                         .items()})

    exp, got = _port_run(
        port_training.DistillationExperiment,
        {**port_conf, "checkpointer.directory": str(tmp_path / "port")},
        FaultPlan(kill_at_step=KILL, nan_at_step=NAN), start, probe=probe, after_step=after_step)
    _assert_same_resume(got, want)
    assert [e["skipped_steps"] for e in got.history["train"]] == \
        [e["skipped_steps"] for e in want.history["train"]] == [0.0, 1.0]
    final = _flat(flax_train_state(exp.final_state))
    saved = _flat(saved)
    assert {k: v.shape for k, v in final.items()} == {k: v.shape for k, v in saved.items()}
    steps = 2 * MNIST["steps_per_epoch"]
    assert int(final["step"]) == steps and int(saved["opt_state/fp/count"]) == steps - 1

    # Every decision of the run is clear: the binary layers' inputs of 0
    # and +-1, and at every step each Bop memory of the threshold by more
    # than the two finished runs' memories differ.
    assert len(binary_inputs) == 3 * steps and min(binary_inputs) > 1e-5, binary_inputs
    threshold = exp.optimizer.threshold
    assert len(memories) == steps
    for name, t in exp.final_state.opt_state["binary"]["gradient_memory"].items():
        path = "opt_state/binary/gradient_memory/" + name.replace(".", "/")
        apart = np.abs(t.numpy() - saved[path]).max()
        margin = min((m[name].abs() - threshold).abs().min().item() for m in memories)
        assert margin > apart, (path, margin, apart)

    assert _misses(final, saved, "opt_state/fp") == []
    assert any(BINARY.search(k) for k in final)
    assert 0.0 < got.history["train"][-1]["flip_ratio"] < 1.0

    # The bounds fail a zeroed Bop memory and an EMA replaced by the
    # weights...
    assert _misses(_replaced(final, "opt_state/binary/gradient_memory/", lambda k, v: 0 * v),
                   saved, "opt_state/fp")
    assert _misses(_replaced(final, "ema_params/", lambda k, v: final["params/" + k[11:]]),
                   saved, "opt_state/fp")

    # ...and a resume whose restore zeroes Bop's memory.
    def zero_memory(state):
        for t in state.opt_state["binary"]["gradient_memory"].values():
            t.zero_()

    faulty, _ = _port_run(
        port_training.DistillationExperiment,
        {**port_conf, "checkpointer.directory": str(tmp_path / "faulty")},
        FaultPlan(kill_at_step=KILL, nan_at_step=NAN), start, fault=zero_memory)
    assert _misses(_flat(flax_train_state(faulty.final_state)), saved, "opt_state/fp")


def test_start_batch_gives_jax_batches_and_errors():
    arrays = {"x": np.arange(40, dtype=np.float32).reshape(20, 2),
              "y": np.arange(20, dtype=np.int32)}
    for start_batch in range(4):
        want = list(jax_batch_iterator(JaxArraySource(arrays), None, 5, training=True, seed=7,
                                       epoch=2, start_batch=start_batch))
        got = list(batch_iterator(ArraySource(arrays), None, 5, training=True, seed=7,
                                  epoch=2, start_batch=start_batch))
        assert len(got) == len(want) == 4 - start_batch
        for g, w in zip(got, want):
            assert set(g) == set(w) and all(np.array_equal(g[k], w[k]) for k in w)
    for bad in (-1, 4, 9):
        with pytest.raises(ValueError) as want_err:
            list(jax_batch_iterator(JaxArraySource(arrays), None, 5, training=True,
                                    start_batch=bad))
        with pytest.raises(ValueError) as got_err:
            list(batch_iterator(ArraySource(arrays), None, 5, training=True, start_batch=bad))
        assert str(got_err.value) == str(want_err.value)
