"""The train step's recipe options in the port against JAX's
``make_train_step``: distillation, the parameter EMA, the flip ratio,
``nan_policy`` and the remat policies, with Bop (Adam on the fp side) on
a small BinaryNet (features (8, 8, 16, 16), one 32-unit dense layer,
16x16x3, "mxu") distilled from a SimpleCnn teacher.

Tolerances are ``test_torch_zoo_training.py``'s: the loss (and
``kd_loss``) within 2e-5 relative, each gradient within 1e-4 of its
largest magnitude, BatchNorm statistics within 2e-5 relative; XLA and
oneDNN order the fp convs' and BatchNorms' sums differently. ``flip_ratio``
and ``skipped_steps`` are equal. Bop's memory is ``gamma * g`` after one
step, so its flips could differ only where ``|m|`` lies within the
gradients' tolerance of the threshold: the threshold is put where its
distance to every one of JAX's ``|m|`` values is more than twice that
value's tolerance (asserted); the binary kernels after the
step are then equal to JAX's bit for bit. The binary layers' inputs are
asserted clear of 0 and +-1 by more than 1e-5. Inside the port every
remat policy gives the same bits as "none" (loss, gradients, parameters,
statistics, optimizer state, EMA), on "mxu" and on the popcount path
(``xnor_conv`` under the checkpoint), and a NaN batch leaves every state
tensor as it was.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from zookeeper_tpu import models as jax_models
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.training import Bop as JaxBop
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import kd_divergence as jax_kd
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import softmax_cross_entropy as jax_ce
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import (
    flax_train_state,
    from_flax_variables,
    load_flax_train_state,
)
from zookeeper_tpu_torch.ops import layers as port_layers
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN, QuantConv, QuantDense
from zookeeper_tpu_torch.training import Bop as PortBop
from zookeeper_tpu_torch.training import TrainState as PortTrainState
from zookeeper_tpu_torch.training import kd_divergence as port_kd
from zookeeper_tpu_torch.training import make_train_step as port_make_train_step

STUDENT = {"features": (8, 8, 16, 16), "dense_units": (32,)}
TEACHER = {"features": (8, 16), "dense_units": (32,)}
SHAPE, CLASSES, BATCH = (16, 16, 3), 10, 8
ALPHA, TEMPERATURE, GAMMA, LR, EMA = 0.4, 2.0, 0.05, 1e-3, 0.9


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _prune(tree):
    """A tree without optax's MaskedNode leaves and the scopes they empty."""
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
    """The JAX Bop state as the port's dict under optax's names."""
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
    return {"step": np.array(state.step), "params": _numpy(state.params),
            "model_state": _numpy(state.model_state), "opt_state": _opt_state(state.opt_state),
            "ema_params": _numpy(state.ema_params)}


def _bop(cls, threshold):
    opt = cls()
    (jax_configure if cls is JaxBop else port_configure)(opt, {
        "threshold": float(threshold), "gamma": GAMMA, "fp_optimizer.schedule.base_lr": LR,
    }, name="optimizer")
    return opt


def _batch(seed=5, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BATCH, *SHAPE)).astype(np.float32)
    if nan:
        x[1, 3, 4, 0] = np.nan
    return {"input": x, "target": rng.integers(0, CLASSES, size=BATCH).astype(np.int32)}


def _clear_threshold(values, tols):
    """A threshold between the 20th and 80th percentiles of ``values``
    whose distance to every value is the largest multiple of that value's
    tolerance; asserted to be more than 2."""
    order = np.argsort(values)
    v, tol = values[order], tols[order]
    lo, hi = int(0.2 * len(v)), int(0.8 * len(v))
    candidates = (v[lo:hi] + v[lo + 1:hi + 1]) / 2
    margins = np.array([np.min(np.abs(v - t) / tol) for t in candidates])
    best = int(np.argmax(margins))
    assert margins[best] > 2
    return np.float32(candidates[best])


@functools.lru_cache(maxsize=1)
def _jax_setup():
    student, teacher = jax_models.BinaryNet(), jax_models.SimpleCnn()
    jax_configure(student, STUDENT, name="model")
    jax_configure(teacher, TEACHER, name="teacher")
    smod, tmod = student.build(SHAPE, num_classes=CLASSES), teacher.build(SHAPE, num_classes=CLASSES)
    params, model_state = student.initialize(smod, SHAPE, seed=3)
    tparams, tstate = teacher.initialize(tmod, SHAPE, seed=4)
    tvars = {"params": tparams, **tstate}
    teacher_fn = lambda x: tmod.apply(tvars, x, training=False)  # noqa: E731
    batch = _batch()

    def compute_loss(p):
        logits, _ = smod.apply({"params": p, **model_state}, jnp.asarray(batch["input"]),
                               training=True, mutable=["batch_stats"])
        hard = jax_ce(logits, jnp.asarray(batch["target"]))
        kd = jax_kd(logits, teacher_fn(jnp.asarray(batch["input"])), TEMPERATURE)
        return ALPHA * hard + (1 - ALPHA) * kd

    grads = _numpy(jax.grad(compute_loss)(params))
    pattern = re.compile(BINARY_KERNEL_PATTERN)
    binary = {p: g for p, g in traverse_util.flatten_dict(grads, sep="/").items()
              if pattern.search(p)}
    # Bop's memory after one step is gamma * g: the threshold sits farther
    # than twice the gradients' tolerance from every |m|.
    values = np.concatenate([GAMMA * np.abs(g).ravel() for g in binary.values()])
    tols = np.concatenate([np.full(g.size, GAMMA * 1e-4 * np.abs(g).max()) for g in binary.values()])
    threshold = _clear_threshold(values, tols)
    return smod, params, model_state, teacher_fn, (tparams, tstate), grads, threshold


def _jax_step(remat="none", nan_policy="skip", nan=False):
    smod, params, model_state, teacher_fn, _, _, threshold = _jax_setup()
    state = JaxTrainState.create(apply_fn=smod.apply, params=params, model_state=model_state,
                                 tx=_bop(JaxBop, threshold).build(10), ema=True)
    step = jax_make_train_step(jax_ce, flip_ratio_pattern=BINARY_KERNEL_PATTERN,
                               distill=(teacher_fn, ALPHA, TEMPERATURE), ema_decay=EMA,
                               remat=remat, nan_policy=nan_policy)
    batch = _batch(nan=nan)
    new, metrics = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (_jax_numpy_state(state), _jax_numpy_state(new),
            {k: float(v) for k, v in metrics.items()}, batch)


def _port_state(start):
    *_, (tparams, tstate), _, threshold = _jax_setup()
    student, teacher = port_models.BinaryNet(), port_models.SimpleCnn()
    port_configure(student, STUDENT, name="model")
    port_configure(teacher, TEACHER, name="teacher")
    state = PortTrainState.create(student.build(SHAPE, CLASSES),
                                  _bop(PortBop, threshold).build(10), ema=True)
    load_flax_train_state(state, **start)
    tmod = teacher.build(SHAPE, CLASSES)
    tmod.load_state_dict(from_flax_variables(tparams, tstate))
    return state, tmod.eval()


def _port_step(state, teacher, batch, remat="none", nan_policy="skip"):
    grads = {}
    update = state.tx.update

    def spy(g, opt_state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, opt_state, params)

    state.tx.update = spy
    seen = []
    handles = [m.register_forward_pre_hook(lambda _, a: seen.append(
        min(a[0].abs().min().item(), (a[0].abs() - 1).abs().min().item())))
        for m in state.module.modules() if isinstance(m, (QuantConv, QuantDense))]
    step = port_make_train_step(flip_ratio_pattern=BINARY_KERNEL_PATTERN,
                                distill=(teacher, ALPHA, TEMPERATURE), ema_decay=EMA,
                                remat=remat, nan_policy=nan_policy)
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for h in handles:
        h.remove()
    del state.tx.update
    return metrics, grads, seen


def _leaf(tree, path):
    return functools.reduce(lambda t, k: t[k], path.split("/"), tree)


@pytest.mark.parametrize("remat", ["none", "dots", "full", "quant"])
def test_distill_bop_ema_flip_step_matches_jax(remat):
    start, new, jmetrics, batch = _jax_step(remat=remat)
    *_, jgrads, threshold = _jax_setup()
    state, teacher = _port_state(start)
    metrics, grads, seen = _port_step(state, teacher, batch, remat=remat)
    assert min(seen) > 1e-5, "a binary layer's input lies within rounding of 0 or +-1"

    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"], rtol=2e-5)
    np.testing.assert_allclose(float(metrics["kd_loss"]), jmetrics["kd_loss"], rtol=2e-5)
    assert float(metrics["accuracy"]) == jmetrics["accuracy"]
    assert float(metrics["skipped_steps"]) == jmetrics["skipped_steps"] == 0.0
    assert float(metrics["flip_ratio"]) == jmetrics["flip_ratio"]
    assert 0.05 < jmetrics["flip_ratio"] < 0.95
    want = from_flax_variables(jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g.numpy(), want[name].numpy(), 1e-4)

    got = flax_train_state(state)
    pattern = re.compile(BINARY_KERNEL_PATTERN)
    flat_g = traverse_util.flatten_dict(jgrads, sep="/")
    for path, w in traverse_util.flatten_dict(new["params"], sep="/").items():
        p = _leaf(got["params"], path)
        if pattern.search(path):
            # Bop's flips: -w or w, exactly as JAX.
            assert np.array_equal(p.view(np.int32), w.view(np.int32)), path
            np.testing.assert_allclose(_leaf(got["opt_state"]["binary"]["gradient_memory"], path),
                                       GAMMA * flat_g[path], rtol=0,
                                       atol=GAMMA * 1e-4 * np.abs(flat_g[path]).max())
        else:
            # Adam's first step moves a weight by about lr * sign(g).
            g = np.abs(flat_g[path])
            atol = np.where((g > 1e-6) & (g > 1e-4 * g.max()), LR * 1e-3, 2 * LR)
            assert (np.abs(p - w) <= atol).all(), path
        e, we = _leaf(got["ema_params"], path), _leaf(new["ema_params"], path)
        np.testing.assert_allclose(e, we, rtol=1e-6, atol=(1 - EMA) * 2 * LR, err_msg=path)
    for path, v in traverse_util.flatten_dict(new["model_state"], sep="/").items():
        _close(_leaf(got["model_state"], path), v, 2e-5)
    assert int(got["opt_state"]["binary"]["count"]) == int(new["opt_state"]["binary"]["count"]) == 1
    assert int(got["opt_state"]["fp"]["count"]) == 1


@pytest.mark.parametrize("nan_policy", ["skip", "halt"])
def test_nan_batch_is_skipped_like_jax(nan_policy):
    start, new, jmetrics, batch = _jax_step(nan_policy=nan_policy, nan=True)
    assert jmetrics["skipped_steps"] == 1.0
    state, teacher = _port_state(start)
    before = flax_train_state(state)
    metrics, _, _ = _port_step(state, teacher, batch, nan_policy=nan_policy)
    assert float(metrics["skipped_steps"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    after = flax_train_state(state)
    assert int(after["step"]) == int(new["step"]) == 1  # the step count advances
    for key in ("params", "model_state", "ema_params"):
        for path, v in traverse_util.flatten_dict(before[key], sep="/").items():
            assert np.array_equal(v.view(np.int32), _leaf(after[key], path).view(np.int32))
    # The optimizer's counts stayed, on the card's side.
    for side in ("binary", "fp"):
        count = state.opt_state[side]["count"]
        assert isinstance(count, torch.Tensor) and int(count) == 0


def test_kd_divergence_matches_jax():
    rng = np.random.default_rng(2)
    s, t = rng.normal(size=(2, 6, 10)).astype(np.float32) * 3
    want = float(jax_kd(jnp.asarray(s), jnp.asarray(t), 2.5))
    got = float(port_kd(torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(t), 2.5))
    want_bf16 = float(jax_kd(jnp.asarray(s, jnp.bfloat16), jnp.asarray(t), 2.5))
    np.testing.assert_allclose(got, want_bf16, rtol=1e-6)
    np.testing.assert_allclose(float(port_kd(torch.from_numpy(s), torch.from_numpy(t), 2.5)),
                               want, rtol=1e-6)


def _bireal_state(binary_compute):
    model = port_models.BiRealNet()
    port_configure(model, {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64),
                           "binary_compute": binary_compute}, name="model")
    module = model.build((32, 32, 3), CLASSES)
    model.initialize(module, seed=2)
    opt = PortBop()
    port_configure(opt, {"threshold": 1e-6, "gamma": 0.1}, name="optimizer")
    return PortTrainState.create(module, opt.build(10), ema=True)


def _everything(state):
    out = {f"m {k}": v.detach().clone() for k, v in state.module.state_dict().items()}
    out.update({f"e {k}": v.clone() for k, v in state.ema_params.items()})
    from zookeeper_tpu_torch.training.optimizer import state_tensors

    out.update({f"o {i}": t.clone() for i, t in enumerate(state_tensors(state.opt_state))})
    return out


@pytest.mark.parametrize("binary_compute", ["mxu", "xnor_popcount"])
def test_remat_policies_give_the_bits_of_none(binary_compute, monkeypatch):
    rng = np.random.default_rng(8)
    batch = {"input": torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32)),
             "target": torch.from_numpy(rng.integers(0, CLASSES, size=4).astype(np.int32))}
    tagged = []
    counted = port_layers.tag_quant_act

    def count_tags(x):
        y = counted(x)
        tagged.append(y is not x)
        return y

    monkeypatch.setattr(port_layers, "tag_quant_act", count_tags)
    runs = {}
    for remat in ("none", "dots", "full", "quant"):
        state = _bireal_state(binary_compute)
        grads = {}
        update = state.tx.update
        state.tx.update = lambda g, o, p: (grads.update({k: v.clone() for k, v in g.items()}),
                                           update(g, o, p))[1]
        tagged.clear()
        _, metrics = port_make_train_step(ema_decay=0.9, nan_policy="skip", remat=remat,
                                          flip_ratio_pattern=BINARY_KERNEL_PATTERN)(state, batch)
        # "quant" tags each binary conv's input once in the forward and once
        # in the recompute; the other policies tag nothing.
        convs = sum(isinstance(m, QuantConv) for m in state.module.modules())
        assert tagged.count(True) == (2 * convs if remat == "quant" else 0), (remat, tagged)
        runs[remat] = (metrics, grads, _everything(state))
    metrics0, grads0, after0 = runs["none"]
    assert float(metrics0["flip_ratio"]) > 0
    for remat in ("dots", "full", "quant"):
        metrics, grads, after = runs[remat]
        for k in metrics0:
            assert torch.equal(metrics[k], metrics0[k]), (remat, k)
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), (remat, k)
        for k in after0:
            assert torch.equal(after[k], after0[k]), (remat, k)
