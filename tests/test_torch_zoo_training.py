"""Training the ResNet-topology binary zoo in the port against the JAX
package: one Bi-Real-Net int8 step (approx_sign inputs, magnitude_aware_sign
kernels) from the same state, and the train-state converter on nested
block scopes.

The JAX step runs ``make_train_step`` of a BiRealNet with
``binary_compute="int8"`` (the JAX module has no ``pack_residuals`` field;
1-bit residuals change no number, which the port's own on/off comparison
checks bit for bit). The loss is held to 2e-5 relative and each gradient
to 1e-4 of its largest magnitude: XLA and oneDNN order the fp convs' and
BatchNorms' float sums differently, and ``magnitude_aware_sign``'s means
differ by a few ulps. Those differences could flip a binary conv's input
sign only within ~1e-6 of 0, so the test asserts that no such input on
the port's side lies within 1e-5 of 0 (approx_sign's gradient is
continuous at |x| = 1, so its mask edge moves nothing).
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu import models as jax_models
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import smoothed_softmax_cross_entropy as jax_smoothed_loss
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import (
    flax_train_state,
    from_flax_variables,
    load_flax_train_state,
)
from zookeeper_tpu_torch.ops import binary_compute as bc
from zookeeper_tpu_torch.ops.layers import QuantConv
from zookeeper_tpu_torch.training import Adam as PortAdam
from zookeeper_tpu_torch.training import TrainState as PortTrainState
from zookeeper_tpu_torch.training import make_train_step as port_make_train_step
from zookeeper_tpu_torch.training import smoothed_softmax_cross_entropy as port_smoothed_loss

R18 = {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64)}
CONF = {**R18, "binary_compute": "int8"}
SHAPE = (32, 32, 3)
CLASSES = 10
LR = 1e-3


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _adam(cls):
    opt = cls()
    configure = jax_configure if cls is JaxAdam else port_configure
    configure(opt, {"schedule": "ConstantSchedule", "schedule.base_lr": LR}, name="optimizer")
    return opt


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_state_numpy(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {
        "step": np.array(state.step), "params": _numpy_tree(state.params),
        "model_state": _numpy_tree(state.model_state),
        "adam": {"count": np.array(adam.count), "mu": _numpy_tree(adam.mu),
                 "nu": _numpy_tree(adam.nu)},
    }


def _port_state(family, conf, start):
    model = getattr(port_models, family)()
    port_configure(model, conf, name="model")
    state = PortTrainState.create(model.build(SHAPE, CLASSES), _adam(PortAdam).build(10))
    return load_flax_train_state(state, **start)


@functools.lru_cache(maxsize=1)
def _jax_step():
    model = jax_models.BiRealNet()
    jax_configure(model, CONF, name="model")
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=3))()
    state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                 model_state=model_state, tx=_adam(JaxAdam).build(10))
    rng = np.random.default_rng(11)
    batch = {"input": rng.normal(size=(4, *SHAPE)).astype(np.float32),
             "target": rng.integers(0, CLASSES, size=4).astype(np.int32)}
    loss_fn = jax_smoothed_loss(0.1)

    def compute_loss(p):
        logits, _ = module.apply({"params": p, **state.model_state}, jnp.asarray(batch["input"]),
                                 training=True, mutable=["batch_stats"])
        return loss_fn(logits, jnp.asarray(batch["target"]))

    grads = jax.jit(jax.grad(compute_loss))(state.params)
    new_state, metrics = jax.jit(jax_make_train_step(loss_fn))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (_jax_state_numpy(state), batch, _numpy_tree(grads), _jax_state_numpy(new_state),
            {k: float(v) for k, v in metrics.items()})


def _port_step(state, batch):
    """One port step; returns (metrics, gradients, module state after)."""
    grads = {}
    update = state.tx.update

    def spy(g, opt_state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, opt_state, params)

    state.tx.update = spy
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].detach().abs().min().item()))
        for m in state.module.modules() if isinstance(m, QuantConv)]
    state, metrics = port_make_train_step(port_smoothed_loss(0.1))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for h in handles:
        h.remove()
    assert len(seen) == 4 and min(seen) > 1e-5, "a binary conv input lies within rounding of 0"
    after = {k: v.detach().clone() for k, v in state.module.state_dict().items()}
    return metrics, grads, after


def test_bireal_int8_step_matches_jax_and_packed_residuals_change_nothing():
    start, batch, jax_grads, jax_new, jax_metrics = _jax_step()
    runs = {}
    for pack in (True, False):
        state = _port_state("BiRealNet", {**CONF, "pack_residuals": pack}, start)
        bc.reset_launches()
        runs[pack] = _port_step(state, batch)
        assert sum(bc.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    (metrics, grads, after), (metrics_off, grads_off, after_off) = runs[True], runs[False]

    np.testing.assert_allclose(float(metrics["loss"]), jax_metrics["loss"], rtol=2e-5)
    want = from_flax_variables(jax_grads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g.numpy(), want[name].numpy(), 1e-4)
    # The latent kernels are named as flax names them, nested in blocks.
    assert "_BiRealBlock_0.QuantConv_0.kernel" in grads
    assert "_BiRealBlock_0.Conv_0.weight" in grads  # 64 -> 8: the shortcut conv

    # 1-bit residuals (K6 on the conv inputs, K7 in the backward; approx_sign
    # keeps its float input, so no K8) change no bit.
    assert torch.equal(metrics["loss"], metrics_off["loss"])
    for name in grads:
        assert torch.equal(grads[name], grads_off[name]), name
    for name in after:
        assert torch.equal(after[name], after_off[name]), name

    # The parameters after the step, in flax's tree: Adam's first step moves
    # a weight by lr * g / (|g| + eps), about lr * sign(g): within lr * 1e-3
    # of JAX's where |g| is clear of both eps (> 1e-6) and the gradients'
    # tolerance (> 1e-4 of the leaf's largest, so the signs agree); where it
    # is not, both moves lie in [-lr, lr].
    state = _port_state("BiRealNet", CONF, start)
    state.module.load_state_dict(after)
    got = flax_train_state(state)

    def leaf(tree, path):
        return functools.reduce(lambda t, k: t[k.key], path, tree)

    for path, w in jax.tree_util.tree_leaves_with_path(jax_new["params"]):
        g = np.abs(leaf(jax_grads, path))
        atol = np.where((g > 1e-6) & (g > 1e-4 * g.max()), LR * 1e-3, 2 * LR)
        assert (np.abs(leaf(got["params"], path) - w) <= atol).all(), str(path)


@pytest.mark.parametrize("family,conf", [
    ("BiRealNet", CONF),
    ("ReActNet", {"features": (8, 16, 16, 32), "strides": (1, 2, 1)}),
    ("RealToBinaryNet", R18),
    ("ResNet50", {"blocks_per_section": (1, 1, 1, 1), "width": 8}),
])
def test_train_state_converter_round_trips_nested_scopes(family, conf):
    """A JAX train state (params, batch_stats, Adam's count, mu and nu,
    all nested in block scopes) loads into the port and comes back leaf
    for leaf; moments set in the port survive a second round trip."""
    model = getattr(jax_models, family)()
    jax_configure(model, conf, name="model")
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=1))()
    jstate = JaxTrainState.create(apply_fn=module.apply, params=params,
                                  model_state=model_state, tx=_adam(JaxAdam).build(10))
    start = _jax_state_numpy(jstate)
    state = _port_state(family, conf, start)
    tree = flax_train_state(state)
    for key in ("params", "model_state"):
        for path, w in jax.tree_util.tree_leaves_with_path(start[key]):
            g = functools.reduce(lambda t, k: t[k.key], path, tree[key])
            np.testing.assert_array_equal(g, w)
    with torch.no_grad():
        for i, t in enumerate(state.opt_state["mu"].values()):
            t.fill_(0.25 * i)
    state.step, state.opt_state["count"] = 7, 7
    other = _port_state(family, conf, flax_train_state(state))
    assert other.step == 7 and other.opt_state["count"] == 7
    a, b = state.module.state_dict(), other.module.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    for name, t in state.opt_state["mu"].items():
        assert torch.equal(t, other.opt_state["mu"][name])
