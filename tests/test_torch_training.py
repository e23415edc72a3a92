"""The port's training path against the JAX package on the CPU.

What must be exact is compared bit for bit: the int8 conv's forward (an
exact integer sum and one fp32 multiply on both sides), its gradients
where every sum is exact (small-integer cotangents, power-of-two kernel
scales), and the port with 1-bit residuals against the port without.
The rest is compared within stated tolerances, because XLA and oneDNN
order floating-point sums differently:

- a float reduction (BatchNorm statistics, the gradient of a random
  cotangent, the loss): within 2e-5 of the largest magnitude in fp32,
  one bfloat16 ulp (2**-7) of it in bfloat16;
- a train step: differences of ~1e-6 relative could flip a binary
  conv's input sign, or its straight-through mask, where the input lies
  within that of 0 or of +-1, so each model test asserts that no such
  input on the port's side lies within 1e-5 of either;
- optimizer state after Adam: within the same relative bound as the
  gradients it comes from; parameters as ``test_train_step_matches_jax``
  states.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flax import linen as flax_nn
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu.ops.layers import QuantConv as JaxQuantConv
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu.training.schedule import WarmupCosine as JaxWarmupCosine
from zookeeper_tpu.training.schedule import CosineDecay as JaxCosineDecay
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import (
    smoothed_softmax_cross_entropy as jax_smoothed_loss,
)
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import QuickNet as PortQuickNet
from zookeeper_tpu_torch.models.convert import (
    flax_train_state,
    from_flax_variables,
    load_flax_train_state,
)
from zookeeper_tpu_torch.ops import binary_compute as bc
from zookeeper_tpu_torch.ops.layers import BatchNorm as PortBatchNorm
from zookeeper_tpu_torch.ops.layers import QuantConv as PortQuantConv
from zookeeper_tpu_torch.training import Adam as PortAdam
from zookeeper_tpu_torch.training import TrainingExperiment as PortTrainingExperiment
from zookeeper_tpu_torch.training import TrainState as PortTrainState
from zookeeper_tpu_torch.training import make_train_step as port_make_train_step
from zookeeper_tpu_torch.training import smoothed_softmax_cross_entropy as port_smoothed_loss
from zookeeper_tpu_torch.training.imagenet import TrainImageNet
from zookeeper_tpu_torch.training.schedule import CosineDecay as PortCosineDecay
from zookeeper_tpu_torch.training.schedule import WarmupCosine as PortWarmupCosine

CONF = {
    "blocks_per_section": (1, 1, 1, 1),
    "section_features": (32, 32, 64, 64),
    "binary_compute": "int8",
    "pack_residuals": True,
}
SHAPE = (32, 32, 3)
CLASSES = 10
LR = 1e-3
FP32_RTOL = 2e-5
BF16_RTOL = 2.0**-7


def _close(got, want, rtol):
    """``got`` within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


# -- int8_conv -----------------------------------------------------------------

CONV_CASES = [  # (dtype, strides, padding, groups)
    ("float32", (1, 1), "SAME", 1),
    ("float32", (2, 2), "VALID", 1),
    ("bfloat16", (2, 2), "SAME", 1),
    ("bfloat16", (1, 1), "VALID", 1),
    ("float32", (1, 1), "SAME", 4),
    ("bfloat16", (2, 2), "SAME", 2),
]


def _conv_operands(dtype, groups, seed, pow2_scale):
    rng = np.random.default_rng(seed)
    ci, co = 8, 12
    x = rng.choice([-1.0, 1.0], size=(2, 9, 9, ci)).astype(np.float32)
    if pow2_scale:
        scale = 2.0 ** rng.integers(-2, 3, size=co)
    else:
        scale = np.abs(rng.normal(size=co)) + 0.1
    k = (rng.choice([-1.0, 1.0], size=(3, 3, ci // groups, co)) * scale).astype(np.float32)
    return x, k


def _jax_int8_conv(x, k, dtype, strides, padding, groups, pack):
    def f(xx, kk):
        return jbc.int8_conv(xx, kk, strides, padding, groups, True, pack, True)

    return f, jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(k)


def _port_int8_conv(x, k, dtype, strides, padding, groups, pack):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    return bc.int8_conv(xt, kt, strides, padding, groups, True, pack), xt, kt


@pytest.mark.parametrize("dtype,strides,padding,groups", CONV_CASES)
def test_int8_conv_forward_bitwise(dtype, strides, padding, groups):
    x, k = _conv_operands(dtype, groups, seed=1, pow2_scale=False)
    f, xj, kj = _jax_int8_conv(x, k, dtype, strides, padding, groups, False)
    want = np.asarray(f(xj, kj))
    with torch.no_grad():
        got = bc.int8_conv(
            torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(k),
            strides, padding, groups,
        )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cotangent", ["integer", "random"])
@pytest.mark.parametrize("dtype,strides,padding,groups", CONV_CASES)
def test_int8_conv_grads_match_jax(dtype, strides, padding, groups, cotangent):
    """pack_residuals on both sides (K6 and K7 in the port, the Pallas
    kernels interpreted in JAX). Small-integer cotangents and power-of-
    two scales keep every sum exact: bitwise. A random cotangent: within
    the float-sum tolerance."""
    exact = cotangent == "integer"
    x, k = _conv_operands(dtype, groups, seed=2, pow2_scale=exact)
    f, xj, kj = _jax_int8_conv(x, k, dtype, strides, padding, groups, True)
    y, vjp = jax.vjp(f, xj, kj)
    rng = np.random.default_rng(3)
    if exact:
        g = rng.integers(-1, 2, size=y.shape).astype(np.float32)
    else:
        g = rng.normal(size=y.shape).astype(np.float32)
    want_dx, want_dk = vjp(jnp.asarray(g))

    out, xt, kt = _port_int8_conv(x, k, dtype, strides, padding, groups, True)
    dx, dk = torch.autograd.grad(out, (xt, kt), torch.from_numpy(g))
    assert dx.dtype == getattr(torch, dtype) and dk.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(dx.float().numpy(), _np(want_dx))
        np.testing.assert_array_equal(dk.numpy(), _np(want_dk))
    else:
        rtol = FP32_RTOL if dtype == "float32" else BF16_RTOL
        _close(dx.float().numpy(), _np(want_dx), rtol)
        _close(dk.numpy(), _np(want_dk), rtol)


@pytest.mark.parametrize("dtype,strides,padding,groups", CONV_CASES[:3])
def test_int8_conv_pack_residuals_bitwise_in_the_port(dtype, strides, padding, groups):
    x, k = _conv_operands(dtype, groups, seed=4, pow2_scale=False)
    g = torch.randn(*_port_int8_conv(x, k, dtype, strides, padding, groups, False)[0].shape)
    grads = []
    for pack in (False, True):
        out, xt, kt = _port_int8_conv(x, k, dtype, strides, padding, groups, pack)
        grads.append(torch.autograd.grad(out, (xt, kt), g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_int8_conv_pack_residuals_saves_words_not_the_input():
    x, k = _conv_operands("bfloat16", 1, seed=5, pow2_scale=False)
    out, _, _ = _port_int8_conv(x, k, "bfloat16", (1, 1), "SAME", 1, True)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.int32, torch.float32]
    assert tuple(saved[0].shape) == (1, 9, 9, 8)


# -- layers ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 5, 5, 8)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, 8).astype(np.float32)
    mean0 = rng.uniform(-0.3, 0.3, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = flax_nn.BatchNorm(
        use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=getattr(jnp, dtype)
    )
    want, updated = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x, getattr(jnp, dtype)), mutable=["batch_stats"],
    )
    port = PortBatchNorm(8, dtype=getattr(torch, dtype)).train()
    port.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0),
    })
    got = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().detach().numpy(), _np(want), FP32_RTOL if dtype == "float32" else BF16_RTOL)
    stats = updated["batch_stats"]
    _close(port.running_mean.numpy(), np.asarray(stats["mean"]), FP32_RTOL)
    _close(port.running_var.numpy(), np.asarray(stats["var"]), FP32_RTOL)


@pytest.mark.parametrize("mode", ["int8", "mxu"])
def test_weight_clip_passes_the_gradient_through(mode):
    """The read-time weight clip is a straight-through projection: latent
    weights with |w| > 1 still get the conv's gradient (a clamp would
    give them 0)."""
    rng = np.random.default_rng(7)
    ci, co = 8, 6
    kernel = (rng.normal(size=(3, 3, ci, co)) * 1.5).astype(np.float32)
    assert (np.abs(kernel) > 1).mean() > 0.25
    x = rng.normal(size=(2, 6, 6, ci)).astype(np.float32)
    g = rng.integers(-1, 2, size=(2, 6, 6, co)).astype(np.float32)
    layer = JaxQuantConv(
        co, (3, 3), input_quantizer="ste_sign", kernel_quantizer="ste_sign",
        binary_compute=mode, pallas_interpret=True,
    )

    def loss(k):
        return jnp.sum(layer.apply({"params": {"kernel": k}}, jnp.asarray(x)) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(kernel)))
    port = PortQuantConv(ci, co, (3, 3), binary_compute=mode)
    port.load_state_dict({"kernel": torch.from_numpy(kernel)})
    (port(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    got = port.kernel.grad.numpy()
    assert np.abs(want[np.abs(kernel) > 1]).max() > 0
    np.testing.assert_array_equal(got, want)  # integer sums: exact


# -- one train step and three experiment steps -------------------------------------


def _jax_model(**conf):
    model = JaxQuickNet()
    jax_configure(model, {**CONF, **conf}, name="model")
    return model


def _port_model(**conf):
    model = PortQuickNet()
    port_configure(model, {**CONF, **conf}, name="model")
    return model


def _adam(cls, conf=None):
    opt = cls()
    configure = jax_configure if cls is JaxAdam else port_configure
    configure(opt, conf or {"schedule": "ConstantSchedule", "schedule.base_lr": LR},
              name="optimizer")
    return opt


def _adam_state(opt_state):
    (adam,) = [
        s for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)
        ) if isinstance(s, optax.ScaleByAdamState)
    ]
    return adam


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_train_state_numpy(state):
    """A JAX TrainState as the numpy trees ``load_flax_train_state``
    takes."""
    adam = _adam_state(state.opt_state)
    return {
        "step": np.array(state.step),
        "params": _numpy_tree(state.params),
        "model_state": _numpy_tree(state.model_state),
        "adam": {"count": np.array(adam.count), "mu": _numpy_tree(adam.mu),
                 "nu": _numpy_tree(adam.nu)},
    }


def _port_state_from_jax(jax_numpy_state, model=None, optimizer=None):
    model = model or _port_model()
    module = model.build(SHAPE, CLASSES)
    state = PortTrainState.create(module, (optimizer or _adam(PortAdam)).build(10))
    return load_flax_train_state(state, **jax_numpy_state)


def _assert_clear_of_flips(module, margin=1e-5):
    """Forward hooks on the port's binary convs: no input within
    ``margin`` of 0 (the sign) or of +-1 (the straight-through mask)."""
    seen = []

    def hook(_, args):
        a = args[0].detach().abs()
        seen.append(min(a.min().item(), (a - 1).abs().min().item()))

    handles = [
        sub.register_forward_pre_hook(hook)
        for name, sub in module.named_children() if name.startswith("QuantConv")
    ]
    return seen, handles


@functools.lru_cache(maxsize=1)
def _jax_step_result():
    model = _jax_model()
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=3))()
    tx = _adam(JaxAdam).build(10)
    state = JaxTrainState.create(
        apply_fn=module.apply, params=params, model_state=model_state, tx=tx
    )
    rng = np.random.default_rng(33)  # a batch clear of sign flips (asserted)
    batch = {
        "input": rng.normal(size=(4, *SHAPE)).astype(np.float32),
        "target": rng.integers(0, CLASSES, size=4).astype(np.int32),
    }
    loss_fn = jax_smoothed_loss(0.1)

    def compute_loss(p):
        logits, _ = module.apply(
            {"params": p, **state.model_state}, jnp.asarray(batch["input"]),
            training=True, mutable=["batch_stats"],
        )
        return loss_fn(logits, jnp.asarray(batch["target"]))

    grads = jax.jit(jax.grad(compute_loss))(state.params)
    new_state, metrics = jax.jit(jax_make_train_step(loss_fn))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    return (_jax_train_state_numpy(state), batch, _numpy_tree(grads),
            _jax_train_state_numpy(new_state), {k: float(v) for k, v in metrics.items()})


def test_train_step_matches_jax():
    """One make_train_step step of a small int8 QuickNet with 1-bit
    residuals, from the JAX state converted across."""
    start, batch, jax_grads, jax_new, jax_metrics = _jax_step_result()
    state = _port_state_from_jax(start)
    grads = {}
    update = state.tx.update

    def spy(g, opt_state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, opt_state, params)

    state.tx.update = spy
    seen, handles = _assert_clear_of_flips(state.module)
    bc.reset_launches()
    state, metrics = port_make_train_step(port_smoothed_loss(0.1))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    for h in handles:
        h.remove()
    assert min(seen) > 1e-5, "a binary conv input lies within rounding of 0 or +-1"
    assert sum(bc.LAUNCHES.values()) == 0  # CPU tensors: plain versions only

    np.testing.assert_allclose(float(metrics["loss"]), jax_metrics["loss"], rtol=FP32_RTOL)
    assert float(metrics["accuracy"]) == jax_metrics["accuracy"]
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_metrics["grad_norm"], rtol=1e-4)
    want_grads = from_flax_variables(jax_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        _close(g.numpy(), want_grads[name].numpy(), 1e-4)

    got = flax_train_state(state)
    assert int(got["step"]) == int(jax_new["step"]) == 1
    assert int(got["adam"]["count"]) == int(jax_new["adam"]["count"]) == 1
    def leaf(tree, path):
        return functools.reduce(lambda t, k: t[k.key], path, tree)

    for path, want in jax.tree_util.tree_leaves_with_path(jax_new["params"]):
        # Adam's first step moves a weight by lr * g / (|g| + eps), about
        # lr * sign(g): within lr * 1e-3 where |g| > 1e-6, and within the
        # step's own bound lr where |g| is near eps, whose update turns
        # on the last digits of g.
        atol = np.where(np.abs(leaf(jax_grads, path)) > 1e-6, LR * 1e-3, LR)
        assert (np.abs(leaf(got["params"], path) - want) <= atol).all(), str(path)
    for path, want in jax.tree_util.tree_leaves_with_path(jax_new["model_state"]):
        _close(leaf(got["model_state"], path), want, FP32_RTOL)
    for key in ("mu", "nu"):
        for path, want in jax.tree_util.tree_leaves_with_path(jax_new["adam"][key]):
            _close(leaf(got["adam"][key], path), want, 1e-4 if key == "mu" else 2e-4)


def test_train_state_converter_round_trips():
    start, _, _, _, _ = _jax_step_result()
    state = _port_state_from_jax(start)
    with torch.no_grad():
        for i, t in enumerate(state.opt_state["mu"].values()):
            t.fill_(0.25 * i)
    state.step, state.opt_state["count"] = 7, 7
    tree = flax_train_state(state)
    other = _port_state_from_jax(tree)
    assert other.step == 7 and other.opt_state["count"] == 7
    a, b = state.module.state_dict(), other.module.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    for key in ("mu", "nu"):
        for name, t in state.opt_state[key].items():
            assert torch.equal(t, other.opt_state[key][name])


EXPERIMENT_CONF = {
    "loader.dataset": "SyntheticImageClassification",
    "loader.dataset.num_train_examples": 12,
    "loader.dataset.num_validation_examples": 4,
    "loader.dataset.image_height": 40,
    "loader.dataset.image_width": 40,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.augment": True,
    "loader.preprocessing.random_resized_crop": True,
    "loader.seed": 4,
    "model": "QuickNet",
    **{f"model.{k}": v for k, v in CONF.items()},
    "optimizer": "Adam",
    "optimizer.schedule": "ConstantSchedule",
    "optimizer.schedule.base_lr": LR,
    "epochs": 3,
    "steps_per_epoch": 1,
    "batch_size": 4,
    "seed": 2,
    "validate": False,
    "verbose": False,
}


def test_three_experiment_steps_track_jax(monkeypatch):
    """Three TrainingExperiment steps (one per epoch, so run() reports each
    step's loss) from the same initial state track JAX's losses within
    1e-3: the gradients agree to ~1e-5 and three Adam steps move each
    weight by ~lr * sign(g), so the losses drift by far less."""
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {**EXPERIMENT_CONF, "loader.host_index": 0,
                            "loader.host_count": 1}, name="experiment")
    start = _jax_train_state_numpy(jax_exp.build_state())
    want = [e["loss"] for e in jax_exp.run()["train"]]

    port_exp = PortTrainingExperiment()
    port_configure(port_exp, {**EXPERIMENT_CONF, "device": "cpu"}, name="experiment")
    build = PortTrainingExperiment.build_state
    monkeypatch.setattr(
        PortTrainingExperiment, "build_state",
        lambda self, device: load_flax_train_state(build(self, device), **start),
    )
    history = port_exp.run()
    got = [e["loss"] for e in history["train"]]
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert port_exp.final_state.step == 3


# -- schedules, optimizer and entry points --------------------------------------------


@pytest.mark.parametrize(
    "cls,conf",
    [
        ("WarmupCosine", {"base_lr": 1e-2, "warmup_steps": 3, "alpha": 0.1}),
        ("WarmupCosine", {"base_lr": 2.5e-3, "warmup_fraction": 0.25}),
        ("CosineDecay", {"base_lr": 1e-2, "alpha": 0.05}),
    ],
)
def test_schedules_match_optax(cls, conf):
    jax_s, port_s = {"WarmupCosine": (JaxWarmupCosine, PortWarmupCosine),
                     "CosineDecay": (JaxCosineDecay, PortCosineDecay)}[cls]
    js, ps = jax_s(), port_s()
    jax_configure(js, conf, name="schedule")
    port_configure(ps, conf, name="schedule")
    jf, pf = js.build(20), ps.build(20)
    want = [float(jf(jnp.int32(c))) for c in range(24)]
    got = [pf(c) for c in range(24)]
    if cls == "WarmupCosine":
        assert got[0] == 0.0  # optax's init_value=0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 0.0), (1e-2, 0.5)])
def test_adam_update_matches_optax(weight_decay, clip):
    rng = np.random.default_rng(9)
    shapes = {"a.weight": (3, 4), "b.bias": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    conf = {"schedule": "WarmupCosine", "schedule.base_lr": 1e-2,
            "schedule.warmup_steps": 2, "weight_decay": weight_decay,
            "global_clip_norm": clip}
    jtx, ptx = _adam(JaxAdam, conf).build(10), _adam(PortAdam, conf).build(10)
    jp = dict(params)
    jstate = jtx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = ptx.init(pp)
    for _ in range(4):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = jtx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.update({k: torch.from_numpy(v) for k, v in grads.items()}, pstate, pp)
    for k in shapes:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kwargs", [
    {"remat": "full"}, {"nan_policy": "skip"}, {"ema_decay": 0.99},
    {"flip_ratio_pattern": "kernel"}, {"distill": (None, 0.5, 2.0)}, {"accumulate_steps": 2},
    {"remat": "everything"}, {"nan_policy": "retry"},
])
def test_training_options_build_and_unknown_policies_raise_as_jax(kwargs):
    """The step options and accumulation build; an unknown remat or
    nan_policy raises JAX's ``ValueError``."""
    if "accumulate_steps" in kwargs:
        tx = _adam(PortAdam, kwargs).build(10)
        assert type(tx).__name__ == "MultiSteps" and tx.every_k == 2
        return
    if kwargs.get("remat") == "everything" or kwargs.get("nan_policy") == "retry":
        with pytest.raises(ValueError) as want:
            jax_make_train_step(**kwargs)
        with pytest.raises(ValueError) as got:
            port_make_train_step(**kwargs)
        assert str(got.value) == str(want.value)
        return
    assert callable(port_make_train_step(**kwargs))


def test_train_imagenet_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = TrainImageNet()
    port_configure(exp, {
        "model.blocks_per_section": (1, 1, 1, 1),
        "loader.dataset.num_train_examples": 4,
        "batch_size": 4, "verbose": False,
    }, name="experiment")
    assert exp.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp.run()
