"""The port's BinaryDenseNet and MeliusNet against the flax modules.

Weights are made in the flax layout from a seed (the tree's scopes,
nesting and shapes are checked against ``jax.eval_shape`` of the JAX
module's init) and carried into the port by ``from_flax_variables``; both
packages compute logits from the same seeded input, the JAX packed paths
with ``pallas_interpret=True``, the port's kernel wrappers on CPU tensors
(their plain versions).

The logits are held to ``1e-4 * max|logit|``: the fp stems, transitions,
BatchNorms and heads round differently in XLA and in PyTorch, ~1e-6
relative, which could flip a binary conv's input sign only within about
that of zero, so each comparison asserts that no binary conv's input on
the port's side lies within 1e-5 of zero. Train mode is compared the same
way, the updated running statistics within 2e-5 of their largest
magnitude. The training step is held as ``test_torch_zoo_training.py``
holds Bi-Real-Net's: the loss within 2e-5 relative, each gradient within
1e-4 of its largest magnitude (or one float32 ulp of the loss, for a
gradient that is zero in exact arithmetic, see the test), and the binary
convs' inputs asserted clear of 0 and of +-1 (ste_sign's mask edge) by
1e-5.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu import models as jax_models
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models.binary import _MeliusImprovementBlock as JaxImprovementBlock
from zookeeper_tpu.ops.layers import QuantConv as JaxQuantConv
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import smoothed_softmax_cross_entropy as jax_smoothed_loss
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.binary_dense import (
    _MeliusDenseBlock,
    _MeliusImprovementBlock,
    _round_channels,
)
from zookeeper_tpu_torch.models.convert import (
    flax_train_state,
    from_flax_variables,
    load_flax_train_state,
    to_flax_variables,
)
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops.layers import QuantConv
from zookeeper_tpu_torch.ops.packed import pack_quantconv_params as port_pack
from zookeeper_tpu_torch.training import Adam as PortAdam
from zookeeper_tpu_torch.training import TrainState as PortTrainState
from zookeeper_tpu_torch.training import make_train_step as port_make_train_step
from zookeeper_tpu_torch.training import smoothed_softmax_cross_entropy as port_smoothed_loss

DENSE = {"layers_per_block": (2, 2), "reduction": (2.0,), "dilation": (1, 1),
         "growth_rate": 16, "initial_features": 24}
FAMILIES = {
    "BinaryDenseNet28": DENSE,
    "BinaryDenseNet37Dilated": {**DENSE, "dilation": (1, 2)},
    "MeliusNet22": {"blocks_per_section": (2, 2), "transition_features": (48,),
                    "growth": 16, "stem_features": 24},
}
SHAPE = (32, 32, 3)
CLASSES = 10
MODES = ["mxu", "int8", "xnor", "xnor_popcount"]


def _models(family, conf):
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(jm, {**FAMILIES[family], **conf, "pallas_interpret": True}, name="model")
    port_configure(pm, {**FAMILIES[family], **conf}, name="model")
    return jm, pm


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def _fill(tree, rng, path=""):
    """Seeded values for a flax tree of shapes: BN scale/var in [0.5, 1.5],
    BN bias/mean in [-0.3, 0.3], other leaves normal / sqrt(fan-in)."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = _fill(v, rng, f"{path}/{key}")
            continue
        shape = tuple(v.shape)
        if key in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif key == "mean" or (key == "bias" and "BatchNorm" in path):
            x = rng.uniform(-0.3, 0.3, shape)
        else:
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]) if len(shape) > 1 else 1)
        out[key] = x.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)  # read-only: the converters copy
def _float_tree(family):
    _, pm = _models(family, {})
    params, state = to_flax_variables(pm.build(SHAPE, CLASSES))
    rng = np.random.default_rng(len(family))
    return _fill(params, rng), _fill(state["batch_stats"], rng)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_tree_is_flaxs(family):
    """Flax's scopes (DenseNet flat, Melius nested per block), leaf names
    and shapes; the converter round-trips the tree through the module."""
    jm, pm = _models(family, {})
    params, state = jax.eval_shape(lambda: jm.initialize(jm.build(SHAPE, CLASSES), SHAPE, seed=0))
    module = pm.build(SHAPE, CLASSES)
    got, got_state = to_flax_variables(module)
    assert _shapes(got) == _shapes(params)
    assert _shapes(got_state["batch_stats"]) == _shapes(state["batch_stats"])
    p, s = _float_tree(family)
    module.load_state_dict(from_flax_variables(p, {"batch_stats": s}))
    back, back_state = to_flax_variables(module)
    for a, b in ((back, p), (back_state["batch_stats"], s)):
        for path, w in jax.tree_util.tree_leaves_with_path(b):
            np.testing.assert_array_equal(
                functools.reduce(lambda t, k: t[k.key], path, a), w)
    if family == "MeliusNet22":
        assert list(got["_MeliusDenseBlock_0"]) == ["BatchNorm_0", "QuantConv_0"]
    else:
        assert [k for k in got if k.startswith("QuantConv")] == [f"QuantConv_{i}" for i in range(4)]


def _clearance_hooks(module):
    """Pre-hooks recording, for every binary conv, the least distance of
    its input to 0 and to +-1."""
    zero, one = [], []

    def hook(_, args):
        a = args[0].detach().float().abs()
        zero.append(a.min().item())
        one.append((a - 1.0).abs().min().item())

    return zero, one, [m.register_forward_pre_hook(hook) for m in module.modules()
                       if isinstance(m, QuantConv)]


def _deploy(family, conf):
    params, stats = _float_tree(family)
    if not conf.get("packed_weights"):
        return params, stats
    jm, _ = _models(family, conf)
    template = jax.eval_shape(lambda: jm.initialize(jm.build(SHAPE, CLASSES), SHAPE)[0])
    return _np_tree(jax_pack(params, template=template)), stats


def _compare(family, conf, train):
    params, stats = _deploy(family, conf)
    x = np.random.default_rng(3).normal(size=(2, *SHAPE)).astype(np.float32)
    jm, pm = _models(family, conf)
    jmod = jm.build(SHAPE, CLASSES)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, new_state = jax.jit(lambda v, xb: jmod.apply(
            v, xb, training=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        want = jax.jit(lambda v, xb: jmod.apply(v, xb, training=False))(variables, jnp.asarray(x))
    want = np.asarray(want)
    module = pm.build(SHAPE, CLASSES)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    module.train(train)
    zero, _, handles = _clearance_hooks(module)
    tbc.reset_launches()
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    for h in handles:
        h.remove()
    assert sum(tbc.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    assert zero and min(zero) > 1e-5, "a binary conv's input lies within rounding of zero"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    if train:
        _, got_state = to_flax_variables(module)
        for path, w in jax.tree_util.tree_leaves_with_path(new_state["batch_stats"]):
            g = functools.reduce(lambda t, k: t[k.key], path, got_state["batch_stats"])
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max())
    return module


CASES = [(f, m, t) for f in ("BinaryDenseNet28", "MeliusNet22") for m in MODES
         for t in (False, True)]


@pytest.mark.parametrize("family,mode,train", CASES,
                         ids=[f"{f}-{m}-{'train' if t else 'eval'}" for f, m, t in CASES])
def test_logits_match_flax(family, mode, train):
    _compare(family, {"binary_compute": mode}, train)


@pytest.mark.parametrize("mode", ["xnor_popcount", "xnor"])
def test_packed_densenet_matches_flax_and_its_float_twin(mode):
    """The packed deployment (the JAX converter's tree) against flax, and a
    seeded packed build against its float twin bit for bit."""
    _compare("BinaryDenseNet28", {"binary_compute": mode, "packed_weights": True}, False)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, *SHAPE)).astype(np.float32))
    _, pm = _models("BinaryDenseNet28", {"binary_compute": mode})
    twin = pm.initialize(pm.build(SHAPE, CLASSES), seed=7)
    _, pm = _models("BinaryDenseNet28", {"binary_compute": mode, "packed_weights": True})
    packed = pm.initialize(pm.build(SHAPE, CLASSES), seed=7)
    assert all(m.packed_weights for m in packed.modules() if isinstance(m, QuantConv))
    with torch.no_grad():
        np.testing.assert_array_equal(packed(x).numpy(), twin(x).numpy())


def test_dilated_variant_keeps_the_resolution_and_matches_flax():
    """BinaryDenseNet37Dilated with dilation (1, 2): the transition skips
    its pool, so block 2 runs at block 1's 8x8 (4x4 undilated); "mxu" is
    its only binary path."""
    module = _compare("BinaryDenseNet37Dilated", {"binary_compute": "mxu"}, False)
    sizes = []
    hooks = [m.register_forward_pre_hook(lambda _, a: sizes.append(tuple(a[0].shape[1:3])))
             for m in module.modules() if isinstance(m, QuantConv)]
    with torch.no_grad():
        module(torch.zeros(1, *SHAPE))
    for h in hooks:
        h.remove()
    assert sizes == [(8, 8)] * 4
    assert [m.kernel_dilation for m in module.modules() if isinstance(m, QuantConv)] == \
        [(1, 1)] * 2 + [(2, 2)] * 2
    _, pm = _models("BinaryDenseNet37Dilated", {"binary_compute": "xnor_popcount"})
    with pytest.raises(ValueError, match="kernel_dilation"):
        pm.build(SHAPE, CLASSES)


def test_melius_blocks():
    """The Improvement block changes only the newest ``growth`` channels,
    against the flax block's output; the Dense block grows the stack."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
    jblk = JaxImprovementBlock(growth=8, dtype=jnp.float32)
    variables = jblk.init(jax.random.key(0), jnp.asarray(x), training=False)
    want = np.asarray(jblk.apply(variables, jnp.asarray(x), training=False))
    blk = _MeliusImprovementBlock(24, 8, torch.float32)
    blk.load_state_dict(from_flax_variables(variables["params"], variables))
    blk.eval()
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[..., :16], x[..., :16])
    assert not np.allclose(got[..., 16:], x[..., 16:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    dense = _MeliusDenseBlock(24, 8, torch.float32).eval()
    with torch.no_grad():
        assert dense(torch.from_numpy(x)).shape == (2, 8, 8, 32)
    _, pm = _models("MeliusNet22", {"transition_features": (48, 64)})
    with pytest.raises(ValueError, match="one per section boundary"):
        pm.build(SHAPE, CLASSES)


def test_densenet_fold_is_refused_as_jax_refuses_it():
    """Pre-activation: no BN follows a binary conv, so both converters
    refuse to fold rather than fold the next layer's BN."""
    params, stats = _float_tree("BinaryDenseNet28")
    for pack in (jax_pack, port_pack):
        with pytest.raises(ValueError, match="does not normalize this conv's output"):
            pack(params, fold_bn=True, batch_stats=stats)
    assert _round_channels(448 / 2.7) == 160 and _round_channels(10.0) == 32


@pytest.mark.parametrize("conf,match", [
    ({"kernel_dilation": (2, 2), "binary_compute": "int8"}, "kernel_dilation"),
    ({"feature_group_count": 0}, "invalid"),
    ({"feature_group_count": 3}, "must divide"),
    ({"feature_group_count": 2, "binary_compute": "xnor"}, "grouped conv"),
])
def test_quantconv_dilation_and_group_validation_matches_jax(conf, match):
    """The same refusals, with JAX's message text, and the accepted
    dilated and grouped convs equal to flax's."""
    quant = {"input_quantizer": "ste_sign", "kernel_quantizer": "ste_sign"}
    x = jnp.zeros((1, 8, 8, 4), jnp.float32)
    with pytest.raises(ValueError, match=match):
        JaxQuantConv(8, (3, 3), **quant, **conf).init(jax.random.key(0), x)
    with pytest.raises(ValueError, match=match):
        QuantConv(4, 8, (3, 3), **quant, **conf)


@pytest.mark.parametrize("conf", [
    {"kernel_dilation": (2, 2)},
    {"feature_group_count": -1, "binary_compute": "int8"},
    {"feature_group_count": 2, "strides": (2, 2), "binary_compute": "mxu"},
    {"kernel_dilation": (2, 1), "padding": ((1, 2), (0, 1))},
], ids=["dilated", "depthwise-int8", "grouped-s2", "explicit-pads"])
def test_quantconv_dilated_and_grouped_match_flax(conf):
    quant = {"input_quantizer": "ste_sign", "kernel_quantizer": "ste_sign"}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    jlayer = JaxQuantConv(8, (3, 3), **quant, **conf)
    variables = jlayer.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    layer = QuantConv(4, 8, (3, 3), **quant, **conf)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in from_flax_variables(
        {"QuantConv_0": variables["params"]}).items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- training ---------------------------------------------------------------

TRAIN_CONF = {"binary_compute": "xnor_popcount"}
LR = 1e-3


def _adam(cls):
    opt = cls()
    configure = jax_configure if cls is JaxAdam else port_configure
    configure(opt, {"schedule": "ConstantSchedule", "schedule.base_lr": LR}, name="optimizer")
    return opt


def _jax_state_numpy(state):
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    np_tree = functools.partial(jax.tree.map, np.array)
    return {"step": np.array(state.step), "params": np_tree(state.params),
            "model_state": np_tree(state.model_state),
            "adam": {"count": np.array(adam.count), "mu": np_tree(adam.mu),
                     "nu": np_tree(adam.nu)}}


def _jax_state(family, conf, seed):
    model = getattr(jax_models, family)()
    jax_configure(model, {**FAMILIES[family], **conf, "pallas_interpret": True}, name="model")
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=seed))()
    return module, JaxTrainState.create(apply_fn=module.apply, params=params,
                                        model_state=model_state, tx=_adam(JaxAdam).build(10))


def _port_state(family, conf, start):
    _, pm = _models(family, conf)
    state = PortTrainState.create(pm.build(SHAPE, CLASSES), _adam(PortAdam).build(10))
    return load_flax_train_state(state, **start)


def test_densenet_xnor_popcount_step_matches_jax():
    """One TrainImageNet-style step (label smoothing 0.1, Adam) of a small
    DenseNet on "xnor_popcount": K1 + K3 forwards (ones-padded SAME), the
    one-padded float conv's gradients."""
    module, jstate = _jax_state("BinaryDenseNet28", TRAIN_CONF, seed=3)
    rng = np.random.default_rng(12)
    batch = {"input": rng.normal(size=(4, *SHAPE)).astype(np.float32),
             "target": rng.integers(0, CLASSES, size=4).astype(np.int32)}
    loss_fn = jax_smoothed_loss(0.1)

    def compute_loss(p):
        logits, _ = module.apply({"params": p, **jstate.model_state},
                                 jnp.asarray(batch["input"]), training=True,
                                 mutable=["batch_stats"])
        return loss_fn(logits, jnp.asarray(batch["target"]))

    jax_grads = jax.tree.map(np.array, jax.jit(jax.grad(compute_loss))(jstate.params))
    _, jax_metrics = jax.jit(jax_make_train_step(loss_fn))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = _port_state("BinaryDenseNet28", TRAIN_CONF, _jax_state_numpy(jstate))
    grads = {}
    update = state.tx.update

    def spy(g, opt_state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, opt_state, params)

    state.tx.update = spy
    zero, one, handles = _clearance_hooks(state.module)
    tbc.reset_launches()
    _, metrics = port_make_train_step(port_smoothed_loss(0.1))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for h in handles:
        h.remove()
    assert sum(tbc.LAUNCHES.values()) == 0
    assert len(zero) == 4 and min(zero) > 1e-5 and min(one) > 1e-5
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=2e-5)
    want = from_flax_variables(jax_grads)
    assert set(grads) == set(want) and "QuantConv_3.kernel" in grads
    # The stem BN's scale has a zero gradient in exact arithmetic: every
    # consumer of the stem is a batch-statistics BN (through ReLU and max
    # pool, which commute with a positive per-channel scale) and its bias
    # starts at 0. Both sides compute rounding noise there, of the order
    # of one float32 ulp of the loss, which is the floor of the tolerance.
    floor = float(np.spacing(np.float32(jax_metrics["loss"])))
    for name, g in grads.items():
        w = want[name].numpy()
        atol = max(1e-4 * np.abs(w).max(), floor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("family", ["BinaryDenseNet28", "MeliusNet22"])
def test_train_state_round_trips_through_the_converters(family):
    """A JAX train state loads into the port and comes back leaf for leaf;
    moments set in the port survive a second round trip."""
    _, jstate = _jax_state(family, {}, seed=1)
    start = _jax_state_numpy(jstate)
    state = _port_state(family, {}, start)
    tree = flax_train_state(state)
    for key in ("params", "model_state"):
        for path, w in jax.tree_util.tree_leaves_with_path(start[key]):
            np.testing.assert_array_equal(
                functools.reduce(lambda t, k: t[k.key], path, tree[key]), w)
    with torch.no_grad():
        for i, t in enumerate(state.opt_state["nu"].values()):
            t.fill_(0.5 * i)
    state.step, state.opt_state["count"] = 5, 5
    other = _port_state(family, {}, flax_train_state(state))
    assert other.step == 5 and other.opt_state["count"] == 5
    for name, t in state.opt_state["nu"].items():
        assert torch.equal(t, other.opt_state["nu"][name])
