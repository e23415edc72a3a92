"""The port's packed QuantConv layer and QuickNet against the JAX ones.

The layer is compared bit for bit: sign, an exact integer sum and one
fp32 multiply (plus the bias add) are the same operations on both sides.
The whole model is compared within ``1e-4 * max|logit|``: its fp stem,
blurpool, 1x1 transitions, BatchNorms and head round differently in XLA
and in PyTorch. Those differences are ~1e-6 relative, so they could only
flip a binary conv's sign where its input lies within about that of
zero; the test asserts that no binary conv input on the port's side lies
within 1e-4 of zero, so the seeded inputs are clear of that case.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.ops.binary_compute import pack_conv_kernel as jax_pack_conv_kernel
from zookeeper_tpu.ops.layers import QuantConv as JaxQuantConv
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import QuickNet as PortQuickNet
from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from zookeeper_tpu_torch.ops.layers import QuantConv as PortQuantConv

CONF = {"blocks_per_section": (1, 1, 1, 1), "section_features": (32, 32, 64, 64)}
SHAPE = (32, 32, 3)
CLASSES = 10


def _jax_flavor(mode):
    """The JAX flavor that runs its Pallas kernels: the fused kernels on
    the popcount path; the "xnor" path runs its one kernel under any
    flavor (and warns when "pallas" is named)."""
    return "pallas" if mode == "xnor_popcount" else "auto"


# -- the packed layer --------------------------------------------------------


@pytest.mark.parametrize(
    "mode,dtype,strides,padding,use_bias",
    [
        ("xnor_popcount", "float32", (1, 1), "SAME", True),
        ("xnor_popcount", "bfloat16", (2, 2), "VALID", False),
        ("xnor", "float32", (2, 2), "SAME", False),
        ("xnor", "bfloat16", (1, 1), "SAME", True),
    ],
)
def test_packed_quantconv_layer_bitwise(mode, dtype, strides, padding, use_bias):
    rng = np.random.default_rng(len(mode) + len(dtype) + strides[0])
    ci, co = 40, 24
    x = rng.normal(size=(2, 9, 8, ci)).astype(np.float32)
    x[0, 0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]  # sign edge cases
    scale = (np.abs(rng.normal(size=co)) + 0.1).astype(np.float32)
    q = np.where(rng.random((3, 3, ci, co)) < 0.5, -1.0, 1.0).astype(np.float32) * scale
    packed, kscale = (np.array(a) for a in jax_pack_conv_kernel(jnp.asarray(q)))
    bias = rng.normal(size=co).astype(np.float32)
    params = {"kernel_packed": packed, "kernel_scale": kscale}
    if use_bias:
        params["bias"] = bias

    jax_layer = JaxQuantConv(
        co, (3, 3), strides=strides, padding=padding,
        input_quantizer="ste_sign", kernel_quantizer="ste_sign",
        use_bias=use_bias, dtype=getattr(jnp, dtype), binary_compute=mode,
        packed_weights=True, pallas_interpret=True, binary_flavor=_jax_flavor(mode),
    )
    want = jax_layer.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype)))

    layer = PortQuantConv(
        ci, co, (3, 3), strides=strides, padding=padding, use_bias=use_bias,
        dtype=getattr(torch, dtype), binary_compute=mode, packed_weights=True,
    )
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.inference_mode():
        got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


# -- the whole model ---------------------------------------------------------


def _port_model(**conf):
    model = PortQuickNet()
    port_configure(model, {**CONF, **conf}, name="model")
    return model


def _jax_model(**conf):
    model = JaxQuickNet()
    jax_configure(model, {**CONF, **conf}, name="model")
    return model


def _fill(shapes, rng):
    """Seeded values for a flax shape tree: BN scale/var in [0.5, 1.5],
    BN bias/mean in [-0.3, 0.3], other leaves normal / sqrt(fan-in)."""
    out = {}
    for scope, leaves in shapes.items():
        out[scope] = {}
        for name, s in leaves.items():
            if name in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, s.shape)
            elif name in ("bias", "mean"):
                v = rng.uniform(-0.3, 0.3, s.shape)
            else:
                v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            out[scope][name] = v.astype(np.float32)
    return out


@functools.lru_cache(maxsize=1)  # read-only: the converters copy
def _trained_like():
    """A float QuickNet tree as flax lays it out (names, nesting, HWIO and
    [in, out] layouts from the JAX module's own init, traced with
    ``jax.eval_shape``), filled with seeded values, scopes in flax
    creation order (the port module's order; eval_shape sorts them)."""
    model = _jax_model()
    module = model.build(SHAPE, num_classes=CLASSES)
    params, state = jax.eval_shape(lambda: model.initialize(module, SHAPE, seed=5))
    rng = np.random.default_rng(1)
    params, stats = _fill(params, rng), _fill(state["batch_stats"], rng)
    order = [n for n, _ in _port_model(binary_compute="xnor").build(SHAPE, CLASSES).named_children()]
    assert sorted(order) == sorted(params)
    return {k: params[k] for k in order}, {k: stats[k] for k in order if k in stats}


@pytest.mark.parametrize("mode", ["xnor_popcount", "xnor"])
def test_quicknet_logits_match_jax(mode):
    params, stats = _trained_like()
    packed, packed_stats = jax_pack(params, fold_bn=True, batch_stats=stats)
    packed = {k: {n: np.array(v) for n, v in d.items()} for k, d in packed.items()}
    packed_stats = {k: {n: np.array(v) for n, v in d.items()} for k, d in packed_stats.items()}
    conf = {"binary_compute": mode, "packed_weights": True, "fold_bn": True}
    x = np.random.default_rng(2).normal(size=(3, *SHAPE)).astype(np.float32)

    jax_module = _jax_model(**conf, pallas_interpret=True, binary_flavor=_jax_flavor(mode)).build(
        SHAPE, num_classes=CLASSES
    )
    want = np.asarray(jax.jit(
        lambda v, xb: jax_module.apply(v, xb, training=False)
    )({"params": packed, "batch_stats": packed_stats}, jnp.asarray(x)))

    module = _port_model(**conf).build(SHAPE, CLASSES)
    module.load_state_dict(from_flax_variables(packed, {"batch_stats": packed_stats}))
    closest = []
    for name, sub in module.named_children():
        if name.startswith("QuantConv"):
            sub.register_forward_pre_hook(
                lambda _, args: closest.append(args[0].abs().min().item())
            )
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert min(closest) > 1e-4, "a binary conv input lies within rounding of zero"
    assert got.shape == (3, CLASSES) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_mixed_section_deployment_matches_jax():
    """int8 on the early, compute-bound sections and packed "xnor" weights
    with folded BNs on the deep ones: the template-driven pack converts
    only the packed sections, and the logits match JAX as above."""
    params, stats = _trained_like()
    conf = {"binary_compute": ("int8", "int8", "xnor", "xnor"),
            "packed_weights": (False, False, True, True), "fold_bn": True}
    jax_model = _jax_model(**conf, pallas_interpret=True)
    jax_module = jax_model.build(SHAPE, num_classes=CLASSES)
    template = jax.eval_shape(lambda: jax_model.initialize(jax_module, SHAPE, seed=0))[0]
    packed, packed_stats = jax_pack(params, template=template, fold_bn=True, batch_stats=stats)
    packed = {k: {n: np.array(v) for n, v in d.items()} for k, d in packed.items()}
    packed_stats = {k: {n: np.array(v) for n, v in d.items()} for k, d in packed_stats.items()}
    assert "kernel" in packed["QuantConv_0"] and "kernel_packed" in packed["QuantConv_3"]
    x = np.random.default_rng(2).normal(size=(3, *SHAPE)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda v, xb: jax_module.apply(v, xb, training=False)
    )({"params": packed, "batch_stats": packed_stats}, jnp.asarray(x)))

    module = _port_model(**conf).build(SHAPE, CLASSES)
    module.load_state_dict(from_flax_variables(packed, {"batch_stats": packed_stats}))
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    # Built from a seed, the same deployment serves its float twin's logits.
    model = _port_model(**conf)
    served = model.initialize(model.build(SHAPE, CLASSES), seed=4)
    assert served.QuantConv_0.kernel.abs().sum() > 0
    assert served.QuantConv_3.kernel_packed.abs().sum() > 0


def test_flax_round_trip_and_layouts():
    params, stats = _trained_like()
    module = _port_model(binary_compute="xnor").build(SHAPE, CLASSES)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    # HWIO -> OIHW (the grouped stem conv included) and [in, out] -> [out, in].
    assert module.Conv_1.weight.shape == (32, 8 // 4, 3, 3)
    np.testing.assert_array_equal(
        module.Conv_1.weight.detach().numpy(), params["Conv_1"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(module.Dense_0.weight.detach().numpy(), params["Dense_0"]["kernel"].T)
    back, back_state = to_flax_variables(module)
    assert list(back) == list(params)
    for scope in params:
        for name in params[scope]:
            np.testing.assert_array_equal(back[scope][name], params[scope][name])
    for scope in stats:
        for name in stats[scope]:
            np.testing.assert_array_equal(back_state["batch_stats"][scope][name], stats[scope][name])


@pytest.mark.parametrize("mode", ["xnor_popcount", "xnor"])
def test_packed_init_serves_the_float_twin(mode):
    """A packed build initialized from a seed holds the packed form of its
    float twin initialized from the same seed: without the BN fold, both
    compute the same logits bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, *SHAPE)).astype(np.float32))
    float_model = _port_model(binary_compute=mode)
    twin = float_model.initialize(float_model.build(SHAPE, CLASSES), seed=7)
    packed_model = _port_model(binary_compute=mode, packed_weights=True)
    packed = packed_model.initialize(packed_model.build(SHAPE, CLASSES), seed=7)
    assert packed.QuantConv_0.kernel_packed.abs().sum() > 0
    with torch.inference_mode():
        np.testing.assert_array_equal(twin(x).numpy(), packed(x).numpy())


def test_unported_modes_raise_naming_the_roadmap():
    """Every binary_compute mode builds and trains now (the xnor paths
    through ``xnor_conv``'s VJP), and a packed build still refuses a
    training forward's gradient. Every quantizer of the registry is
    ported: a name outside it raises, listing the registry."""
    for mode in ("mxu", "int8", ("int8", "int8", "xnor", "xnor")):
        _port_model(binary_compute=mode).build(SHAPE, CLASSES)
    module = _port_model(binary_compute="xnor").build(SHAPE, CLASSES).train()
    module(torch.zeros(2, *SHAPE)).sum().backward()
    assert all(p.grad is not None for p in module.parameters())
    packed = _port_model(binary_compute="xnor", packed_weights=True).build(SHAPE, CLASSES).train()
    with pytest.raises(ValueError, match="inference-only"):
        packed(torch.zeros(2, *SHAPE, requires_grad=True))
    PortQuantConv(8, 8, input_quantizer="approx_sign", kernel_quantizer="magnitude_aware_sign")
    with pytest.raises(ValueError, match="Known: .*'approx_sign'"):
        PortQuantConv(8, 8, input_quantizer="aprox_sign")
