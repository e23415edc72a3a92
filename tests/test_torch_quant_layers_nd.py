"""The rest of the port's Quant layers against the flax layers:
``QuantConvND``/``1D``/``3D``, ``QuantLocallyConnectedND``/``1D``/``2D``,
``QuantConvTranspose``, ``QuantDepthwiseConv``, ``QuantSeparableConvND``/
``1D`` and ``QuantSeparableConv``.

Each case initializes the flax layer from a seed, carries its parameters
into the port through ``from_flax_variables`` (the port's layer under the
flax layer's scope; the tree of the port's layer must come back with
flax's scopes and shapes) and runs both on the same seeded input. Where
the operands are quantized to +-1 (``ste_sign`` on both), every sum is a
small integer, exact in any order, and the outputs are held bit for bit;
with float operands, within 1e-5 of the largest output (XLA and oneDNN
order the sums differently). The int8 transposed conv's gradients
(float transposed-conv VJPs of +-1 operands against a seeded cotangent)
are held within 1e-5 of their largest magnitude.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from zookeeper_tpu.ops import layers as jl
from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops import layers as pl

Q = {"input_quantizer": "ste_sign", "kernel_quantizer": "ste_sign"}


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def _pair(jlayer, player, x, seed=0):
    """Init the flax layer on ``x``, load its params into the port layer
    (checking the port's tree against flax's); returns (flax variables,
    the port layer's holder)."""
    variables = jlayer.init(jax.random.key(seed), jnp.asarray(x))
    scope = f"{type(jlayer).__name__}_0"
    holder = nn.Module()
    holder.add_module(scope, player)
    params, _ = to_flax_variables(holder)
    assert _shapes(params[scope]) == _shapes(variables["params"])
    holder.load_state_dict(from_flax_variables({scope: variables["params"]}))
    return variables, holder


def _run(jlayer, player, x, exact, seed=0):
    variables, _ = _pair(jlayer, player, x, seed)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    tbc.reset_launches()
    with torch.no_grad():
        got = player(torch.from_numpy(x)).numpy()
    assert sum(tbc.LAUNCHES.values()) == 0
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    return got


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


CONV_ND = [
    # (jax class, port class, input shape, features, kwargs, exact)
    ("QuantConv1D", (2, 16, 12), 8, {"kernel_size": (3,), **Q, "binary_compute": "int8"}, True),
    ("QuantConv1D", (2, 16, 12), 8, {"kernel_size": (3,), "strides": (2,), **Q}, True),
    ("QuantConv1D", (2, 15, 12), 8, {"kernel_size": (5,), "padding": ((2, 1),),
                                     "kernel_dilation": (2,)}, False),
    ("QuantConv1D", (2, 16, 12), 6, {"kernel_size": (3,), "feature_group_count": 3, **Q,
                                     "binary_compute": "int8", "padding": "VALID"}, True),
    ("QuantConv3D", (2, 5, 6, 6, 8), 4, {**Q, "binary_compute": "int8"}, True),
    ("QuantConv3D", (2, 5, 6, 6, 8), 4, {"strides": (2, 1, 2)}, False),
    ("QuantConvND", (2, 7, 9, 5), 4, {"kernel_size": (3, 2), "padding": ((1, 0), (0, 2))}, False),
]


@pytest.mark.parametrize("name,shape,features,kw,exact", CONV_ND,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONV_ND)])
def test_conv_nd_matches_flax(name, shape, features, kw, exact):
    jlayer = getattr(jl, name)(features, **kw)
    player = getattr(pl, name)(shape[-1], features, **kw)
    _run(jlayer, player, _x(shape), exact)


def test_conv1d_equals_conv2d_on_a_height1_embedding():
    x = _x((2, 16, 8))
    c1 = pl.QuantConv1D(8, 4, (3,), **Q)
    c2 = pl.QuantConv(8, 4, (1, 3), **Q)
    with torch.no_grad():
        c1.kernel.copy_(torch.from_numpy(_x((3, 8, 4), 2)))
        c2.kernel.copy_(c1.kernel[None])
        y1 = c1(torch.from_numpy(x))
        y2 = c2(torch.from_numpy(x)[:, None])
    assert torch.equal(y1, y2[:, 0])


LOCAL = [
    ("QuantLocallyConnected2D", (2, 7, 6, 3), {"padding": "VALID"}),
    ("QuantLocallyConnected2D", (2, 7, 6, 3), {"padding": "SAME", "strides": (2, 2)}),
    ("QuantLocallyConnected2D", (2, 7, 6, 3), {"padding": ((1, 0), (0, 2)), "strides": (1, 2)}),
    ("QuantLocallyConnected1D", (3, 9, 4), {"strides": (2,), "padding": "SAME"}),
    ("QuantLocallyConnectedND", (2, 5, 4, 4, 2), {"kernel_size": (2, 3, 2), "use_bias": False}),
]


@pytest.mark.parametrize("name,shape,kw", LOCAL, ids=[f"{c[0]}-{i}" for i, c in enumerate(LOCAL)])
def test_locally_connected_matches_flax(name, shape, kw):
    """Unshared weights, the per-position bias, XLA's patch order (channel
    major, then the window)."""
    jlayer = getattr(jl, name)(5, **kw)
    player = getattr(pl, name)(shape[-1], 5, shape[1:-1], **kw)
    got = _run(jlayer, player, _x(shape), False)
    assert tuple(player.latent.shape[:-2]) == got.shape[1:-1]


def test_locally_connected_quantized_forward_and_gradient():
    x = _x((2, 6, 6, 3))
    jlayer = jl.QuantLocallyConnected2D(4, (3, 3), **Q)
    player = pl.QuantLocallyConnected2D(3, 4, (6, 6), (3, 3), **Q)
    variables, _ = _pair(jlayer, player, x)
    g = _x((2, 4, 4, 4), 3)
    want_dx = np.asarray(jax.grad(
        lambda xx: (jlayer.apply(variables, xx) * g).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = player(xt)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jlayer.apply(variables, jnp.asarray(x))))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-5 * np.abs(want_dx).max())


TRANSPOSE = [
    ((2, 5, 5, 6), {"strides": (2, 2), "padding": "SAME"}),
    ((2, 5, 5, 6), {"strides": (2, 2), "padding": "VALID"}),
    ((2, 4, 5, 6), {"kernel_size": (2, 3), "strides": (3, 1), "padding": "SAME"}),
    ((2, 7, 6), {"kernel_size": (3,), "strides": (2,), "padding": "SAME"}),
    ((2, 5, 5, 6), {"strides": (2, 2), "padding": ((1, 2), (0, 1))}),
]


@pytest.mark.parametrize("mode", ["mxu", "int8"])
@pytest.mark.parametrize("shape,kw", TRANSPOSE, ids=[str(i) for i in range(len(TRANSPOSE))])
def test_conv_transpose_matches_flax(shape, kw, mode):
    if mode == "int8" and not isinstance(kw["padding"], str):
        with pytest.raises(ValueError, match="padding"):
            pl.QuantConvTranspose(shape[-1], 4, binary_compute=mode, **Q, **kw)
        return
    jlayer = jl.QuantConvTranspose(4, **Q, binary_compute=mode, **kw)
    player = pl.QuantConvTranspose(shape[-1], 4, **Q, binary_compute=mode, **kw)
    _run(jlayer, player, _x(shape), True)


@pytest.mark.parametrize("scaled", [True, False])
def test_int8_conv_transpose_gradients_match_jax(scaled):
    from zookeeper_tpu.ops.binary_compute import int8_conv_transpose as jax_int8_convt

    rng = np.random.default_rng(4)
    x = np.where(rng.random((2, 5, 5, 6)) < 0.5, -1.0, 1.0).astype(np.float32)
    k = np.where(rng.random((3, 3, 6, 4)) < 0.5, -1.0, 1.0).astype(np.float32)
    if scaled:
        k = k * rng.uniform(0.3, 1.2, 4).astype(np.float32)
    for padding in ("SAME", "VALID"):
        y, vjp = jax.vjp(lambda a, b: jax_int8_convt(a, b, (2, 2), padding, scaled),
                         jnp.asarray(x), jnp.asarray(k))
        g = _x(y.shape, 5)
        want_dx, want_dk = vjp(jnp.asarray(g))
        xt = torch.tensor(x, requires_grad=True)
        kt = torch.tensor(k, requires_grad=True)
        got = tbc.int8_conv_transpose(xt, kt, (2, 2), padding, scaled)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
        got.backward(torch.from_numpy(g))
        for a, b in ((xt.grad, want_dx), (kt.grad, want_dk)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("mode,mult", [("mxu", 1), ("int8", 2)])
def test_depthwise_matches_flax(mode, mult):
    jlayer = jl.QuantDepthwiseConv(channel_multiplier=mult, strides=(2, 2), **Q,
                                   binary_compute=mode)
    player = pl.QuantDepthwiseConv(6, mult, strides=(2, 2), **Q, binary_compute=mode)
    _run(jlayer, player, _x((2, 7, 7, 6)), True)
    assert player.QuantConv_0.kernel.shape == (3, 3, 1, 6 * mult)


@pytest.mark.parametrize("pointwise", ["mxu", "int8", "xnor", "xnor_popcount"])
def test_separable_conv_matches_flax(pointwise):
    """The depthwise stage on "mxu", the intermediate re-binarized, the
    1x1 pointwise stage on every QuantConv path (on "xnor_popcount" a 1x1
    K1 + K3, ci 40 padded to 64 with +1 bits)."""
    kw = {"input_quantizer": "ste_sign", "depthwise_quantizer": "ste_sign",
          "pointwise_quantizer": "ste_sign", "intermediate_quantizer": "ste_sign",
          "channel_multiplier": 2, "pointwise_compute": pointwise}
    jlayer = jl.QuantSeparableConv(8, pallas_interpret=True, **kw)
    player = pl.QuantSeparableConv(20, 8, **kw)
    _run(jlayer, player, _x((2, 6, 6, 20)), True)


def test_separable_conv1d_matches_flax():
    kw = {"kernel_size": (3,), "input_quantizer": "ste_sign",
          "depthwise_quantizer": "ste_sign", "pointwise_quantizer": "ste_sign",
          "intermediate_quantizer": "ste_sign", "depthwise_compute": "int8",
          "pointwise_compute": "int8", "use_bias": True}
    jlayer = jl.QuantSeparableConv1D(7, **kw)
    player = pl.QuantSeparableConv1D(5, 7, **kw)
    _run(jlayer, player, _x((2, 11, 5)), True)
    with pytest.raises(ValueError, match="spatial dim"):
        pl.QuantSeparableConv1D(5, 7, kernel_size=(3, 3))


def test_nd_layers_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="2-D-specific"):
        pl.QuantConv1D(8, 4, binary_compute="xnor", **Q)
    with pytest.raises(ValueError, match="spatial dim"):
        pl.QuantConv1D(8, 4, kernel_size=(3, 3))
    with pytest.raises(ValueError, match="must match kernel_size rank"):
        pl.QuantConv3D(8, 4, strides=(1, 1))
    with pytest.raises(ValueError, match="only supported with binary_compute='mxu'"):
        pl.QuantConv1D(8, 4, kernel_dilation=(2,), binary_compute="int8", **Q)
    with pytest.raises(ValueError, match="input rank"):
        pl.QuantConv1D(8, 4)(torch.zeros(2, 4, 4, 8))
    with pytest.raises(ValueError, match="not supported"):
        pl.QuantLocallyConnected2D(3, 4, (6, 6), binary_compute="int8", **Q)
    with pytest.raises(ValueError, match="expects a rank-4"):
        pl.QuantLocallyConnected2D(3, 4, (6,))
    with pytest.raises(ValueError, match="nothing for the packed kernels"):
        pl.QuantDepthwiseConv(6, binary_compute="xnor_popcount", **Q)
    with pytest.raises(ValueError, match="forward conv only"):
        pl.QuantConvTranspose(6, 4, binary_compute="xnor", **Q)
    with pytest.raises(ValueError, match="never falls back silently"):
        pl.QuantConv1D(8, 4, binary_compute="int8")


def test_nd_kernels_match_the_binary_param_pattern():
    """The sign-read latent kernels of the new layers are the paths
    ``BINARY_KERNEL_PATTERN`` names (what the summary counts as binary);
    unquantized ones are ``kernel_fp`` and are not."""
    pattern = re.compile(pl.BINARY_KERNEL_PATTERN)
    holder = nn.Module()
    for name, layer in (("QuantConv1D_0", pl.QuantConv1D(8, 4, **Q)),
                        ("QuantConvTranspose_0", pl.QuantConvTranspose(8, 4, **Q)),
                        ("QuantSeparableConv_0", pl.QuantSeparableConv(
                            8, 4, depthwise_quantizer="ste_sign")),
                        ("QuantLocallyConnected2D_0", pl.QuantLocallyConnected2D(8, 4, (5, 5)))):
        holder.add_module(name, layer)
    paths = ["/".join(k.split(".")) for k in holder.state_dict()]
    binary = sorted(p for p in paths if pattern.search(p))
    assert binary == ["QuantConv1D_0/kernel", "QuantConvTranspose_0/kernel",
                      "QuantSeparableConv_0/QuantDepthwiseConv_0/QuantConv_0/kernel"]
    assert "QuantSeparableConv_0/QuantConv_0/kernel_fp" in paths
