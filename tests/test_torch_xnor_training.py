"""Training through the packed binary paths in the port against the JAX
package: ``xnor_conv`` and ``xnor_dense`` under autograd against
``jax.vjp`` of the JAX functions (their Pallas kernels in interpret mode),
the Quant layers' straight-through gradients on "xnor" and
"xnor_popcount" against flax, and the packed-weight inference paths
still refusing a gradient.

The forwards are held bit for bit: integer sums times one float32 scale
on both sides. The gradients are float convs and matmuls of the saved
quantized operands, summed in another order by XLA and by PyTorch: fp32
within 1e-5 of the largest magnitude; bf16 (the backward runs in the
activations' dtype, as the JAX package's does) within 2^-7 of it, one
bf16 rounding step either side.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu.ops.layers import QuantConv as JaxQuantConv
from zookeeper_tpu.ops.layers import QuantDense as JaxQuantDense
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops.layers import QuantConv, QuantDense

TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _scaled_kernel(rng, shape):
    """Sign x a positive per-output-channel scale: the packed kernels'
    contract."""
    return (_signs(rng, shape) * rng.uniform(0.2, 1.5, shape[-1])).astype(np.float32)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _port_vjp(fn, x, k, g, dtype):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    y = fn(xt, kt)
    y.backward(torch.tensor(g))
    return y.detach(), xt.grad.float().numpy(), kt.grad.numpy()


def _jax_vjp(fn, x, k, g, dtype):
    y, vjp = jax.vjp(fn, jnp.asarray(x, dtype), jnp.asarray(k))
    dx, dk = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx.astype(jnp.float32)), np.asarray(dk)


CONV_CASES = [
    (pop, pad, stride, dtype)
    for pop in (True, False) for pad in ("SAME", "VALID") for stride in (1, 2)
    for dtype in ("float32", "bfloat16")
]


@pytest.mark.parametrize(
    "use_popcount,padding,stride,dtype", CONV_CASES,
    ids=[f"{'popcount' if p else 'xnor'}-{pad}-s{s}-{d}" for p, pad, s, d in CONV_CASES])
def test_xnor_conv_forward_and_gradients_match_jax(use_popcount, padding, stride, dtype):
    """ci = 40 (not a multiple of 32: the pad channels' +1 bits), 7x7, so
    SAME at stride 2 pads the odd pixel after; the popcount border
    gradient is the one-padded conv's."""
    rng = np.random.default_rng(11 + stride + 2 * use_popcount)
    x = _signs(rng, (2, 7, 7, 40))
    k = _scaled_kernel(rng, (3, 3, 40, 8))
    strides = (stride, stride)
    ho = -(-7 // stride) if padding == "SAME" else (7 - 3) // stride + 1
    g = rng.normal(size=(2, ho, ho, 8)).astype(np.float32)
    flavor = "pallas" if use_popcount else "auto"
    want_y, want_dx, want_dk = _jax_vjp(
        lambda xx, kk: jbc.xnor_conv(xx, kk, strides, padding, use_popcount, True, flavor),
        x, k, g, getattr(jnp, dtype))
    tbc.reset_launches()
    got_y, got_dx, got_dk = _port_vjp(
        lambda xx, kk: tbc.xnor_conv(xx, kk, strides, padding, use_popcount, "auto"),
        x, k, g, getattr(torch, dtype))
    assert sum(tbc.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    _close(got_dx, want_dx, TOL[dtype])
    _close(got_dk, want_dk, TOL[dtype])


@pytest.mark.parametrize("flavor", ["auto", "reference", "xnor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xnor_dense_gradients_match_jax(flavor, dtype):
    """K = 100 (padded to 128 with equal +1 bits on both sides), on the
    fused flavor (K1 + K2), "reference" (pack_bits + K5) and "xnor" (K4)."""
    rng = np.random.default_rng(23)
    x = _signs(rng, (6, 100))
    k = _scaled_kernel(rng, (100, 12))
    g = rng.normal(size=(6, 12)).astype(np.float32)
    pop = flavor != "xnor"
    jax_flavor = {"auto": "pallas", "reference": "reference", "xnor": "auto"}[flavor]
    want = _jax_vjp(lambda xx, kk: jbc.xnor_dense(xx, kk, pop, True, jax_flavor),
                    x, k, g, getattr(jnp, dtype))
    got = _port_vjp(lambda xx, kk: tbc.xnor_dense(xx, kk, pop, "auto" if flavor == "xnor"
                                                  else flavor),
                    x, k, g, getattr(torch, dtype))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    _close(got[1], want[1], TOL[dtype])
    _close(got[2], want[2], TOL[dtype])


@pytest.mark.parametrize("mode", ["xnor", "xnor_popcount"])
def test_quant_layers_ste_gradients_match_flax(mode):
    """QuantConv (SAME, ci 36) and QuantDense on a packed path: the input
    through ste_sign (its mask zeroes |x| > 1), the latent kernel clipped
    straight-through and quantized; loss sum(y * g). The inputs keep clear
    of 0 and of |x| = 1, where a rounding could move the sign or the mask."""
    rng = np.random.default_rng(5)
    xc = rng.uniform(0.05, 1.6, (2, 6, 6, 36)) * _signs(rng, (2, 6, 6, 36))
    xc = xc.astype(np.float32)
    xc[np.abs(np.abs(xc) - 1.0) < 0.02] = 0.5
    kc = (rng.normal(size=(3, 3, 36, 8)) * 0.8).astype(np.float32)
    gc = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    xd = xc.reshape(2, -1)[:, :50].copy()
    kd = (rng.normal(size=(50, 7)) * 0.8).astype(np.float32)
    gd = rng.normal(size=(2, 7)).astype(np.float32)
    quant = {"input_quantizer": "ste_sign", "kernel_quantizer": "ste_sign",
             "binary_compute": mode}
    for jlayer, player, x, k, g in (
        (JaxQuantConv(8, (3, 3), pallas_interpret=True, **quant),
         QuantConv(36, 8, (3, 3), **quant), xc, kc, gc),
        (JaxQuantDense(7, use_bias=False, pallas_interpret=True, **quant),
         QuantDense(50, 7, use_bias=False, **quant), xd, kd, gd),
    ):
        def loss(params, xx):
            return (jlayer.apply({"params": params}, xx) * g).sum()

        (want_dp, want_dx) = jax.grad(loss, argnums=(0, 1))({"kernel": jnp.asarray(k)},
                                                            jnp.asarray(x))
        with torch.no_grad():
            player.kernel.copy_(torch.from_numpy(k))
        xt = torch.tensor(x, requires_grad=True)
        (player(xt) * torch.from_numpy(g)).sum().backward()
        _close(xt.grad.numpy(), want_dx, 1e-5)
        _close(player.kernel.grad.numpy(), want_dp["kernel"], 1e-5)
        assert np.count_nonzero(want_dx) < want_dx.size  # the STE mask cut some


def test_packed_weight_inference_still_refuses_a_gradient():
    rng = np.random.default_rng(9)
    packed, scale = tbc.pack_conv_kernel(torch.from_numpy(_scaled_kernel(rng, (3, 3, 32, 4))))
    x = torch.tensor(_signs(rng, (1, 5, 5, 32)), requires_grad=True)
    for pop in (True, False):
        with pytest.raises(ValueError, match="inference-only"):
            tbc.packed_conv_infer(x, packed, scale, (1, 1), "SAME", use_popcount=pop)
    dpacked, dscale = tbc.pack_dense_kernel(torch.from_numpy(_scaled_kernel(rng, (32, 4))))
    with pytest.raises(ValueError, match="inference-only"):
        tbc.packed_dense_infer(x.reshape(25, 32), dpacked, dscale, 32, use_popcount=True)
    layer = QuantConv(32, 4, binary_compute="xnor_popcount", packed_weights=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        layer(x)
    with torch.no_grad():  # the same call serves without a gradient
        assert layer(x).shape == (1, 5, 5, 4)
