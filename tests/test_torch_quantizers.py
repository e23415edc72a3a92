"""The port's quantizers and the Quant layers' validation against the JAX
package.

Elementwise quantizers (approx_sign, ste_tern with a fixed threshold,
ste_heaviside, dorefa) are compared bit for bit, forward and gradient
(``jax.vjp`` against autograd), at the edges: +-0, +-1 and their
neighbours, +-inf, NaN, the tern threshold and its neighbours, dorefa's
rounding midpoints and their neighbours. swish_sign's gradient goes
through ``exp`` and ``tanh``, whose float32 polynomials differ by an ulp
between XLA and PyTorch: in float32 it is held to 1e-6 of each value
(plus 1e-6 of the largest), in bfloat16 bit for bit. magnitude_aware_sign's
scale and TWN's threshold are float32 means (a sum times the float32
reciprocal of the count on both sides), which XLA and PyTorch sum in
different orders: the scale is held to 2e-6 relative (a few ulps), the
signs bit for bit, and with dyadic weights (sums exact in any order)
everything bit for bit.

Subnormals stay out of the comparison with JAX: XLA's CPU backend flushes
them to zero, so it reads -1e-40 as -0 (sign +1), where the port
computes in IEEE arithmetic (sign -1); a separate test pins the port's
subnormal semantics.

The layers' validation is compared over the whole registry (and None)
for both quantizers, the four binary_compute modes and both layers: the
port raises exactly where flax raises, and names the latent kernel as
flax does (``kernel`` or ``kernel_fp``).
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import layers as jl
from zookeeper_tpu.ops import quantizers as jq
from zookeeper_tpu_torch.ops import layers as pl
from zookeeper_tpu_torch.ops import quantizers as pq

DTYPES = ["float32", "bfloat16"]
ONE_UP = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
EDGES = [0.0, -0.0, 1.0, -1.0, ONE_UP, -ONE_UP, 0.5, -0.5, np.inf, -np.inf, np.nan]


def _near(v):
    """``v`` and its float32 neighbours."""
    v = np.float32(v)
    return [float(np.nextafter(v, np.float32(-9))), float(v), float(np.nextafter(v, np.float32(9)))]


TERN_EDGES = [e for t in (0.05, -0.05, 0.3, -0.3) for e in _near(t)]
DOREFA_EDGES = [e for k in (1, 2, 3) for i in range(2**k - 1)
                for e in _near((i + 0.5) / (2**k - 1))]


def _values(dtype, seed, extra=(), n=600):
    """Normal values at scale 1.5 and the edges, as float32 numpy exactly
    representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=n) * 1.5).astype(np.float32)
    edges = np.array(EDGES + list(extra), np.float32)
    v[rng.choice(n, size=len(edges), replace=False)] = edges
    return np.array(jnp.asarray(v, getattr(jnp, dtype)).astype(jnp.float32))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.int32)


def _same_bits(got, want):
    """Equal values bit for bit (which tells -0 from +0); NaN by position."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


def _jax_run(fn, x, g, dtype):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    y, vjp = jax.vjp(fn, jx)
    (dx,) = vjp(jnp.asarray(g, getattr(jnp, dtype)))
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port_run(fn, x, g, dtype):
    t = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = fn(t)
    (dx,) = torch.autograd.grad(y, t, torch.tensor(g).to(getattr(torch, dtype)))
    with torch.no_grad():  # the forward without a gradient to take
        y_plain = fn(t)
    assert torch.equal(y.detach(), y_plain) or (
        torch.isnan(y).any() and torch.equal(torch.isnan(y), torch.isnan(y_plain))
    )
    return y.detach().float().numpy(), dx.float().numpy()


ELEMENTWISE = {
    "approx_sign": (jq.approx_sign, pq.approx_sign, ()),
    "ste_tern": (jq.ste_tern, pq.ste_tern, TERN_EDGES),
    "ste_tern_0.3": (functools.partial(jq.ste_tern, threshold_value=0.3),
                     functools.partial(pq.ste_tern, threshold_value=0.3), TERN_EDGES),
    "ste_heaviside": (jq.ste_heaviside, pq.ste_heaviside, ()),
    "dorefa": (jq.dorefa, pq.dorefa, DOREFA_EDGES),
    "dorefa_1": (functools.partial(jq.dorefa, k_bit=1),
                 functools.partial(pq.dorefa, k_bit=1), DOREFA_EDGES),
    "dorefa_3": (functools.partial(jq.dorefa, k_bit=3),
                 functools.partial(pq.dorefa, k_bit=3), DOREFA_EDGES),
    "ste_sign": (jq.ste_sign, pq.ste_sign, ()),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_quantizer_matches_jax_bitwise(name, dtype):
    jfn, pfn, extra = ELEMENTWISE[name]
    x = _values(dtype, len(name), extra)
    g = _values(dtype, len(name) + 1)
    g[~np.isfinite(g)] = 0.5
    jy, jdx = _jax_run(jfn, x, g, dtype)
    py, pdx = _port_run(pfn, x, g, dtype)
    _same_bits(py, jy)
    _same_bits(pdx, jdx)


@pytest.mark.parametrize("name", ["approx_sign", "swish_sign", "ste_sign"])
def test_sign_family_edges(name):
    """sign(+-0) = +1 and sign(NaN) = -1, in both packages; the port's
    subnormals compare in IEEE arithmetic (-1e-40 < 0)."""
    x = np.array([0.0, -0.0, np.nan, 1e-40, -1e-40, -np.inf, np.inf], np.float32)
    want = np.array([1, 1, -1, 1, -1, -1, 1], np.float32)
    got = getattr(pq, name)(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(getattr(jq, name)(jnp.asarray(x[:3])))
    np.testing.assert_array_equal(jgot, want[:3])


@pytest.mark.parametrize("beta", [5.0, 1.5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_swish_sign_matches_jax(beta, dtype):
    x = _values(dtype, 3)
    x[~np.isfinite(x)] = 0.25  # the surrogate is inf * 0 at +-inf on both sides
    g = _values(dtype, 4)
    g[~np.isfinite(g)] = 0.5
    fn = functools.partial(jq.swish_sign, beta=beta)
    jy, jdx = _jax_run(fn, x, g, dtype)
    py, pdx = _port_run(functools.partial(pq.swish_sign, beta=beta), x, g, dtype)
    _same_bits(py, jy)
    if dtype == "bfloat16":
        _same_bits(pdx, jdx)  # each step rounds to bfloat16 on both sides
    else:  # exp and tanh: the libraries' float32 polynomials differ by an ulp
        np.testing.assert_allclose(pdx, jdx, rtol=1e-6, atol=1e-6 * np.abs(jdx).max())


MA_SHAPES = [(3, 3, 8, 16), (3, 3, 64, 128), (5, 5, 96, 32), (200, 64), (7, 7, 3, 64)]


def _weights(shape, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:  # multiples of 1/64 in [-2, 2]: every sum exact in float32
        return (rng.integers(-128, 129, shape) / 64).astype(np.float32)
    return (rng.normal(size=shape) * 0.6).astype(np.float32)


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("shape", MA_SHAPES)
def test_magnitude_aware_sign_matches_jax(shape, dyadic):
    w = _weights(shape, len(shape) + shape[-1], dyadic)
    g = _weights(shape, shape[0], False)
    jy, jdx = _jax_run(jq.magnitude_aware_sign, w, g, "float32")
    py, pdx = _port_run(pq.magnitude_aware_sign, w, g, "float32")
    np.testing.assert_array_equal(np.sign(py), np.sign(jy))
    np.testing.assert_array_equal(np.sign(py), np.where(w >= 0, 1.0, -1.0))
    axes = tuple(range(len(shape) - 1))
    scale = np.abs(py).max(axis=axes)
    assert (np.abs(py) == scale).all()  # one scale per output channel
    if dyadic:
        _same_bits(py, jy)
        _same_bits(pdx, jdx)
    else:
        # The float32 means differ by a few ulps at most (summation order).
        np.testing.assert_allclose(py, jy, rtol=2e-6, atol=0)
        np.testing.assert_allclose(pdx, jdx, rtol=2e-6, atol=0)
        np.testing.assert_array_equal(pdx == 0, jdx == 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ternary_weight_networks_threshold_matches_jax(seed):
    """TWN's threshold is 0.7 * mean|x|: a float32 mean, so the two
    thresholds may differ in the last bits; every value clear of them by
    more than 1e-6 relative gets the same ternary value, and the gradient
    is the same bit for bit."""
    x = _weights((3, 3, 32, 16), seed, False)
    g = _weights((3, 3, 32, 16), seed + 5, False)
    fn_j = functools.partial(jq.ste_tern, ternary_weight_networks=True)
    fn_p = functools.partial(pq.ste_tern, ternary_weight_networks=True)
    jy, jdx = _jax_run(fn_j, x, g, "float32")
    py, pdx = _port_run(fn_p, x, g, "float32")
    thr = 0.7 * np.abs(x).astype(np.float64).mean()
    clear = np.abs(np.abs(x) - thr) > 1e-6 * thr
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(py[clear], jy[clear])
    assert set(np.unique(py)) <= {-1.0, 0.0, 1.0}
    _same_bits(pdx, jdx)


def test_every_jax_quantizer_resolves_in_the_port():
    assert set(pq.QUANTIZERS) == set(jq.QUANTIZERS)
    for name in jq.QUANTIZERS:
        assert pq.get_quantizer(name) is pq.QUANTIZERS[name]
    fn = functools.partial(pq.dorefa, k_bit=3)
    assert pq.get_quantizer(fn) is fn and pq.get_quantizer(None) is None
    with pytest.raises(ValueError, match="Unknown quantizer 'ste_sgn'"):
        pq.get_quantizer("ste_sgn")


# -- the layers' validation ---------------------------------------------------

QUANTIZER_NAMES = [None, *sorted(jq.QUANTIZERS)]
MODES = ["mxu", "int8", "xnor", "xnor_popcount"]


def _jax_outcome(layer, mode, in_q, k_q):
    """("raises", None) or ("ok", latent kernel name) of the flax layer."""
    if layer == "QuantConv":
        module = jl.QuantConv(8, (3, 3), input_quantizer=in_q, kernel_quantizer=k_q,
                              binary_compute=mode, pallas_interpret=True)
        x = jnp.zeros((1, 5, 5, 8))
    else:
        module = jl.QuantDense(8, input_quantizer=in_q, kernel_quantizer=k_q,
                               binary_compute=mode, pallas_interpret=True)
        x = jnp.zeros((1, 8))
    try:
        params = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    except ValueError:
        return "raises", None
    return "ok", [k for k in params if k.startswith("kernel")]


def _port_outcome(layer, mode, in_q, k_q):
    cls = pl.QuantConv if layer == "QuantConv" else pl.QuantDense
    try:
        module = cls(8, 8, input_quantizer=in_q, kernel_quantizer=k_q, binary_compute=mode)
    except ValueError:
        return "raises", None
    return "ok", [n for n, _ in module.named_parameters() if n.startswith("kernel")]


@pytest.mark.parametrize("in_q", QUANTIZER_NAMES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layer", ["QuantConv", "QuantDense"])
def test_layer_validation_and_kernel_name_match_flax(layer, mode, in_q):
    """For every kernel quantizer: the port raises exactly where flax
    raises, and otherwise holds its latent kernel under flax's name."""
    for k_q in QUANTIZER_NAMES:
        want = _jax_outcome(layer, mode, in_q, k_q)
        got = _port_outcome(layer, mode, in_q, k_q)
        assert got == want, (layer, mode, in_q, k_q)
        if got[0] == "ok":
            assert got[1] == [pl.kernel_param_name(k_q)]
            assert got[1] == [jl._kernel_param_name(k_q)]


@pytest.mark.parametrize("in_q", ["ste_sign", "approx_sign", "swish_sign", "ste_tern", "dorefa"])
def test_pack_residuals_validation_matches_flax(in_q):
    """pack_residuals=True on the int8 path needs a strictly +-1 input
    quantizer: approx_sign and swish_sign qualify (Bi-Real-Net trains
    with it), ste_tern and dorefa raise, as in flax."""
    k_q = "magnitude_aware_sign"
    jax_layer = jl.QuantConv(8, (3, 3), input_quantizer=in_q, kernel_quantizer=k_q,
                             binary_compute="int8", pack_residuals=True)
    try:
        jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 8)))
        want = "ok"
    except ValueError:
        want = "raises"
    try:
        pl.QuantConv(8, 8, input_quantizer=in_q, kernel_quantizer=k_q, binary_compute="int8",
                     pack_residuals=True)
        got = "ok"
    except ValueError:
        got = "raises"
    assert got == want == ("ok" if in_q in ("ste_sign", "approx_sign", "swish_sign") else "raises")
