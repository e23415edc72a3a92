"""The port's binary dense layer and its paths against the JAX ones.

``QuantDense`` runs on all four ``binary_compute`` paths, with latent or
packed weights, through the JAX layer (its Pallas kernels in interpret
mode, as the JAX package's own CPU tests run them) and through the
port's (CPU tensors, so every kernel wrapper runs its plain version), on
the same seeded numpy inputs. The binary paths compute a sign, an exact
integer sum and one fp32 multiply (plus the cast and the bias add) on
both sides, so "int8", "xnor" and "xnor_popcount" (both flavors) are
compared bit for bit; "mxu" is a float matmul whose sums XLA and PyTorch
order differently, so it is held to rtol 1e-5 (the tolerance of
``tests/ops/test_dense_paths.py``). The int8 path's gradients (the float
matmul's VJP) are held to JAX's custom VJP at the same rtol.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.ops import binary_compute as jbc
from zookeeper_tpu.ops.layers import QuantDense as JaxQuantDense
from zookeeper_tpu.ops.packed import quantized_param_view as jax_view
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN, QuantDense
from zookeeper_tpu_torch.ops.packed import quantized_param_view

#: The JAX flavor that runs the same kernels as the port's: the port's
#: "auto" is the fused path (K1 + K2), which JAX runs under "pallas"
#: (its "auto" is the reference composition off a TPU).
JAX_FLAVOR = {"auto": "pallas", "reference": "reference"}


def _case(seed, lead, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    x.reshape(-1, k)[0, :4] = [0.0, -0.0, 1e-30, -1e-30]  # sign edge cases
    kernel = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    kernel[:, 1] *= 40.0  # a channel past the clip
    bias = rng.normal(size=n).astype(np.float32)
    return x, kernel, bias


def _jax_layer(n, mode, dtype, packed, use_bias, flavor):
    return JaxQuantDense(
        n, input_quantizer="ste_sign", kernel_quantizer="ste_sign", use_bias=use_bias,
        dtype=getattr(jnp, dtype), binary_compute=mode, packed_weights=packed,
        pallas_interpret=True,
        # Only the popcount path has a fused flavor ("xnor" runs K4 either way).
        binary_flavor=JAX_FLAVOR[flavor] if mode == "xnor_popcount" else "auto",
    )


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize(
    "mode,dtype,packed,use_bias,flavor,lead,k",
    [
        ("xnor_popcount", "float32", True, True, "auto", (3,), 40),
        ("xnor_popcount", "bfloat16", True, False, "auto", (2, 3), 64),
        ("xnor_popcount", "float32", True, True, "reference", (3,), 40),
        ("xnor_popcount", "float32", False, False, "auto", (4,), 96),
        ("xnor_popcount", "bfloat16", False, True, "reference", (2,), 33),
        ("xnor", "float32", True, True, "auto", (3,), 40),
        ("xnor", "bfloat16", False, False, "auto", (2, 2), 64),
        ("int8", "float32", False, True, "auto", (3,), 40),
        ("int8", "bfloat16", False, False, "auto", (2,), 64),
    ],
)
def test_quantdense_binary_paths_bitwise(mode, dtype, packed, use_bias, flavor, lead, k):
    n = 24
    x, kernel, bias = _case(len(mode) + k + len(lead), lead, k, n)
    if packed:
        q = np.asarray(jax.jit(lambda w: jnp.clip(w, -1, 1))(kernel))
        q = np.where(q >= 0, 1.0, -1.0).astype(np.float32) * (np.abs(q).max(0) + 0.5)
        kp, ks = (np.array(a) for a in jbc.pack_dense_kernel(jnp.asarray(q)))
        params = {"kernel_packed": kp, "kernel_scale": ks}
    else:
        params = {"kernel": kernel}
    if use_bias:
        params["bias"] = bias
    jlayer = _jax_layer(n, mode, dtype, packed, use_bias, flavor)
    want = jlayer.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype)))

    layer = QuantDense(
        k, n, input_quantizer="ste_sign", kernel_quantizer="ste_sign", use_bias=use_bias,
        dtype=getattr(torch, dtype), binary_compute=mode, packed_weights=packed,
        binary_flavor=flavor,
    )
    layer.load_state_dict({name: torch.from_numpy(v) for name, v in params.items()})
    tbc.reset_launches()
    with torch.inference_mode():
        got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(_bits(got.float().numpy()),
                                  _bits(np.asarray(want.astype(jnp.float32))))
    assert tbc.LAUNCHES == {name: 0 for name in tbc.LAUNCHES}  # CPU: plain versions


@pytest.mark.parametrize("use_bias", [False, True])
def test_quantdense_mxu_matches_jax(use_bias):
    x, kernel, bias = _case(5, (4,), 48, 16)
    params = {"kernel": kernel, **({"bias": bias} if use_bias else {})}
    want = _jax_layer(16, "mxu", "float32", False, use_bias, "auto").apply(
        {"params": params}, jnp.asarray(x))
    layer = QuantDense(48, 16, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                       use_bias=use_bias, binary_compute="mxu")
    layer.load_state_dict({name: torch.from_numpy(v) for name, v in params.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scaled", [True, False])
def test_int8_dense_gradients_match_jax(scaled):
    rng = np.random.default_rng(11 + scaled)
    x = np.where(rng.random((2, 3, 40)) < 0.5, -1.0, 1.0).astype(np.float32)
    x[0, 0, :3] = 0.0  # a literal 0 stays 0
    k = np.where(rng.random((40, 12)) < 0.5, -1.0, 1.0).astype(np.float32)
    if scaled:
        k *= (rng.random(12) + 0.5).astype(np.float32)
    g = rng.normal(size=(2, 3, 12)).astype(np.float32)

    def loss(xx, kk):
        return jnp.sum(jbc.int8_dense(xx, kk, scaled) * g)

    want_y = np.asarray(jbc.int8_dense(jnp.asarray(x), jnp.asarray(k), scaled))
    want_dx, want_dk = (np.asarray(t) for t in jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(k)))
    tx, tk = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, k))
    y = tbc.int8_dense(tx, tk, scaled)
    np.testing.assert_array_equal(_bits(y.detach().numpy()), _bits(want_y))
    dx, dk = torch.autograd.grad(y, (tx, tk), torch.from_numpy(g))
    assert dx.dtype == torch.float32 and dk.shape == (40, 12)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=1e-5, atol=1e-5)


def test_int8_quantdense_trains():
    """A gradient reaches the latent kernel through the STE and the clip."""
    layer = QuantDense(40, 8, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                       binary_compute="int8")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    out = layer(torch.randn(3, 40, generator=torch.Generator().manual_seed(1)))
    (grad,) = torch.autograd.grad(out.square().sum(), layer.kernel)
    assert grad.shape == (40, 8) and grad.abs().sum() > 0


def test_packed_and_xnor_dense_are_inference_only():
    """Packed weights serve only; the latent "xnor" layer now trains too
    (``xnor_dense``'s float-matmul gradients), with and without a
    gradient to take."""
    x = torch.ones(2, 64, requires_grad=True)
    packed = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="inference-only"):
        tbc.packed_dense_infer(x, packed, torch.ones(4), 64, use_popcount=True)
    layer = QuantDense(64, 4, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                       binary_compute="xnor")
    layer(torch.ones(2, 64)).sum().backward()
    assert layer.kernel.grad is not None and layer.kernel.grad.shape == (64, 4)
    with torch.no_grad():  # inference through the same layer runs
        assert layer(torch.ones(2, 64)).shape == (2, 4)


def test_quantdense_validates_its_configuration():
    with pytest.raises(ValueError, match="unknown binary_compute"):
        QuantDense(8, 4, binary_compute="xnr")
    with pytest.raises(ValueError, match="needs both"):
        QuantDense(8, 4, input_quantizer="ste_sign", binary_compute="int8")
    with pytest.raises(ValueError, match="packed_weights=True requires"):
        QuantDense(8, 4, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                   binary_compute="int8", packed_weights=True)
    with pytest.raises(ValueError, match="binary_flavor"):
        QuantDense(8, 4, binary_flavor="palas")
    layer = QuantDense(40, 4, input_quantizer="ste_sign", kernel_quantizer="ste_sign",
                       binary_compute="xnor_popcount", packed_weights=True)
    assert layer.kernel_packed.shape == (2, 4) and layer.kernel_scale.shape == (4,)
    with pytest.raises(ValueError, match="built for 40"):
        layer(torch.ones(1, 32))


def test_quantized_param_view_matches_jax():
    from zookeeper_tpu.ops.layers import BINARY_KERNEL_PATTERN as JAX_PATTERN

    assert BINARY_KERNEL_PATTERN == JAX_PATTERN
    rng = np.random.default_rng(3)
    tree = {
        "Conv_0": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)},
        "QuantConv_0": {"kernel": (rng.normal(size=(3, 3, 8, 8)) * 2).astype(np.float32)},
        "QuantDense_1": {"kernel": (rng.normal(size=(16, 4)) * 2).astype(np.float32),
                         "bias": rng.normal(size=4).astype(np.float32)},
        "BatchNorm_0": {"scale": rng.normal(size=8).astype(np.float32)},
        "block": {"QuantDense_0": {"kernel": rng.normal(size=(4, 4)).astype(np.float32),
                                   "kernel_fp": rng.normal(size=(4, 4)).astype(np.float32)}},
    }
    want = jax_view(tree)
    got = quantized_param_view(tree)

    def same(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for key in w:
                same(g[key], w[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=path)

    same(got, want, "")
    assert set(np.unique(np.asarray(got["QuantDense_1"]["kernel"]))) <= {-1.0, 1.0}
    assert got["Conv_0"]["kernel"] is tree["Conv_0"]["kernel"]  # passed through
    with pytest.raises(ValueError, match="kernel quantizer"):
        quantized_param_view(tree, kernel_quantizer=None)
