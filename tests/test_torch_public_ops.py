"""The public binary GEMMs and the packages' exports against the JAX
package.

- ``xnor_matmul`` (K1 on both operands, then K5; on the CPU their plain
  versions) equals JAX's ``xnor_matmul`` (its Pallas kernels in
  interpret mode) bit for bit, at K that is and is not a multiple of 32,
  with zeros and a NaN among the operands (bit 1 for x >= 0, 0 for NaN),
  and equals the float product of ±1 operands;
- ``int8_matmul`` equals JAX's bit for bit at K that is and is not a
  multiple of 8, a literal 0 stays 0, and .5 rounds half to even;
- every name in each JAX package's ``__all__`` resolves in the port's
  counterpart and is in its ``__all__``, less the names ROADMAP.md lists
  as not ported.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import importlib

import numpy as np
import pytest
import torch

from zookeeper_tpu.ops.binary_compute import int8_matmul as jax_int8_matmul
from zookeeper_tpu.ops.binary_compute import xnor_matmul as jax_xnor_matmul
from zookeeper_tpu_torch.ops import binary_compute as bc
from zookeeper_tpu_torch.ops import int8_matmul, xnor_matmul


def _signs(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0, 1.0) \
        .astype(np.float32)


#: (M, K, N): K a multiple of 32, and K's remainders 8 and 1 and 31.
XNOR_SHAPES = ((17, 96, 23), (5, 40, 7), (3, 33, 5), (8, 63, 16), (1, 32, 1))


@pytest.mark.parametrize("m,k,n", XNOR_SHAPES)
def test_xnor_matmul_equals_jax_and_the_float_product(m, k, n):
    a, b = _signs((m, k), 1), _signs((k, n), 2)
    before = dict(bc.LAUNCHES)
    got = xnor_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert bc.LAUNCHES == before  # the CPU runs the plain versions, launching nothing
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = np.asarray(jax_xnor_matmul(a, b, interpret=True, block_m=8, block_n=8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a @ b)


def test_xnor_matmul_sign_rule_of_zeros_and_nan_equals_jax():
    a, b = _signs((6, 40), 3), _signs((40, 9), 4)
    a[0, :5] = 0.0
    a[1, 3] = -0.0
    a[2, 7] = np.nan
    b[11, 2] = 0.0
    b[12, 4] = np.nan
    got = xnor_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_xnor_matmul(a, b, interpret=True, block_m=8, block_n=8))
    np.testing.assert_array_equal(got, want)
    # bf16 and float64 operands keep their signs.
    for dtype in (torch.bfloat16, torch.float64):
        cast = xnor_matmul(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))
        np.testing.assert_array_equal(cast.numpy(), want)


def test_xnor_matmul_rejects_mismatched_inner_dims():
    with pytest.raises(ValueError, match="Inner dims mismatch"):
        xnor_matmul(torch.ones(2, 32), torch.ones(31, 2))


#: (M, K, N): K a multiple of 8 and not; M below and above _int_mm's 17.
INT8_SHAPES = ((16, 64, 8), (5, 13, 7), (33, 24, 9), (1, 1, 1))


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_equals_jax(m, k, n):
    a, b = _signs((m, k), 5), _signs((k, n), 6)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_int8_matmul(a, b)))
    np.testing.assert_array_equal(got.numpy(), a @ b)


def test_int8_matmul_keeps_zeros_and_rounds_half_to_even_as_jax():
    a = _signs((8, 32), 9)
    a[0, :] = 0.0  # a literal 0 contributes 0, not sign(0)
    a[1, :4] = (0.5, -0.5, 1.5, -1.5)
    b = _signs((32, 6), 10)
    b[:, 0] = 0.0
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_int8_matmul(a, b)))
    assert (got[0] == 0).all() and (got[:, 0] == 0).all()


#: Names ROADMAP.md lists as not ported (no PyTorch counterpart).
NOT_PORTED = {
    "ops": {"conv_dim_numbers"},
    "observability": {"LedgeredExecutable", "cost_analysis_dict"},
    "data": {"TFDSDataset", "MultiTFDSDataset"},
}
PACKAGES = ("", "core", "data", "loadgen", "models", "observability", "ops", "parallel",
            "resilience", "serving", "serving.decode", "serving.disagg", "training")


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_resolves_in_the_port(package):
    suffix = f".{package}" if package else ""
    jax_pkg = importlib.import_module(f"zookeeper_tpu{suffix}")
    port_pkg = importlib.import_module(f"zookeeper_tpu_torch{suffix}")
    wanted = set(jax_pkg.__all__) - NOT_PORTED.get(package, set())
    missing = sorted(n for n in wanted if not hasattr(port_pkg, n))
    assert not missing, f"{port_pkg.__name__} lacks {missing}"
    assert wanted <= set(port_pkg.__all__), sorted(wanted - set(port_pkg.__all__))
    # What is left out is left out on purpose, never by accident.
    for name in NOT_PORTED.get(package, ()):
        assert name in jax_pkg.__all__ and not hasattr(port_pkg, name), name
