"""The port's deployment converter against the JAX one, bit for bit.

A small QuickNet tree in the JAX package's layout (latent float kernels,
BatchNorms with seeded affine and running stats) goes through the JAX
``pack_quantconv_params`` and the port's, with and without ``fold_bn``
and with ``fold_order``; every leaf must be equal and every level must
list its scopes in the same order.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import numpy as np
import pytest

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import QuickNet as PortQuickNet
from zookeeper_tpu_torch.ops.packed import pack_quantconv_params as port_pack


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


@functools.lru_cache(maxsize=1)  # read-only: no converter mutates its input
def _trained_like():
    """A float QuickNet tree as flax lays it out (traced with
    ``jax.eval_shape`` from the JAX module's init), filled with seeded
    values, scopes in flax creation order (the port module's order;
    eval_shape sorts them, and the fold pairing reads the order)."""
    model = JaxQuickNet()
    jax_configure(
        model,
        {"blocks_per_section": (1, 1), "section_features": (32, 64)},
        name="model",
    )
    module = model.build((16, 16, 3), num_classes=8)
    params, state = jax.eval_shape(lambda: model.initialize(module, (16, 16, 3), seed=3))
    rng = np.random.default_rng(0)
    params, stats = _fill(params, rng), _fill(state["batch_stats"], rng)
    order = [name for name, _ in _port_module().named_children()]
    assert sorted(order) == sorted(params)
    return {k: params[k] for k in order}, {k: stats[k] for k in order if k in stats}


def _port_module():
    model = PortQuickNet()
    port_configure(
        model,
        {"blocks_per_section": (1, 1), "section_features": (32, 64),
         "binary_compute": "xnor_popcount"},
        name="model",
    )
    return model.build((16, 16, 3), num_classes=8)


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        # Same scopes in the same order: the fold pairing reads the order.
        if path == "root":
            assert list(got) == list(want), path
        else:
            assert sorted(got) == sorted(want), path
        for key in want:
            _assert_same_tree(got[key], want[key], f"{path}/{key}")
        return
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_pack_without_fold_matches_jax():
    params, _ = _trained_like()
    _assert_same_tree(port_pack(params), jax_pack(params))


def test_pack_with_fold_matches_jax():
    params, stats = _trained_like()
    got_p, got_s = port_pack(params, fold_bn=True, batch_stats=stats)
    want_p, want_s = jax_pack(params, fold_bn=True, batch_stats=stats)
    _assert_same_tree(got_p, want_p)
    _assert_same_tree(got_s, want_s)
    assert "BatchNorm_2" not in got_p and "bias" in got_p["QuantConv_0"]


def test_pack_with_fold_order_matches_jax():
    params, stats = _trained_like()
    sorted_params = {k: params[k] for k in sorted(params)}
    with pytest.raises(ValueError, match="not followed by a BatchNorm"):
        port_pack(sorted_params, fold_bn=True, batch_stats=stats)
    got = port_pack(sorted_params, fold_bn=True, batch_stats=stats, fold_order=params)
    want = jax_pack(sorted_params, fold_bn=True, batch_stats=stats, fold_order=params)
    _assert_same_tree(got[0], want[0])
    _assert_same_tree(got[1], want[1])


def test_pack_with_template_matches_jax():
    """A deployment template that packs only the second section."""
    params, _ = _trained_like()
    model = JaxQuickNet()
    jax_configure(
        model,
        {"blocks_per_section": (1, 1), "section_features": (32, 64),
         "binary_compute": ("mxu", "xnor_popcount"),
         "packed_weights": (False, True)},
        name="model",
    )
    module = model.build((16, 16, 3), num_classes=8)
    template = jax.eval_shape(lambda: model.initialize(module, (16, 16, 3))[0])
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    assert "kernel_packed" in template["QuantConv_1"]
    got = port_pack(params, template=template)
    assert "kernel" in got["QuantConv_0"] and "kernel_packed" in got["QuantConv_1"]
    _assert_same_tree(got, jax_pack(params, template=template))


def test_pack_requires_batch_stats_for_fold():
    params, _ = _trained_like()
    with pytest.raises(ValueError, match="batch_stats"):
        port_pack(params, fold_bn=True)
