"""The port's BinaryNet and BinaryAlexNet against the flax modules.

Weights are made in the flax layout from a seed and carried into the
port by ``from_flax_variables``; both packages then compute logits from
the same seeded input (the JAX Pallas kernels in interpret mode, the
port's kernel wrappers on CPU tensors, i.e. their plain versions).

Every value before the fp head is made exact in both packages, so no
rounding difference can flip a binary layer's sign: inputs, fp conv
kernels and BN means and shifts are small dyadic numbers (sums of their
products are exact in fp32 in any order), and every BN has scale 1 and a
variance with ``var + eps == 1`` in fp32, so its ``rsqrt`` is exactly 1
and the BN adds the same two exact terms on both sides. The binary
layers are exact integers times one fp32 scale. Only the fp head's
matmul sums in another order, so the logits are held to 1e-5 of their
largest magnitude. The dense-stage BN fold is compared leaf for leaf,
bit for bit, with seeded BN statistics of any value.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import BinaryAlexNet as JaxBinaryAlexNet
from zookeeper_tpu.models import BinaryNet as JaxBinaryNet
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import BinaryAlexNet, BinaryNet
from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops.packed import pack_quantconv_params as port_pack

NET = {"features": (16, 16, 32, 32), "dense_units": (64,)}
NET_SHAPE, NET_CLASSES = (32, 32, 3), 10
ALEX_SHAPE, ALEX_CLASSES = (67, 67, 3), 5
FAMILIES = {
    "BinaryNet": (JaxBinaryNet, BinaryNet, NET, NET_SHAPE, NET_CLASSES),
    "BinaryAlexNet": (JaxBinaryAlexNet, BinaryAlexNet, {}, ALEX_SHAPE, ALEX_CLASSES),
}


def _unit_var():
    """A float32 variance with ``var + 1e-5 == 1`` exactly in float32."""
    eps = np.float32(1e-5)
    v = np.float32(1.0) - eps
    while np.float32(v + eps) != np.float32(1.0):
        v = np.nextafter(v, np.float32(2.0) if v + eps < 1 else np.float32(0.0))
    return v


def _models(family, conf):
    jax_cls, port_cls, base, _, _ = FAMILIES[family]
    jm, pm = jax_cls(), port_cls()
    jax_configure(jm, {**base, **conf, "pallas_interpret": True}, name="model")
    port_configure(pm, {**base, **conf}, name="model")
    return jm, pm


@functools.lru_cache(maxsize=None)  # read-only: the converters copy
def _float_tree(family, exact=True):
    """A float tree in the flax layout (names, nesting and layouts from
    the JAX module's init, traced with ``jax.eval_shape``), seeded, its
    scopes in flax creation order (the port module's; eval_shape sorts
    them). ``exact``: the dyadic values of the module docstring; else BN
    statistics of any value."""
    _, _, _, shape, classes = FAMILIES[family]
    jm, pm = _models(family, {})
    params, state = jax.eval_shape(lambda: jm.initialize(jm.build(shape, classes), shape, seed=1))
    rng = np.random.default_rng(len(family))
    out = {}
    for tree in (params, state["batch_stats"]):
        for scope, leaves in tree.items():
            for name, s in leaves.items():
                if name == "scale":
                    v = np.ones(s.shape) if exact else rng.uniform(-1.5, 1.5, s.shape)
                elif name == "var":
                    v = np.full(s.shape, _unit_var()) if exact else rng.uniform(0.5, 1.5, s.shape)
                elif name in ("bias", "mean") and scope.startswith("BatchNorm"):
                    v = rng.integers(-4, 5, s.shape) / 8 if exact else rng.uniform(-0.3, 0.3, s.shape)
                elif scope.startswith("Conv") and exact:  # the fp stem: dyadic
                    v = rng.integers(-16, 17, s.shape) / 16
                else:
                    v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                out.setdefault(scope, {})[name] = v.astype(np.float32)
    order = [n for n, _ in pm.build(shape, classes).named_children()]
    assert sorted(order) == sorted(params)
    p = {k: {n: out[k][n] for n in params[k]} for k in order}
    stats = {k: {n: out[k][n] for n in ("mean", "var")} for k in order if k in state["batch_stats"]}
    return p, stats


def _input(family, batch=2):
    shape = FAMILIES[family][3]
    return (np.random.default_rng(9).integers(-8, 9, (batch, *shape)) / 4).astype(np.float32)


def _np_tree(tree):
    return {k: {n: np.array(v) for n, v in d.items()} for k, d in tree.items()}


def _deploy(family, conf):
    """The float tree converted to ``conf``'s deployment by the JAX
    converter (template from the deployment module's init, the fold when
    ``conf`` folds)."""
    params, stats = _float_tree(family)
    jm, _ = _models(family, conf)
    shape, classes = FAMILIES[family][3:]
    if not (conf.get("packed_weights") or conf.get("dense_packed_weights")):
        return params, stats
    template = jax.eval_shape(lambda: jm.initialize(jm.build(shape, classes), shape)[0])
    if conf.get("fold_bn"):
        p, s = jax_pack(params, template=dict(template), fold_bn=True, batch_stats=stats)
        return _np_tree(p), _np_tree(s)
    return _np_tree(jax_pack(params, template=dict(template))), stats


def _logits(family, conf, params, stats, x):
    jm, pm = _models(family, conf)
    shape, classes = FAMILIES[family][3:]
    jmod = jm.build(shape, classes)
    want = np.asarray(jax.jit(lambda v, xb: jmod.apply(v, xb, training=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    module = pm.build(shape, classes)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    tbc.reset_launches()
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert tbc.LAUNCHES == {k: 0 for k in tbc.LAUNCHES}  # CPU: plain versions
    return got, want


DEPLOYMENTS = [
    ("BinaryNet", {}),
    ("BinaryNet", {"binary_compute": "int8"}),
    ("BinaryNet", {"binary_compute": "xnor_popcount", "packed_weights": True,
                   "binary_flavor": "reference"}),
    ("BinaryNet", {"binary_compute": "xnor", "packed_weights": True}),
    ("BinaryNet", {"dense_binary_compute": "xnor_popcount", "dense_packed_weights": True,
                   "fold_bn": True, "binary_flavor": "reference"}),
    ("BinaryAlexNet", {}),
    ("BinaryAlexNet", {"binary_compute": "xnor_popcount", "packed_weights": True}),
    ("BinaryAlexNet", {"dense_binary_compute": "xnor", "dense_packed_weights": True,
                       "fold_bn": True}),
]


@pytest.mark.parametrize("family,conf", DEPLOYMENTS, ids=lambda v: str(v))
def test_logits_match_flax(family, conf):
    params, stats = _deploy(family, conf)
    got, want = _logits(family, conf, params, stats, _input(family))
    assert got.shape == (2, FAMILIES[family][4]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_fused_flavor_equals_reference_flavor():
    """The port's "auto" flavor (K1 + K3 convs, K1 + K2 dense) and
    "reference" (``pack_bits`` + K5, then the scale) share their integer
    sums and their one fp32 multiply: equal logits, bit for bit. JAX's
    "pallas" flavor runs the same kernels as the port's "auto"."""
    conf = {"binary_compute": "xnor_popcount", "packed_weights": True}
    params, stats = _deploy("BinaryNet", conf)
    x = _input("BinaryNet")
    got_ref, _ = _logits("BinaryNet", {**conf, "binary_flavor": "reference"}, params, stats, x)
    got, want = _logits("BinaryNet", {**conf, "binary_flavor": "pallas"}, params, stats, x)
    np.testing.assert_array_equal(got.view(np.int32), got_ref.view(np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("family", ["BinaryNet", "BinaryAlexNet"])
def test_dense_stage_fold_matches_jax(family):
    """The dense-stage fold pairs each packed QuantDense with the BN made
    after it, as JAX's converter does, leaf for leaf and bit for bit."""
    params, stats = _float_tree(family, exact=False)
    conf = {"dense_binary_compute": "xnor_popcount", "dense_packed_weights": True}
    _, pm = _models(family, {**conf, "fold_bn": True})
    shape, classes = FAMILIES[family][3:]
    module = pm.build(shape, classes)
    template, _ = to_flax_variables(module)
    got_p, got_s = port_pack(params, template=template, fold_bn=True, batch_stats=stats)
    want_p, want_s = jax_pack(params, template=template, fold_bn=True, batch_stats=stats)
    assert list(got_p) == list(want_p) and list(got_s) == list(want_s)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        for scope in want:
            assert sorted(got[scope]) == sorted(want[scope]), scope
            for name in want[scope]:
                np.testing.assert_array_equal(np.asarray(got[scope][name]),
                                              np.asarray(want[scope][name]), err_msg=scope)
    n_dense = len(NET["dense_units"]) if family == "BinaryNet" else 2
    assert sum("kernel_packed" in leaves for leaves in got_p.values()) == n_dense
    assert all("bias" in got_p[f"QuantDense_{i}"] for i in range(n_dense))
    # The folded BNs keep their numbers: the module skips them by name.
    assert sorted(got_p) == sorted(n for n, _ in module.named_children())


@pytest.mark.parametrize("family", ["BinaryNet", "BinaryAlexNet"])
def test_conv_packed_fold_raises(family):
    _, pm = _models(family, {"binary_compute": "xnor", "packed_weights": True,
                             "fold_bn": True})
    with pytest.raises(ValueError, match="DENSE stage only"):
        pm.build(*FAMILIES[family][3:])
    _, pm = _models(family, {"dense_binary_compute": "xnor", "dense_packed_weights": True,
                             "fold_bn": True})
    module = pm.build(*FAMILIES[family][3:]).train()
    with pytest.raises(ValueError, match="DEPLOYMENT mode"):
        module(torch.zeros(1, *FAMILIES[family][3]))


def test_alexnet_dense_only_deployment_converts_two_kernels():
    """BASELINE's deployment: "mxu" convs and the packed "xnor" dense
    stage; the template converts exactly the two dense kernels."""
    _, pm = _models("BinaryAlexNet", {"dense_binary_compute": "xnor",
                                      "dense_packed_weights": True})
    template, _ = to_flax_variables(pm.build(ALEX_SHAPE, ALEX_CLASSES))
    packed = port_pack(_float_tree("BinaryAlexNet")[0], template=template)
    assert sorted(k for k, v in packed.items() if "kernel_packed" in v) == [
        "QuantDense_0", "QuantDense_1"]
    assert "kernel" in packed["QuantConv_3"]


@pytest.mark.parametrize("family", ["BinaryNet", "BinaryAlexNet"])
def test_packed_init_serves_the_float_twin(family):
    """A packed build initialized from a seed holds the packed form of its
    float twin from the same seed: without a fold, equal logits, bit for
    bit."""
    conf = {"binary_compute": "xnor_popcount", "packed_weights": True}
    _, float_model = _models(family, {"binary_compute": "xnor_popcount"})
    _, packed_model = _models(family, conf)
    shape, classes = FAMILIES[family][3:]
    twin = float_model.initialize(float_model.build(shape, classes), seed=7)
    packed = packed_model.initialize(packed_model.build(shape, classes), seed=7)
    assert packed.QuantDense_0.kernel_packed.abs().sum() > 0
    x = torch.from_numpy(_input(family))
    with torch.inference_mode():
        np.testing.assert_array_equal(twin(x).numpy(), packed(x).numpy())


def test_flax_round_trip_with_dense_scopes():
    params, stats = _float_tree("BinaryAlexNet")
    _, pm = _models("BinaryAlexNet", {})
    module = pm.build(ALEX_SHAPE, ALEX_CLASSES)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    assert module.QuantDense_0.kernel.shape == params["QuantDense_0"]["kernel"].shape
    back, back_state = to_flax_variables(module)
    assert list(back) == list(params)
    for scope in params:
        for name in params[scope]:
            np.testing.assert_array_equal(back[scope][name], params[scope][name])
    for scope in stats:
        for name in stats[scope]:
            np.testing.assert_array_equal(back_state["batch_stats"][scope][name],
                                          stats[scope][name])


@pytest.mark.parametrize("family,overrides", [
    ("BinaryNet", {"model.features": (16, 16, 32, 32), "model.dense_units": (64,),
                   "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
                   "model.binary_flavor": "reference", "height": 32, "width": 32,
                   "num_classes": 10}),
    ("BinaryAlexNet", {"model.dense_binary_compute": "xnor", "model.dense_packed_weights": True,
                       "model.fold_bn": True, "height": 67, "width": 67, "num_classes": 5}),
])
def test_serving_config_runs(family, overrides):
    from zookeeper_tpu_torch.serving import ServingConfig

    cfg = ServingConfig()
    port_configure(cfg, {"model": family, **overrides, "engine.batch_buckets": (1, 4),
                         "requests": 5, "max_request": 4, "device": "cpu",
                         "verbose": False})
    result = cfg.run()
    assert result["model"] == family and result["requests"] == 5
    assert cfg.engine.packed_deployment
