"""The port's ResNet-topology binary zoo (BiRealNet, BinaryResNetE18,
RealToBinaryNet, ReActNet) and XNORNet and DoReFaNet against the flax
modules.

Weights are made in the flax layout from a seed (the tree's names,
nesting and shapes are flax's own, checked against ``jax.eval_shape`` of
the JAX module's init) and carried into the port by
``from_flax_variables``; both packages then compute logits from the same
seeded input, the JAX "xnor"/"xnor_popcount" paths with
``pallas_interpret=True``, the port's kernel wrappers on CPU tensors
(their plain versions).

The logits are held to ``1e-4 * max|logit|``: the fp stems, shortcuts,
BatchNorms, gates, heads and ``magnitude_aware_sign``'s means round
differently in XLA and in PyTorch. Those differences are ~1e-6 relative,
so they could flip a binary layer's sign only where its input lies within
about that of zero; each test asserts that no binary layer's input (nor
an RSign's shifted input) on the port's side lies within 1e-5 of zero,
so the seeded inputs are clear of that case. DoReFa-Net's 2-bit
activations have three rounding boundaries in [0, 1] and some input
comes within 1e-5 of one at every seed tried (the hooks report it), so
its test holds the logits alone: a level moved by rounding would show
there. Train mode (batch-statistics
BatchNorms) is compared the same way, with the updated running statistics
within 2e-5 of their largest magnitude.

The packed trees are compared leaf for leaf: with dyadic latent weights
(sums exact in any order) every leaf bit for bit; with seeded normal
weights the packed words bit for bit and ``kernel_scale``/``bias``
within 2e-6 relative (the float32 means of ``magnitude_aware_sign``, summed
in different orders).
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu import models as jax_models
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.binary_resnet import RSign
from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from zookeeper_tpu_torch.ops import binary_compute as tbc
from zookeeper_tpu_torch.ops.layers import QuantConv, QuantDense
from zookeeper_tpu_torch.ops.packed import pack_quantconv_params as port_pack

R18 = {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64)}
#: (config, input shape): 40x40 takes the ResNet-18 skeleton through 20,
#: 10, 10, 5, 3 and 2, so the stride-2 convs and the 2x2 SAME average
#: pools meet an odd size (5 -> 3, padded after).
FAMILIES = {
    "BiRealNet": (R18, (40, 40, 3)),
    "BinaryResNetE18": (R18, (40, 40, 3)),
    "RealToBinaryNet": (R18, (40, 40, 3)),
    "ReActNet": ({"features": (8, 16, 16, 32), "strides": (1, 2, 1)}, (32, 32, 3)),
    "XNORNet": ({}, (67, 67, 3)),
    "DoReFaNet": ({}, (67, 67, 3)),
}
CLASSES = 10
#: Seeds of the inputs, clear of the sign flips (asserted).
INPUT_SEED = {**{f: 3 for f in FAMILIES}, "BiRealNet": 5, "XNORNet": 4}
KERNEL_QUANTIZER = {"BiRealNet": "magnitude_aware_sign", "XNORNet": "magnitude_aware_sign"}


def _models(family, conf):
    base, _ = FAMILIES[family]
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_conf = {**base, **conf}
    if family != "DoReFaNet":
        jax_conf["pallas_interpret"] = True
    jax_configure(jm, jax_conf, name="model")
    port_configure(pm, {**base, **conf}, name="model")
    return jm, pm


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def _fill(tree, rng, dyadic=False, path=""):
    """Seeded values for a flax tree of shapes, in its key order: BN
    scale/var in [0.5, 1.5], BN bias/mean and the RSign/RPReLU shifts in
    [-0.3, 0.3], RPReLU slopes in [0.1, 0.4], other leaves normal /
    sqrt(fan-in) (``dyadic``: the binary layers' latent kernels multiples
    of 1/64 instead)."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = _fill(v, rng, dyadic, f"{path}/{key}")
            continue
        shape = tuple(v.shape)
        if key in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif key in ("mean", "alpha", "gamma", "zeta") or (key == "bias" and "BatchNorm" in path):
            x = rng.uniform(-0.3, 0.3, shape)
        elif key == "beta":
            x = rng.uniform(0.1, 0.4, shape)
        elif dyadic and key == "kernel" and "Quant" in path:
            x = rng.integers(-64, 65, shape) / 64
        else:
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]) if len(shape) > 1 else 1)
        out[key] = x.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)  # read-only: the converters copy
def _float_tree(family, dyadic=False):
    """A float (params, batch_stats) tree of ``family`` in flax's layout
    and the port's creation order, seeded."""
    _, shape = FAMILIES[family]
    _, pm = _models(family, {})
    params, state = to_flax_variables(pm.build(shape, CLASSES))
    rng = np.random.default_rng(len(family) + 7 * dyadic)
    return _fill(params, rng, dyadic), _fill(state["batch_stats"], rng)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_tree_is_flaxs(family):
    """The port's tree has flax's scopes, nesting, leaf names and shapes
    (from ``jax.eval_shape`` of the JAX module's init), and the converter
    round-trips it through the port module unchanged."""
    _, shape = FAMILIES[family]
    jm, pm = _models(family, {})
    params, state = jax.eval_shape(lambda: jm.initialize(jm.build(shape, CLASSES), shape, seed=0))
    module = pm.build(shape, CLASSES)
    got, got_state = to_flax_variables(module)
    assert _shapes(got) == _shapes(params)
    assert _shapes(got_state["batch_stats"]) == _shapes(state.get("batch_stats", {}))
    p, s = _float_tree(family)
    module.load_state_dict(from_flax_variables(p, {"batch_stats": s}))
    back, back_state = to_flax_variables(module)

    def same(a, b):
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    same(back, p)
    same(back_state["batch_stats"], s)


def _clearance_hooks(module):
    """Pre-hooks recording, for every binary layer and RSign, how close its
    (shifted) input comes to zero (to a rounding boundary for dorefa's
    levels)."""
    seen = []

    def quant(_, args):
        seen.append(args[0].detach().float().abs().min().item())

    def rsign(mod, args):
        seen.append((args[0].detach().float() - mod.alpha).abs().min().item())

    def dorefa_levels(mod, args):  # the distance to a rounding boundary
        n = 2 ** mod.in_q.keywords["k_bit"] - 1
        v = args[0].detach().float().clamp(0, 1) * n + 0.5
        seen.append(((v - v.round()).abs().min() / n).item())

    handles = []
    for sub in module.modules():
        if isinstance(sub, (QuantConv, QuantDense)) and sub.in_q is not None:
            dorefa = isinstance(sub.in_q, functools.partial)
            handles.append(sub.register_forward_pre_hook(dorefa_levels if dorefa else quant))
        elif isinstance(sub, RSign):
            handles.append(sub.register_forward_pre_hook(rsign))
    return seen, handles


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def _deploy(family, conf, dyadic=False):
    """The float tree in ``conf``'s deployment, packed (and folded) by the
    JAX converter with the family's kernel quantizer."""
    params, stats = _float_tree(family, dyadic)
    if not conf.get("packed_weights"):
        return params, stats
    _, shape = FAMILIES[family]
    jm, _ = _models(family, conf)
    template = jax.eval_shape(lambda: jm.initialize(jm.build(shape, CLASSES), shape)[0])
    k_q = KERNEL_QUANTIZER.get(family, "ste_sign")
    if conf.get("fold_bn"):
        p, s = jax_pack(params, kernel_quantizer=k_q, template=template, fold_bn=True,
                        batch_stats=stats)
        return _np_tree(p), _np_tree(s)
    return _np_tree(jax_pack(params, kernel_quantizer=k_q, template=template)), stats


def _compare(family, conf, train):
    _, shape = FAMILIES[family]
    params, stats = _deploy(family, conf)
    batch = 2
    x = np.random.default_rng(INPUT_SEED[family]).normal(size=(batch, *shape)).astype(np.float32)
    jm, pm = _models(family, conf)
    jmod = jm.build(shape, CLASSES)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, new_state = jax.jit(lambda v, xb: jmod.apply(
            v, xb, training=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        want_stats = new_state["batch_stats"]
    else:
        want = jax.jit(lambda v, xb: jmod.apply(v, xb, training=False))(variables, jnp.asarray(x))
    want = np.asarray(want)

    module = pm.build(shape, CLASSES)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    module.train(train)
    seen, handles = _clearance_hooks(module)
    tbc.reset_launches()
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    for h in handles:
        h.remove()
    assert sum(tbc.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    if family != "DoReFaNet":
        assert seen and min(seen) > 1e-5, "a binary layer's input lies within rounding of zero"
    assert got.shape == (batch, CLASSES) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    if train:
        _, got_state = to_flax_variables(module)
        for path, w in jax.tree_util.tree_leaves_with_path(want_stats):
            g = functools.reduce(lambda t, k: t[k.key], path, got_state["batch_stats"])
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max())


MODES = ["mxu", "int8", "xnor", "xnor_popcount"]
CASES = [
    *((f, {"binary_compute": m}, train) for f in ("BiRealNet", "BinaryResNetE18",
                                               "RealToBinaryNet", "ReActNet")
      for m in MODES for train in (False, True)),
    *(("XNORNet", {"binary_compute": m}, train) for m in ("mxu", "int8") for train in (False, True)),
    ("XNORNet", {"binary_compute": "xnor", "dense_binary_compute": "xnor_popcount"}, False),
    ("DoReFaNet", {}, False),
    ("DoReFaNet", {}, True),
]
PACKED = [
    ("BiRealNet", "xnor_popcount", True), ("BiRealNet", "xnor", True),
    ("BiRealNet", "xnor_popcount", False), ("BinaryResNetE18", "xnor_popcount", True),
    ("BinaryResNetE18", "xnor", False), ("RealToBinaryNet", "xnor_popcount", False),
    ("XNORNet", "xnor_popcount", True), ("XNORNet", "xnor", False),
]


@pytest.mark.parametrize("family,conf,train", CASES,
                         ids=[f"{f}-{c.get('binary_compute', 'mxu')}-{'train' if t else 'eval'}"
                              for f, c, t in CASES])
def test_logits_match_flax(family, conf, train):
    _compare(family, conf, train)


@pytest.mark.parametrize("family,mode,fold", PACKED,
                         ids=[f"{f}-{m}-{'fold' if d else 'nofold'}" for f, m, d in PACKED])
def test_packed_deployment_logits_match_flax(family, mode, fold):
    conf = {"binary_compute": mode, "packed_weights": True}
    if fold:
        conf["fold_bn"] = True
    _compare(family, conf, False)


def _assert_trees(got, want, path, exact):
    assert sorted(got) == sorted(want), path
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _assert_trees(g, w, f"{path}/{key}", exact)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{key}"
        if exact or key == "kernel_packed" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                          w.view(np.int32) if w.dtype == np.float32 else w,
                                          err_msg=f"{path}/{key}")
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0, err_msg=f"{path}/{key}")


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "normal"])
@pytest.mark.parametrize("family,fold", [("BiRealNet", True), ("BiRealNet", False),
                                         ("XNORNet", True), ("BinaryResNetE18", True)])
def test_packed_tree_matches_jax(family, fold, dyadic):
    """``pack_quantconv_params`` with the family's kernel quantizer: the
    fold runs inside each block's scope, pairing the binary conv with the
    BN after it; the shortcut BN (after an fp conv) is never folded."""
    params, stats = _float_tree(family, dyadic)
    k_q = KERNEL_QUANTIZER.get(family, "ste_sign")
    _, pm = _models(family, {"binary_compute": "xnor_popcount", "packed_weights": True,
                             "fold_bn": fold})
    template, _ = to_flax_variables(pm.build(FAMILIES[family][1], CLASSES))
    if fold:
        want, want_stats = jax_pack(params, kernel_quantizer=k_q, template=template,
                                    fold_bn=True, batch_stats=stats)
        got, got_stats = port_pack(params, kernel_quantizer=k_q, template=template,
                                   fold_bn=True, batch_stats=stats)
        _assert_trees(_np_tree(got_stats), _np_tree(want_stats), "stats", True)
    else:
        want = jax_pack(params, kernel_quantizer=k_q, template=template)
        got = port_pack(params, kernel_quantizer=k_q, template=template)
    _assert_trees(_np_tree(got), _np_tree(want), "params", dyadic)
    if family == "BiRealNet":
        block = _np_tree(got)["_BiRealBlock_0"]  # 64 -> 8 channels: a shortcut conv
        assert list(block) == (["Conv_0", "BatchNorm_0", "QuantConv_0"] if fold else
                               ["Conv_0", "BatchNorm_0", "QuantConv_0", "BatchNorm_1"])
        assert set(block["QuantConv_0"]) == ({"kernel_packed", "kernel_scale", "bias"} if fold
                                             else {"kernel_packed", "kernel_scale"})


@pytest.mark.parametrize("family,mode", [("BiRealNet", "xnor_popcount"), ("BiRealNet", "xnor"),
                                         ("BinaryResNetE18", "xnor_popcount"),
                                         ("XNORNet", "xnor_popcount")])
def test_packed_init_serves_the_float_twin(family, mode):
    """A packed build initialized from a seed holds its float twin's
    weights packed with the family's kernel quantizer (Bi-Real-Net and
    XNOR-Net: mean|w| scales, not 1): without the fold both compute the
    same logits bit for bit; with it, within 1e-5 of the largest (the
    folded affine rounds once where the BN rounds twice)."""
    _, shape = FAMILIES[family]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, *shape)).astype(np.float32))
    _, float_model = _models(family, {"binary_compute": mode})
    twin = float_model.initialize(float_model.build(shape, CLASSES), seed=7)
    with torch.no_grad():
        want = twin(x).numpy()
    for fold in (False, True):
        _, packed_model = _models(family, {"binary_compute": mode, "packed_weights": True,
                                           "fold_bn": fold})
        packed = packed_model.initialize(packed_model.build(shape, CLASSES), seed=7)
        scales = [m.kernel_scale for m in packed.modules()
                  if isinstance(m, QuantConv) and m.packed_weights]
        assert scales
        if family in KERNEL_QUANTIZER and not fold:
            assert all(not torch.equal(s, torch.ones_like(s)) for s in scales)
        with torch.no_grad():
            got = packed(x).numpy()
        if fold:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


def test_fold_bn_is_deployment_only_and_raises_in_training():
    _, pm = _models("BiRealNet", {"binary_compute": "xnor_popcount", "packed_weights": True,
                                  "fold_bn": True})
    module = pm.build(FAMILIES["BiRealNet"][1], CLASSES).train()
    with pytest.raises(ValueError, match="DEPLOYMENT mode"):
        module(torch.zeros(1, *FAMILIES["BiRealNet"][1]))
    _, pm = _models("ReActNet", {"features": (8, 24), "strides": (1,)})
    with pytest.raises(ValueError, match="only same-width or exact doubling"):
        pm.build((16, 16, 3), CLASSES)
