"""The port's optimizers and schedules against the JAX package's (optax).

Every schedule is held to optax over counts 0..N+4 (rtol 1e-6), on the
host and read from the card's side (a count tensor). Every optimizer,
``MultiSteps`` at k = 2 and 3, ``scale_by_bop`` with flat and scheduled
knobs and ``Bop``'s split take the same gradients for several steps in
both packages: parameters and state within rtol 1e-6 / atol 1e-7 (optax
and the port round the same float32 ops in the same order; the norms of
the clip and the trust ratio, and ``rsqrt``, may differ in the last
place), Bop's flips bit for bit. Where a flip turns on ``|m|`` against
``threshold`` the test asserts the margin clears rounding. The same runs
with the counts on the card's side (as a train step under a
``nan_policy`` keeps them) meet optax at the same tolerance. Bop's
binary/fp labels equal the JAX split's on five zoo models, and every
``ValueError`` of ``Bop.build`` carries JAX's text.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from zookeeper_tpu import models as jax_models
from zookeeper_tpu import training as jax_training
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.training import schedule as jax_schedule
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch import training as port_training
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import flax_param_paths
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN
from zookeeper_tpu_torch.training import schedule as port_schedule
from zookeeper_tpu_torch.training.optimizer import counts_to_device

RTOL, ATOL = 1e-6, 1e-7

#: Flat parameters under flax paths: two binary kernels (Bop's), the rest fp.
SHAPES = {
    "QuantConv_0/kernel": (3, 3, 4, 8),
    "BatchNorm_0/scale": (8,),
    "BatchNorm_0/bias": (8,),
    "QuantDense_0/kernel": (32, 10),
    "QuantDense_0/bias": (10,),
    "Dense_0/kernel": (10, 5),
}


def _pair(cls_name, conf, module=port_training, jax_module=jax_training, name="optimizer"):
    jx, pt = getattr(jax_module, cls_name)(), getattr(module, cls_name)()
    jax_configure(jx, conf, name=name)
    port_configure(pt, conf, name=name)
    return jx, pt


# -- schedules --------------------------------------------------------------


SCHEDULES = [
    ("StepDecay", {"base_lr": 0.1}, 20),
    ("StepDecay", {"base_lr": 0.1, "boundaries": [0.3, 0.35, 0.9], "factor": 0.5}, 3),
    ("StepDecay", {"base_lr": 0.2, "boundaries": [0.25, 1.5]}, 8),
    ("PolynomialDecay", {"base_lr": 0.1, "end_lr": 0.01}, 17),
    ("PolynomialDecay", {"base_lr": 0.1, "end_lr": 1e-3, "power": 2.0}, 9),
    ("LinearWarmup", {"base_lr": 0.3, "warmup_steps": 5}, 12),
    ("LinearWarmup", {"base_lr": 0.3}, 40),
    ("WarmupCosine", {"base_lr": 0.01, "warmup_steps": 3, "alpha": 0.1}, 10),
    ("CosineDecay", {"base_lr": 0.02, "alpha": 0.05}, 7),
    ("ConstantSchedule", {"base_lr": 0.007}, 4),
]


@pytest.mark.parametrize("cls,conf,total", SCHEDULES)
def test_schedules_match_optax_on_host_and_card_counts(cls, conf, total):
    js, ps = _pair(cls, conf, port_schedule, jax_schedule, name="schedule")
    jf, pf = js.build(total), ps.build(total)
    counts = range(total + 5)
    want = [float(jf(jnp.int32(c))) for c in counts]
    np.testing.assert_allclose([pf(c) for c in counts], want, rtol=RTOL, atol=1e-12)
    on_card = [pf(torch.tensor(c, dtype=torch.int32)) for c in counts]
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in on_card)
    assert [float(t) for t in on_card] == [pf(c) for c in counts]


def test_step_decay_compounds_boundaries_that_collapse():
    js, ps = _pair("StepDecay", {"base_lr": 1.0, "boundaries": [0.5, 0.6], "factor": 0.1},
                   port_schedule, jax_schedule, name="schedule")
    pf = ps.build(3)  # both boundaries land on step 1
    assert pf(0) == 1.0
    np.testing.assert_allclose(pf(1), 0.01, rtol=RTOL)
    np.testing.assert_allclose(pf(1), float(js.build(3)(jnp.int32(1))), rtol=RTOL)


# -- optimizer runs ---------------------------------------------------------


def _params(seed=0):
    rng = np.random.default_rng(seed)
    # Kept clear of 0, so no sign is within rounding of a flip.
    out = {}
    for k, s in SHAPES.items():
        v = rng.normal(size=s).astype(np.float32)
        out[k] = np.where(np.abs(v) < 0.05, np.float32(0.05) * np.sign(v + 1e-9), v).astype(np.float32)
    return out


def _grads(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}


def _state_dict(s):
    """An optax state as the port's dict under optax's names."""
    if isinstance(s, optax.MultiStepsState):
        return {"mini_step": s.mini_step, "gradient_step": s.gradient_step,
                "inner_opt_state": _state_dict(s.inner_opt_state), "acc_grads": s.acc_grads}
    if isinstance(s, optax.MultiTransformState):
        return {k: _state_dict(v) for k, v in s.inner_states.items()}
    if isinstance(s, optax.MaskedState):
        return _state_dict(s.inner_state)
    if hasattr(s, "_fields"):
        return {f: getattr(s, f) for f in s._fields}
    out = {}
    for part in s:  # a chain: merge its stages' fields (their counts agree)
        for key, value in _state_dict(part).items():
            if key == "count" and key in out:
                assert int(out[key]) == int(value)
            out[key] = value
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()
            if not isinstance(v, optax.MaskedNode)}


def _assert_state(port, want, where=""):
    assert set(port) == set(want), (where, sorted(port), sorted(want))
    for key, value in port.items():
        if key in ("count", "mini_step", "gradient_step"):
            assert int(value) == int(want[key]), where + key
        elif key in ("mu", "nu", "trace", "gradient_memory", "acc_grads"):
            jflat = _flat(want[key]) if isinstance(want[key], dict) else {}
            assert set(value) == set(jflat), where + key
            for name, t in value.items():
                np.testing.assert_allclose(t.numpy(), jflat[name], rtol=RTOL, atol=ATOL,
                                           err_msg=where + key + "/" + name)
        else:
            _assert_state(value, want[key], f"{where}{key}/")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _run(jtx, ptx, steps=5, grad_scale=1.0, on_card=False, check_margin=None, seed=1):
    """Feed both the same gradients for ``steps`` steps; compare after each."""
    rng = np.random.default_rng(seed)
    start = _params()
    jp = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in start.items()})
    jstate = jtx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    pstate = ptx.init(pp)
    if on_card:
        counts_to_device(pstate, torch.device("cpu"))
    for step in range(steps):
        g = _grads(rng, grad_scale)
        jg = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in g.items()})
        updates, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, pstate, pp)
        jflat = _flat(jp)
        if check_margin is not None:
            check_margin(jstate)
        for k, v in pp.items():
            if re.search(BINARY_KERNEL_PATTERN, k) and check_margin is not None:
                assert np.array_equal(_bits(v.numpy()), _bits(jflat[k])), (step, k)
            np.testing.assert_allclose(v.numpy(), jflat[k], rtol=RTOL, atol=ATOL, err_msg=f"{step} {k}")
        _assert_state(pstate, _state_dict(jstate))
    return pstate


OPTIMIZERS = [
    ("Sgd", {"schedule.base_lr": 0.1}),
    ("Sgd", {"schedule": "WarmupCosine", "schedule.base_lr": 0.1, "schedule.warmup_steps": 2,
             "weight_decay": 1e-2, "global_clip_norm": 2.0}),
    ("Momentum", {"schedule.base_lr": 0.05}),
    ("Momentum", {"schedule.base_lr": 0.05, "nesterov": True, "momentum": 0.8,
                  "weight_decay": 1e-3}),
    ("Adam", {"schedule": "StepDecay", "schedule.base_lr": 1e-2}),
    ("AdamW", {"schedule": "PolynomialDecay", "schedule.base_lr": 1e-2, "global_clip_norm": 1.0}),
    ("Rmsprop", {"schedule.base_lr": 1e-3}),
    ("Rmsprop", {"schedule": "LinearWarmup", "schedule.base_lr": 1e-3, "momentum": 0.9,
                 "decay": 0.8}),
    ("Lamb", {"schedule.base_lr": 1e-2}),
    ("Lamb", {"schedule.base_lr": 1e-2, "weight_decay": 1e-2, "b1": 0.8}),
    ("Lars", {"schedule.base_lr": 0.1}),
    ("Lars", {"schedule.base_lr": 0.1, "weight_decay": 1e-4, "trust_coefficient": 0.01}),
]


@pytest.mark.parametrize("on_card", [False, True], ids=["host_counts", "card_counts"])
@pytest.mark.parametrize("cls,conf", OPTIMIZERS)
def test_optimizers_match_optax(cls, conf, on_card):
    jx, pt = _pair(cls, conf)
    _run(jx.build(8), pt.build(8), on_card=on_card)


@pytest.mark.parametrize("on_card", [False, True], ids=["host_counts", "card_counts"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("cls,conf", [
    ("Adam", {"schedule": "WarmupCosine", "schedule.base_lr": 1e-2, "schedule.warmup_steps": 1}),
    ("Momentum", {"schedule.base_lr": 0.05, "global_clip_norm": 1.5}),
])
def test_accumulation_matches_multisteps(cls, conf, k, on_card):
    jx, pt = _pair(cls, {**conf, "accumulate_steps": k})
    ptx = pt.build(12)
    assert isinstance(ptx, port_training.optimizer.MultiSteps)
    state = _run(jx.build(12), ptx, steps=2 * k + 1, on_card=on_card)
    # The inner count advanced only on the two boundaries.
    assert int(state["inner_opt_state"]["count"]) == 2


def _bop_margin(threshold_at):
    """Every memory value's |m| is clear of the threshold by more than
    rounding, so no flip turns on the last bit."""

    def check(jstate):
        s = _state_dict(jstate)
        bop = s["binary"] if "binary" in s else s.get("inner_opt_state", {}).get("binary", s)
        t = threshold_at(int(bop["count"]) - 1)
        for m in _flat(bop["gradient_memory"]).values():
            margin = np.abs(np.abs(m) - t)
            assert (margin > 1e-5 * np.maximum(np.abs(m), t)).all()

    return check


@pytest.mark.parametrize("knobs", ["flat", "scheduled"])
def test_scale_by_bop_matches_jax(knobs):
    if knobs == "flat":
        threshold, gamma = 0.02, 0.3
        jt, jg, pt_, pg = threshold, gamma, threshold, gamma
        at = lambda c: threshold  # noqa: E731
    else:
        jsched, psched = _pair("PolynomialDecay", {"base_lr": 0.3, "end_lr": 0.1},
                               port_schedule, jax_schedule, name="schedule")
        tj, tp = _pair("StepDecay", {"base_lr": 0.03, "boundaries": [0.4], "factor": 0.5},
                       port_schedule, jax_schedule, name="schedule")
        jg, pg = jsched.build(5), psched.build(5)
        jt, pt_ = tj.build(5), tp.build(5)
        at = lambda c: np.float32(pt_(c))  # noqa: E731
    jtx = jax_training.scale_by_bop(threshold=jt, gamma=jg)
    ptx = port_training.scale_by_bop(threshold=pt_, gamma=pg)
    _run(jtx, ptx, steps=5, check_margin=_bop_margin(at))


@pytest.mark.parametrize("on_card", [False, True], ids=["host_counts", "card_counts"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_bop_split_matches_multi_transform(k, on_card):
    conf = {"threshold": 0.02, "gamma": 0.3, "fp_optimizer.schedule.base_lr": 1e-2,
            "fp_optimizer.global_clip_norm": 1.0, "accumulate_steps": k}
    jx, pt = _pair("Bop", conf)
    ptx = pt.build(12)
    _run(jx.build(12), ptx, steps=3 * k, on_card=on_card, check_margin=_bop_margin(lambda c: 0.02))
    labels = (ptx.inner if k > 1 else ptx).labels
    assert {n for n, side in labels.items() if side == "binary"} == {
        "QuantConv_0/kernel", "QuantDense_0/kernel"}


def test_bop_flip_adds_minus_two_w_as_optax_does():
    """A flip is exact, and an unflipped -0.0 becomes +0.0 (``w + 0``)."""
    tx = port_training.scale_by_bop(threshold=0.0, gamma=1.0)
    w = torch.tensor([1.5, -0.0, 0.25, -3.0])
    state = tx.init({"w": w})
    tx.update({"w": torch.tensor([2.0, 1.0, -1.0, 0.0])}, state, {"w": w})
    assert _bits(w.numpy()).tolist() == _bits(np.array([-1.5, 0.0, 0.25, -3.0])).tolist()


# -- Bop's labels and refusals ----------------------------------------------


ZOO = [
    ("QuickNet", {"blocks_per_section": (1, 1, 1, 1), "section_features": (32, 32, 64, 64)}),
    ("BiRealNet", {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64)}),
    ("RealToBinaryNet", {"blocks_per_section": (1, 1, 1, 1), "section_features": (8, 16, 32, 64)}),
    ("BinaryDenseNet28", {"layers_per_block": (2, 2), "reduction": (2.0,), "dilation": (1, 1),
                          "growth_rate": 16, "initial_features": 32}),
    ("BinaryNet", {"features": (16, 16, 32, 32), "dense_units": (64,)}),
]


@pytest.mark.parametrize("family,conf", ZOO)
def test_bop_labels_equal_the_jax_split(family, conf):
    shape, classes = (32, 32, 3), 10
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(jm, conf, name="model")
    port_configure(pm, conf, name="model")
    jmodule = jm.build(shape, num_classes=classes)
    params, _ = jax.eval_shape(lambda: jm.initialize(jmodule, shape, seed=0))
    pattern = re.compile(BINARY_KERNEL_PATTERN)
    want = {p: ("binary" if pattern.search(p) else "fp")
            for p in traverse_util.flatten_dict(params, sep="/")}
    module = pm.build(shape, classes)
    paths = flax_param_paths(module)
    bop = port_training.Bop()
    ptx = bop.build(10)
    ptx.init(dict(module.named_parameters()), paths)
    got = {paths[n]: side for n, side in ptx.labels.items()}
    assert got == want
    assert "binary" in got.values() and "fp" in got.values()


REFUSALS = [
    {"weight_decay": 1e-4},
    {"global_clip_norm": 1.0},
    {"schedule": "WarmupCosine"},
    {"schedule.base_lr": 0.5},
    {"gamma": 1e-3, "gamma_schedule": "CosineDecay"},
    {"threshold": 1e-6, "threshold_schedule.base_lr": 1e-7},
]


@pytest.mark.parametrize("conf", REFUSALS)
def test_bop_refusals_carry_the_jax_text(conf):
    jx, pt = _pair("Bop", conf)
    with pytest.raises(ValueError) as jerr:
        jx.build(10)
    with pytest.raises(ValueError) as perr:
        pt.build(10)
    assert str(perr.value) == str(jerr.value)
