"""The port's fp ResNet family (BASELINE config 5), SimpleCnn and Mlp
(config 1), the MNIST task and the new datasets against the JAX package.

Weights are the JAX module's own seeded init, carried into the port by
``from_flax_variables`` (BN statistics seeded too, so eval mode is not
the identity). Logits are held to ``1e-4 * max|logit|`` in float32 (XLA
and oneDNN order the conv sums differently) and to ``2**-5 * max|logit|``
in bfloat16 (every layer rounds to bfloat16, 2**-8 relative, on both
sides, in a different order; the differences compound over the layers).
Train mode's updated BN statistics are held to 2e-5 of their largest
(float32) or a bfloat16 step, 2**-7 (bfloat16). The datasets give the same
bytes as JAX's for the same seed, and ``TrainMnist`` tracks the JAX
example's losses from the same state.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu import data as jax_data
from zookeeper_tpu import models as jax_models
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu_torch import data as port_data
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import from_flax_variables, load_flax_train_state
from zookeeper_tpu_torch.training.mnist import TrainMnist

CASES = {
    "ResNet50": ({"blocks_per_section": (1, 1, 1, 1), "width": 8}, (48, 48, 3)),
    "ResNet101": ({"blocks_per_section": (1, 2, 1, 1), "width": 4}, (35, 35, 3)),
    "SimpleCnn": ({}, (28, 28, 1)),
    "SimpleCnn-nobn": ({"use_batch_norm": False, "features": (8, 16, 16)}, (28, 28, 1)),
    "Mlp": ({"hidden_units": (64, 32)}, (28, 28, 1)),
}
CLASSES = 10


def _models(case, dtype):
    conf, _ = CASES[case]
    family = case.split("-")[0]
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(jm, {**conf, "compute_dtype": dtype}, name="model")
    port_configure(pm, {**conf, "compute_dtype": dtype}, name="model")
    return jm, pm


def _seeded_stats(stats, rng):
    return {k: _seeded_stats(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.5, 1.5, v.shape) if k == "var" else rng.uniform(-0.3, 0.3, v.shape)
             ).astype(np.float32)
            for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _jax_init(case, dtype):
    """The flax module, its seeded parameters and statistics (numpy),
    built once for the eval and the train case."""
    _, shape = CASES[case]
    jm, _ = _models(case, dtype)
    jmod = jm.build(shape, CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, state = jax.jit(lambda: jm.initialize(jmod, shape, seed=2))()
    return (jmod, jax.tree.map(np.array, params),
            jax.tree.map(np.array, state.get("batch_stats", {})))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_flax(case, dtype, train):
    _, shape = CASES[case]
    _, pm = _models(case, dtype)
    jmod, params, stats = _jax_init(case, dtype)
    stats = _seeded_stats(stats, np.random.default_rng(5))
    x = np.random.default_rng(6).normal(size=(3, *shape)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, new_state = jax.jit(lambda v, xb: jmod.apply(
            v, xb, training=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        want = jax.jit(lambda v, xb: jmod.apply(v, xb, training=False))(variables, jnp.asarray(x))
    want = np.asarray(want)

    module = pm.build(shape, CLASSES)
    module.load_state_dict(from_flax_variables(params, {"batch_stats": stats}))
    module.train(train)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, CLASSES)
    assert torch.isfinite(got).all()
    tol = 1e-4 if dtype == "float32" else 2.0**-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    if train and stats:
        stat_tol = 2e-5 if dtype == "float32" else 2.0**-7
        got_stats = dict(module.named_buffers())
        for path, w in jax.tree_util.tree_leaves_with_path(new_state["batch_stats"]):
            keys = [k.key for k in path]
            name = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
            np.testing.assert_allclose(got_stats[name].numpy(), np.asarray(w), rtol=0,
                                       atol=stat_tol * np.abs(np.asarray(w)).max())


def test_resnet_depths_and_bottleneck_scopes():
    """ResNet50/101/152 have the published depths, and each bottleneck is a
    nested scope whose shortcut conv comes first where it has one."""
    for family, blocks in (("ResNet50", (3, 4, 6, 3)), ("ResNet101", (3, 4, 23, 3)),
                           ("ResNet152", (3, 8, 36, 3))):
        model = getattr(port_models, family)()
        port_configure(model, {}, name="model")
        assert tuple(model.blocks_per_section) == blocks
    model = port_models.ResNet50()
    port_configure(model, {"blocks_per_section": (2, 1, 1, 1), "width": 8}, name="model")
    module = model.build((32, 32, 3), CLASSES)
    first, second = module._Bottleneck_0, module._Bottleneck_1
    assert first.shortcut == ("Conv_0", "BatchNorm_0") and second.shortcut is None
    assert first.Conv_0.weight.shape == (32, 8, 1, 1)
    assert module._Bottleneck_2.Conv_0.strides == (2, 2)


# -- datasets -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["SyntheticMnist", "SyntheticCifar10"])
def test_synthetic_datasets_same_bytes(name):
    conf = {"num_train_examples": 24, "num_validation_examples": 8, "seed": 3}
    j, p = getattr(jax_data, name)(), getattr(port_data, name)()
    jax_configure(j, conf, name="dataset")
    port_configure(p, conf, name="dataset")
    assert p.resolved_num_classes() == j.resolved_num_classes() == 10
    for split in ("train", "validation"):
        js, ps = getattr(j, split)(), getattr(p, split)()
        assert len(js) == len(ps)
        for key in ("image", "label"):
            a, b = np.asarray(ps.arrays[key]), np.asarray(js.arrays[key])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arrays", [
    {"image": np.zeros((5, 2, 2, 1), np.uint8), "label": np.array([0, 3, 1, 2, 1])},
    {"image": np.zeros((4, 2, 2, 1), np.uint8), "y": np.array([4, 0, 1, 2], np.int64)},
], ids=["label", "one-integer-feature"])
def test_array_dataset_matches_jax(arrays):
    j, p = jax_data.ArrayDataset(), port_data.ArrayDataset()
    jax_configure(j, {}, name="dataset")
    port_configure(p, {}, name="dataset")
    j.with_data(arrays, arrays)
    p.with_data(arrays, arrays)
    assert p.resolved_num_classes() == j.resolved_num_classes()
    assert len(p.train()) == len(j.train()) and len(p.validation()) == len(j.validation())
    empty = port_data.ArrayDataset()
    port_configure(empty, {}, name="dataset")
    with pytest.raises(ValueError, match="with_data"):
        empty.train()


# -- the MNIST task -----------------------------------------------------------

MNIST_CONF = {
    "loader.dataset.num_train_examples": 24,
    "loader.dataset.num_validation_examples": 8,
    "loader.seed": 2,
    "optimizer": "Adam",
    "optimizer.schedule": "ConstantSchedule",
    "optimizer.schedule.base_lr": 1e-3,
    "epochs": 3,
    "steps_per_epoch": 1,
    "batch_size": 8,
    "seed": 1,
    "validate": False,
    "verbose": False,
}


def _jax_state_numpy(state):
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    tree = functools.partial(jax.tree.map, np.array)
    return {"step": np.array(state.step), "params": tree(state.params),
            "model_state": tree(state.model_state),
            "adam": {"count": np.array(adam.count), "mu": tree(adam.mu), "nu": tree(adam.nu)}}


def test_train_mnist_tracks_the_jax_example(monkeypatch):
    """Three TrainMnist steps (one per epoch) from the same initial state
    track the JAX example's (``examples/mnist_experiment.py``: SimpleCnn
    on SyntheticMnist at 28x28x1) losses within 1e-3 relative (the
    gradients agree to ~1e-5; three Adam steps move each weight by ~lr
    sign(g))."""
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {
        **MNIST_CONF, "loader.host_index": 0, "loader.host_count": 1,
        "loader.dataset": "SyntheticMnist",
        "loader.preprocessing": "ImageClassificationPreprocessing",
        "loader.preprocessing.height": 28, "loader.preprocessing.width": 28,
        "loader.preprocessing.channels": 1, "model": "SimpleCnn",
    }, name="experiment")
    start = _jax_state_numpy(jax_exp.build_state())
    want = [e["loss"] for e in jax_exp.run()["train"]]

    port_exp = TrainMnist()
    port_configure(port_exp, {**MNIST_CONF, "device": "cpu"}, name="experiment")
    build = TrainMnist.build_state
    monkeypatch.setattr(TrainMnist, "build_state",
                        lambda self, device: load_flax_train_state(build(self, device), **start))
    got = [e["loss"] for e in port_exp.run()["train"]]
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_train_mnist_cli_runs_on_the_cpu_and_on_the_card_by_default(monkeypatch):
    cmd = [sys.executable, "-m", "zookeeper_tpu_torch.training", "TrainMnist", "device=cpu",
           "loader.dataset.num_train_examples=32", "loader.dataset.num_validation_examples=8",
           "batch_size=8", "steps_per_epoch=2", "epochs=2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("epoch ")]
    assert [l.split()[1] for l in lines] == ["1/2", "2/2"]
    assert all("val_loss=" in l for l in lines)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = TrainMnist()
    port_configure(exp, {"verbose": False}, name="experiment")
    assert exp.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp.run()
