"""The port's LM training path against the JAX package on the CPU: the
loss over ``[b, s, vocab]`` logits, the token pipeline, one train step of
a small TransformerLM from the same state, the LM train-state converter
and the ``TrainLM`` task.

Tolerances: the loss within 1e-6 relative (one fp32 log-softmax and a
mean on both sides); one step's loss and grad_norm within 1e-5 relative,
each gradient within 1e-4 of its tensor's largest magnitude (XLA and
oneDNN order the fp32 sums of the matmuls and the flash blocks
differently); Adam's moments within 1e-4 (mu) and 2e-4 (nu) of their
largest magnitude, as the gradients they come from; the updated weights
as ``test_torch_training.py`` states (lr * 1e-3 where |g| > 1e-6, else
lr: the first Adam step moves a weight by about lr * sign(g)).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.data import DataLoader as JaxDataLoader
from zookeeper_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from zookeeper_tpu.models.transformer import TransformerLM as JaxLM
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import smoothed_softmax_cross_entropy as jax_smoothed_loss
from zookeeper_tpu.training.step import softmax_cross_entropy as jax_loss
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.data import DataLoader as PortDataLoader
from zookeeper_tpu_torch.models import TransformerLM as PortLM
from zookeeper_tpu_torch.models.convert import (
    flax_train_state,
    from_flax_lm_variables,
    load_flax_train_state,
)
from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.training import Adam as PortAdam
from zookeeper_tpu_torch.training import TrainState as PortTrainState
from zookeeper_tpu_torch.training import make_train_step as port_make_train_step
from zookeeper_tpu_torch.training import smoothed_softmax_cross_entropy as port_smoothed_loss
from zookeeper_tpu_torch.training import softmax_cross_entropy as port_loss
from zookeeper_tpu_torch.training.lm import TrainLM

VOCAB, SEQ, BATCH, LR = 31, 32, 4, 1e-3
GEOMETRY = {"num_layers": 2, "d_model": 32, "num_heads": 2}
TOKENS = {"seq_len": SEQ, "vocab_size": VOCAB, "pattern_period": 7, "seed": 4,
          "num_train_examples": 12, "num_validation_examples": 5}


def _close(got, want, rtol):
    """``got`` within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


# -- the loss over the last axis ----------------------------------------------


@pytest.mark.parametrize("s,vocab", [(8, 31), (8, 8)], ids=["s!=vocab", "s==vocab"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_loss_takes_the_last_axis(s, vocab, smoothing):
    """Logits [b, s, vocab] and targets [b, s]: the mean over every
    position of the cross-entropy over the vocabulary, as optax's."""
    rng = np.random.default_rng(s + vocab)
    logits = (rng.normal(size=(2, s, vocab)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, size=(2, s)).astype(np.int32)
    want = float(jax_smoothed_loss(smoothing)(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(port_smoothed_loss(smoothing)(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if smoothing == 0.0:
        assert float(jax_loss(jnp.asarray(logits), jnp.asarray(labels))) == want
        assert float(port_loss(torch.from_numpy(logits), torch.from_numpy(labels))) == got


# -- the token pipeline ---------------------------------------------------------


def _loaders(**extra):
    conf = {"dataset": "SyntheticTokens", **{f"dataset.{k}": v for k, v in TOKENS.items()},
            "preprocessing": "TokenPreprocessing", "preprocessing.seq_len": SEQ,
            "batch_size": BATCH, "seed": 6, **extra}
    j, p = JaxDataLoader(), PortDataLoader()
    jax_configure(j, {"prefetch": 0, "host_index": 0, "host_count": 1, **conf}, name="loader")
    port_configure(p, conf, name="loader")
    return j, p


def test_token_batches_same_bytes():
    j, p = _loaders()
    assert p.dataset.resolved_num_classes() == j.dataset.resolved_num_classes() == VOCAB
    assert p.preprocessing.input_shape == j.preprocessing.input_shape == (SEQ,)
    assert p.preprocessing.input_dtype == j.preprocessing.input_dtype == "int32"
    for split in ("train", "validation"):
        js, ps = getattr(j.dataset, split)(), getattr(p.dataset, split)()
        for key in ("tokens", "next"):
            assert ps.arrays[key].dtype == js.arrays[key].dtype == np.int32
            assert ps.arrays[key].tobytes() == js.arrays[key].tobytes()
    for split, epoch in (("train", 0), ("train", 1), ("validation", 0)):
        training = split == "train"
        want = list(jax_batch_iterator(
            j._source(split).map(lambda e: e), j.preprocessing, BATCH, training=training,
            shuffle=training, seed=6, epoch=epoch, drop_remainder=True))
        got = list(p.host_batches(split, epoch=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("input", "target"):
                assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()


def test_pass_through_preprocessing_needs_its_shape():
    from zookeeper_tpu_torch.data import PassThroughPreprocessing

    pp = PassThroughPreprocessing()
    port_configure(pp, {"input_key": "x", "target_key": "y"}, name="preprocessing")
    out = pp({"x": np.arange(3), "y": np.int32(1)}, training=True)
    assert out["input"].tolist() == [0, 1, 2] and int(out["target"]) == 1
    assert pp.input_dtype is None
    with pytest.raises(ValueError, match="example_shape"):
        pp.input_shape


# -- one train step against JAX -------------------------------------------------


def _adam(cls):
    opt = cls()
    configure = jax_configure if cls is JaxAdam else port_configure
    configure(opt, {"schedule": "ConstantSchedule", "schedule.base_lr": LR}, name="optimizer")
    return opt


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_numpy_state(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {"step": np.array(state.step), "params": _numpy_tree(state.params),
            "model_state": _numpy_tree(state.model_state),
            "adam": {"count": np.array(adam.count), "mu": _numpy_tree(adam.mu),
                     "nu": _numpy_tree(adam.nu)}}


def _port_state(attention, jax_numpy_state, compute_dtype="float32"):
    model = PortLM()
    port_configure(model, {**GEOMETRY, "attention": attention, "compute_dtype": compute_dtype},
                   name="model")
    state = PortTrainState.create(model.build((SEQ,), VOCAB), _adam(PortAdam).build(10))
    return load_flax_train_state(state, **jax_numpy_state)


@functools.lru_cache(maxsize=None)
def _jax_step(attention):
    model = JaxLM()
    jax_configure(model, {**GEOMETRY, "attention": attention}, name="model")
    module = model.build((SEQ,), VOCAB)
    params, model_state = model.initialize(module, (SEQ,), seed=1)
    state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                 model_state=model_state, tx=_adam(JaxAdam).build(10))
    _, loader = _loaders()
    batch = next(iter(loader.host_batches("train")))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jax_loss(module.apply({"params": p}, jbatch["input"]), jbatch["target"])

    grads = jax.grad(loss)(state.params)
    new_state, metrics = jax.jit(jax_make_train_step(jax_loss))(state, jbatch)
    return (_jax_numpy_state(state), batch, _numpy_tree(grads), _jax_numpy_state(new_state),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_lm_train_step_matches_jax(attention):
    """One make_train_step step of a 2-layer TransformerLM (d 32, 2
    heads, seq 32, vocab 31, fp32) from the JAX state carried across by
    the LM train-state converter: loss, grad_norm, every gradient, the
    updated weights and Adam's moments. With "flash" both sides run the
    flash forward with lse and the recompute backward."""
    start, batch, jax_grads, jax_new, jax_metrics = _jax_step(attention)
    state = _port_state(attention, start)
    grads = {}
    update = state.tx.update

    def spy(g, opt_state, params):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(g, opt_state, params)

    state.tx.update = spy
    A.reset_launches()
    state, metrics = port_make_train_step(port_loss)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sum(A.LAUNCHES.values()) == 0  # CPU tensors: the plain versions

    np.testing.assert_allclose(float(metrics["loss"]), jax_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_metrics["grad_norm"], rtol=1e-5)
    assert float(metrics["accuracy"]) == jax_metrics["accuracy"]
    want_grads = from_flax_lm_variables(jax_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        _close(g.numpy(), want_grads[name].numpy(), 1e-4)
    got = flax_train_state(state)
    assert int(got["step"]) == int(jax_new["step"]) == 1
    assert int(got["adam"]["count"]) == int(jax_new["adam"]["count"]) == 1
    for path, want in jax.tree_util.tree_leaves_with_path(jax_new["params"]):
        atol = np.where(np.abs(_leaf(jax_grads, path)) > 1e-6, LR * 1e-3, LR)
        assert (np.abs(_leaf(got["params"], path) - want) <= atol).all(), str(path)
    for key, rtol in (("mu", 1e-4), ("nu", 2e-4)):
        for path, want in jax.tree_util.tree_leaves_with_path(jax_new["adam"][key]):
            _close(_leaf(got["adam"][key], path), want, rtol)


def test_lm_bf16_loss_trajectory_matches_jax():
    """Eight Adam steps (lr 1e-3) of the 2-layer TransformerLM in bf16
    with flash attention, from the same state and on the same eight
    batches through both packages: every step's loss within 1e-3
    relative of JAX's. The packages round to bf16 at other points of the
    step (XLA fuses casts into its kernels), which moves each loss by
    about 5e-5 relative at this size; a divergence such as a loss spike
    (a factor of 5 on the card at full width) or a cast in the wrong
    dtype is far outside. With the chip run's spike unexplained by the
    kernels (the fp32 step matches its plain version), this holds the
    port's bf16 arithmetic to the reference's over a trajectory."""
    steps = 8
    model = JaxLM()
    jax_configure(model, {**GEOMETRY, "attention": "flash", "compute_dtype": "bfloat16"},
                  name="model")
    module = model.build((SEQ,), VOCAB)
    params, model_state = model.initialize(module, (SEQ,), seed=1)
    jax_state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                     model_state=model_state, tx=_adam(JaxAdam).build(10))
    state = _port_state("flash", _jax_numpy_state(jax_state), compute_dtype="bfloat16")
    assert state.module.dtype == torch.bfloat16
    _, loader = _loaders(**{"dataset.num_train_examples": BATCH * steps})
    batches = list(loader.host_batches("train"))
    assert len(batches) == steps
    jax_step, port_step = jax.jit(jax_make_train_step(jax_loss)), port_make_train_step(port_loss)
    want, got = [], []
    for batch in batches:
        jax_state, metrics = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(metrics["loss"]))
        state, metrics = port_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[-1] < want[0] and got[-1] < got[0]


def _leaf(tree, path):
    return functools.reduce(lambda t, k: t[k.key], path, tree)


def test_lm_train_state_converter_round_trips():
    """JAX TrainState -> port -> JAX, bit for bit, with moments and
    counts that are not the initial ones."""
    _, _, _, jax_new, _ = _jax_step("flash")
    state = _port_state("flash", jax_new)
    with torch.no_grad():
        for i, t in enumerate(state.opt_state["nu"].values()):
            t.add_(0.5 * i)
    tree = flax_train_state(state)
    assert tree["model_state"] == {} and int(tree["step"]) == 1
    back = flax_train_state(_port_state("flash", tree))
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    for key in ("params", "adam"):
        a, b = flat(tree[key]), flat(back[key])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    for path, want in flat(jax_new["params"]):
        assert _leaf(tree["params"], path).tobytes() == np.asarray(want).tobytes()
    with pytest.raises(ValueError, match="no model state"):
        load_flax_train_state(state, **{**tree, "model_state": {"batch_stats": {}}})


# -- the task ---------------------------------------------------------------------


def test_train_lm_cli_trains_on_the_cpu():
    cmd = [sys.executable, "-m", "zookeeper_tpu_torch.training", "TrainLM", "device=cpu",
           "model.num_layers=2", "model.d_model=32", "model.num_heads=2", f"seq_len={SEQ}",
           f"loader.dataset.vocab_size={VOCAB}", "loader.dataset.num_train_examples=16",
           "loader.dataset.num_validation_examples=4", "batch_size=4", "steps_per_epoch=2",
           "epochs=2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("epoch ")]
    assert [l.split()[1] for l in lines] == ["1/2", "2/2"]
    assert all("val_loss=" in l for l in lines)


def test_train_lm_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = TrainLM()
    port_configure(exp, {"model.num_layers": 1, "model.d_model": 16, "model.num_heads": 2,
                         "loader.dataset.num_train_examples": 4, "batch_size": 4,
                         "verbose": False}, name="experiment")
    assert exp.device == "cuda" and exp.seq_len == 64
    assert exp.loader.dataset.seq_len == exp.loader.preprocessing.seq_len == 64
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp.run()
