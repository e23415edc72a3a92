"""The port's fused multi-step loop (``TrainingExperiment.unroll``,
``training.step.build_multi_step``) on the CPU, against the port's eager
loop and the JAX package's ``unroll``: the cases of JAX's
``tests/training/test_multi_step.py`` (but the data-parallel mesh), and
the port's own.

- Against the eager loop, bit for bit: every state tensor (parameters,
  statistics, optimizer state and counts, EMA, step) and every per-step
  metric. On the CPU the fused loop is the same steps in the same order.
- Against JAX's ``unroll``: per-step losses within 1e-3 relative, the
  bound ``test_torch_training.py``'s experiment steps are held to (the
  gradients agree to ~1e-5; a few Adam steps move each weight by about
  lr sign(g)).
- What the card's CUDA graph relies on, checked here without a card: the
  state with its counts and step on the device (``prepare_for_graph``)
  gives the host counts' bits for every optimizer option and the NaN
  fault; every state tensor keeps its storage across a step; and the step
  asks the host for nothing (no scalar read back, no host tensor copied
  in), which a capture forbids.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.resilience import (
    FaultPlan,
    NonFiniteLossError,
    Preempted,
    faults,
    run_with_recovery,
)
from zookeeper_tpu_torch.training import (
    TrainingExperiment,
    build_multi_step,
    finalized_steps,
    make_train_step,
    prepare_for_graph,
)
from zookeeper_tpu_torch.training.benchmark import measure_fused_loop_time
from zookeeper_tpu_torch.training.profiling import slab_annotation
from zookeeper_tpu_torch.training.step import state_storage

MNIST = {
    "loader.dataset": "SyntheticMnist",
    "loader.dataset.num_train_examples": 256,
    "loader.dataset.num_validation_examples": 64,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28,
    "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1,
    "batch_size": 32,
    "epochs": 2,
    "verbose": False,
    "device": "cpu",
}
MLP = {"model": "Mlp", "model.hidden_units": (32,)}
CNN = {"model": "SimpleCnn", "model.features": (8, 16), "model.dense_units": (32,)}
BINARY = {"model": "BinaryNet", "model.features": (8, 8, 16, 16), "model.dense_units": (32,)}
BOP = {"optimizer": "Bop", "optimizer.fp_optimizer.schedule": "ConstantSchedule",
       "optimizer.fp_optimizer.schedule.base_lr": 1e-3}


def make_experiment(extra=None, cls=TrainingExperiment):
    exp = cls()
    extra = dict(extra or {})
    conf = {**MNIST, **({} if "model" in extra else MLP), **extra}
    configure(exp, conf, name="experiment")
    return exp


def flat_state(state):
    """Every tensor and count the next step reads, by name."""
    out = {f"module {k}": v for k, v in state.module.state_dict().items()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"opt {prefix}{k}"] = v

    walk(state.opt_state, "")
    out.update({f"ema {k}": v for k, v in (state.ema_params or {}).items()})
    out["step"] = state.step
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else torch.tensor(int(v)))
            for k, v in out.items()}


def assert_states_equal(a, b, counts_as_values=False):
    fa, fb = flat_state(a), flat_state(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if counts_as_values and x.ndim == 0 and not x.is_floating_point():
            x, y = x.long(), y.long()
        assert x.dtype == y.dtype and torch.equal(x, y), k


def assert_histories_equal(h_a, h_b):
    for split in ("train", "validation"):
        assert len(h_a[split]) == len(h_b[split])
        for a, b in zip(h_a[split], h_b[split]):
            assert set(a) == set(b)
            for k, v in a.items():
                if k != "examples_per_sec":
                    assert v == b[k] or (np.isnan(v) and np.isnan(b[k])), (split, k)


def run_pair(conf, unroll, cls=TrainingExperiment):
    ref = make_experiment(conf, cls)
    h_ref = ref.run()
    fused = make_experiment({**conf, "unroll": unroll}, cls)
    h_fused = fused.run()
    return ref, h_ref, fused, h_fused


# -- build_multi_step ---------------------------------------------------------


def _mlp_state(seed=0):
    from zookeeper_tpu_torch.models import Mlp
    from zookeeper_tpu_torch.training import Adam, TrainState

    m = Mlp()
    configure(m, {"hidden_units": (8,)}, name="m")
    module = m.build((4, 4, 1), num_classes=3)
    m.initialize(module, seed=seed)
    opt = Adam()
    configure(opt, {}, name="opt")
    return TrainState.create(module, opt.build(total_steps=10))


def _batches(n, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return [{"input": torch.from_numpy(rng.normal(size=(8, 4, 4, 1)).astype(np.float32)),
             "target": torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))}
            for _ in range(n)]


def test_build_multi_step_matches_sequential_steps():
    """The multi-step over a slab of 5 is 5 eager steps: parameters,
    optimizer state, the step and the per-step metrics, bit for bit."""
    batches = _batches(5)
    eager = _mlp_state()
    step = make_train_step()
    per_step = []
    for b in batches:
        eager, m = step(eager, b)
        per_step.append(m)
    slab = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    fused, stacked = build_multi_step(make_train_step())(_mlp_state(), slab)
    assert fused.step == 5
    assert_states_equal(eager, fused)
    for i, m in enumerate(per_step):
        for k, v in m.items():
            assert stacked[k].shape == (5,)
            assert torch.equal(v, stacked[k][i]), (k, i)


def test_multi_step_matches_jax_multi_step():
    """The port's multi-step against JAX's ``build_multi_step`` under
    ``jax.jit`` from the same start state: the per-step losses within
    1e-3 relative, the step counters equal."""
    import jax
    import jax.numpy as jnp
    import optax

    from zookeeper_tpu.core import configure as jax_configure
    from zookeeper_tpu.models import Mlp as JaxMlp
    from zookeeper_tpu.training import TrainState as JaxTrainState
    from zookeeper_tpu.training import build_multi_step as jax_build_multi_step
    from zookeeper_tpu.training import make_train_step as jax_make_train_step
    from zookeeper_tpu_torch.models.convert import load_flax_train_state

    m = JaxMlp()
    jax_configure(m, {"hidden_units": (8,)}, name="m")
    module = m.build((4, 4, 1), num_classes=3)
    params, model_state = m.initialize(module, (4, 4, 1))
    jstate = JaxTrainState.create(apply_fn=module.apply, params=params,
                                  model_state=model_state, tx=optax.adam(1e-3))
    batches = _batches(5)
    slab = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    jslab = {k: jnp.asarray(v.numpy()) for k, v in slab.items()}
    jstate, jmetrics = jax.jit(jax_build_multi_step(jax_make_train_step()))(jstate, jslab)

    adam = jax.tree_util.tree_leaves(
        JaxTrainState.create(apply_fn=module.apply, params=params, model_state=model_state,
                             tx=optax.adam(1e-3)).opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))[0]
    start = {"step": np.array(0), "params": jax.tree.map(np.array, params),
             "model_state": jax.tree.map(np.array, model_state),
             "adam": {"count": np.array(adam.count), "mu": jax.tree.map(np.array, adam.mu),
                      "nu": jax.tree.map(np.array, adam.nu)}}
    port = load_flax_train_state(_mlp_state(), **start)
    port, metrics = build_multi_step(make_train_step())(port, slab)
    assert port.step == int(jstate.step) == 5
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]),
                               rtol=1e-3)


# -- the experiment's fused loop against the eager loop ---------------------------


@pytest.mark.parametrize("unroll", [2, 3, 4])
def test_unroll_bit_exact_with_eager_loop(unroll):
    """``unroll`` k over 8 steps an epoch (slabs of 3, 3, 2 at k 3): the
    epochs' train and validation metrics and the final state equal the
    eager loop's, bit for bit."""
    ref, h_ref, fused, h_fused = run_pair({}, unroll)
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)
    assert fused.final_state.step == 16


def test_unroll_bit_exact_conv_model():
    """SimpleCnn (convolutions, BatchNorm statistics) at unroll 3: the
    eager loop's bits (the JAX package's scan differs here by XLA's
    reduction order; the port runs the same kernels either way)."""
    ref, h_ref, fused, h_fused = run_pair({**CNN, "epochs": 1}, 3)
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


def test_unroll_mid_slab_resume_bit_exact(tmp_path):
    """A step checkpoint at step 5 resumes mid-slab under unroll 4 (the
    first slab covers steps 5-7) and lands on the uninterrupted eager
    run's bits."""
    ckpt = {"checkpointer.directory": str(tmp_path / "ckpt"),
            "checkpointer.save_every_steps": 5, "checkpointer.save_every_epochs": 0,
            "checkpointer.synchronous": True}
    make_experiment({"epochs": 1, **ckpt}).run()
    resumed = make_experiment({"epochs": 2, "unroll": 4, **ckpt})
    h_resumed = resumed.run()
    ref = make_experiment()
    h_ref = ref.run()
    assert_states_equal(ref.final_state, resumed.final_state)
    for k, v in h_ref["train"][1].items():
        if k != "examples_per_sec":
            assert v == h_resumed["train"][1][k], k


def test_unroll_step_cadence_checkpoints_quantize_to_slab_end(tmp_path):
    """Step saves fire at the end of the slab holding the due step: 8
    steps in slabs [0, 4), [4, 8), due at 3 and 6 -> saved at 4 and 8."""
    directory = str(tmp_path / "ckpt")
    make_experiment({"epochs": 1, "unroll": 4, "checkpointer.directory": directory,
                     "checkpointer.save_every_steps": 3, "checkpointer.save_every_epochs": 0,
                     "checkpointer.synchronous": True}).run()
    assert finalized_steps(directory) == [4, 8]


def test_deferred_readback_logs_same_metrics_as_eager(tmp_path):
    """``log_every`` 2 under unroll 3 (readbacks straddling the slab
    ends): the ``train/`` rows equal the eager loop's, step for step."""
    rows = {}
    for name, unroll in (("eager", 1), ("fused", 3)):
        path = str(tmp_path / f"{name}.jsonl")
        make_experiment({"epochs": 1, "unroll": unroll, "log_every": 2,
                         "writer.jsonl.path": path}).run()
        with open(path) as f:
            rows[name] = [r for r in map(json.loads, f)
                          if any(k.startswith("train/") for k in r)]
    assert len(rows["eager"]) == 4
    assert rows["eager"] == rows["fused"]


def test_unroll_respects_steps_per_epoch_cap():
    """A cap inside a slab truncates it: 5 steps at unroll 4 -> 4 + 1."""
    ref, h_ref, fused, h_fused = run_pair({"epochs": 1, "steps_per_epoch": 5}, 4)
    assert fused.final_state.step == 5
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


@pytest.mark.parametrize("unroll", [0, -2])
def test_unroll_invalid_rejected(unroll):
    with pytest.raises(ValueError, match="unroll"):
        make_experiment({"unroll": unroll}).run()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_unroll_kill_midepoch_recovery_bit_exact(tmp_path, mode):
    """A kill at step 5 under unroll 3 exits at the slab end, step 6,
    after one synchronous save (async: step saves every 3 ride the
    writer); ``run_with_recovery`` resumes to the uninterrupted eager
    run's bits."""
    ref = make_experiment()
    h_ref = ref.run()
    ckpt = {"checkpointer.directory": str(tmp_path / "ckpt"),
            "checkpointer.save_every_epochs": 0}
    if mode == "sync":
        ckpt.update({"checkpointer.synchronous": True, "checkpointer.save_every_steps": 0})
    else:
        ckpt.update({"checkpointer.mode": "async", "checkpointer.save_every_steps": 3,
                     "checkpointer.save_retry_backoff_s": 0.0})
    exp = make_experiment({"unroll": 3, **ckpt})
    with faults.injected(FaultPlan(kill_at_step=5)):
        result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 1 and isinstance(result.causes[0], Preempted)
    assert result.causes[0].step == 6 and result.causes[0].saved
    assert_states_equal(ref.final_state, exp.final_state)
    for k, v in h_ref["train"][1].items():
        if k != "examples_per_sec":
            assert v == result.history["train"][1][k], k


def test_unroll_with_ema_label_smoothing_and_flip_ratio_bit_exact():
    """EMA, label smoothing and the flip ratio ride the slab unchanged
    (a binary net, so the flip ratio has kernels to read)."""
    conf = {**BINARY, "epochs": 1, "ema_decay": 0.9, "label_smoothing": 0.1,
            "track_flip_ratio": True, "steps_per_epoch": 6}
    ref, h_ref, fused, h_fused = run_pair(conf, 4)
    assert "flip_ratio" in h_ref["train"][0]
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


@pytest.mark.parametrize("policy", ["skip", "halt"])
def test_unroll_nan_policy_with_fault_inside_a_slab(policy):
    """``FaultPlan.nan_at_step`` 5 falls inside the slab [4, 8): "skip"
    keeps the eager loop's bits (one skipped step); "halt" raises at the
    slab's readback (``log_every`` 1), its end, step 8, where the eager
    loop raises at step 6."""
    conf = {"epochs": 1, "nan_policy": policy, "log_every": 1 if policy == "halt" else 0}
    raised = {}
    for name, unroll in (("eager", 1), ("fused", 4)):
        exp = make_experiment({**conf, "unroll": unroll})
        with faults.injected(FaultPlan(nan_at_step=5)):
            if policy == "halt":
                with pytest.raises(NonFiniteLossError) as exc:
                    exp.run()
                raised[name] = exc.value
            else:
                raised[name] = (exp, exp.run())
    if policy == "halt":
        assert raised["eager"].step == 6 and raised["fused"].step == 8
        assert raised["eager"].skipped == raised["fused"].skipped == 1
        return
    (ref, h_ref), (fused, h_fused) = raised["eager"], raised["fused"]
    assert h_ref["train"][0]["skipped_steps"] == 1.0
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


def test_unroll_accumulate_steps_across_slab_boundaries():
    """Gradient accumulation every 3 micro-steps under unroll 4: the
    boundaries fall inside slabs and across them."""
    conf = {"epochs": 1, "optimizer.accumulate_steps": 3}
    ref, h_ref, fused, h_fused = run_pair(conf, 4)
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


def test_unroll_bop_bit_exact():
    """Bop (flips of the binary kernels) with Adam on the rest."""
    conf = {**BINARY, **BOP, "epochs": 1, "steps_per_epoch": 6}
    ref, h_ref, fused, h_fused = run_pair(conf, 4)
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


def test_unroll_tracks_jax_unroll(tmp_path, monkeypatch):
    """The port's ``unroll`` 4 against JAX's ``unroll`` 4 (slabs of 4 and
    2), SimpleCnn on SyntheticMnist from the same start state: every
    step's loss within 1e-3 relative."""
    import jax

    from zookeeper_tpu.core import configure as jax_configure
    from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
    from zookeeper_tpu_torch.models.convert import load_flax_train_state

    import optax

    conf = {**{k: v for k, v in MNIST.items() if k != "device"}, **CNN, "unroll": 4,
            "epochs": 1, "steps_per_epoch": 6, "batch_size": 8, "seed": 1,
            "validate": False, "log_every": 1,
            "optimizer.schedule": "ConstantSchedule", "optimizer.schedule.base_lr": 1e-3}
    losses = {}
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {**conf, "loader.host_index": 0, "loader.host_count": 1,
                            "writer.jsonl.path": str(tmp_path / "jax.jsonl")},
                  name="experiment")
    jstate = jax_exp.build_state()
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    tree = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    start = {"step": np.array(jstate.step), "params": tree(jstate.params),
             "model_state": tree(jstate.model_state),
             "adam": {"count": np.array(adam.count), "mu": tree(adam.mu), "nu": tree(adam.nu)}}
    jax_exp.run()
    port_exp = make_experiment({**conf, "device": "cpu",
                                "writer.jsonl.path": str(tmp_path / "port.jsonl")})
    build = TrainingExperiment.build_state
    monkeypatch.setattr(TrainingExperiment, "build_state",
                        lambda self, device: load_flax_train_state(build(self, device), **start))
    port_exp.run()
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}.jsonl") as f:
            losses[name] = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    assert len(losses["port"]) == len(losses["jax"]) == 6
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-3)
    assert port_exp.final_state.step == 6


# -- the tasks ------------------------------------------------------------------


TASKS = {
    "TrainImageNet": ({
        "model": "QuickNet", "model.blocks_per_section": (1, 1, 1, 1),
        "model.section_features": (8, 8, 16, 16), "model.binary_compute": "int8",
        "model.pack_residuals": True, "model.compute_dtype": "float32",
        "loader.preprocessing.height": 32, "loader.preprocessing.width": 32,
        "loader.dataset.image_height": 32, "loader.dataset.image_width": 32,
        "loader.dataset.num_classes": 10,
        "loader.dataset.num_train_examples": 24, "loader.dataset.num_validation_examples": 4,
        "batch_size": 4, "loader.num_workers": 0, "epochs": 1, "verbose": False,
        "device": "cpu",
    }, "zookeeper_tpu_torch.training.imagenet"),
    "DistillImageNet": ({
        "model": "RealToBinaryNet", "model.blocks_per_section": (1, 1, 1, 1),
        "model.section_features": (8, 8, 16, 16), "model.compute_dtype": "float32",
        "teacher": "ResNet50", "teacher.blocks_per_section": (1, 1, 1, 1),
        "teacher.width": 4, "teacher.compute_dtype": "float32", "allow_random_teacher": True,
        **BOP, "optimizer.schedule": "ConstantSchedule", "ema_decay": 0.999, "track_flip_ratio": True, "nan_policy": "skip",
        "loader.preprocessing.height": 32, "loader.preprocessing.width": 32,
        "loader.dataset.image_height": 32, "loader.dataset.image_width": 32,
        "loader.dataset.num_classes": 10,
        "loader.dataset.num_train_examples": 20, "loader.dataset.num_validation_examples": 4,
        "batch_size": 4, "epochs": 1, "verbose": False, "device": "cpu",
    }, "zookeeper_tpu_torch.training.imagenet"),
    "BiRealNet": ({
        "model": "BiRealNet", "model.blocks_per_section": (1, 1, 1, 1),
        "model.section_features": (8, 16, 32, 64), "model.binary_compute": "int8",
        "model.pack_residuals": True, "model.compute_dtype": "float32",
        "loader.preprocessing.height": 32, "loader.preprocessing.width": 32,
        "loader.dataset.image_height": 32, "loader.dataset.image_width": 32,
        "loader.dataset.num_classes": 10,
        "loader.dataset.num_train_examples": 20, "loader.dataset.num_validation_examples": 4,
        "batch_size": 4, "loader.num_workers": 0, "epochs": 1, "verbose": False,
        "device": "cpu",
    }, "zookeeper_tpu_torch.training.imagenet"),
    "TrainLM": ({
        "model.num_layers": 2, "model.d_model": 32, "model.num_heads": 2, "seq_len": 32,
        "loader.dataset.vocab_size": 31, "loader.dataset.num_train_examples": 40,
        "loader.dataset.num_validation_examples": 8, "batch_size": 4, "epochs": 1,
        "verbose": False, "device": "cpu",
    }, "zookeeper_tpu_torch.training.lm"),
}


def _task(name, extra):
    import importlib

    conf, module = TASKS[name]
    exp = getattr(importlib.import_module(module),
                  "TrainImageNet" if name == "BiRealNet" else name)()
    configure(exp, {**conf, **extra}, name="experiment")
    return exp


@pytest.mark.parametrize("name", sorted(TASKS))
def test_tasks_accept_unroll_and_give_the_eager_bits(name):
    """TrainImageNet (QuickNet and Bi-Real-Net, int8 with packed
    residuals, Adam under WarmupCosine), DistillImageNet (RealToBinaryNet
    from a ResNet-50 teacher, Bop + Adam, EMA, flip ratio, NaN skip) and
    TrainLM (flash attention under autograd), tiny: unroll 4 over 5-10
    steps (a partial last slab) equals the eager run in every tensor and
    metric."""
    ref = _task(name, {})
    h_ref = ref.run()
    fused = _task(name, {"unroll": 4})
    h_fused = fused.run()
    assert fused.final_state.step == ref.final_state.step >= 5
    assert_histories_equal(h_ref, h_fused)
    assert_states_equal(ref.final_state, fused.final_state)


# -- what the CUDA graph relies on ------------------------------------------------


OPTIONS = {
    "adam": {},
    "adam-warmup-cosine-clip-decay": {"optimizer.schedule": "WarmupCosine",
                                      "optimizer.schedule.base_lr": 1e-2,
                                      "optimizer.global_clip_norm": 0.5,
                                      "optimizer.weight_decay": 1e-2},
    "sgd": {"optimizer": "Sgd"},
    "momentum": {"optimizer": "Momentum", "optimizer.nesterov": True},
    "rmsprop": {"optimizer": "Rmsprop", "optimizer.momentum": 0.9},
    "lamb": {"optimizer": "Lamb", "optimizer.weight_decay": 1e-2},
    "lars": {"optimizer": "Lars", "optimizer.weight_decay": 1e-2},
    "accumulate": {"optimizer.accumulate_steps": 3},
    "ema-flip": {**BINARY, "ema_decay": 0.9, "track_flip_ratio": True},
    "bop": {**BINARY, **BOP},
    "bop-schedules-accumulate": {**BINARY, **BOP, "optimizer.gamma_schedule": "CosineDecay",
                                 "optimizer.gamma_schedule.base_lr": 1e-3,
                                 "optimizer.accumulate_steps": 2},
    "nan-skip": {"nan_policy": "skip"},
    "remat-full": {**CNN, "remat": "full"},
    "remat-dots": {**CNN, "remat": "dots"},
    "remat-quant": {**BINARY, "remat": "quant"},
}


def _state_and_batches(conf, steps=4):
    exp = make_experiment({"epochs": 1, **conf})
    state = exp.build_state(torch.device("cpu"))
    batches = list(exp.loader.batches("train", device="cpu", epoch=0, max_batches=steps))
    return exp, state, batches


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_state_on_the_device_gives_the_host_bits(option):
    """``prepare_for_graph`` (every optimizer count and the step as 0-d
    tensors, what a graph reads) then 4 steps: every tensor and metric as
    with host counts, bit for bit; a ``nan_at_step`` fault in the run
    poisons the same step through ``step_counter``."""
    conf = OPTIONS[option]
    results = []
    for graph_mode in (False, True):
        plan = FaultPlan(nan_at_step=2) if conf.get("nan_policy") else None
        with faults.injected(plan) if plan else _null():
            exp, state, batches = _state_and_batches(conf)
            step = exp._train_step_fn()
            if graph_mode:
                prepare_for_graph(state, torch.device("cpu"))
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append(m)
        results.append((state, metrics))
    (host, m_host), (dev, m_dev) = results
    assert dev.step_counter is not None and int(dev.step_counter) == dev.step == host.step
    assert_states_equal(host, dev, counts_as_values=True)
    for a, b in zip(m_host, m_dev):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]) or (a[k].isnan() & b[k].isnan()).all(), k
    if conf.get("nan_policy"):
        assert [float(m["skipped_steps"]) for m in m_dev] == [0.0, 0.0, 1.0, 0.0]


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_state_tensor_keeps_its_storage_across_a_step(option):
    """A graph replays the addresses it captured: parameters, BatchNorm
    statistics, optimizer state with its counts, EMA, MultiSteps'
    accumulators and the step counter are all updated in place."""
    exp, state, batches = _state_and_batches(OPTIONS[option], steps=2)
    prepare_for_graph(state, torch.device("cpu"))
    step = exp._train_step_fn()
    before = state_storage(state)
    for b in batches:
        state, _ = step(state, b)
        assert state_storage(state) == before


#: Ops that need the host in the middle of a step: a scalar read back
#: (``.item()``, ``float(t)``, ``if t:``), a data-dependent shape, or a
#: host tensor made into a device one (``torch.tensor(x, device=...)``).
_HOST_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "lift_fresh")


class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(h in name for h in _HOST_OPS):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("option", sorted(OPTIONS) + sorted(TASKS))
def test_a_graph_step_asks_nothing_of_the_host(option):
    """What a CUDA graph's capture forbids, caught on the CPU: the step
    with its state prepared for a graph (counts and step on the device)
    reads no scalar back and copies no host tensor in, for every option
    and the three tasks' steps (the kernels' plain versions stand in for
    the kernels)."""
    if option in TASKS:
        exp = _task(option, {})
        state = exp.build_state(torch.device("cpu"))
        batches = list(exp.loader.batches("train", device="cpu", epoch=0, max_batches=2))
    else:
        exp, state, batches = _state_and_batches(OPTIONS[option], steps=2)
    with faults.injected(FaultPlan(nan_at_step=7)):
        step = exp._train_step_fn()
    prepare_for_graph(state, torch.device("cpu"))
    state, _ = step(state, batches[0])  # the first step makes the tables
    with _HostOps() as mode:
        step(state, batches[1])
    assert mode.seen == []


def test_measure_fused_loop_time_and_slab_annotation():
    """``measure_fused_loop_time`` returns seconds per step and the state
    it trained (2 warm slabs, then chains of 1 and 2 slabs, 1 round);
    ``slab_annotation`` names the slab in a profiler trace."""
    batches = _batches(3)
    slab = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    multi = build_multi_step(make_train_step())
    seconds, state = measure_fused_loop_time(multi, _mlp_state(), slab, rounds=1, n1=1, n2=2)
    assert np.isfinite(seconds) and state.step == 3 * (2 + 1 + 2)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with slab_annotation(7, num_steps=3):
            multi(state, slab)
    assert any(e.name == "slab 7 (3 steps)" for e in prof.events())
