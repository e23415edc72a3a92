"""The port's partitioners against the JAX package's.

- The config rejections of ``SequenceParallelPartitioner.setup`` and of
  ``initialize_distributed``, with the JAX package's messages; the rank
  layout of the ``("data", "sp")`` mesh on 4 gloo ranks.
- One ``DataParallelPartitioner`` step of a small int8 QuickNet with
  BatchNorm on 2 gloo ranks (each its rows of a global batch of 8; its
  remat="full" twin to the bit) against JAX's
  ``DataParallelPartitioner`` step on 2 CPU devices, from
  the same state: the loss within 1e-5, BatchNorm statistics (of the
  global batch) within 2e-5 of their largest magnitude, and each weight
  within lr * 1e-3 where its gradient is above 1e-6 and within lr
  elsewhere (Adam's first step moves a weight by about lr * sign(g)),
  the rules of ``test_torch_training.py``'s one-step test.
- Three steps of a 2 x 2 dp x sp ``TrainLM`` (2 layers, d 32, seq 32,
  ring-flash) on 4 gloo ranks against JAX's ``SequenceParallelPartitioner``
  run on 4 CPU devices, from the same state: each step's loss and each
  epoch's validation loss and accuracy (averaged over the ranks) within
  1e-5, and the weights within 5e-5 (the JAX dp x sp test's gates are
  1e-5 and 2e-5 against its own oracle; the port's sums run in another
  order, so 5e-5); the ranks end with the same bits; a FaultPlan kill at
  step 2 and ``run_with_recovery``'s resume end on the uninterrupted
  run's bits.
- Without a launcher the tasks' default ``DataParallelPartitioner`` runs
  the single-device step bit for bit.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as workers
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.parallel import DataParallelPartitioner as JaxDataParallelPartitioner
from zookeeper_tpu.parallel import SequenceParallelPartitioner as JaxSequenceParallelPartitioner
from zookeeper_tpu.parallel import initialize_distributed as jax_initialize_distributed
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu.training.step import smoothed_softmax_cross_entropy as jax_smoothed_loss
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.parallel import SequenceParallelPartitioner
from zookeeper_tpu_torch.parallel import initialize_distributed
from zookeeper_tpu_torch.parallel.partitioner import BatchSlice

QUICKNET = {"blocks_per_section": (1, 1, 1, 1), "section_features": (32, 32, 64, 64),
            "binary_compute": "int8"}
SHAPE, CLASSES, LR = (32, 32, 3), 10, 1e-3

LM_CONF = {
    "loader.dataset": "SyntheticTokens",
    "loader.dataset.vocab_size": 31,
    "loader.dataset.num_train_examples": 8,
    "loader.dataset.num_validation_examples": 8,
    "loader.preprocessing": "TokenPreprocessing",
    "seq_len": 32,
    "model": "TransformerLM",
    "model.num_layers": 2,
    "model.d_model": 32,
    "model.num_heads": 2,
    "batch_size": 8,
    "epochs": 3,
    "verbose": False,
    "optimizer.schedule": "ConstantSchedule",
    "optimizer.schedule.base_lr": LR,
    "partitioner": "SequenceParallelPartitioner",
    "partitioner.sp": 2,
    "partitioner.dp": 2,
}


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


def _leaf(tree, path):
    return functools.reduce(lambda t, k: t[k.key], path, tree)


# -- configuration and layout ---------------------------------------------------


@pytest.mark.parametrize("fields", [
    {"mesh_shape": (2, 2)},
    {"attention": "sparse"},
    {"attention": "ulysses", "ulysses_local": "sparse"},
    {"attention": "ulysses", "overlap": False},
    {"ulysses_local": "dense"},
    {"tp": 0},
    {"sp": 0},
    {"dp": -2},
], ids=lambda f: ",".join(f))
def test_sequence_partitioner_config_rejections_match_jax(fields):
    jax_part, port_part = JaxSequenceParallelPartitioner(), SequenceParallelPartitioner()
    jax_configure(jax_part, dict(fields), name="partitioner")
    port_configure(port_part, dict(fields), name="partitioner")
    with pytest.raises(ValueError) as want:
        jax_part.setup()
    with pytest.raises(ValueError) as got:
        port_part.setup()
    assert str(got.value) == str(want.value)


def test_unported_layouts_raise_not_implemented(tmp_path):
    """The sharded layouts are ported: FSDP, a ``model`` axis with rules
    and ``tp`` lay out one rank without a group (``tp=2`` needs its ranks,
    with JAX's message). The per-host sharded checkpoint's fields take their
    values: one process saves the bare layout, and the invalid values
    raise JAX's ``ValueError``s."""
    from zookeeper_tpu_torch.parallel import (
        FsdpPartitioner,
        MeshPartitioner,
        transformer_tp_rules,
    )
    from zookeeper_tpu_torch.training import Checkpointer

    fsdp = FsdpPartitioner()
    port_configure(fsdp, {}, name="partitioner")
    mesh = MeshPartitioner()
    port_configure(mesh, {"mesh_shape": (1, 1), "mesh_axes": ("data", "model")},
                   name="partitioner")
    assert mesh.with_rules(transformer_tp_rules()) is mesh
    assert mesh.rules == transformer_tp_rules()
    for part, sizes in ((fsdp, {"fsdp": 1}), (mesh, {"data": 1, "model": 1})):
        part.setup()
        assert part.mesh is None and part.mesh_sizes == sizes and part.replicas() is None
    assert mesh.decode_cache_axes() == (("data",), "model")
    tp = SequenceParallelPartitioner()
    port_configure(tp, {"tp": 2}, name="partitioner")
    with pytest.raises(ValueError, match="not divisible by fixed axes 2"):
        tp.setup()
    from zookeeper_tpu.training import Checkpointer as JaxCheckpointer
    from zookeeper_tpu_torch.training import Sgd, TrainState

    sgd = Sgd()
    port_configure(sgd, {}, name="optimizer")
    tx = sgd.build(total_steps=1)
    module = torch.nn.Linear(2, 2)
    state = TrainState(step=3, module=module, tx=tx,
                       opt_state=tx.init(dict(module.named_parameters())))
    for field, value in (("sharded_per_host", True), ("process_index", 0),
                         ("process_count", 2), ("host_commit_timeout_s", 5.0)):
        # One process in the group: the save lands in the bare layout.
        ckpt = Checkpointer()
        directory = tmp_path / field
        port_configure(ckpt, {"directory": str(directory), field: value}, name="checkpointer")
        assert ckpt.save(state) and sorted(os.listdir(directory)) == ["3"]
    for bad in ({"host_commit_timeout_s": 0.0},
                {"sharded_per_host": True, "keep_best_metric": "accuracy"}):
        jax_ckpt, port_ckpt = JaxCheckpointer(), Checkpointer()
        jax_configure(jax_ckpt, {"directory": str(tmp_path), **bad}, name="checkpointer")
        port_configure(port_ckpt, {"directory": str(tmp_path), **bad}, name="checkpointer")
        with pytest.raises(ValueError) as want:
            jax_ckpt._validate_mode()
        with pytest.raises(ValueError) as got:
            port_ckpt.save(state)
        assert str(got.value) == str(want.value)


def test_initialize_distributed_rejections_match_jax(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    for kw in ({"num_processes": 2}, {"process_id": 0}, {"num_processes": 2, "process_id": 1}):
        with pytest.raises(ValueError) as want:
            jax_initialize_distributed(**kw)
        with pytest.raises(ValueError) as got:
            initialize_distributed(**kw, device="cpu")
        assert str(got.value).split(" Under ")[0] == str(want.value).split(" On TPU")[0]
    # No launcher, no coordinator: no group, world size 1.
    initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    # A run asked for the card that has none raises; it never takes gloo.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        initialize_distributed(device="cuda")
    assert not torch.distributed.is_initialized()


def test_sequence_partitioner_without_group_is_one_rank():
    """Without a launcher there is no mesh; sp=1 lays out one rank and a
    larger degree needs the ranks, with JAX's message."""
    part = SequenceParallelPartitioner()
    port_configure(part, {"sp": 1}, name="partitioner")
    part.setup()
    assert part.mesh is None and part.mesh_sizes == {"data": 1, "sp": 1}
    assert part.batch_sharding() == BatchSlice(0, 1, 0, 1) and part.replicas() is None
    wide = SequenceParallelPartitioner()
    port_configure(wide, {"sp": 4, "dp": 1}, name="partitioner")
    with pytest.raises(ValueError, match=r"Mesh \{'data': 1, 'sp': 4\} needs 4 devices, have 1"):
        wide.setup()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank cluster's legs: the layout, then the dp x sp TrainLM run
    and its kill-and-resume, from the JAX run's initial state."""
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {**LM_CONF, "partitioner.num_devices": 4}, name="experiment")
    start = _jax_numpy_state(jax_exp.build_state())
    want = jax_exp.run()
    want_params = _numpy_tree(jax_exp.final_state.params)
    out_dir = str(tmp_path_factory.mktemp("four"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    workers.spawn(workers.four_rank_legs, 4, out_dir,
                  {**LM_CONF, "device": "cpu"}, start, ckpt, 2)
    return {"layout": workers.load(out_dir, "layout", 4), "lm": workers.load(out_dir, "lm", 4),
            "want": want, "want_params": want_params}


def test_rank_layout_is_row_major(four_ranks):
    """Rank r sits at (data, sp) = (r // 2, r % 2): its rows are data
    index r // 2, its sequence columns sp index r % 2; the sp group is
    the ranks of one data index, the data group those of one sp index."""
    for r, got in enumerate(four_ranks["layout"]):
        assert got["sp_sizes"] == {"data": 2, "sp": 2}
        assert got["sp_coords"] == {"data": r // 2, "sp": r % 2}
        assert got["sp_slice"] == BatchSlice(r // 2, 2, r % 2, 2)
        assert got["sp_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["data_group"] == [r % 2, r % 2 + 2]
        assert got["dp_sizes"] == {"data": 4} and got["dp_slice"] == BatchSlice(r, 4)
        assert got["dp_replicas"] == got["sp_replicas"] == 4


def test_dp_sp_train_lm_matches_jax(four_ranks):
    got = four_ranks["lm"]
    want = [e["loss"] for e in four_ranks["want"]["train"]]
    losses = [e["loss"] for e in got[0]["history"]["train"]]
    assert len(losses) == len(want) == 3 and want[-1] < want[0]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    # Validation: each rank scores its rows and sequence columns, the
    # weighted sums are added over the ranks.
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([e[key] for e in got[0]["history"]["validation"]],
                                   [e[key] for e in four_ranks["want"]["validation"]],
                                   rtol=1e-5, err_msg=key)
    for path, w in jax.tree_util.tree_leaves_with_path(four_ranks["want_params"]):
        np.testing.assert_allclose(_leaf(got[0]["state"]["params"], path), w, atol=5e-5,
                                   rtol=5e-5, err_msg=str(path))
    for r in got[1:]:  # every rank ends with rank 0's bits
        for path, w in jax.tree_util.tree_leaves_with_path(got[0]["state"]["params"]):
            assert np.array_equal(_leaf(r["state"]["params"], path), w), str(path)


def test_dp_sp_kill_and_resume_is_bit_identical(four_ranks):
    for r in four_ranks["lm"]:
        assert r["restarts"] == 1
        a, b = r["state"], r["resumed_state"]
        assert int(a["step"]) == int(b["step"]) == 3
        for key in ("params", "adam"):
            for path, w in jax.tree_util.tree_leaves_with_path(a[key]):
                assert np.array_equal(_leaf(b[key], path), w), (key, str(path))


# -- data parallelism -------------------------------------------------------------


def _jax_dp_step():
    model = JaxQuickNet()
    jax_configure(model, QUICKNET, name="model")
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=3))()
    adam = JaxAdam()
    jax_configure(adam, {"schedule": "ConstantSchedule", "schedule.base_lr": LR},
                  name="optimizer")
    state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                 model_state=model_state, tx=adam.build(10))
    rng = np.random.default_rng(5)
    batch = {"input": rng.normal(size=(8, *SHAPE)).astype(np.float32),
             "target": rng.integers(0, CLASSES, size=8).astype(np.int32)}
    loss_fn = jax_smoothed_loss(0.1)
    start = _jax_numpy_state(state)
    dp = JaxDataParallelPartitioner()
    jax_configure(dp, {"num_devices": 2}, name="partitioner")
    dp.setup()
    state = dp.shard_state(state)
    step = dp.compile_step(jax_make_train_step(loss_fn), state, donate_state=False)
    new_state, metrics = step(state, jax.device_put(
        {k: jnp.asarray(v) for k, v in batch.items()}, dp.batch_sharding()))
    new_state = _jax_numpy_state(new_state)
    # Adam's first moment after its first step is (1 - b1) g.
    grads = jax.tree.map(lambda mu: mu / 0.1, new_state["adam"]["mu"])
    return start, batch, grads, new_state, {k: float(v) for k, v in metrics.items()}


def test_data_parallel_step_matches_jax_with_global_batch_stats(tmp_path):
    start, batch, grads, want, want_metrics = _jax_dp_step()
    out_dir = str(tmp_path)
    workers.spawn(workers.dp_step_leg, 2, out_dir, QUICKNET, SHAPE, CLASSES, LR, start, batch)
    got = workers.load(out_dir, "dp_step", 2)
    assert min(r["margin"] for r in got) > 1e-5, "a binary conv input lies near 0 or +-1"
    np.testing.assert_allclose(got[0]["metrics"]["loss"], want_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["metrics"]["grad_norm"], want_metrics["grad_norm"],
                               rtol=1e-4)
    assert got[0]["metrics"]["accuracy"] == want_metrics["accuracy"]
    state = got[0]["state"]
    for path, w in jax.tree_util.tree_leaves_with_path(want["params"]):
        atol = np.where(np.abs(_leaf(grads, path)) > 1e-6, LR * 1e-3, LR)
        assert (np.abs(_leaf(state["params"], path) - w) <= atol).all(), str(path)
    for path, w in jax.tree_util.tree_leaves_with_path(want["model_state"]):
        np.testing.assert_allclose(_leaf(state["model_state"], path), w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30), err_msg=str(path))
    for key in ("params", "model_state"):
        for path, w in jax.tree_util.tree_leaves_with_path(state[key]):
            # Both ranks hold the same bits, and remat="full" (whose
            # recompute reduces the moments again) gives them too.
            assert np.array_equal(_leaf(got[1]["state"][key], path), w), str(path)
            assert np.array_equal(_leaf(got[0]["remat_state"][key], path), w), str(path)


@pytest.mark.parametrize("task", ["TrainLM", "TrainImageNet"])
def test_default_data_parallel_without_launcher_is_the_single_device_run(task):
    """The tasks now default to DataParallelPartitioner. Without a
    launcher it forms no group and calls no collective: the run equals
    the SingleDevicePartitioner run (the step as it was) bit for bit."""
    from zookeeper_tpu_torch.models.convert import flax_train_state
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet
    from zookeeper_tpu_torch.training.lm import TrainLM

    conf = {"device": "cpu", "verbose": False, "epochs": 1, "steps_per_epoch": 2}
    if task == "TrainLM":
        cls = TrainLM
        conf.update({"model.num_layers": 1, "model.d_model": 16, "model.num_heads": 2,
                     "seq_len": 16, "loader.dataset.vocab_size": 17, "batch_size": 4,
                     "loader.dataset.num_train_examples": 8,
                     "loader.dataset.num_validation_examples": 4})
    else:
        cls = TrainImageNet
        conf.update({"model.blocks_per_section": (1, 1, 1, 1),
                     "model.section_features": (8, 8, 16, 16), "model.binary_compute": "int8",
                     "model.compute_dtype": "float32", "loader.preprocessing.height": 32,
                     "loader.preprocessing.width": 32, "loader.num_workers": 0,
                     "loader.dataset.num_train_examples": 8,
                     "loader.dataset.num_validation_examples": 4, "batch_size": 4})
    states = {}
    for name in ("DataParallelPartitioner", "SingleDevicePartitioner"):
        exp = cls()
        extra = {} if name == "DataParallelPartitioner" else {"partitioner": name}
        port_configure(exp, {**conf, **extra}, name="experiment")
        assert type(exp.partitioner).__name__ == name
        history = exp.run()
        states[name] = (history, flax_train_state(exp.final_state))
    (h_dp, s_dp), (h_single, s_single) = states.values()
    assert not torch.distributed.is_initialized()
    for split in ("train", "validation"):
        for a, b in zip(h_dp[split], h_single[split]):
            a.pop("examples_per_sec", None), b.pop("examples_per_sec", None)
            assert a == b
    for key in ("params", "model_state", "adam"):
        for path, w in jax.tree_util.tree_leaves_with_path(s_single[key]):
            assert np.array_equal(_leaf(s_dp[key], path), w), (key, str(path))
