"""The port's tensor parallelism against the JAX package's.

- One step of a small int8 QuickNet on a 2 x 2 ``("data", "model")``
  mesh under ``conv_model_tp_rules`` on 4 gloo ranks against JAX's
  ``MeshPartitioner`` step on 4 CPU devices (``test_quicknet_tp_matches_
  dp_numerics``'s model), from the same state and batch: the loss within
  1e-5, BatchNorm statistics within 2e-5 of their largest magnitude, each
  weight within lr * 1e-3 where its gradient is above 1e-6 and within lr
  elsewhere (``test_torch_parallel.py``'s DP step rules). The convs, the
  BatchNorms and the head compute on their output-channel blocks, the
  grouped stem conv is gathered; each rank holds half of each sharded
  tensor and its moments, and the two ranks of a model index hold the
  same bits.
- Three steps of a 2 x 2 sp x tp ``TrainLM`` (ring-flash on each rank's
  heads) against JAX's ``SequenceParallelPartitioner(sp=2, tp=2)`` run
  on 4 CPU devices at PR 19's LM gates (losses and validation within
  1e-5, weights within 5e-5); each rank holds the head-aligned ``qkv``
  rows of its heads, and its checkpoint file holds the global tensors,
  ``qkv`` in JAX's order.
- A layer whose heads do not divide the model axis computes whole on
  gathered weights; a tensor-parallel block at one rank decodes equal to
  the whole block; the plan's
  blocks round-trip the head-aligned layout; each partitioner's
  ``decode_cache_axes`` is JAX's.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
import torch_serving_workers as serving_workers
import torch_shard_workers as shard_workers
from test_torch_fsdp import _flat, _jax_numpy_state, _numpy_tree
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.parallel import MeshPartitioner as JaxMeshPartitioner
from zookeeper_tpu.parallel import conv_model_tp_rules as jax_conv_model_tp_rules
from zookeeper_tpu.training import Adam as JaxAdam
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import TransformerLM
from zookeeper_tpu_torch.models.convert import from_flax_lm_variables
from zookeeper_tpu_torch.parallel.shards import Layout, MeshGroups, ShardPlan

QUICKNET = {"blocks_per_section": (1, 1), "section_features": (8, 16), "binary_compute": "int8"}
SHAPE, CLASSES, LR = (16, 16, 3), 4, 1e-3

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
    "model.num_heads": 4,
    "batch_size": 8,
    "epochs": 3,
    "verbose": False,
    "optimizer.schedule": "ConstantSchedule",
    "optimizer.schedule.base_lr": LR,
    "partitioner": "SequenceParallelPartitioner",
    "partitioner.sp": 2,
    "partitioner.tp": 2,
    "partitioner.dp": 1,
}


def _jax_quicknet_tp_step():
    model = JaxQuickNet()
    jax_configure(model, dict(QUICKNET), name="model")
    module = model.build(SHAPE, num_classes=CLASSES)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, SHAPE, seed=3))()
    adam = JaxAdam()
    jax_configure(adam, {"schedule": "ConstantSchedule", "schedule.base_lr": LR},
                  name="optimizer")
    state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                 model_state=model_state, tx=adam.build(10))
    rng = np.random.default_rng(1)
    batch = {"input": rng.normal(size=(8, *SHAPE)).astype(np.float32),
             "target": rng.integers(0, CLASSES, size=8).astype(np.int32)}
    start = _jax_numpy_state(state)
    mp = JaxMeshPartitioner()
    jax_configure(mp, {"mesh_shape": (2, 2), "mesh_axes": ("data", "model"),
                       "data_axes": ("data",), "num_devices": 4}, name="partitioner")
    mp.with_rules(jax_conv_model_tp_rules())
    mp.setup()
    state = mp.shard_state(state)
    step = mp.compile_step(jax_make_train_step(), state, donate_state=False)
    new_state, metrics = step(state, jax.device_put(batch, mp.batch_sharding()))
    new_state = _jax_numpy_state(new_state)
    grads = jax.tree.map(lambda mu: mu / 0.1, new_state["adam"]["mu"])
    return start, batch, grads, new_state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank cluster's legs: the QuickNet TP step and the sp x tp
    TrainLM run, from the JAX runs' initial states."""
    start, batch, grads, want, want_metrics = _jax_quicknet_tp_step()
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {**LM_CONF, "partitioner.num_devices": 4}, name="experiment")
    lm_start = _jax_numpy_state(jax_exp.build_state())
    lm_want = jax_exp.run()
    out_dir = str(tmp_path_factory.mktemp("tp"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    workers.spawn(shard_workers.tp_legs, 4, out_dir,
                  (QUICKNET, SHAPE, CLASSES, LR, start, batch),
                  ({**LM_CONF, "device": "cpu"}, lm_start, ckpt), timeout=240)
    return {"quicknet": workers.load(out_dir, "quicknet_tp", 4),
            "lm": workers.load(out_dir, "lm_tp", 4), "grads": grads, "want": want,
            "want_metrics": want_metrics, "lm_want": lm_want,
            "lm_want_params": _numpy_tree(jax_exp.final_state.params)}


def test_quicknet_tensor_parallel_step_matches_jax(four_ranks):
    got, want = four_ranks["quicknet"], four_ranks["want"]
    np.testing.assert_allclose(got[0]["metrics"]["loss"], four_ranks["want_metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got[0]["metrics"]["grad_norm"],
                               four_ranks["want_metrics"]["grad_norm"], rtol=1e-4)
    state = got[0]["state"]
    grads = _flat(four_ranks["grads"])
    for path, w in _flat(want["params"]).items():
        atol = np.where(np.abs(grads[path]) > 1e-6, LR * 1e-3, LR)
        assert (np.abs(_flat(state["params"])[path] - w) <= atol).all(), path
    for path, w in _flat(want["model_state"]).items():
        np.testing.assert_allclose(_flat(state["model_state"])[path], w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30), err_msg=path)
    for r in got[1:]:
        for key in ("params", "model_state"):
            for path, w in _flat(state[key]).items():
                assert np.array_equal(_flat(r["state"][key])[path], w), (key, path)


def test_quicknet_layers_compute_on_their_channel_blocks(four_ranks):
    for r, got in enumerate(four_ranks["quicknet"]):
        assert got["coords"] == {"data": r // 2, "model": r % 2}
        # The grouped stem conv (Conv_1) has no local form: gathered.
        assert got["local"] == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_2", "BatchNorm_3",
                                "BatchNorm_4", "Conv_0", "Conv_2", "Dense_0", "QuantConv_0",
                                "QuantConv_1"]
        held = got["held"]
        for key in ("module", "mu", "nu"):
            assert held[key]["QuantConv_1.kernel"] == (3, 3, 16, 8)
            assert held[key]["Conv_1.weight"] == (4, 2, 3, 3)
            assert held[key]["Dense_0.weight"] == (2, 16)
        assert held["module"]["BatchNorm_4.running_var"] == (8,)


def test_sp_tp_train_lm_matches_jax(four_ranks):
    got = four_ranks["lm"]
    want = [e["loss"] for e in four_ranks["lm_want"]["train"]]
    losses = [e["loss"] for e in got[0]["history"]["train"]]
    assert len(losses) == len(want) == 3 and want[-1] < want[0]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([e[key] for e in got[0]["history"]["validation"]],
                                   [e[key] for e in four_ranks["lm_want"]["validation"]],
                                   rtol=1e-5, err_msg=key)
    for path, w in _flat(four_ranks["lm_want_params"]).items():
        np.testing.assert_allclose(_flat(got[0]["state"]["params"])[path], w, atol=5e-5,
                                   rtol=5e-5, err_msg=path)
    for r in got[1:]:
        for path, w in _flat(got[0]["state"]["params"]).items():
            assert np.array_equal(_flat(r["state"]["params"])[path], w), path


def test_sp_tp_blocks_are_head_aligned_and_checkpoint_global(four_ranks):
    got = four_ranks["lm"]
    full = torch.from_numpy(np.ascontiguousarray(
        got[0]["state"]["params"]["block0"]["qkv"]["kernel"].T))  # [3d, d]
    d = 32
    for r, res in enumerate(got):
        assert res["coords"] == {"data": 0, "sp": r // 2, "model": r % 2}
        assert res["attn_local"] and res["mlp_local"]
        m = r % 2
        rows = [full[j * d + m * d // 2: j * d + (m + 1) * d // 2] for j in range(3)]
        assert torch.equal(res["qkv_block"], torch.cat(rows)), r
        assert res["held"]["module"]["block0.proj.weight"] == (32, 16)
        assert res["held"]["mu"]["block0.down.weight"] == (32, 64)
    # The checkpoint rank 0 wrote holds the global tensors in the global
    # order: JAX's final weights, qkv included.
    module = got[0]["file"]["module"]
    want = from_flax_lm_variables(four_ranks["lm_want_params"])
    assert set(module) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(module[name].numpy(), w.numpy(), atol=5e-5, rtol=5e-5,
                                   err_msg=name)


def test_plan_blocks_round_trip_the_head_aligned_layout():
    """The plan's shard of a head-aligned ``qkv`` row block (interleave 3)
    and of a 2-D split are the blocks of the global tensor, and putting
    every member's block back (the gather's assembly) restores it."""
    from zookeeper_tpu_torch.parallel.shards import _block, _unfold

    full = torch.arange(12 * 4 * 6, dtype=torch.float32).reshape(12 * 4, 6)
    mesh = MeshGroups({"data": 2, "model": 2}, rank=3)
    for layout in (Layout((48, 6), (((("model",)), 3), ((), 1)), local=True),
                   Layout((48, 6), ((("data",), 1), (("model",), 1)))):
        plan = ShardPlan({"w": layout}, ["w"], mesh, ("data",))
        rebuilt = torch.zeros_like(full)
        for rank in range(4):
            coords = mesh.coords(rank)
            block = _block(full, layout, coords, mesh.sizes)
            local = block.reshape(plan.local_shape("w"))
            _block(rebuilt, layout, coords, mesh.sizes).copy_(_unfold(local, layout))
        assert torch.equal(rebuilt, full)
    qkv = Layout((48, 6), ((("model",), 3), ((), 1)), local=True)
    plan = ShardPlan({"w": qkv}, ["w"], mesh, ("data",))
    block = plan.shard("w", full)  # rank 3: model index 1
    assert torch.equal(block, torch.cat([full[8:16], full[24:32], full[40:48]]))


def test_tensor_parallel_fallbacks_and_decode(tmp_path):
    """Three heads do not divide two ranks: the block keeps no model group
    (its weights are gathered on use). A block that has one decodes: on a
    one-rank gloo group, every block of an LM handed its model group by
    the plan gives the decode step's logits and cache rows of the whole
    block bit for bit."""
    from zookeeper_tpu_torch.parallel import transformer_tp_rules
    from zookeeper_tpu_torch.parallel.shards import plan_state

    model = TransformerLM()
    port_configure(model, {"num_layers": 1, "d_model": 24, "num_heads": 3}, name="model")
    module = model.build((8,), 11)

    class OneRank(MeshGroups):
        def group(self, axes):
            return None

    plan = plan_state(module, transformer_tp_rules(), OneRank({"model": 2}, 0), ("model",), ())
    assert module.block0._tp_attn is None and module.block0._tp_mlp is not None
    assert not plan.layouts["block0.qkv.weight"].local
    assert plan.gathered == ["block0.qkv.weight", "block0.proj.weight"]
    geometry = {"num_layers": 2, "d_model": 32, "num_heads": 4, "max_seq_len": 16}
    lm = TransformerLM()
    port_configure(lm, dict(geometry), name="model")
    whole = lm.build((16,), 11)
    lm.initialize(whole, seed=0)
    state = whole.state_dict()
    tokens = np.array([3, 7, 1], np.int32)
    lengths = np.array([0, 5, 15], np.int32)
    workers.spawn(serving_workers.tp_block_decode, 1, str(tmp_path), (geometry, 11, state),
                  tokens, lengths, timeout=120)
    (got,) = workers.load(str(tmp_path), "tp_block", 1)
    assert got["groups"] == [(True, True), (True, True)]
    assert torch.equal(got["tp"][0], got["whole"][0])
    for tp_layer, whole_layer in zip(got["tp"][1], got["whole"][1]):
        for name in ("k", "v"):
            assert torch.equal(tp_layer[name], whole_layer[name]), name


@pytest.mark.parametrize("name,conf", [
    ("SequenceParallelPartitioner", {"sp": 1, "tp": 1}),
    ("FsdpPartitioner", {}),
    ("MeshPartitioner", {"mesh_shape": (1, 1), "mesh_axes": ("data", "model")}),
    ("MeshPartitioner", {"mesh_shape": (1, 1, 1), "mesh_axes": ("data", "fsdp", "model"),
                         "data_axes": ("data", "fsdp")}),
], ids=["sp", "fsdp", "data_model", "data_fsdp_model"])
def test_decode_cache_axes_match_jax(name, conf):
    """The ``(data_axes, model_axis)`` a decode cache would shard over, as
    JAX's partitioners derive it from their fields."""
    import zookeeper_tpu.parallel as jax_parallel
    import zookeeper_tpu_torch.parallel as port_parallel

    jax_part, port_part = getattr(jax_parallel, name)(), getattr(port_parallel, name)()
    extra = {} if name == "SequenceParallelPartitioner" else {"num_devices": 1}
    jax_configure(jax_part, {**conf, **extra}, name="partitioner")
    port_configure(port_part, dict(conf), name="partitioner")
    assert port_part.decode_cache_axes() == tuple(jax_part.decode_cache_axes())
