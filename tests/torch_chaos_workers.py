"""Rank programs for the port's multi-process chaos leg on gloo ranks.

Like ``torch_parallel_workers`` (whose ``spawn``, ``load`` and result
files these use), they import torch and the port only, never JAX.
"""

import os
import time

import torch

from torch_parallel_workers import _save

MNIST = {
    "loader.dataset": "SyntheticMnist",
    "loader.dataset.num_train_examples": 64,
    "loader.dataset.num_validation_examples": 0,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28,
    "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1,
    "model": "Mlp",
    "model.hidden_units": (8,),
    "partitioner": "FsdpPartitioner",
    "partitioner.min_weight_size": 1,
    "batch_size": 16,
    # 4 steps an epoch, 4 epochs: a kill at step 3 lands at the end of
    # the slab holding it (4); the group exits at 4 + the margin 8 = 12
    # and the restored group still trains an epoch.
    "epochs": 4,
    "unroll": 2,
    "validate": False,
    "verbose": False,
    "device": "cpu",
}


def _configured(cls, conf, name):
    from zookeeper_tpu_torch.core import configure

    obj = cls()
    configure(obj, conf, name=name)
    return obj


def _tensors(state):
    """Every tensor this rank holds of the state, by name, copied."""
    out = {f"module {k}": v.detach().clone() for k, v in state.module.state_dict().items()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"opt {prefix}{k}"] = torch.as_tensor(v).clone()

    walk(state.opt_state, "")
    out["step"] = torch.tensor(int(state.step))
    return out


def _same(a, b):
    """The same names, dtypes and bits."""
    bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(bits(a[k]), bits(b[k])) for k in a)


def protocol_leg(rank, world, workdir):
    """The per-host protocol over a genuinely split state: a committed
    step round-trips bit for bit, and a step whose finalize dies on host 1
    is restored by no host."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    import zookeeper_tpu_torch.models  # noqa: F401  (models by name)
    from zookeeper_tpu_torch.resilience import FaultPlan, faults
    from zookeeper_tpu_torch.training import Checkpointer
    from zookeeper_tpu_torch.training.experiment import TrainingExperiment

    def state(seed):
        exp = _configured(TrainingExperiment, {**MNIST, "seed": seed}, "experiment")
        return exp.partitioner.shard_state(exp.build_state(exp._setup_ranks()))

    ck = _configured(Checkpointer, {
        "directory": os.path.join(workdir, "ckpt_proto"), "sharded_per_host": True,
        "save_every_epochs": 0, "host_commit_timeout_s": 3.0}, "checkpointer")
    saved = state(1)
    saved.step = 1
    want = _tensors(saved)
    results = {"split": sorted(n for n, layout in saved.shards.layouts.items()
                               if saved.shards.local_shape(n) != layout.shape)}
    assert ck.save(saved)
    # Host 1 returns once its half is durable; process 0 commits.
    deadline = time.monotonic() + 30
    while ck.latest_step() != 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    results["latest_committed"] = ck.latest_step()
    torn = state(2)
    torn.step = 2
    with faults.injected(FaultPlan(fail_host_finalize=1)):
        results["torn_saved"] = bool(ck.save(torn))
    results["latest_after_torn"] = ck.latest_step()
    target = state(3)
    ck.restore_state(target)
    results["restored_step"] = target.step
    results["restored_exact"] = _same(_tensors(target), want)
    results["listing"] = sorted(os.listdir(os.path.join(workdir, "ckpt_proto")))
    _save(workdir, "protocol", rank, results)


def recovery_leg(rank, world, workdir):
    """``kill_process_at_step={1: 3}`` under ``unroll`` 2: both hosts
    drain at one boundary, both supervisors restart together, and the
    final state equals an uninterrupted 2-rank run's."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    import zookeeper_tpu_torch.models  # noqa: F401  (models by name)
    from zookeeper_tpu_torch.resilience import FaultPlan, FileCoordinator, faults, run_with_recovery
    from zookeeper_tpu_torch.training.experiment import TrainingExperiment

    oracle = _configured(TrainingExperiment, MNIST, "experiment")
    oracle.run()
    chaos = _configured(TrainingExperiment, {
        **MNIST, "checkpointer.directory": os.path.join(workdir, "ckpt_chaos"),
        "checkpointer.sharded_per_host": True, "checkpointer.save_every_epochs": 0,
        "checkpointer.host_commit_timeout_s": 30.0}, "experiment")
    coord = FileCoordinator(os.path.join(workdir, "group_coord"), rank, world, timeout_s=120.0)
    with faults.injected(FaultPlan(kill_process_at_step={1: 3})):
        recovery = run_with_recovery(chaos, coordinator=coord, max_restarts=2, backoff_s=0.0,
                                     sleep=lambda s: None)
    _save(workdir, "recovery", rank, {
        "restarts": recovery.restarts,
        "causes": [(type(c).__name__, c.step, c.saved) for c in recovery.causes],
        "bit_identical": _same(_tensors(chaos.final_state), _tensors(oracle.final_state)),
        "final_step": chaos.final_state.step,
        "restore_ms": recovery.restore_ms,
        "steps_on_disk": sorted(os.listdir(os.path.join(workdir, "ckpt_chaos"))),
    })


#: A tiny TrainLM whose ``qkv`` splits by heads over a model axis of 2
#: (interleave 3: each rank holds the q, k and v rows of its head).
LM_TP = {
    "loader.dataset.vocab_size": 31,
    "loader.dataset.num_train_examples": 8,
    "loader.dataset.num_validation_examples": 0,
    "seq_len": 32,
    "model.num_layers": 2,
    "model.d_model": 32,
    "model.num_heads": 2,
    "batch_size": 4,
    "epochs": 1,
    "validate": False,
    "verbose": False,
    "device": "cpu",
    "partitioner": "SequenceParallelPartitioner",
    "partitioner.sp": 1,
    "partitioner.tp": 2,
}


def tp_leg(rank, world, workdir):
    """A tensor-parallel TrainLM saved by the per-host protocol (each rank
    its head-aligned blocks), and the same final state in the bare layout
    (gathered, rank 0 writes): the test reads both in one process."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    from zookeeper_tpu_torch.training import Checkpointer
    from zookeeper_tpu_torch.training.lm import TrainLM

    exp = _configured(TrainLM, {
        **LM_TP, "checkpointer.directory": os.path.join(workdir, "lm_hosts"),
        "checkpointer.sharded_per_host": True, "checkpointer.host_commit_timeout_s": 30.0,
    }, "experiment")
    exp.run()
    state = exp.final_state
    layout = state.shards.layouts["block0.qkv.weight"]
    bare = _configured(Checkpointer, {"directory": os.path.join(workdir, "lm_bare")},
                       "checkpointer")
    bare.set_replicas(exp.partitioner.replicas(), exp.partitioner.is_chief)
    bare.save(state)
    _save(workdir, "tp", rank, {"qkv_dims": layout.dims, "step": state.step,
                                "held": tuple(state.module.block0.qkv.weight.shape)})


def chaos_legs(rank, world, workdir):
    protocol_leg(rank, world, workdir)
    recovery_leg(rank, world, workdir)
    tp_leg(rank, world, workdir)
