"""Rank programs for the port's sharded-parameter tests (FSDP and tensor
parallelism) on gloo ranks.

Like ``torch_parallel_workers`` (whose ``spawn``, ``load`` and result
files these use), they import torch and the port only, never JAX: the
tests hold what they write against the JAX package in the pytest
process.
"""

import os

import torch

from torch_parallel_workers import _save


def _configured(cls, conf, name):
    from zookeeper_tpu_torch.core import configure

    obj = cls()
    configure(obj, conf, name=name)
    return obj


def _adam(lr):
    from zookeeper_tpu_torch.training import Adam

    return _configured(Adam, {"schedule": "ConstantSchedule", "schedule.base_lr": lr},
                       "optimizer")


def _rows(part, batch):
    """This rank's rows of a global numpy batch."""
    share = part.batch_sharding()
    rows = len(batch["target"]) // share.data_count
    lo = share.data_index * rows
    return {k: torch.from_numpy(v[lo:lo + rows].copy()) for k, v in batch.items()}


def _held(state):
    """The shapes this rank holds: parameters, buffers, Adam moments."""
    held = {"module": {n: tuple(t.shape) for n, t in state.module.state_dict().items()}}
    for key in ("mu", "nu"):
        if key in state.opt_state:
            held[key] = {n: tuple(t.shape) for n, t in state.opt_state[key].items()}
    return held


# -- FSDP (2 ranks) ----------------------------------------------------------------


def fsdp_mlp_leg(rank, world, out_dir, mlp_conf, shape, classes, lr, start, batch):
    """One ``FsdpPartitioner(min_weight_size=1)`` step of an Mlp from the JAX
    state ``start`` on this rank's rows of ``batch``: the loss, the state
    after it (gathered, flax layout) and the shapes this rank holds."""
    from zookeeper_tpu_torch.models import Mlp
    from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state
    from zookeeper_tpu_torch.parallel import FsdpPartitioner
    from zookeeper_tpu_torch.training import TrainState, make_train_step

    model = _configured(Mlp, mlp_conf, "model")
    part = _configured(FsdpPartitioner, {"min_weight_size": 1}, "partitioner")
    part.setup()
    state = TrainState.create(model.build(shape, classes), _adam(lr).build(10))
    state = part.shard_state(load_flax_train_state(state, **start))
    held = _held(state)
    state, metrics = make_train_step(replicas=part.replicas())(state, _rows(part, batch))
    _save(out_dir, "fsdp_mlp", rank, {"loss": float(metrics["loss"]), "held": held,
                                      "state": flax_train_state(state)})


def features_leg(rank, world, out_dir, model_conf, shape, classes, batch):
    """Three steps of a small int8 QuickNet under LAMB with a global clip
    norm, the flip ratio and ``nan_policy="skip"`` (a FaultPlan poisons
    step 1), under ``FsdpPartitioner(min_weight_size=1)`` and under
    ``DataParallelPartitioner``, from one seed: each step's metrics and the
    final parameters of both."""
    from zookeeper_tpu_torch.models import QuickNet
    from zookeeper_tpu_torch.models.convert import flax_train_state
    from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN
    from zookeeper_tpu_torch.parallel import DataParallelPartitioner, FsdpPartitioner
    from zookeeper_tpu_torch.resilience import FaultPlan, faults
    from zookeeper_tpu_torch.training import Lamb, TrainState, make_train_step

    results = {}
    for name, cls, conf in (("fsdp", FsdpPartitioner, {"min_weight_size": 1}),
                            ("dp", DataParallelPartitioner, {})):
        model = _configured(QuickNet, model_conf, "model")
        part = _configured(cls, conf, "partitioner")
        part.setup()
        lamb = _configured(Lamb, {"schedule": "ConstantSchedule", "schedule.base_lr": 1e-2,
                                  "weight_decay": 1e-4, "global_clip_norm": 0.05}, "optimizer")
        module = model.build(shape, classes)
        model.initialize(module, seed=7)
        state = part.shard_state(TrainState.create(module, lamb.build(10)))
        with faults.injected(FaultPlan(nan_at_step=1)):
            step = make_train_step(flip_ratio_pattern=BINARY_KERNEL_PATTERN, nan_policy="skip",
                                   replicas=part.replicas())
        local = _rows(part, batch)
        history = []
        for _ in range(3):
            state, metrics = step(state, local)
            history.append({k: float(v) for k, v in metrics.items()})
        results[name] = {"history": history, "state": flax_train_state(state)}
    _save(out_dir, "features", rank, results)


def _lm_state_file(ckpt_dir):
    from zookeeper_tpu_torch.training.checkpoint import STATE_FILE, finalized_steps

    step = finalized_steps(ckpt_dir)[-1]
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), weights_only=True)


def single_device_file(rank, exp, flax_state, out):
    """The checkpoint file a single-device run of ``exp``'s task writes at
    the state ``flax_state`` (rank 0 writes it into ``out``)."""
    from zookeeper_tpu_torch.models.convert import load_flax_train_state
    from zookeeper_tpu_torch.training import Checkpointer

    if rank != 0:
        return None
    state = load_flax_train_state(exp.build_state(torch.device("cpu")), **flax_state)
    _configured(Checkpointer, {"directory": out}, "checkpointer").save(state)
    return _lm_state_file(out)


def resume_leg(rank, world, out_dir, conf, ckpt_dir, single_dir, kill_at_step):
    """An ``FsdpPartitioner`` TrainLM run, then the same run killed at
    ``kill_at_step`` (a FaultPlan) and resumed by ``run_with_recovery``
    from its step checkpoints: both final states, the last checkpoint file
    and the file a single-device run writes at the same state."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    import zookeeper_tpu_torch.training  # noqa: F401  (schedules by name)
    from zookeeper_tpu_torch.models.convert import flax_train_state
    from zookeeper_tpu_torch.resilience import FaultPlan, faults, run_with_recovery
    from zookeeper_tpu_torch.training.lm import TrainLM

    exp = _configured(TrainLM, conf, "experiment")
    exp.run()
    results = {"state": flax_train_state(exp.final_state),
               "held": _held(exp.final_state)}
    resumed = _configured(TrainLM, {**conf, "checkpointer.directory": ckpt_dir,
                                    "checkpointer.save_every_steps": 1,
                                    "checkpointer.save_every_epochs": 0}, "experiment")
    with faults.injected(FaultPlan(kill_at_step=kill_at_step)):
        recovery = run_with_recovery(resumed, max_restarts=1, backoff_s=0.0)
    results["restarts"] = recovery.restarts
    results["resumed_state"] = flax_train_state(resumed.final_state)
    if rank == 0:
        results["file"] = _lm_state_file(ckpt_dir)
        single_conf = {k: v for k, v in conf.items() if not k.startswith("partitioner.")}
        single = _configured(TrainLM, {**single_conf, "partitioner": "SingleDevicePartitioner"},
                             "experiment")
        results["single_file"] = single_device_file(rank, single, results["resumed_state"],
                                                    single_dir)
    _save(out_dir, "resume", rank, results)


def fsdp_legs(rank, world, out_dir, mlp, features, resume):
    """The 2-rank cluster of the FSDP tests."""
    fsdp_mlp_leg(rank, world, out_dir, *mlp)
    features_leg(rank, world, out_dir, *features)
    resume_leg(rank, world, out_dir, *resume)


# -- tensor parallelism (4 ranks) --------------------------------------------------


def quicknet_tp_leg(rank, world, out_dir, model_conf, shape, classes, lr, start, batch):
    """One step of a QuickNet on a 2 x 2 ``("data", "model")`` mesh under
    ``conv_model_tp_rules`` from the JAX state ``start``: the metrics, the
    state after it (gathered), the shapes this rank holds and which layers
    compute on their shard."""
    from zookeeper_tpu_torch.models import QuickNet
    from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state
    from zookeeper_tpu_torch.parallel import MeshPartitioner, conv_model_tp_rules
    from zookeeper_tpu_torch.training import TrainState, make_train_step

    model = _configured(QuickNet, model_conf, "model")
    part = _configured(MeshPartitioner, {"mesh_shape": (2, 2), "mesh_axes": ("data", "model"),
                                         "data_axes": ("data",)}, "partitioner")
    part.with_rules(conv_model_tp_rules())
    part.setup()
    state = TrainState.create(model.build(shape, classes), _adam(lr).build(10))
    state = part.shard_state(load_flax_train_state(state, **start))
    held = _held(state)
    local_layers = sorted(n for n, m in state.module.named_modules()
                          if getattr(m, "_tp", None) is not None)
    state, metrics = make_train_step(replicas=part.replicas())(state, _rows(part, batch))
    _save(out_dir, "quicknet_tp", rank, {
        "metrics": {k: float(v) for k, v in metrics.items()}, "held": held,
        "local": local_layers, "coords": part.coordinates(),
        "state": flax_train_state(state)})


def lm_tp_leg(rank, world, out_dir, conf, start, ckpt_dir):
    """A 2 x 2 sp x tp TrainLM run from the JAX state ``start`` with step
    checkpoints: its history, final state, the last checkpoint file, and
    this rank's ``qkv`` block of the first layer beside the global one."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    import zookeeper_tpu_torch.training  # noqa: F401  (schedules by name)
    from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state
    from zookeeper_tpu_torch.training.lm import TrainLM

    build = TrainLM.build_state
    TrainLM.build_state = lambda self, device: load_flax_train_state(build(self, device), **start)
    exp = _configured(TrainLM, {**conf, "checkpointer.directory": ckpt_dir,
                                "checkpointer.save_every_epochs": 1}, "experiment")
    history = exp.run()
    state = exp.final_state
    results = {"history": history, "state": flax_train_state(state),
               "coords": exp.partitioner.coordinates(), "held": _held(state),
               "qkv_block": state.module.block0.qkv.weight.detach().clone(),
               "attn_local": state.module.block0._tp_attn is not None,
               "mlp_local": state.module.block0._tp_mlp is not None}
    if rank == 0:
        results["file"] = _lm_state_file(ckpt_dir)
    _save(out_dir, "lm_tp", rank, results)


def tp_legs(rank, world, out_dir, quicknet, lm):
    """The 4-rank cluster of the tensor-parallel tests."""
    quicknet_tp_leg(rank, world, out_dir, *quicknet)
    lm_tp_leg(rank, world, out_dir, *lm)
