"""Rank programs for the port's multi-process CPU tests.

``spawn(fn, world, out_dir, *args)`` runs ``fn(rank, world, out_dir,
*args)`` in ``world`` fresh processes that form a gloo group through the
port's own ``initialize_distributed`` (the ``env://`` variables
``torch.distributed.run`` would set), with a deadline, so a rank that
hangs in a collective fails the test instead of stalling the suite.
The rank programs below import torch and the port only, never JAX: the
tests hold what they write (``torch.save`` files in ``out_dir``) against
the JAX package in the pytest process.
"""

import os
import socket
import time
import traceback

import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, out_dir, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from zookeeper_tpu_torch.parallel.distributed import initialize_distributed

    try:
        initialize_distributed(device="cpu")
        fn(rank, world, out_dir, *args)
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, out_dir: str, *args, timeout: float = 150.0) -> None:
    """Run ``fn`` on ``world`` gloo ranks; raise with the first rank's
    traceback if one fails, or if the ranks outlive ``timeout`` s."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
    errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
              if f.endswith(".err")]
    if errors:
        raise AssertionError(f"a rank failed:\n{errors[0]}")
    if alive:
        raise AssertionError(f"{len(alive)} rank(s) still running after {timeout} s (a hang)")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"ranks exited with {bad}")


def _save(out_dir, name, rank, tree) -> None:
    torch.save(tree, os.path.join(out_dir, f"{name}.rank{rank}.pt"))


def load(out_dir, name, world):
    """Every rank's ``name`` results, in rank order (files these tests'
    own ranks wrote)."""
    return [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- sequence-parallel attention ---------------------------------------------

RING_FLAVORS = ("ring", "ring_flash", "ulysses_dense", "ulysses_flash")


def _attention(flavor, q, k, v, mesh, causal, overlap=True):
    from zookeeper_tpu_torch.ops import attention as ops

    kw = dict(mesh=mesh, seq_axis="sp", causal=causal)
    if flavor == "ring":
        return ops.ring_attention(q, k, v, overlap=overlap, **kw)
    if flavor == "ring_flash":
        return ops.ring_flash_attention(q, k, v, overlap=overlap, **kw)
    return ops.all_to_all_attention(q, k, v, local_attention=flavor.split("_")[1], **kw)


def ring_legs(rank, world, out_dir, inputs):
    """Every flavor, causal and not, on this rank's sequence shard of the
    global ``inputs`` (q, k, v and the upstream gradient w): the output
    and the q/k/v gradients of ``sum(out * w)``; the ring flavors also
    with ``overlap=False``; then the rejections' messages."""
    from torch.distributed.device_mesh import init_device_mesh

    from zookeeper_tpu_torch.ops import attention as ops

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
    s_local = inputs["q"].shape[1] // world
    shard = {k: torch.from_numpy(v[:, rank * s_local:(rank + 1) * s_local].copy())
             for k, v in inputs.items()}
    results = {}
    for flavor in RING_FLAVORS:
        for causal in (False, True):
            schedules = (True, False) if flavor.startswith("ring") else (True,)
            for overlap in schedules:
                q, k, v = (shard[n].clone().requires_grad_(True) for n in "qkv")
                ops.reset_launches()
                out = _attention(flavor, q, k, v, mesh, causal, overlap)
                (out * shard["w"]).sum().backward()
                results[(flavor, causal, overlap)] = {
                    "out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                    "launches": dict(ops.LAUNCHES)}
    errors = {}
    q = shard["q"]
    for name, call in (
        ("heads", lambda: ops.all_to_all_attention(q[:, :, :1].repeat(1, 1, 3, 1),
                                                    q[:, :, :1].repeat(1, 1, 3, 1),
                                                    q[:, :, :1].repeat(1, 1, 3, 1),
                                                    mesh=mesh, seq_axis="sp")),
        ("shapes", lambda: ops.ring_attention(q, q[:, :-1], q, mesh=mesh, seq_axis="sp")),
        ("local", lambda: ops.all_to_all_attention(q, q, q, mesh=mesh, seq_axis="sp",
                                                    local_attention="sparse")),
    ):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    results["errors"] = errors
    _save(out_dir, "ring", rank, results)


# -- partitioners ------------------------------------------------------------


def layout_leg(rank, world, out_dir):
    """Where each partitioner puts this rank: mesh coordinates, batch
    share and the ranks of its groups."""
    import torch.distributed as dist

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.parallel import DataParallelPartitioner, SequenceParallelPartitioner

    sp = SequenceParallelPartitioner()
    configure(sp, {"sp": 2}, name="partitioner")
    dp = DataParallelPartitioner()
    configure(dp, {}, name="partitioner")
    _save(out_dir, "layout", rank, {
        "sp_sizes": sp.mesh_sizes, "sp_coords": sp.coordinates(),
        "sp_slice": sp.batch_sharding(),
        "sp_group": dist.get_process_group_ranks(sp.mesh.get_group("sp")),
        "data_group": dist.get_process_group_ranks(sp.mesh.get_group("data")),
        "dp_sizes": dp.mesh_sizes, "dp_slice": dp.batch_sharding(),
        "dp_replicas": dp.replicas().size, "sp_replicas": sp.replicas().size,
    })


def dp_step_leg(rank, world, out_dir, model_conf, shape, classes, lr, start, batch):
    """One DataParallelPartitioner train step of a QuickNet from the JAX
    state ``start``, on this rank's rows of the global ``batch``: the
    state after it (flax layout), the metrics, and the smallest distance
    of a binary conv's input from 0 or +-1; then the same step under
    ``remat="full"`` (its recompute takes the global moments again)."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import QuickNet
    from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state
    from zookeeper_tpu_torch.parallel import DataParallelPartitioner
    from zookeeper_tpu_torch.training import Adam, TrainState, make_train_step
    from zookeeper_tpu_torch.training.step import smoothed_softmax_cross_entropy

    model = QuickNet()
    configure(model, model_conf, name="model")
    adam = Adam()
    configure(adam, {"schedule": "ConstantSchedule", "schedule.base_lr": lr}, name="optimizer")
    part = DataParallelPartitioner()
    configure(part, {}, name="partitioner")

    def fresh():
        state = TrainState.create(model.build(shape, classes), adam.build(10))
        return part.shard_state(load_flax_train_state(state, **start))

    state = fresh()
    share = part.batch_sharding()
    rows = len(batch["target"]) // share.data_count
    local = {k: torch.from_numpy(v[share.data_index * rows:(share.data_index + 1) * rows].copy())
             for k, v in batch.items()}
    margins = []

    def hook(_, args):
        a = args[0].detach().abs()
        margins.append(min(a.min().item(), (a - 1).abs().min().item()))

    for name, sub in state.module.named_children():
        if name.startswith("QuantConv"):
            sub.register_forward_pre_hook(hook)
    loss = smoothed_softmax_cross_entropy(0.1)
    state, metrics = make_train_step(loss, replicas=part.replicas())(state, local)
    remat_state, _ = make_train_step(loss, remat="full", replicas=part.replicas())(fresh(), local)
    _save(out_dir, "dp_step", rank, {"state": flax_train_state(state),
                                     "remat_state": flax_train_state(remat_state),
                                     "metrics": {k: float(v) for k, v in metrics.items()},
                                     "margin": min(margins)})


def lm_legs(rank, world, out_dir, conf, start, ckpt_dir, kill_at_step):
    """A dp x sp TrainLM run from the JAX state ``start``, then the same
    run killed at ``kill_at_step`` (a FaultPlan) and resumed by
    ``run_with_recovery`` from its step checkpoints: both runs' histories
    and final states."""
    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    import zookeeper_tpu_torch.training  # noqa: F401  (schedules by name)
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state
    from zookeeper_tpu_torch.resilience import FaultPlan, faults, run_with_recovery
    from zookeeper_tpu_torch.training.lm import TrainLM

    build = TrainLM.build_state
    TrainLM.build_state = lambda self, device: load_flax_train_state(build(self, device), **start)
    results = {}
    exp = TrainLM()
    configure(exp, conf, name="experiment")
    results["history"] = exp.run()
    results["state"] = flax_train_state(exp.final_state)
    results["coords"] = exp.partitioner.coordinates()
    resumed = TrainLM()
    configure(resumed, {**conf, "checkpointer.directory": ckpt_dir,
                        "checkpointer.save_every_steps": 1,
                        "checkpointer.save_every_epochs": 0}, name="experiment")
    with faults.injected(FaultPlan(kill_at_step=kill_at_step)):
        recovery = run_with_recovery(resumed, max_restarts=1, backoff_s=0.0)
    results["restarts"] = recovery.restarts
    results["resumed_state"] = flax_train_state(resumed.final_state)
    _save(out_dir, "lm", rank, results)


def four_rank_legs(rank, world, out_dir, conf, start, ckpt_dir, kill_at_step):
    """The 4-rank cluster of the partitioner tests: the layout, then the
    dp x sp TrainLM legs."""
    layout_leg(rank, world, out_dir)
    lm_legs(rank, world, out_dir, conf, start, ckpt_dir, kill_at_step)
