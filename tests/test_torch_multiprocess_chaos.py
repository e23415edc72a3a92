"""The port's multi-process chaos leg: two gloo ranks under
``FsdpPartitioner`` (every weight of the ``Mlp`` split between the
processes) walk the multi-host fault-tolerance contracts end to end, the
counterpart of ``tests/resilience/test_multiprocess_chaos.py``:

- the per-host sharded checkpoint: a committed step round-trips bit for
  bit, each rank writing and reading only its own blocks, and a step
  whose finalize dies on host 1 (``fail_host_finalize``) has no commit
  record, so neither process restores it;
- group recovery: ``kill_process_at_step={1: 3}`` under ``unroll`` 2
  drains and saves both ranks at one agreed boundary (4 + the margin 8),
  both supervisors restart together, the restore agrees on the step, and
  the final state equals an uninterrupted 2-rank run's bit for bit.

- blocks that are not boxes: a tensor-parallel TrainLM's head-aligned
  ``qkv`` (interleave 3) saved by each rank as its box of the
  ``[3, members, rest]`` view; one process reads the group's step back
  (``load_inference_model``, and ``restore_state`` into a one-process
  state) equal to the gathered state in the bare layout, bit for bit.

Its oracle is the port's own uninterrupted run (JAX's leg is slow-marked).
The cluster is spawned once for the module; its rank programs are in
``tests/torch_chaos_workers.py``.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import pytest

import torch_chaos_workers as chaos
import torch_parallel_workers as workers

pytestmark = pytest.mark.chaos

WORLD = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("group_chaos"))
    workers.spawn(chaos.chaos_legs, WORLD, workdir)
    out = {leg: workers.load(workdir, leg, WORLD) for leg in ("protocol", "recovery", "tp")}
    out["workdir"] = workdir
    return out


def test_sharded_commit_round_trip(results):
    for r in results["protocol"]:
        assert r["split"]  # a tensor split across the processes
        assert r["latest_committed"] == 1
        assert r["restored_step"] == 1 and r["restored_exact"]


def test_torn_host_finalize_invisible_to_every_process(results):
    for r in results["protocol"]:
        assert not r["torn_saved"]
        assert r["latest_after_torn"] == 1 and r["restored_step"] == 1
        assert "1.zkhost" in r["listing"] and "2.zkhost" in r["listing"]


def test_group_recovery_bit_identical(results):
    for r in results["recovery"]:
        assert r["restarts"] == 1
        assert r["causes"] == [("Preempted", 12, True)]
        assert r["final_step"] == 16 and r["bit_identical"]
        assert "12.zkhost" in r["steps_on_disk"]
        assert r["restore_ms"]


def test_one_process_reads_head_aligned_blocks_in_global_order(results):
    import json
    import os

    import torch

    import zookeeper_tpu_torch.data  # noqa: F401  (datasets by name)
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training import load_inference_model
    from zookeeper_tpu_torch.training.lm import TrainLM

    tp = results["tp"]
    assert [r["qkv_dims"][0][1] for r in tp] == [3, 3] and tp[0]["held"] == (48, 32)
    hosts = os.path.join(results["workdir"], "lm_hosts")
    bare = os.path.join(results["workdir"], "lm_bare")
    step = tp[0]["step"]
    with open(os.path.join(hosts, f"{step}.zkhost", "host_00001", "manifest.json")) as f:
        boxes = {m["path"]: m for m in json.load(f).values()}
    qkv = boxes["['module']['block0.qkv.weight']"]
    assert qkv["shape"] == [3, 2, 16, 32] and qkv["index"][1] == [1, 2]
    assert qkv["global_shape"] == [96, 32]
    got, want = load_inference_model(hosts), load_inference_model(bare)
    for g, w in zip(got, want):
        assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)

    def restored(directory):
        exp = TrainLM()
        conf = {k: v for k, v in chaos.LM_TP.items() if not k.startswith("partitioner")}
        configure(exp, {**conf, "partitioner": "SingleDevicePartitioner",
                        "checkpointer.directory": directory,
                        "checkpointer.sharded_per_host": True}, name="experiment")
        state = exp.build_state(torch.device("cpu"))
        exp.checkpointer.restore_state(state)
        return state

    a, b = restored(hosts), restored(bare)
    assert a.step == b.step == step
    sa, sb = chaos._tensors(a), chaos._tensors(b)
    assert chaos._same(sa, sb)
