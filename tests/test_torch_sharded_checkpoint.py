"""The port's per-host sharded checkpoints against the JAX package's.

Every case of ``tests/training/test_sharded_checkpoint.py`` but the
serving watcher's (``CheckpointWatcher`` is not ported), and one where
the two hosts' views of a step differ, runs twice: two
``Checkpointer``s with injected ``process_index``/``process_count``
play hosts 0 and 1 of a group over one directory, once in the JAX
package (its ``tiny_state``: ``w`` [4, 2] float32 and a bfloat16 scalar
``b``) and once in the port (the same leaves in a module, under a scope
the flax converter keeps as it is). The outcomes must be equal:

- the relative paths of every file under the checkpoint root (the
  ``.zkhost`` step directories, their temporary remnants and the
  restore agreement's ``.zkcoord`` rounds file by file; a bare-layout
  step, which the two packages write in their own formats, by its
  directory);
- the contents of every ``COMMIT.json``;
- each host manifest's ``index``/``shape``/``shard_shape``/``dtype`` of
  ``w`` and ``b``;
- what each save returned, the latest and finalized steps, the agreed
  restore step and the restored values (``b`` bit for bit in bfloat16),
  the errors raised, and what ``load_inference_model`` reads.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu.training import Checkpointer as JaxCheckpointer
from zookeeper_tpu.training import TrainState as JaxTrainState
from zookeeper_tpu.training.checkpoint import finalized_steps as jax_finalized_steps
from zookeeper_tpu.training.checkpoint import load_inference_model as jax_load_inference_model
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.training import Adam, Checkpointer, Sgd, TrainState
from zookeeper_tpu_torch.training.checkpoint import finalized_steps, load_inference_model

pytestmark = pytest.mark.chaos


class JaxSide:
    Plan, faults = JaxFaultPlan, jax_faults
    finalized_steps, load_inference_model = jax_finalized_steps, jax_load_inference_model
    leaves = {"['params']['w']": "w", "['params']['b']": "b"}

    @staticmethod
    def state(value, step, adam=False, w_rows=4, with_b=True):
        params = {"w": jnp.full((w_rows, 2), value, jnp.float32)}
        if with_b:
            params["b"] = jnp.asarray(value, jnp.bfloat16)
        state = JaxTrainState.create(apply_fn=lambda *a, **k: None, params=params,
                                     model_state={},
                                     tx=optax.adam(1e-3) if adam else optax.sgd(0.1))
        return state.replace(step=jnp.asarray(step))

    @staticmethod
    def checkpointer(conf, name):
        ck = JaxCheckpointer()
        jax_configure(ck, conf, name=name)
        return ck

    @staticmethod
    def read(state):
        b = np.asarray(state.params["b"])
        return (int(np.asarray(state.step)), np.asarray(state.params["w"]).tolist(),
                str(b.dtype), b.view(np.uint16).tolist())

    @staticmethod
    def weights(params):
        return {k: np.asarray(v, np.float32).tolist() for k, v in params.items()}


class _Leaves(torch.nn.Module):
    def __init__(self, value, w_rows, with_b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((w_rows, 2), float(value)))
        if with_b:
            self.b = torch.nn.Parameter(torch.tensor(value, dtype=torch.bfloat16))


class _Tiny(torch.nn.Module):
    """``w`` and ``b`` under a scope the flax converter keeps as it is."""

    def __init__(self, value, w_rows=4, with_b=True):
        super().__init__()
        self.RSign_0 = _Leaves(value, w_rows, with_b)


class PortSide:
    Plan, faults = FaultPlan, faults
    finalized_steps, load_inference_model = finalized_steps, load_inference_model
    leaves = {"['module']['RSign_0.w']": "w", "['module']['RSign_0.b']": "b"}

    @staticmethod
    def state(value, step, adam=False, w_rows=4, with_b=True):
        opt = Adam() if adam else Sgd()
        configure(opt, {"schedule": "ConstantSchedule",
                        "schedule.base_lr": 1e-3 if adam else 0.1}, name="optimizer")
        tx = opt.build(total_steps=1)
        module = _Tiny(value, w_rows, with_b)
        return TrainState(step=step, module=module, tx=tx,
                          opt_state=tx.init(dict(module.named_parameters())))

    @staticmethod
    def checkpointer(conf, name):
        ck = Checkpointer()
        configure(ck, conf, name=name)
        return ck

    @staticmethod
    def read(state):
        leaves = state.module.RSign_0
        return (int(state.step), leaves.w.detach().tolist(), "bfloat16",
                leaves.b.detach().reshape(1).view(torch.int16).numpy().view(np.uint16).tolist()[0])

    @staticmethod
    def weights(params):
        return {k.split("/")[-1]: np.asarray(v.float()).tolist() for k, v in params.items()}


def host_pair(side, root, **extra):
    """Two Checkpointers impersonating hosts 0/1 of one group."""
    return [side.checkpointer({
        "directory": str(root), "sharded_per_host": True, "synchronous": True,
        "save_every_epochs": 0, "process_index": pid, "process_count": 2,
        "host_commit_timeout_s": 2.0, **extra}, f"ck_host{pid}") for pid in range(2)]


def single(side, root, **extra):
    return side.checkpointer({"directory": str(root), "synchronous": True,
                              "save_every_epochs": 0, **extra}, "ck_single")


def group_save(cks, state, step):
    """Host 1 first, so host 0's commit wait finds its marker at once."""
    ok1 = cks[1].save(state, step=step)
    ok0 = cks[0].save(state, step=step)
    return ok0, ok1


def group_restore(side, cks, target):
    """Both hosts restore at once (the agreement's exchanges meet)."""
    out, errors = {}, {}

    def run(pid):
        try:
            out[pid] = side.read(cks[pid].restore_state(target()))
        except ValueError as e:
            errors[pid] = str(e)

    t = threading.Thread(target=run, args=(1,))
    t.start()
    run(0)
    t.join()
    return out if not errors else {"errors": errors}


def value_of(read):
    """(step, w's value, b's dtype and value) of a ``side.read``."""
    step, w, dtype, bits = read
    bits = bits if isinstance(bits, int) else int(np.asarray(bits).reshape(-1)[0])
    b = float(np.array([bits], np.uint16).view(jnp.bfloat16)[0])
    assert len({x for row in w for x in row}) == 1
    return step, w[0][0], dtype, b


def layout(root):
    """Relative file paths under ``root``; a bare-layout step directory
    (each package's own format) as its directory."""
    out = set()
    for dirpath, _, names in os.walk(root):
        for n in names:
            parts = os.path.relpath(os.path.join(dirpath, n), root).split(os.sep)
            cut = next((i for i, p in enumerate(parts) if p.isdigit()), None)
            out.add("/".join(parts if cut is None else parts[:cut + 1]))
    return sorted(out)


def records(side, root):
    """Every ``COMMIT.json``'s contents, and each host manifest's box of
    ``w`` and ``b``, by relative path."""
    commits, manifests = {}, {}
    for dirpath, _, names in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if "COMMIT.json" in names:
            with open(os.path.join(dirpath, "COMMIT.json")) as f:
                commits[rel] = json.load(f)
        if "manifest.json" in names:
            with open(os.path.join(dirpath, "manifest.json")) as f:
                manifest = json.load(f)
            manifests[rel] = {side.leaves[m["path"]]: (m["index"], m["shape"], m["shard_shape"],
                                                       m["dtype"])
                              for m in manifest.values() if m["path"] in side.leaves}
    return commits, manifests


# -- the scenarios: each returns its outcomes, and checks JAX's asserts ------


def commit_and_round_trip_both_hosts(side, root):
    cks = host_pair(side, root)
    saved = group_save(cks, side.state(3.0, 7), 7)
    assert saved == (True, True)
    commit = json.loads(open(os.path.join(root, "7.zkhost", "COMMIT.json")).read())
    assert commit["step"] == 7 and commit["process_count"] == 2
    latest = [ck.latest_step() for ck in cks]
    assert latest == [7, 7]
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p]) for p in (0, 1)] == [(7, 3.0, "bfloat16", 3.0)] * 2
    return saved, latest, out


def torn_host_finalize_is_invisible_to_every_host(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 1), 1))
    with side.faults.injected(side.Plan(fail_host_finalize=1)):
        saved = (cks[1].save(side.state(2.0, 2), step=2), cks[0].save(side.state(2.0, 2), step=2))
    assert saved == (False, False)
    assert not os.path.exists(os.path.join(root, "2.zkhost", "COMMIT.json"))
    assert not os.path.exists(os.path.join(root, "2.zkhost", "host_00001"))
    latest = [ck.latest_step() for ck in cks]
    assert latest == [1, 1]
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p]) for p in (0, 1)] == [(1, 1.0, "bfloat16", 1.0)] * 2
    return saved, latest, out


def gc_race_per_host_walk_falls_through(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 1), 1))
    assert all(group_save(cks, side.state(2.0, 2), 2))
    shutil.rmtree(os.path.join(root, "2.zkhost", "host_00001"))
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p])[:2] for p in (0, 1)] == [(1, 1.0)] * 2
    return out


def peer_torn_step_skipped_by_healthy_host(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 1), 1))
    assert all(group_save(cks, side.state(2.0, 2), 2))
    os.unlink(os.path.join(root, "2.zkhost", "host_00001", "data.npz"))
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p])[:2] for p in (0, 1)] == [(1, 1.0)] * 2
    return out


def restore_agreement_follows_a_peer_that_sees_a_step_torn(side, root):
    """Host 1's storage reads step 2 as torn while host 0's reads it whole
    (each host's own view of the directory): the agreement skips step 2 on
    both, and both restore step 1."""
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 1), 1))
    assert all(group_save(cks, side.state(2.0, 2), 2))
    real = cks[1]._validate_entry
    object.__setattr__(cks[1], "_validate_entry",
                       lambda step, tier: step != 2 and real(step, tier))
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p])[:2] for p in (0, 1)] == [(1, 1.0)] * 2
    return out


def retention_prunes_committed_steps(side, root):
    cks = host_pair(side, root, max_to_keep=2)
    for step in (1, 2, 3):
        assert all(group_save(cks, side.state(float(step), step), step))
    names = sorted(n for n in os.listdir(root) if n.endswith(".zkhost"))
    assert names == ["2.zkhost", "3.zkhost"]
    return names


def durable_tier_promotion_and_fallback(side, root):
    cks = host_pair(side, root, durable_every_steps=2)
    for step in (1, 2, 3):
        assert all(group_save(cks, side.state(float(step), step), step))
    droot = os.path.join(root, "durable")
    durable = sorted(n for n in os.listdir(droot) if n.endswith(".zkhost"))
    assert durable == ["1.zkhost", "3.zkhost"]
    for name in ("1.zkhost", "2.zkhost", "3.zkhost"):
        shutil.rmtree(os.path.join(root, name))
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p]) for p in (0, 1)] == [(3, 3.0, "bfloat16", 3.0)] * 2
    return durable, out


def async_mode_sharded_save_lands_commit(side, root):
    cks = host_pair(side, root, mode="async")
    state = side.state(5.0, 4)
    accepted = [cks[1].save(state, step=4)]
    cks[1].wait()
    accepted.append(cks[0].save(state, step=4))
    cks[0].wait()
    assert accepted == [True, True]
    assert os.path.isfile(os.path.join(root, "4.zkhost", "COMMIT.json"))
    out = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(out[p]) for p in (0, 1)] == [(4, 5.0, "bfloat16", 5.0)] * 2
    for ck in cks:
        ck.close()
    return accepted, out


def coordinator_loss_degrades_to_local_walk(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 9), 9))
    with side.faults.injected(side.Plan(coordinator_loss=1)):
        got = side.read(cks[0].restore_state(side.state(0.0, 0)))
    assert value_of(got) == (9, 1.0, "bfloat16", 1.0)
    return got


def process_count_one_degrades_to_bare_layout(side, root):
    ck = side.checkpointer({"directory": str(root), "sharded_per_host": True,
                            "synchronous": True, "save_every_epochs": 0, "process_index": 0,
                            "process_count": 1}, "ck_single")
    assert ck.save(side.state(2.0, 3), step=3)
    names = os.listdir(root)
    assert "3" in names and not any(n.endswith(".zkhost") for n in names)
    got = side.read(ck.restore_state(side.state(0.0, 0)))
    assert value_of(got) == (3, 2.0, "bfloat16", 2.0)
    ck.close()
    return got


def bare_steps_walked_alongside_sharded(side, root):
    old = single(side, root)
    assert old.save(side.state(1.0, 1), step=1)
    old.close()
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(2.0, 2), 2))
    assert cks[0].latest_step() == 2
    first = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(first[p])[:2] for p in (0, 1)] == [(2, 2.0)] * 2
    shutil.rmtree(os.path.join(root, "2.zkhost"))
    second = group_restore(side, cks, lambda: side.state(0.0, 0))
    assert [value_of(second[p])[:2] for p in (0, 1)] == [(1, 1.0)] * 2
    return first, second


def single_process_can_read_group_checkpoint(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(6.0, 5), 5))
    reader = side.checkpointer({"directory": str(root), "sharded_per_host": True,
                                "synchronous": True, "save_every_epochs": 0,
                                "process_index": 0, "process_count": 1}, "ck_reader")
    got = side.read(reader.restore_state(side.state(0.0, 0)))
    assert value_of(got) == (5, 6.0, "bfloat16", 6.0)
    return got


def sharded_rejects_keep_best_metric(side, root):
    ck = side.checkpointer({"directory": str(root), "sharded_per_host": True,
                            "keep_best_metric": "accuracy"}, "ck_bad")
    with pytest.raises(ValueError, match="sharded_per_host is incompat") as e:
        ck._validate_mode()
    return str(e.value)


def structure_mismatch_raises_clear_error(side, root):
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(1.0, 1), 1))
    out = group_restore(side, cks, lambda: side.state(0.0, 0, w_rows=8, with_b=False))
    assert all("None of the 1 retained" in out["errors"][p] for p in (0, 1))
    return sorted(out["errors"])


def stale_uncommitted_host_dir_rewritten_not_sealed(side, root):
    cks = host_pair(side, root)
    with side.faults.injected(side.Plan(fail_host_finalize=1)):
        assert not cks[1].save(side.state(1.0, 2), step=2)
        assert not cks[0].save(side.state(1.0, 2), step=2)
    cks2 = host_pair(side, root)
    assert all(group_save(cks2, side.state(9.0, 2), 2))
    out = group_restore(side, cks2, lambda: side.state(0.0, 0))
    assert [value_of(out[p]) for p in (0, 1)] == [(2, 9.0, "bfloat16", 9.0)] * 2
    return out


def finalized_steps_lists_committed_sharded_steps(side, root):
    cks = host_pair(side, root)
    seen = [side.finalized_steps(str(root))]
    assert all(group_save(cks, side.state(1.0, 3), 3))
    seen.append(side.finalized_steps(str(root)))
    with side.faults.injected(side.Plan(fail_host_finalize=1)):
        assert not cks[1].save(side.state(2.0, 4), step=4)
        assert not cks[0].save(side.state(2.0, 4), step=4)
    seen.append(side.finalized_steps(str(root)))
    assert all(group_save(cks, side.state(3.0, 5), 5))
    seen.append(side.finalized_steps(str(root)))
    assert seen == [[], [3], [3], [3, 5]]
    return seen


def load_inference_model_reads_sharded_step(side, root, caplog):
    import logging

    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(4.0, 7), 7))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        params, _ = side.load_inference_model(str(root))
    assert any("MULTI-HOST" in r.message for r in caplog.records)
    dtype = str(params[[k for k in params if k.endswith("b")][0]].dtype).replace("torch.", "")
    assert dtype == "bfloat16"
    latest = side.weights(params)
    assert latest == {"w": [[4.0, 4.0]] * 4, "b": 4.0}
    explicit = side.weights(side.load_inference_model(str(root), step=7)[0])
    assert explicit == latest
    return latest, explicit


def load_inference_model_prefers_newest_across_layouts(side, root):
    old = single(side, root)
    assert old.save(side.state(1.0, 1), step=1)
    cks = host_pair(side, root)
    assert all(group_save(cks, side.state(2.0, 2), 2))
    steps = side.finalized_steps(str(root))
    assert steps == [1, 2]
    newest = side.weights(side.load_inference_model(str(root))[0])["w"]
    older = side.weights(side.load_inference_model(str(root), step=1)[0])["w"]
    assert newest == [[2.0, 2.0]] * 4 and older == [[1.0, 1.0]] * 4
    return steps, newest, older


def load_inference_model_skips_stateful_opt_state(side, root):
    state = side.state(8.0, 2, adam=True, with_b=False)
    cks = host_pair(side, root)
    assert cks[1].save(state, step=2) and cks[0].save(state, step=2)
    w = side.weights(side.load_inference_model(str(root))[0])["w"]
    assert w == [[8.0, 8.0]] * 4
    return w


SCENARIOS = [
    commit_and_round_trip_both_hosts, torn_host_finalize_is_invisible_to_every_host,
    gc_race_per_host_walk_falls_through, peer_torn_step_skipped_by_healthy_host,
    restore_agreement_follows_a_peer_that_sees_a_step_torn,
    retention_prunes_committed_steps, durable_tier_promotion_and_fallback,
    async_mode_sharded_save_lands_commit, coordinator_loss_degrades_to_local_walk,
    process_count_one_degrades_to_bare_layout, bare_steps_walked_alongside_sharded,
    single_process_can_read_group_checkpoint, sharded_rejects_keep_best_metric,
    structure_mismatch_raises_clear_error, stale_uncommitted_host_dir_rewritten_not_sealed,
    finalized_steps_lists_committed_sharded_steps, load_inference_model_reads_sharded_step,
    load_inference_model_prefers_newest_across_layouts,
    load_inference_model_skips_stateful_opt_state,
]


def _outcome(value):
    """Outcomes in one form: a ``side.read`` as ``value_of``'s tuple."""
    if isinstance(value, dict):
        return {k: _outcome(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        if len(value) == 4 and isinstance(value[0], int) and isinstance(value[2], str) \
                and value[2] == "bfloat16":
            return value_of(value)
        return [_outcome(v) for v in value]
    return value


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(tmp_path, scenario, caplog):
    extra = (caplog,) if scenario is load_inference_model_reads_sharded_step else ()
    want = scenario(JaxSide, str(tmp_path / "jax"), *extra)
    got = scenario(PortSide, str(tmp_path / "port"), *extra)
    if scenario is sharded_rejects_keep_best_metric:
        assert got == want
    else:
        assert _outcome(got) == _outcome(want)
    assert layout(tmp_path / "port") == layout(tmp_path / "jax")
    assert records(PortSide, tmp_path / "port") == records(JaxSide, tmp_path / "jax")
