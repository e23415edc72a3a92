"""The port's Checkpointer, async writer, PreemptionGuard, FaultPlan and
run_with_recovery, walked end to end on the CPU: one case for each case
of the JAX package's ``tests/training/test_checkpoint.py``,
``test_async_checkpoint.py`` and ``tests/resilience/test_recovery.py``
and ``test_faults.py`` in this slice (the same configurations, an
``Mlp`` on ``SyntheticMnist``), and the port's own contract: a resumed
run equals an uninterrupted one in every tensor (parameters, statistics,
optimizer state and counts, EMA, step), a restore copies into the built
state's own tensors, ``finalized_steps`` never lists a remnant, and
``EvalExperiment``/``ServingConfig`` read a training run's directory as
the export of the same state."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import logging
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.data.pipeline import DataLoader, batch_iterator
from zookeeper_tpu_torch.data.source import ArraySource
from zookeeper_tpu_torch.resilience import (
    FaultPlan,
    NonFiniteLossError,
    Preempted,
    PreemptionGuard,
    corrupt_checkpoint_dir,
    faults,
    measure_recovery_restore_ms,
    run_with_recovery,
)
from zookeeper_tpu_torch.serving.service import ServingConfig
from zookeeper_tpu_torch.training import (
    Checkpointer,
    CheckpointUnreadableError,
    EvalExperiment,
    TrainingExperiment,
    TrainState,
    finalized_steps,
    load_inference_model,
)
from zookeeper_tpu_torch.training.checkpoint import export_trees, save_model
from zookeeper_tpu_torch.training.optimizer import Sgd

pytestmark = pytest.mark.chaos

LOGGER = "zookeeper_tpu_torch.training.checkpoint"


def make_experiment(extra=None, train=256, val=64, hidden=(32,)):
    exp = TrainingExperiment()
    configure(exp, {
        "loader.dataset": "SyntheticMnist",
        "loader.dataset.num_train_examples": train,
        "loader.dataset.num_validation_examples": val,
        "loader.preprocessing": "ImageClassificationPreprocessing",
        "loader.preprocessing.height": 28,
        "loader.preprocessing.width": 28,
        "loader.preprocessing.channels": 1,
        **({} if "model" in (extra or {}) else {"model": "Mlp", "model.hidden_units": hidden}),
        "batch_size": 32,
        "epochs": 2,
        "verbose": False,
        "device": "cpu",
        **(extra or {}),
    }, name="experiment")
    return exp


def small_experiment(tmp_path, extra=None):
    """tests/training/test_checkpoint.py's configuration: 128 examples,
    hidden (16,), 4 steps an epoch, epoch saves."""
    return make_experiment({"checkpointer.directory": str(tmp_path / "ckpt"),
                            "checkpointer.synchronous": True, **(extra or {})},
                           train=128, val=32, hidden=(16,))


def ckpt_conf(tmp_path, **extra):
    return {"checkpointer.directory": str(tmp_path / "ckpt"),
            "checkpointer.synchronous": True,
            "checkpointer.save_every_epochs": 0,
            "checkpointer.save_every_steps": 0, **extra}


def async_conf(tmp_path, **extra):
    return {"checkpointer.directory": str(tmp_path / "ckpt"),
            "checkpointer.mode": "async",
            "checkpointer.save_every_epochs": 0,
            "checkpointer.save_retry_backoff_s": 0.0, **extra}


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


def assert_states_equal(a, b):
    fa, fb = flat_state(a), flat_state(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


class _Tiny(torch.nn.Module):
    def __init__(self, value: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((2,), float(value)))


def tiny_state(value: float, step: int) -> TrainState:
    """A minimal TrainState for direct Checkpointer tests."""
    opt = Sgd()
    configure(opt, {}, name="optimizer")
    tx = opt.build(total_steps=1)
    module = _Tiny(value)
    return TrainState(step=step, module=module, tx=tx,
                      opt_state=tx.init(dict(module.named_parameters())))


def make_ckpt(tmp_path, **conf):
    ckpt = Checkpointer()
    configure(ckpt, {"directory": str(tmp_path / "ck"), "save_retry_backoff_s": 0.0, **conf},
              name="ckpt")
    return ckpt


def tiers(ckpt):
    return sorted(s for s, _ in ckpt._tier_entries())


# -- the Checkpointer in the experiment ------------------------------------


def test_checkpointer_disabled_by_default():
    ckpt = Checkpointer()
    configure(ckpt, {}, name="ckpt")
    assert not ckpt.enabled
    assert ckpt.save(None) is False
    assert ckpt.restore_state("anything") == "anything"
    assert ckpt.latest_step() is None


def test_save_and_restore_roundtrip(tmp_path):
    exp = small_experiment(tmp_path)
    exp.run()
    assert exp.checkpointer.latest_step() == 8  # 2 epochs x 4 steps
    # A fresh run on the directory resumes with every epoch done.
    exp2 = small_experiment(tmp_path)
    assert exp2.run()["train"] == []
    assert exp2.final_state.step == 8
    assert_states_equal(exp.final_state, exp2.final_state)


def test_resume_continues_training(tmp_path):
    exp = small_experiment(tmp_path, {"epochs": 1})
    exp.run()
    assert exp.checkpointer.latest_step() == 4
    exp2 = small_experiment(tmp_path, {"epochs": 3})
    history = exp2.run()
    assert len(history["train"]) == 2  # epochs 1 and 2 only
    assert exp2.final_state.step == 12


def test_restore_disabled_starts_fresh(tmp_path):
    small_experiment(tmp_path, {"epochs": 1}).run()
    exp2 = small_experiment(tmp_path, {"epochs": 1, "checkpointer.restore": False})
    assert len(exp2.run()["train"]) == 1  # trained from scratch


def test_keep_best_retention_and_best_step(tmp_path):
    """keep_best_metric ranks the saves: max_to_keep=1 keeps the best
    accuracy, not the latest."""
    ckpt = make_ckpt(tmp_path, max_to_keep=1, synchronous=True, keep_best_metric="accuracy")
    for step, acc in ((1, 0.2), (2, 0.9), (3, 0.5)):
        ckpt.save(tiny_state(float(step), step), metrics={"accuracy": acc})
    ckpt.wait()
    assert ckpt.best_step() == 2
    restored = ckpt.restore_state(tiny_state(0.0, 0))
    assert restored.step == 2
    assert torch.equal(restored.module.w.detach(), torch.full((2,), 2.0))


def test_keep_best_requires_metrics(tmp_path):
    ckpt = make_ckpt(tmp_path, synchronous=True, keep_best_metric="accuracy")
    with pytest.raises(ValueError, match="carries no such metric"):
        ckpt.save(tiny_state(1.0, 1))
    with pytest.raises(ValueError, match="carries no such metric"):
        ckpt.save(tiny_state(1.0, 1), metrics={"loss": 0.5})


def test_experiment_passes_metrics_to_best_checkpointing(tmp_path):
    exp = small_experiment(tmp_path, {"checkpointer.keep_best_metric": "accuracy"})
    exp.run()
    assert exp.checkpointer.best_step() is not None


def test_keep_best_rank_saves_only_on_validated_epochs(tmp_path):
    """keep_best_metric + validate_every=2: only validated epochs save."""
    exp = small_experiment(tmp_path, {
        "epochs": 4, "steps_per_epoch": 2, "validate_every": 2,
        "checkpointer.keep_best_metric": "accuracy", "checkpointer.max_to_keep": 10,
    })
    exp.run()
    assert tiers(exp.checkpointer) == [4, 8]


def test_step_granular_save_and_exact_midepoch_resume(tmp_path):
    """save_every_steps saves inside the epoch; resuming from a mid-epoch
    step replays exactly the rest of it: the resumed run's final state
    equals an uninterrupted run's in every tensor."""
    ref = small_experiment(tmp_path / "ref", {"epochs": 2})
    ref.run()
    conf = {"checkpointer.save_every_steps": 3, "checkpointer.save_every_epochs": 0}
    exp = small_experiment(tmp_path, {"epochs": 1, **conf})
    exp.run()
    assert exp.checkpointer.latest_step() == 3
    exp2 = small_experiment(tmp_path, {"epochs": 2, **conf})
    history = exp2.run()
    assert exp2.final_state.step == ref.final_state.step == 8
    assert len(history["train"]) == 2
    assert_states_equal(ref.final_state, exp2.final_state)
    assert tiers(exp2.checkpointer) == [3, 6]


def test_save_every_steps_rejects_best_ranking(tmp_path):
    exp = small_experiment(tmp_path, {"checkpointer.save_every_steps": 2,
                                      "checkpointer.keep_best_metric": "accuracy"})
    with pytest.raises(ValueError, match="save_every_steps"):
        exp.run()


@pytest.mark.parametrize("save_every_epochs", [0, 1], ids=["epoch_path_idle", "shared_step"])
def test_step_saves_and_epoch_saves_share_boundaries(tmp_path, save_every_epochs):
    """A step save on an epoch boundary still happens when the epoch path
    does not fire; when both land on one step exactly one save happens."""
    exp = small_experiment(tmp_path, {"epochs": 2, "checkpointer.save_every_steps": 4,
                                      "checkpointer.save_every_epochs": save_every_epochs})
    saves = []
    real = exp.checkpointer.save
    object.__setattr__(exp.checkpointer, "save",
                       lambda state, **kw: saves.append(state.step) or real(state, **kw))
    exp.run()
    assert saves == [4, 8]
    assert tiers(exp.checkpointer) == [4, 8]


def test_midepoch_resume_tags_partial_epoch(tmp_path, capsys):
    """The resumed epoch's train aggregates cover its last steps only: its
    line is tagged partial, and with no validation split it is not scored
    by early stopping (patience 1 would otherwise stop after epoch 2)."""
    conf = {"checkpointer.save_every_steps": 3, "checkpointer.save_every_epochs": 0,
            "validate": False}
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path, **conf)}, train=128, val=0,
                          hidden=(16,))
    exp.run()
    exp2 = make_experiment({"epochs": 3, "verbose": True, "early_stop_metric": "loss",
                            "early_stop_patience": 1, **ckpt_conf(tmp_path, **conf)},
                           train=128, val=0, hidden=(16,))
    capsys.readouterr()
    history = exp2.run()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch ")]
    assert "[partial: resumed at step 3]" in lines[0]
    assert all("partial" not in ln for ln in lines[1:])
    assert len(history["train"]) >= 2


# -- the async mode ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_async_saves_restore_bit_identical_to_sync(tmp_path, mode):
    ckpt = make_ckpt(tmp_path, mode=mode)
    ckpt.save(tiny_state(3.5, 7), step=7)
    ckpt.wait()
    restored = ckpt.restore_state(tiny_state(0.0, 0))
    assert restored.step == 7
    assert torch.equal(restored.module.w.detach(), torch.full((2,), 3.5))
    ckpt.close()


def test_async_mode_training_run_resumes_like_sync(tmp_path):
    ref = make_experiment({"epochs": 2, "validate": False}, val=0)
    ref.run()
    conf = async_conf(tmp_path, **{"checkpointer.save_every_steps": 3})
    exp = make_experiment({"epochs": 1, "validate": False, **conf}, val=0)
    exp.run()
    assert exp.checkpointer.latest_step() == 6  # spe 8: saves at 3, 6
    exp.checkpointer.close()
    exp2 = make_experiment({"epochs": 2, "validate": False, **conf}, val=0)
    exp2.run()
    assert exp2.final_state.step == 16
    assert_states_equal(ref.final_state, exp2.final_state)
    exp2.checkpointer.close()


@pytest.mark.parametrize("bad", [
    {"checkpointer.mode": "background"},
    {"checkpointer.queue_policy": "drop"},
    {"checkpointer.durable_every_steps": -1},
    {"checkpointer.queue_policy": "supersede", "checkpointer.keep_best_metric": "accuracy"},
    {"checkpointer.save_every_steps": -1},
    {"checkpointer.mode": "sync", "checkpointer.synchronous": False},
], ids=["mode", "queue_policy", "durable", "supersede_best", "negative_cadence",
        "background_sync_save"])
def test_invalid_mode_and_policy_rejected(tmp_path, bad):
    exp = make_experiment({**async_conf(tmp_path), **bad})
    with pytest.raises(ValueError):
        exp.run()


@pytest.mark.parametrize("field,value", [
    ("sharded_per_host", True), ("process_index", 0), ("process_count", 2),
    ("host_commit_timeout_s", 5.0),
])
def test_later_slice_fields_raise_naming_roadmap(tmp_path, field, value):
    """The per-host protocol's fields (a group of one process: the bare
    layout's saves land, as they do without them)."""
    exp = make_experiment({**ckpt_conf(tmp_path, **{"checkpointer.save_every_epochs": 1}),
                           f"checkpointer.{field}": value}, train=128, val=0, hidden=(16,))
    exp.run()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "8"]
    assert exp.checkpointer.latest_step() == 8


def test_kill_mid_async_write_restores_previous_finalized_step(tmp_path):
    """An async write that dies before its rename leaves only an
    unfinalized remnant: restore lands on the previous finalized step,
    bit for bit."""
    ref = make_experiment({"epochs": 1, "steps_per_epoch": 3, "validate": False}, val=0)
    ref.run()
    conf = async_conf(tmp_path, **{"checkpointer.save_every_steps": 3})
    exp = make_experiment({"epochs": 1, "validate": False, **conf}, val=0)
    with faults.injected(FaultPlan(kill_during_async_write=6)):
        exp.run()  # spe 8: the step-3 save lands, step 6's write is torn
    exp.checkpointer.close()
    root = str(tmp_path / "ckpt")
    names = os.listdir(root)
    assert any(n.startswith("6.") for n in names), names
    assert "6" not in names and finalized_steps(root) == [3]
    fresh = make_experiment({"epochs": 1, "steps_per_epoch": 3, "validate": False}, val=0)
    ckpt = Checkpointer()
    configure(ckpt, {"directory": root}, name="restore_ckpt")
    restored = ckpt.restore_state(fresh.build_state(torch.device("cpu")))
    assert restored.step == 3
    assert_states_equal(ref.final_state, restored)


def test_fail_async_finalize_retries_then_succeeds(tmp_path):
    ckpt = make_ckpt(tmp_path, mode="async")
    with faults.injected(FaultPlan(fail_async_finalize=1)):
        ckpt.save(tiny_state(1.0, 4), step=4)
        ckpt.wait()
    assert ckpt.latest_step() == 4
    assert ckpt._writer().stats["finalized"] == 1
    assert ckpt.restore_state(tiny_state(0.0, 0)).step == 4
    ckpt.close()


def test_fail_async_finalize_exhausted_drops_and_earlier_step_restores(tmp_path, caplog):
    ckpt = make_ckpt(tmp_path, mode="async", save_retries=0)
    ckpt.save(tiny_state(1.0, 2), step=2)
    ckpt.wait()
    with caplog.at_level(logging.ERROR, LOGGER):
        with faults.injected(FaultPlan(fail_async_finalize=5)):
            ckpt.save(tiny_state(9.0, 4), step=4)
            ckpt.wait()
    dropped = [r for r in caplog.records if "DROPPED" in r.message]
    assert dropped and dropped[0].exc_info is not None
    assert ckpt.latest_step() == 2
    assert ckpt.restore_state(tiny_state(0.0, 0)).step == 2
    ckpt.close()


def test_writer_thread_save_io_failure_never_touches_training(tmp_path):
    ref = make_experiment({"epochs": 1, "validate": False}, val=0)
    ref.run()
    conf = async_conf(tmp_path, **{"checkpointer.save_every_steps": 3,
                                   "checkpointer.save_retries": 0})
    exp = make_experiment({"epochs": 1, "validate": False, **conf}, val=0)
    with faults.injected(FaultPlan(fail_save_io=1)):
        history = exp.run()  # the step-3 write fails and drops; step 6 lands
    assert len(history["train"]) == 1
    assert_states_equal(ref.final_state, exp.final_state)
    assert tiers(exp.checkpointer) == [6]
    exp.checkpointer.close()


def _gated_writer_ckpt(tmp_path, policy):
    """Async writes that wait on a gate the test holds."""
    ckpt = make_ckpt(tmp_path, mode="async", queue_policy=policy)
    gate = threading.Event()
    real = ckpt._attempt_async_write

    def gated(step, tree, metrics):
        gate.wait(timeout=30)
        return real(step, tree, metrics)

    object.__setattr__(ckpt, "_attempt_async_write", gated)
    return ckpt, gate


def test_supersede_policy_replaces_queued_snapshot(tmp_path):
    ckpt, gate = _gated_writer_ckpt(tmp_path, "supersede")
    ckpt.save(tiny_state(1.0, 1), step=1)  # taken by the writer, gated
    writer = ckpt._writer()
    for _ in range(2000):
        if writer._writing_step is not None:
            break
        time.sleep(0.001)
    assert writer._writing_step == 1
    ckpt.save(tiny_state(2.0, 2), step=2)  # queued
    ckpt.save(tiny_state(3.0, 3), step=3)  # supersedes 2
    gate.set()
    ckpt.wait()
    assert tiers(ckpt) == [1, 3]
    assert writer.stats["superseded"] == 1
    assert ckpt.restore_state(tiny_state(0.0, 0)).step == 3
    ckpt.close()


def test_wait_policy_backpressures_and_writes_every_step(tmp_path):
    ckpt, gate = _gated_writer_ckpt(tmp_path, "wait")

    def submit_all():
        for s in (1, 2, 3):
            ckpt.save(tiny_state(float(s), s), step=s)

    t = threading.Thread(target=submit_all)
    t.start()
    gate.set()
    t.join(timeout=30)
    assert not t.is_alive()
    ckpt.wait()
    assert tiers(ckpt) == [1, 2, 3]
    assert ckpt._writer().stats["superseded"] == 0
    ckpt.close()


def test_async_snapshot_owns_its_bytes(tmp_path):
    """The state is updated in place: a snapshot taken before a step must
    hold the pre-step values after it, whenever the writer runs."""
    ckpt, gate = _gated_writer_ckpt(tmp_path, "wait")
    state = tiny_state(1.0, 1)
    ckpt.save(state, step=1)
    with torch.no_grad():
        state.module.w.fill_(5.0)  # the next step's in-place write
    gate.set()
    ckpt.wait()
    assert torch.equal(ckpt.restore_state(tiny_state(0.0, 0)).module.w.detach(),
                       torch.full((2,), 1.0))
    ckpt.close()


def test_preemption_drains_inflight_write_and_records_wait(tmp_path):
    ref = make_experiment({"epochs": 2, "validate": False}, val=0)
    ref.run()
    conf = async_conf(tmp_path, **{"checkpointer.save_every_steps": 2})
    exp = make_experiment({"epochs": 2, "validate": False, **conf}, val=0)
    with faults.injected(FaultPlan(kill_at_step=5)):
        result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 1
    assert len(result.save_wait_ms) == 1 and result.save_wait_ms[0] >= 0.0
    assert len(result.restore_ms) == 1 and result.restore_ms[0] > 0
    assert exp.final_state.step == 16
    assert_states_equal(ref.final_state, exp.final_state)
    exp.checkpointer.close()


def test_durable_tier_promotes_and_restores_after_local_loss(tmp_path):
    ckpt = make_ckpt(tmp_path, mode="async", max_to_keep=2, durable_every_steps=4)
    for s in (2, 4, 6, 8):
        ckpt.save(tiny_state(float(s), s), step=s)
    ckpt.wait()
    entries = ckpt._tier_entries()
    assert [e for e in entries if e[1] == "local"] == [(8, "local"), (6, "local")]
    assert [e for e in entries if e[1] == "durable"] == [(6, "durable"), (2, "durable")]
    for name in os.listdir(str(tmp_path / "ck")):
        if name.isdigit():
            shutil.rmtree(str(tmp_path / "ck" / name))
    restored = ckpt.restore_state(tiny_state(0.0, 0))
    assert restored.step == 6
    assert torch.equal(restored.module.w.detach(), torch.full((2,), 6.0))
    assert corrupt_checkpoint_dir(str(tmp_path / "ck" / "durable" / "6")) > 0
    assert ckpt.restore_state(tiny_state(0.0, 0)).step == 2
    ckpt.close()


def test_durable_tier_cannot_be_starved_by_cadence_misalignment(tmp_path):
    ckpt = make_ckpt(tmp_path, durable_every_steps=100)
    for s in (64, 128, 192, 256):
        ckpt.save(tiny_state(float(s), s), step=s)
    ckpt.wait()
    assert sorted(s for s, t in ckpt._tier_entries() if t == "durable") == [64, 192]


def test_restore_survives_retention_gc_race(tmp_path, caplog):
    ckpt = make_ckpt(tmp_path)
    for s in (1, 2):
        ckpt.save(tiny_state(float(s), s), step=s)
    real = ckpt._tier_entries
    listed = real()
    assert sorted(s for s, _ in listed) == [1, 2]
    # Step 2 deleted under the walk after it was listed.
    shutil.rmtree(str(tmp_path / "ck" / "2"))
    object.__setattr__(ckpt, "_tier_entries", lambda: listed)
    with caplog.at_level(logging.WARNING, LOGGER):
        restored = ckpt.restore_state(tiny_state(0.0, 0))
    assert restored.step == 1
    assert any("falling back" in r.message for r in caplog.records)


def test_save_retry_backoff_rerandomized_per_attempt(tmp_path, monkeypatch):
    delays = []
    monkeypatch.setattr("zookeeper_tpu_torch.training.checkpoint.time.sleep", delays.append)
    ckpt = make_ckpt(tmp_path, save_retries=4, save_retry_backoff_s=1.0)
    with faults.injected(FaultPlan(fail_save_io=10)):
        assert ckpt.save(tiny_state(1.0, 1), step=1) is False
    assert len(delays) == 4
    for attempt, d in enumerate(delays):
        base = 1.0 * 2**attempt
        assert 0.5 * base <= d <= 1.5 * base, (attempt, d)
    assert delays != [1.0, 2.0, 4.0, 8.0]


# -- preemption, the supervisor, restore fallback ---------------------------


def test_injected_kill_saves_and_raises_preempted(tmp_path):
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path)})
    with faults.injected(FaultPlan(kill_at_step=2)):
        with pytest.raises(Preempted) as exc:
            exp.run()
    assert exc.value.step == 2 and exc.value.saved
    assert exp.checkpointer.latest_step() == 2
    assert exp.first_step_at is not None


def test_kill_without_checkpointer_still_exits_cleanly():
    exp = make_experiment({"epochs": 1})
    with faults.injected(FaultPlan(kill_at_step=2)):
        with pytest.raises(Preempted) as exc:
            exp.run()
    assert exc.value.step == 2 and not exc.value.saved
    # The first step is marked in every run, as in the JAX package (its one
    # synchronisation also starts the step-time stream).
    assert exp.first_step_at is not None


def test_real_sigterm_exits_at_boundary_with_save(tmp_path):
    """A real SIGTERM (``os.kill`` of this process) trips the guard: the
    loop saves and exits at the next step boundary, and the handlers are
    put back afterwards."""
    prev = signal.getsignal(signal.SIGTERM)
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path)})
    real_install = PreemptionGuard.install

    def install_and_sigterm():
        real_install(exp.guard)
        os.kill(os.getpid(), signal.SIGTERM)
        return exp.guard

    object.__setattr__(exp.guard, "install", install_and_sigterm)
    with pytest.raises(Preempted) as exc:
        exp.run()
    assert exc.value.step == 1
    assert exp.guard.received_signal == signal.SIGTERM
    assert exp.checkpointer.latest_step() == 1
    assert signal.getsignal(signal.SIGTERM) is prev


def test_run_with_recovery_resumes_bit_exact_eager(tmp_path):
    ref = make_experiment()
    ref.run()
    exp = make_experiment(ckpt_conf(tmp_path))
    with faults.injected(FaultPlan(kill_at_step=5)):
        result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 1 and isinstance(result.causes[0], Preempted)
    assert len(result.restore_ms) == 1 and result.restore_ms[0] > 0
    assert_states_equal(ref.final_state, exp.final_state)


def test_supervisor_budget_exhausted_propagates(tmp_path):
    exp = make_experiment(ckpt_conf(tmp_path))
    sleeps = []
    attempts = {"n": 0}
    real_run = exp.run

    def run_rearmed():
        attempts["n"] += 1
        with faults.injected(FaultPlan(kill_at_step=attempts["n"])):
            return real_run()

    exp.run = run_rearmed
    with pytest.raises(Preempted):
        run_with_recovery(exp, max_restarts=2, backoff_s=1.0, backoff_factor=2.0,
                          sleep=sleeps.append)
    assert attempts["n"] == 3
    assert sleeps == [1.0, 2.0]


def test_supervisor_rejects_bad_config():
    with pytest.raises(ValueError, match="max_restarts"):
        run_with_recovery(object(), max_restarts=-1)
    with pytest.raises(ValueError, match="backoff"):
        run_with_recovery(object(), backoff_factor=0.5)

    class Group:
        process_index, process_count, generation = 0, 2, None
        rounds = []

        def exchange(self, key, payload, timeout_s=None):
            self.rounds.append((key, payload, timeout_s))
            return [payload, {"outcome": "ok", "cause": None, "origin": None}]

    class Run:
        group_coordinator = None
        seen = []

        def run(self):
            self.seen.append(self.group_coordinator)
            return "history"

    # A group of two: the coordinator is wired for the run, the verdicts
    # are exchanged, and the run returns.
    group, exp = Group(), Run()
    result = run_with_recovery(exp, coordinator=group, group_timeout_s=7.0)
    assert result.history == "history" and result.restarts == 0
    assert exp.seen == [group] and exp.group_coordinator is None and group.generation == 0
    assert group.rounds == [("supervisor_verdict",
                             {"outcome": "ok", "cause": None, "origin": None}, 7.0)]


def test_supervisor_does_not_restart_operator_sigint(tmp_path):
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path)})
    real_check = exp._boundary_check
    tripped = {"done": False}

    def trip_sigint(state, global_step):
        if not tripped["done"]:
            tripped["done"] = True
            exp.guard.request_preemption(signal.SIGINT)
        return real_check(state, global_step)

    object.__setattr__(exp, "_boundary_check", trip_sigint)
    with pytest.raises(Preempted) as exc:
        run_with_recovery(exp, max_restarts=5, backoff_s=0.0)
    assert exc.value.signum == signal.SIGINT
    assert exp.checkpointer.latest_step() == 1


def test_supervisor_unrecoverable_propagates_immediately():
    class Boom:
        calls = 0

        def run(self):
            type(self).calls += 1
            raise ValueError("config bug")

    with pytest.raises(ValueError, match="config bug"):
        run_with_recovery(Boom(), max_restarts=5, backoff_s=0.0)
    assert Boom.calls == 1


def test_measure_recovery_restore_ms(tmp_path):
    out = measure_recovery_restore_ms(
        lambda: make_experiment({"epochs": 1, **ckpt_conf(tmp_path)}), kill_at_step=2)
    assert out["recovery_restarts"] == 1.0
    assert out["recovery_restore_ms"] > 0
    assert out["recovery_save_wait_ms"] == 0.0


def test_restore_falls_back_to_newest_valid_step(tmp_path, caplog):
    ckpt = make_ckpt(tmp_path, synchronous=True)
    with faults.injected(FaultPlan(corrupt_checkpoint_step=3)):
        for s in (1, 2, 3):
            ckpt.save(tiny_state(float(s), s), step=s)
    with caplog.at_level(logging.WARNING, LOGGER):
        restored = ckpt.restore_state(tiny_state(0.0, 0))
    assert restored.step == 2
    assert torch.equal(restored.module.w.detach(), torch.full((2,), 2.0))
    assert any("falling back" in r.message for r in caplog.records)


def test_restore_raises_when_no_step_is_valid(tmp_path):
    ckpt = make_ckpt(tmp_path, synchronous=True)
    for s in (1, 2):
        ckpt.save(tiny_state(float(s), s), step=s)
    for s in (1, 2):
        assert corrupt_checkpoint_dir(str(tmp_path / "ck" / str(s))) > 0
    live = tiny_state(7.0, 0)
    with pytest.raises(ValueError, match="None of the 2 retained"):
        ckpt.restore_state(live)
    # Nothing was copied into the live state.
    assert torch.equal(live.module.w.detach(), torch.full((2,), 7.0)) and live.step == 0


def test_structure_mismatch_raises_the_clear_error(tmp_path):
    ckpt = make_ckpt(tmp_path)
    ckpt.save(tiny_state(1.0, 1), step=1)
    other = tiny_state(0.0, 0)
    other.module.w = torch.nn.Parameter(torch.zeros(3))
    other.opt_state = other.tx.init(dict(other.module.named_parameters()))
    with pytest.raises(ValueError, match="does not match the target model structure"):
        ckpt.restore_state(other)


def test_corrupt_latest_end_to_end_resume_continues(tmp_path):
    conf = ckpt_conf(tmp_path, **{"checkpointer.save_every_steps": 3,
                                  "checkpointer.max_to_keep": 5})
    exp = make_experiment({"epochs": 1, **conf})
    with faults.injected(FaultPlan(corrupt_checkpoint_step=6)):
        exp.run()  # spe 8: saves at 3 and 6; 6 is torn on disk
    exp2 = make_experiment({"epochs": 2, **conf})
    history = exp2.run()  # resumes at 3
    assert exp2.final_state.step == 16
    assert len(history["train"]) == 2


def test_failed_save_retries_then_succeeds(tmp_path):
    ckpt = make_ckpt(tmp_path, synchronous=True)
    with faults.injected(FaultPlan(fail_save_io=1)):
        assert ckpt.save(tiny_state(1.0, 1), step=1)
    assert ckpt.latest_step() == 1


def test_save_failure_exhausted_drops_without_crashing(tmp_path, caplog):
    ckpt = make_ckpt(tmp_path, synchronous=True, save_retries=1)
    with caplog.at_level(logging.WARNING, LOGGER):
        with faults.injected(FaultPlan(fail_save_io=10)):
            assert ckpt.save(tiny_state(1.0, 1), step=1) is False
    assert ckpt.latest_step() is None
    dropped = [r for r in caplog.records if "DROPPED" in r.message]
    assert dropped and dropped[0].levelno == logging.ERROR
    assert "step 1" in dropped[0].getMessage()
    assert dropped[0].exc_info is not None


def test_training_survives_injected_save_failures(tmp_path):
    conf = ckpt_conf(tmp_path, **{"checkpointer.save_every_steps": 3,
                                  "checkpointer.save_retries": 0})
    exp = make_experiment({"epochs": 1, **conf})
    with faults.injected(FaultPlan(fail_save_io=1)):
        history = exp.run()
    assert len(history["train"]) == 1
    assert tiers(exp.checkpointer) == [6]


# -- nan_at_step and the nan_policy -----------------------------------------


def test_nan_skip_keeps_prestep_state_and_counts():
    probe = make_experiment({"epochs": 1, "steps_per_epoch": 2, "nan_policy": "skip"})
    probe.run()
    exp = make_experiment({"epochs": 1, "steps_per_epoch": 3, "nan_policy": "skip"})
    with faults.injected(FaultPlan(nan_at_step=2)):
        history = exp.run()  # the step with counter 2 (the third) blows up
    assert history["train"][0]["skipped_steps"] == 1.0
    assert exp.final_state.step == 3
    a, b = flat_state(probe.final_state), flat_state(exp.final_state)
    assert all(torch.equal(a[k], b[k]) for k in a if k != "step")


def test_nan_skip_clean_run_counts_zero():
    exp = make_experiment({"epochs": 1, "steps_per_epoch": 2, "nan_policy": "skip"})
    history = exp.run()
    assert history["train"][0]["skipped_steps"] == 0.0
    assert np.isfinite(history["train"][0]["loss"])


def test_nan_halt_raises_and_recovers(tmp_path):
    """halt: the run raises at the readback after the NaN step, with the
    clean step-4 state on disk; a supervised rerun with the fault gone
    (a transient blow-up) restores it and completes."""
    conf = ckpt_conf(tmp_path, **{"checkpointer.save_every_steps": 4, "log_every": 2})
    exp = make_experiment({"epochs": 1, "nan_policy": "halt", **conf})
    with faults.injected(FaultPlan(nan_at_step=5)):
        with pytest.raises(NonFiniteLossError) as exc:
            exp.run()
    assert exc.value.skipped == 1
    assert exp.checkpointer.latest_step() == 4
    exp2 = make_experiment({"epochs": 1, "nan_policy": "halt", **conf})
    calls = {"n": 0}
    real_run = exp2.run

    def run_once_faulted():
        calls["n"] += 1
        if calls["n"] == 1:
            with faults.injected(FaultPlan(nan_at_step=5)):
                return real_run()
        return real_run()

    exp2.run = run_once_faulted
    result = run_with_recovery(exp2, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 1 and isinstance(result.causes[0], NonFiniteLossError)
    assert exp2.final_state.step == 8


def test_teardown_failure_does_not_mask_original_exception(tmp_path, caplog):
    exp = make_experiment({"epochs": 1, "nan_policy": "halt", **ckpt_conf(tmp_path)})

    def broken_wait():
        raise OSError("disk vanished during teardown")

    object.__setattr__(exp.checkpointer, "wait", broken_wait)
    with caplog.at_level(logging.WARNING, "zookeeper_tpu_torch.training.experiment"):
        with faults.injected(FaultPlan(nan_at_step=2)):
            with pytest.raises(NonFiniteLossError):
                exp.run()
    assert any("teardown" in r.message for r in caplog.records)


def test_teardown_failure_propagates_when_run_succeeded(tmp_path):
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path)})

    def broken_wait():
        raise OSError("async save failed at finalize")

    object.__setattr__(exp.checkpointer, "wait", broken_wait)
    with pytest.raises(OSError, match="finalize"):
        exp.run()
    # The guard's handlers were put back all the same.
    assert not exp.guard.installed


def test_multi_restart_soak_bit_exact(tmp_path):
    ref = make_experiment({"epochs": 3})
    ref.run()
    exp = make_experiment({"epochs": 3, **ckpt_conf(tmp_path)})
    kills = iter([3, 9, 17, None])
    real_run = exp.run

    def run_rearmed():
        k = next(kills)
        if k is None:
            return real_run()
        with faults.injected(FaultPlan(kill_at_step=k)):
            return real_run()

    exp.run = run_rearmed
    result = run_with_recovery(exp, max_restarts=5, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 3
    assert len(result.restore_ms) == 3 and all(m > 0 for m in result.restore_ms)
    assert_states_equal(ref.final_state, exp.final_state)


# -- the port's own contract ------------------------------------------------


RECIPE = {"optimizer": "Bop", "optimizer.fp_optimizer.schedule": "ConstantSchedule",
          "optimizer.fp_optimizer.schedule.base_lr": 1e-3, "model": "BinaryNet",
          "model.features": (8, 8, 16, 16), "model.dense_units": (32,),
          "track_flip_ratio": True, "ema_decay": 0.9, "nan_policy": "skip",
          "optimizer.accumulate_steps": 2}


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resumed_recipe_run_equals_uninterrupted_in_every_tensor(tmp_path, mode):
    """Bop + Adam under MultiSteps, EMA, flip ratio, nan_policy=skip with a
    NaN after the resume: the counts live on the device after the first
    step; the resumed run equals the uninterrupted one in parameters,
    statistics, Bop's memory, Adam's moments, every count and the EMA."""
    base = {**RECIPE, "epochs": 2, "steps_per_epoch": 3}
    ref = make_experiment(base, train=128, val=32)
    with faults.injected(FaultPlan(nan_at_step=4)):
        ref.run()
    exp = make_experiment({**base, "checkpointer.directory": str(tmp_path / "ck"),
                           "checkpointer.save_every_steps": 2, "checkpointer.mode": mode},
                          train=128, val=32)
    with faults.injected(FaultPlan(nan_at_step=4, kill_at_step=2)):
        result = run_with_recovery(exp, backoff_s=0.0, sleep=lambda s: None)
    assert result.restarts == 1
    assert_states_equal(ref.final_state, exp.final_state)
    assert isinstance(exp.final_state.opt_state["mini_step"], torch.Tensor)
    exp.checkpointer.close()


def test_restore_copies_into_the_built_state(tmp_path):
    """Restore keeps every tensor object of the built state (the step
    closure's and the optimizer's references stay valid)."""
    exp = make_experiment({"epochs": 1, "ema_decay": 0.9, **ckpt_conf(tmp_path)})
    with faults.injected(FaultPlan(kill_at_step=3)):
        with pytest.raises(Preempted):
            exp.run()
    fresh = make_experiment({"epochs": 1, "ema_decay": 0.9, **ckpt_conf(tmp_path)})
    state = fresh.build_state(torch.device("cpu"))
    ids = {k: id(v) for k, v in flat_state_refs(state).items()}
    fresh.checkpointer.restore_state(state)
    assert {k: id(v) for k, v in flat_state_refs(state).items()} == ids
    assert state.step == 3


def flat_state_refs(state):
    out = {f"param {n}": p for n, p in state.module.named_parameters()}
    out.update({f"buffer {n}": b for n, b in state.module.named_buffers()})
    out.update({f"mu {n}": t for n, t in state.opt_state["mu"].items()})
    out.update({f"ema {n}": t for n, t in state.ema_params.items()})
    return out


def test_ema_seeded_from_restored_params_when_saved_without(tmp_path):
    exp = make_experiment({"epochs": 1, **ckpt_conf(tmp_path)})
    with faults.injected(FaultPlan(kill_at_step=2)):
        with pytest.raises(Preempted):
            exp.run()
    with_ema = make_experiment({"epochs": 1, "ema_decay": 0.9, **ckpt_conf(tmp_path)})
    state = with_ema.checkpointer.restore_state(with_ema.build_state(torch.device("cpu")))
    for name, p in state.module.named_parameters():
        assert torch.equal(state.ema_params[name], p.detach()), name


def test_finalized_steps_never_lists_a_remnant(tmp_path):
    ckpt = make_ckpt(tmp_path, mode="async")
    ckpt.save(tiny_state(1.0, 1), step=1)
    ckpt.wait()
    with faults.injected(FaultPlan(kill_during_async_write=2)):
        ckpt.save(tiny_state(2.0, 2), step=2)
        ckpt.wait()
    root = str(tmp_path / "ck")
    assert any(n.startswith("2.tmp-") for n in os.listdir(root))
    assert finalized_steps(root) == [1] and ckpt.latest_step() == 1
    assert finalized_steps(str(tmp_path / "missing")) == []
    # The next save's retention removes the remnant.
    ckpt.save(tiny_state(3.0, 3), step=3)
    ckpt.wait()
    assert not [n for n in os.listdir(root) if ".tmp-" in n]
    assert finalized_steps(root) == [1, 3]
    ckpt.close()


def test_guard_off_the_main_thread_still_trains(tmp_path, caplog):
    """An experiment run from another thread trains; the guard reports
    that it could not install its handlers."""
    exp = make_experiment({"epochs": 1, "steps_per_epoch": 2, **ckpt_conf(tmp_path)})
    out = {}

    def run():
        with caplog.at_level(logging.WARNING, "zookeeper_tpu_torch.resilience.guard"):
            out["history"] = exp.run()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert len(out["history"]["train"]) == 1
    assert any("could not install" in r.message for r in caplog.records)


@pytest.mark.parametrize("weights", ["auto", "raw"])
def test_eval_and_serving_read_a_run_directory_as_its_export(tmp_path, weights):
    """``load_inference_model``, ``EvalExperiment`` and ``ServingConfig`` on a
    Checkpointer directory give the trees, metrics and logits of the
    export of the same state (EMA or raw)."""
    model = {"model": "BinaryNet", "model.features": (8, 8, 16, 16), "model.dense_units": (32,)}
    exp = make_experiment({**model, "epochs": 1, "steps_per_epoch": 2, "ema_decay": 0.9,
                           **ckpt_conf(tmp_path, **{"checkpointer.save_every_epochs": 1})},
                          train=64, val=32)
    exp.run()
    state = exp.final_state
    export = str(tmp_path / "export")
    save_model(export, *export_trees(
        state.module, state.ema_params if weights == "auto" else None))
    run_dir = str(tmp_path / "ckpt")
    assert finalized_steps(run_dir) == [2]
    got = load_inference_model(run_dir, weights=weights)
    want = load_inference_model(export, weights=weights)
    for a, b in zip(got, want):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert load_inference_model(run_dir, weights=weights, step=2)[0].keys() == got[0].keys()
    with pytest.raises(FileNotFoundError):
        load_inference_model(run_dir, step=7)

    def score(path):
        ev = EvalExperiment()
        configure(ev, {
            "loader.dataset": "SyntheticMnist", "loader.dataset.num_train_examples": 64,
            "loader.dataset.num_validation_examples": 32,
            "loader.preprocessing": "ImageClassificationPreprocessing",
            "loader.preprocessing.height": 28, "loader.preprocessing.width": 28,
            "loader.preprocessing.channels": 1, **model, "checkpoint": path,
            "weights": weights, "batch_size": 16, "verbose": False, "device": "cpu",
        }, name="evaluate")
        return ev.run()

    assert score(run_dir) == score(export)

    def serve(path):
        cfg = ServingConfig()
        configure(cfg, {**model, "model.binary_compute": "xnor_popcount", "checkpoint": path,
                        "weights": weights, "height": 28, "width": 28, "channels": 1,
                        "num_classes": 10, "engine.batch_buckets": (1, 4), "device": "cpu",
                        "verbose": False}, name="serving")
        engine, batcher = cfg.build_service()
        x = np.random.default_rng(0).normal(size=(4, 28, 28, 1)).astype(np.float32)
        try:
            return engine.infer(x)
        finally:
            batcher.close()

    assert torch.equal(serve(run_dir), serve(export))


def test_serving_watch_raises_naming_roadmap():
    """``watch=True`` follows a live ``Checkpointer`` directory: without
    ``checkpoint`` there is none to follow, and the service refuses as
    JAX's does (the watcher itself: ``test_torch_hot_swap.py``)."""
    cfg = ServingConfig()
    configure(cfg, {"model": "Mlp", "model.hidden_units": (4,), "height": 2, "width": 2,
                    "channels": 1, "num_classes": 2, "watch": True, "device": "cpu",
                    "verbose": False}, name="serving")
    with pytest.raises(ValueError, match="watch=True needs checkpoint="):
        cfg.build_service()


def test_start_batch_resumes_the_epoch_and_rejects_out_of_range():
    source = ArraySource({"x": np.arange(10, dtype=np.float32)[:, None],
                          "y": np.arange(10, dtype=np.int32)})
    full = list(batch_iterator(source, None, 3, training=True, seed=4, epoch=1))
    rest = list(batch_iterator(source, None, 3, training=True, seed=4, epoch=1, start_batch=2))
    assert len(full) == 3 and len(rest) == 1
    assert all(np.array_equal(full[2][k], rest[0][k]) for k in full[2])
    for bad in (-1, 3, 4):
        with pytest.raises(ValueError, match=f"start_batch={bad} outside"):
            list(batch_iterator(source, None, 3, training=True, start_batch=bad))


def test_loader_max_batches_counts_from_the_epoch_start():
    loader = DataLoader()
    configure(loader, {"dataset": "SyntheticMnist", "dataset.num_train_examples": 64,
                       "dataset.num_validation_examples": 0,
                       "preprocessing": "ImageClassificationPreprocessing",
                       "preprocessing.height": 28, "preprocessing.width": 28,
                       "preprocessing.channels": 1, "batch_size": 8}, name="loader")
    full = list(loader.batches("train", device="cpu", epoch=0, max_batches=5))
    rest = list(loader.batches("train", device="cpu", epoch=0, start_batch=3, max_batches=5))
    assert len(full) == 5 and len(rest) == 2
    for a, b in zip(full[3:], rest):
        assert torch.equal(a["input"], b["input"]) and torch.equal(a["target"], b["target"])


# -- FaultPlan and PreemptionGuard mechanics ----------------------------------


def test_no_active_plan_by_default():
    assert faults.active() is None


def test_injected_scopes_and_restores():
    outer = FaultPlan(fail_save_io=1)
    with faults.injected(outer) as p:
        assert faults.active() is p is outer
        with faults.injected(FaultPlan(nan_at_step=3)) as inner:
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None


def test_install_clear():
    plan = faults.install(FaultPlan(kill_at_step=1))
    try:
        assert faults.active() is plan
    finally:
        faults.clear()
    assert faults.active() is None


def test_kill_due_is_one_shot_and_threshold():
    plan = FaultPlan(kill_at_step=5)
    assert not plan.kill_due(4)
    assert plan.kill_due(6)
    assert not plan.kill_due(7)
    assert not FaultPlan().kill_due(10**9)


def test_one_shot_and_counted_faults_consume():
    plan = FaultPlan(fail_save_io=2, fail_async_finalize=1, kill_during_async_write=3,
                     corrupt_checkpoint_step=3)
    assert plan.take_save_io_failure() and plan.take_save_io_failure()
    assert not plan.take_save_io_failure()
    assert plan.take_async_finalize_failure() and not plan.take_async_finalize_failure()
    assert not plan.async_kill_due(2) and plan.async_kill_due(3) and not plan.async_kill_due(3)
    assert not plan.corrupt_due(2) and plan.corrupt_due(3) and not plan.corrupt_due(3)


def test_corrupt_checkpoint_dir_tears_files(tmp_path):
    d = tmp_path / "step"
    (d / "sub").mkdir(parents=True)
    (d / "a.bin").write_bytes(b"x" * 100)
    (d / "sub" / "b.bin").write_bytes(b"y" * 10)
    assert corrupt_checkpoint_dir(str(d)) == 2
    assert (d / "a.bin").read_bytes()[:4] == b"\xde\xad\xbe\xef"
    assert len((d / "a.bin").read_bytes()) == 50
    assert corrupt_checkpoint_dir(str(tmp_path / "missing")) == 0


def make_guard(**conf):
    g = PreemptionGuard()
    configure(g, dict(conf), name="guard")
    return g


def test_guard_flags_sigterm_without_dying():
    g = make_guard().install()
    try:
        assert g.installed and not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if g.preempted:
                break
        assert g.preempted and g.received_signal == signal.SIGTERM
    finally:
        g.uninstall()


def test_guard_restores_previous_handlers():
    prev_term, prev_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    g = make_guard().install()
    assert signal.getsignal(signal.SIGTERM) is not prev_term
    g.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev_term
    assert signal.getsignal(signal.SIGINT) is prev_int


def test_guard_reinstall_clears_stale_flag():
    g = make_guard()
    g.request_preemption()
    assert g.preempted
    g.install()
    try:
        assert not g.preempted
    finally:
        g.uninstall()


def test_guard_disabled_hooks_nothing():
    prev = signal.getsignal(signal.SIGTERM)
    g = make_guard(enabled=False).install()
    try:
        assert signal.getsignal(signal.SIGTERM) is prev and not g.installed
        g.request_preemption()
        assert g.preempted
    finally:
        g.uninstall()


def test_guard_sigint_opt_out():
    prev_int = signal.getsignal(signal.SIGINT)
    g = make_guard(handle_sigint=False).install()
    try:
        assert signal.getsignal(signal.SIGINT) is prev_int
        assert signal.getsignal(signal.SIGTERM) is not prev_int
    finally:
        g.uninstall()


def test_guard_install_off_main_thread_is_quiet():
    result = {}

    def run():
        g = make_guard()
        try:
            g.install()
            g.request_preemption()
            result["preempted"] = g.preempted
            result["installed"] = g.installed
            g.uninstall()
        except Exception as e:  # pragma: no cover
            result["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert result.get("error") is None
    assert result.get("preempted") is True and result.get("installed") is False


def test_unreadable_step_is_checkpoint_unreadable(tmp_path):
    (tmp_path / "run" / "5").mkdir(parents=True)
    with pytest.raises(CheckpointUnreadableError):
        load_inference_model(str(tmp_path / "run"))


def test_cli_reaches_checkpointer_and_guard(tmp_path):
    """``checkpointer.*`` and ``guard.*`` configure from the training CLI;
    a second call on the directory resumes."""
    import subprocess
    import sys

    run = tmp_path / "run"
    args = [sys.executable, "-m", "zookeeper_tpu_torch.training", "TrainMnist", "device=cpu",
            "model=Mlp", "model.hidden_units=(8,)", "loader.dataset.num_train_examples=32",
            "loader.dataset.num_validation_examples=0", "batch_size=8", "validate=False",
            f"checkpointer.directory={run}", "checkpointer.save_every_steps=3",
            "checkpointer.mode=async", "guard.handle_sigint=False"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    first = subprocess.run(args + ["epochs=1"], cwd=root, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert finalized_steps(str(run)) == [3, 4]
    second = subprocess.run(args + ["epochs=2"], cwd=root, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from checkpoint at step 4 (epoch 1)" in second.stdout
    assert finalized_steps(str(run)) == [4, 6, 8]
