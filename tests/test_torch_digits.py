"""Real handwritten digits in the port: ``SklearnDigits`` gives the JAX
package's splits bit for bit and raises its errors, ``TrainDigits``
tracks the JAX experiment's losses from the same start, the fp model
learns the digits (the JAX package's accuracy anchor), and
``ServeDigits`` scores what ``EvalExperiment`` scores on the same
export."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools
import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from zookeeper_tpu import data as jax_data
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu_torch import data as port_data
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import load_flax_train_state
from zookeeper_tpu_torch.serving.classifier import ServeDigits
from zookeeper_tpu_torch.training import EvalExperiment, TrainingExperiment
from zookeeper_tpu_torch.training.digits import TrainDigits

pytest.importorskip("sklearn")

DIGITS = {
    "loader.dataset": "SklearnDigits",
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 8,
    "loader.preprocessing.width": 8,
    "loader.preprocessing.channels": 1,
    "batch_size": 64,
    "verbose": False,
}


def _datasets(conf):
    j, p = jax_data.SklearnDigits(), port_data.SklearnDigits()
    jax_configure(j, conf, name="dataset")
    port_configure(p, conf, name="dataset")
    return j, p


@pytest.mark.parametrize("conf", [
    {},
    {"seed": 3},
    {"seed": 1, "validation_fraction": 0.35},
    {"seed": 2, "train_fraction": 0.1},
    {"seed": 5, "train_fraction": 0.5, "label_noise_fraction": 0.3},
    {"label_noise_fraction": 1.0},
    {"seed": 7, "num_classes": 12, "label_noise_fraction": 0.5},
], ids=["default", "seed3", "val35", "few_labels", "noisy", "all_noisy", "wide_noise"])
def test_splits_equal_jax_bitwise(conf):
    j, p = _datasets(conf)
    for split in ("train", "validation"):
        want, got = getattr(j, split)().arrays, getattr(p, split)().arrays
        assert sorted(got) == sorted(want) == ["image", "label"]
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].tobytes() == want[key].tobytes()
    assert p.resolved_num_classes() == j.resolved_num_classes()
    assert p.train().arrays["image"].dtype == np.uint8
    if conf.get("label_noise_fraction"):
        clean, _ = _datasets({**conf, "label_noise_fraction": 0.0})
        flipped = clean.train().arrays["label"] != p.train().arrays["label"]
        n = len(flipped)
        assert flipped.sum() == int(round(n * conf["label_noise_fraction"]))


@pytest.mark.parametrize("conf, match", [
    ({"train_fraction": 0.0}, r"train_fraction=0.0 outside \(0, 1\]"),
    ({"train_fraction": 1.5}, r"train_fraction=1.5 outside \(0, 1\]"),
    ({"train_fraction": 1e-4}, "keeps zero of the 1438 train examples"),
    ({"label_noise_fraction": 1.5}, r"label_noise_fraction=1.5 outside \[0, 1\]"),
    ({"label_noise_fraction": -0.1}, r"outside \[0, 1\]"),
])
def test_errors_equal_jax(conf, match):
    for ds in _datasets(conf):
        with pytest.raises(ValueError, match=match):
            ds.train()


def _jax_state_numpy(state):
    import optax

    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    tree = functools.partial(jax.tree.map, np.array)
    return {"step": np.array(state.step), "params": tree(state.params),
            "model_state": tree(state.model_state),
            "adam": {"count": np.array(adam.count), "mu": tree(adam.mu), "nu": tree(adam.nu)}}


STEPS = {"epochs": 3, "steps_per_epoch": 1, "validate": False, "seed": 1,
         "optimizer": "Adam", "optimizer.schedule": "ConstantSchedule",
         "optimizer.schedule.base_lr": 1e-3}


def test_train_digits_tracks_the_jax_example(monkeypatch):
    """Three TrainDigits steps (one per epoch) from the JAX experiment's
    initial state, carried across with ``models.convert``, follow the JAX
    example's losses (``examples/digits_experiment.py``: SimpleCnn on
    SklearnDigits at 8x8x1, batch 64) within 1e-3 relative."""
    jax_exp = JaxTrainingExperiment()
    jax_configure(jax_exp, {**DIGITS, **STEPS, "model": "SimpleCnn",
                            "loader.host_index": 0, "loader.host_count": 1},
                  name="experiment")
    start = _jax_state_numpy(jax_exp.build_state())
    want = [e["loss"] for e in jax_exp.run()["train"]]

    port_exp = TrainDigits()
    port_configure(port_exp, {**STEPS, "device": "cpu", "verbose": False}, name="experiment")
    assert port_exp.batch_size == 64 and type(port_exp.model).__name__ == "SimpleCnn"
    assert port_exp.loader.preprocessing.input_shape == (8, 8, 1)
    build = TrainDigits.build_state
    monkeypatch.setattr(TrainDigits, "build_state",
                        lambda self, device: load_flax_train_state(build(self, device), **start))
    got = [e["loss"] for e in port_exp.run()["train"]]
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fp_model_learns_real_digits():
    """SimpleCnn reaches >= 90% validation accuracy on real handwritten
    digits in five epochs (the JAX package's anchor and threshold)."""
    exp = TrainingExperiment()
    port_configure(exp, {**DIGITS, "model": "SimpleCnn", "model.features": (16, 32),
                         "model.dense_units": (64,), "epochs": 5, "device": "cpu"},
                   name="experiment")
    val_acc = exp.run()["validation"][-1]["accuracy"]
    assert val_acc >= 0.90, f"val accuracy {val_acc:.3f} < 0.90"


def test_serve_digits_scores_what_eval_scores(tmp_path):
    """TrainDigits -> export -> ServeDigits: the validation split served
    as variable-size requests through the batcher scores what
    EvalExperiment scores on the same export, and the report carries the
    serving metrics."""
    export = str(tmp_path / "digits")
    exp = TrainDigits()
    port_configure(exp, {"epochs": 1, "device": "cpu", "verbose": False,
                         "export_model_to": export}, name="experiment")
    exp.run()
    serve = ServeDigits()
    port_configure(serve, {"checkpoint": export, "device": "cpu", "verbose": False,
                           "engine.batch_buckets": (1, 8, 32),
                           "writer.jsonl.path": str(tmp_path / "serve.jsonl")}, name="serving")
    result = serve.run()
    ev = EvalExperiment()
    port_configure(ev, {**DIGITS, "model": "SimpleCnn", "checkpoint": export, "device": "cpu"},
                   name="eval")
    scores = ev.run()
    assert result["examples"] == 359
    assert abs(result["accuracy"] - scores["accuracy"]) <= 5e-5
    assert result["requests"] > 12 and result["recompiles_after_warmup"] == 0
    assert result["latency_p99_ms"] >= result["latency_p50_ms"] > 0
    assert 0 < result["bucket_fill_mean"] <= 1
    (line,) = [json.loads(l) for l in open(tmp_path / "serve.jsonl")]
    assert line["step"] == 0 and line["serve/accuracy"] == pytest.approx(scores["accuracy"])
    assert {"serve/qps", "serve/latency_p95_ms", "serve/padding_waste_mean"} <= set(line)


def test_digits_tasks_on_the_command_line(tmp_path):
    """TrainDigits and ServeDigits through the CLIs on the CPU."""
    export = str(tmp_path / "digits")
    subprocess.run([sys.executable, "-m", "zookeeper_tpu_torch.training", "TrainDigits",
                    "device=cpu", "epochs=1", "verbose=False", f"export_model_to={export}"],
                   check=True, timeout=300, capture_output=True, text=True)
    proc = subprocess.run([sys.executable, "-m", "zookeeper_tpu_torch.serving", "ServeDigits",
                           "device=cpu", f"checkpoint={export}", "engine.batch_buckets=(8,64)"],
                          check=True, timeout=300, capture_output=True, text=True)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["model"] == "SimpleCnn" and result["examples"] == 359
    assert result["accuracy"] > 0.5
