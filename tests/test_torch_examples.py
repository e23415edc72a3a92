"""The port's example tasks against the JAX package's: ``resolve_deploy_conf``
on the JAX cases, ``ConvertPacked``'s packed leaves against JAX's
``pack_quantconv_params`` on the same weights, ``TrainCifar``'s
configuration and two steps, ``LatencyBench``'s JSON line, and the whole
TrainCifar -> ConvertPacked -> LatencyBench / ServingConfig path at a
small width on the CPU."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zookeeper_tpu import models as jax_models
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.ops.packed import pack_quantconv_params as jax_pack
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import flatten_tree, to_flax_variables
from zookeeper_tpu_torch.serving import ServingConfig
from zookeeper_tpu_torch.serving.latency import LatencyBench
from zookeeper_tpu_torch.training import EvalExperiment
from zookeeper_tpu_torch.training.checkpoint import export_trees, save_model
from zookeeper_tpu_torch.training.cifar import TrainCifar
from zookeeper_tpu_torch.training.convert_packed import ConvertPacked, resolve_deploy_conf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    """An example script under its canonical module name (one registered
    task per process, shared with the JAX package's own tests)."""
    examples = os.path.join(ROOT, "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(name)


def _models(family, conf):
    j, p = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(j, conf, name="m")
    port_configure(p, conf, name="m")
    return j, p


# -- resolve_deploy_conf: the six cases of tests/examples/test_deploy_conf.py --


DEPLOY_CASES = {
    "defaults_pack_everything": ("QuickNet", {}, False, {}),
    "explicit_training_mode_flips_to_packable": ("QuickNet", {"binary_compute": "int8"},
                                                 False, {}),
    "explicit_unpacked_config_survives": (
        "BinaryAlexNet", {"packed_weights": False, "binary_compute": "mxu",
                          "dense_packed_weights": True, "dense_binary_compute": "xnor"},
        False, {}),
    "overrides_win_over_everything": ("QuickNet", {"binary_compute": "int8"}, True,
                                      {"binary_compute": "int8", "fold_bn": False}),
    "override_fold_on": ("QuickNet", {}, False, {"fold_bn": True}),
    "per_section_tuples_left_alone": (
        "QuickNet", {"binary_compute": ("int8", "xnor"), "packed_weights": (False, True),
                     "blocks_per_section": (1, 1), "section_features": (8, 16)}, False, {}),
}


@pytest.mark.parametrize("case", sorted(DEPLOY_CASES))
def test_resolve_deploy_conf_equals_jax(case):
    family, conf, fold, overrides = DEPLOY_CASES[case]
    jm, pm = _models(family, conf)
    want_conf, want_fold = _jax_example("convert_packed").resolve_deploy_conf(
        jm, fold, overrides, True)
    got_conf, got_fold = resolve_deploy_conf(pm, fold, overrides)
    # The one difference: the port's models have no pallas_interpret.
    assert want_conf.pop("pallas_interpret") is True
    assert "pallas_interpret" not in got_conf
    assert got_conf == want_conf and got_fold == want_fold
    if case == "defaults_pack_everything":
        assert got_conf == {"packed_weights": True, "binary_compute": "xnor"} and not got_fold


def test_fold_requires_the_model_mode():
    jm, pm = _models("Mlp", {})
    with pytest.raises(ValueError, match="Mlp has no fold_bn deployment mode"):
        _jax_example("convert_packed").resolve_deploy_conf(jm, True, {}, True)
    with pytest.raises(ValueError, match="Mlp has no fold_bn deployment mode"):
        resolve_deploy_conf(pm, True, {})


# -- ConvertPacked against JAX's pack_quantconv_params -----------------------


SMALL = {"features": (8, 8, 16, 16), "dense_units": (32,)}
SHAPE = (16, 16, 3)


def _float_export(tmp_path, seed=3):
    """A seeded float BinaryNet (BN statistics seeded too) exported; its
    flax trees."""
    _, pm = _models("BinaryNet", SMALL)
    module = pm.build(SHAPE, 10)
    pm.initialize(module, seed=seed)
    rng = np.random.default_rng(seed)
    for name, buf in module.named_buffers():
        if name.endswith("running_var"):
            buf.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, buf.shape), dtype=buf.dtype))
        elif name.endswith("running_mean"):
            buf.copy_(torch.as_tensor(rng.uniform(-0.3, 0.3, buf.shape), dtype=buf.dtype))
    for name, p in module.named_parameters():
        if name.endswith("weight") and p.ndim == 1:  # BN scales: away from 0
            p.data.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, p.shape), dtype=p.dtype))
    export = str(tmp_path / "float")
    save_model(export, *export_trees(module))
    params, state = to_flax_variables(module)
    return export, params, state


def _convert(tmp_path, export, label, **conf):
    cp = ConvertPacked()
    port_configure(cp, {"model": "BinaryNet", **{f"model.{k}": v for k, v in SMALL.items()},
                        "height": SHAPE[0], "width": SHAPE[1], "channels": SHAPE[2],
                        "checkpoint": export, "output": str(tmp_path / label),
                        "device": "cpu", "verbose": False, **conf}, name="convert")
    cp.run()
    return cp, torch.load(os.path.join(str(tmp_path / label), "model.pt"))


def _jax_template(conf):
    jm, _ = _models("BinaryNet", {**SMALL, **conf})
    module = jm.build(SHAPE, 10)
    return jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, *SHAPE)),
                                              training=False))


FOLD_DENSE = {"packed_weights": False, "dense_packed_weights": True,
              "dense_binary_compute": "xnor"}


def test_convert_packed_equals_jax_pack(tmp_path):
    """Without the fold the export's packed leaves (kernel_packed,
    kernel_scale) and every other leaf equal JAX's pack_quantconv_params
    of the same float weights bit for bit; the probe passes at
    verify_atol=0."""
    export, params, state = _float_export(tmp_path)
    cp, saved = _convert(tmp_path, export, "packed")
    assert cp.result["max_abs_diff"] == 0.0
    want = jax_pack(params, kernel_quantizer="ste_sign",
                    template=_jax_template({"binary_compute": "xnor",
                                            "packed_weights": True})["params"])
    want = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    got = {k: v.numpy() for k, v in saved["params"].items()}
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("kernel_packed") for k in got) == 4  # 3 convs + 1 dense
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    for k, v in flatten_tree(state["batch_stats"]).items():
        np.testing.assert_array_equal(saved["model_state"][f"batch_stats/{k}"].numpy(), v)


def test_convert_packed_fold_agrees_with_jax(tmp_path):
    """With the fold (BinaryNet folds its dense stage) the folded leaves
    agree with JAX's within float rounding of the fold, and the probe
    within 1e-5."""
    export, params, state = _float_export(tmp_path)
    cp, saved = _convert(tmp_path, export, "folded", fold_bn=True, verify_atol=1e-5,
                         deploy_overrides=FOLD_DENSE)
    template = _jax_template({**FOLD_DENSE, "fold_bn": True})
    want, want_stats = jax_pack(params, kernel_quantizer="ste_sign",
                                template=template["params"], fold_bn=True,
                                batch_stats=state["batch_stats"], fold_order=params)
    want = {k: np.asarray(v) for k, v in flatten_tree(want).items()}
    got = {k: v.numpy() for k, v in saved["params"].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith(("kernel_scale", "bias")):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=1e-6, err_msg=k)
        else:
            assert got[k].tobytes() == want[k].tobytes(), k
    got_stats = {k.split("/", 1)[1] for k in saved["model_state"]}
    assert got_stats == set(flatten_tree(jax.tree.map(np.asarray, want_stats)))
    assert cp.result["max_abs_diff"] <= 1e-5


def test_convert_packed_refusals(tmp_path):
    """A wrong kernel_quantizer fails the probe before anything is
    written, as the JAX task does; a family without the packed fields and
    BinaryNet's conv fold are refused."""
    export, _, _ = _float_export(tmp_path)
    with pytest.raises(RuntimeError, match="Packed model diverges from float model.*"
                                           "Wrong kernel_quantizer for this family"):
        _convert(tmp_path, export, "wrong", kernel_quantizer="magnitude_aware_sign")
    assert not os.path.exists(tmp_path / "wrong")
    with pytest.raises(ValueError, match="dense stage only|DENSE stage only"):
        _convert(tmp_path, export, "conv_fold", fold_bn=True)
    _, mlp = _models("Mlp", {"hidden_units": (8,)})
    module = mlp.build(SHAPE, 10)
    save_model(str(tmp_path / "mlp"), *export_trees(mlp.initialize(module, seed=0)))
    cp = ConvertPacked()
    port_configure(cp, {"model": "Mlp", "model.hidden_units": (8,), "height": SHAPE[0],
                        "width": SHAPE[1], "channels": SHAPE[2], "device": "cpu",
                        "checkpoint": str(tmp_path / "mlp"), "output": str(tmp_path / "m"),
                        "verbose": False}, name="convert")
    with pytest.raises(ValueError, match="Mlp has no packed_weights field"):
        cp.run()


# -- TrainCifar ----------------------------------------------------------------


def test_train_cifar_resolves_to_the_jax_example():
    jax_task = _jax_example("cifar_experiment").TrainCifar()
    jax_configure(jax_task, {"loader.host_index": 0, "loader.host_count": 1}, name="experiment")
    port_task = TrainCifar()
    port_configure(port_task, {}, name="experiment")
    for path in ("epochs", "batch_size", "loader.batch_size", "model.features",
                 "model.dense_units", "model.binary_compute", "model.compute_dtype",
                 "loader.preprocessing.height", "loader.preprocessing.width",
                 "loader.preprocessing.channels", "loader.preprocessing.augment",
                 "loader.preprocessing.pad_pixels", "loader.dataset.num_train_examples",
                 "loader.dataset.num_classes", "optimizer.schedule.base_lr"):
        want, got = jax_task, port_task
        for name in path.split("."):
            want, got = getattr(want, name), getattr(got, name)
        assert tuple(got) == tuple(want) if isinstance(want, (tuple, list)) else got == want, path
    for path in ("model", "optimizer", "loader.dataset", "loader.preprocessing"):
        want, got = jax_task, port_task
        for name in path.split("."):
            want, got = getattr(want, name), getattr(got, name)
        assert type(got).__name__ == type(want).__name__, path
    assert port_task.device == "cuda"


def test_train_cifar_two_steps_on_the_cpu(tmp_path):
    exp = TrainCifar()
    port_configure(exp, {"model.features": (8, 8), "model.dense_units": (16,),
                         "loader.dataset.num_train_examples": 32,
                         "loader.dataset.num_validation_examples": 16, "batch_size": 16,
                         "epochs": 1, "device": "cpu", "verbose": False, "log_every": 1,
                         "writer.jsonl.path": str(tmp_path / "m.jsonl")}, name="experiment")
    history = exp.run()
    assert exp.final_state.step == 2 and np.isfinite(history["train"][0]["loss"])
    steps = [json.loads(l)["step"] for l in open(tmp_path / "m.jsonl")]
    assert steps == [1, 2, 2]


# -- LatencyBench and the whole path ----------------------------------------------


LATENCY_KEYS = {"model", "batch_size", "ms_per_inference", "p50_ms", "p99_ms", "params_mib",
                "compiles"}


def test_latency_bench_prints_the_jax_keys(capsys):
    conf = {"model": "Mlp", "model.hidden_units": (16,), "height": 8, "width": 8,
            "channels": 1, "num_classes": 4, "chain_length": 4, "rounds": 2, "batch_size": 2}
    jb = _jax_example("latency_bench").LatencyBench()
    jax_configure(jb, conf, name="bench")
    want = jb.run()
    capsys.readouterr()
    pb = LatencyBench()
    port_configure(pb, {**conf, "device": "cpu"}, name="bench")
    got = pb.run()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and set(got) == set(want) == LATENCY_KEYS
    for key in ("model", "batch_size", "params_mib", "compiles"):
        assert got[key] == want[key], key
    assert got["ms_per_inference"] > 0 and got["p99_ms"] >= got["p50_ms"] > 0


def test_cifar_path_on_the_cpu(tmp_path, capsys):
    """TrainCifar -> export -> ConvertPacked ("xnor" at verify_atol=0) ->
    LatencyBench on the export -> ServingConfig on it, whose logits equal
    EvalExperiment's forward of the same export bit for bit."""
    small = {"model.features": (8, 8, 16, 16), "model.dense_units": (32,)}
    export, packed = str(tmp_path / "float"), str(tmp_path / "packed")
    exp = TrainCifar()
    port_configure(exp, {**small, "loader.dataset.num_train_examples": 32,
                         "loader.dataset.num_validation_examples": 16, "batch_size": 16,
                         "epochs": 1, "device": "cpu", "verbose": False,
                         "export_model_to": export}, name="experiment")
    exp.run()
    cp = ConvertPacked()
    port_configure(cp, {"model": "BinaryNet", **small, "height": 32, "width": 32, "channels": 3,
                        "checkpoint": export, "output": packed, "device": "cpu",
                        "verbose": False}, name="convert")
    assert cp.run() == packed and cp.result["max_abs_diff"] == 0.0
    before, after = cp.result["whole_mib"]
    assert after < before / 10
    conf, _ = resolve_deploy_conf(cp.model, False, {})
    twin = {"model": "BinaryNet", **{f"model.{k}": v for k, v in conf.items()}}
    geometry = {"height": 32, "width": 32, "channels": 3, "num_classes": 10}
    lb = LatencyBench()
    port_configure(lb, {**twin, **geometry, "checkpoint": packed, "batch_size": 4,
                        "chain_length": 6, "rounds": 1, "device": "cpu"}, name="bench")
    assert set(lb.run()) == LATENCY_KEYS
    cfg = ServingConfig()
    port_configure(cfg, {**twin, **geometry, "checkpoint": packed, "device": "cpu",
                         "requests": 5, "engine.batch_buckets": (1, 4), "max_request": 4,
                         "verbose": False}, name="serving")
    result = cfg.run()
    assert result["requests"] == 5 and result["weights"] == "auto"
    ev = EvalExperiment()
    port_configure(ev, {**twin, "checkpoint": packed, "device": "cpu", "batch_size": 4,
                        "loader.dataset": "SyntheticCifar10",
                        "loader.preprocessing": "ImageClassificationPreprocessing",
                        "verbose": False}, name="eval")
    module = ev.build_state(torch.device("cpu")).module.eval()
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        want = module(torch.from_numpy(x))
    assert torch.equal(cfg.engine.infer(x), want)


def test_convert_and_latency_on_the_command_line(tmp_path):
    small = ["model=BinaryNet", "model.features=(8,8)", "model.dense_units=(16,)"]
    export, packed = str(tmp_path / "float"), str(tmp_path / "packed")
    run = lambda *args: subprocess.run(  # noqa: E731
        [sys.executable, "-m", *args], check=True, timeout=300, capture_output=True,
        text=True).stdout
    run("zookeeper_tpu_torch.training", "TrainCifar", "device=cpu", *small[1:], "epochs=1",
        "batch_size=16", "loader.dataset.num_train_examples=32",
        "loader.dataset.num_validation_examples=16", f"export_model_to={export}")
    out = run("zookeeper_tpu_torch.training", "ConvertPacked", "device=cpu", *small,
              "height=32", "width=32", "channels=3", f"checkpoint={export}", f"output={packed}")
    assert "verified max |forward diff| = 0.0" in out
    out = run("zookeeper_tpu_torch.serving", "LatencyBench", "device=cpu", *small,
              "model.binary_compute=xnor", "model.packed_weights=True", "height=32", "width=32",
              "num_classes=10", f"checkpoint={packed}", "chain_length=6", "rounds=1")
    assert set(json.loads(out.strip().splitlines()[-1])) == LATENCY_KEYS
