"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points never drop from the card to the CPU."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "zookeeper_tpu")


def _port_sources():
    return sorted((ROOT / "zookeeper_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    bad = [
        name for name in _imported_modules(path)
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import zookeeper_tpu_torch.serving, zookeeper_tpu_torch.models\n"
        "import zookeeper_tpu_torch.ops.packed, zookeeper_tpu_torch.models.convert\n"
        "import zookeeper_tpu_torch.training, zookeeper_tpu_torch.data\n"
        "import zookeeper_tpu_torch.training.imagenet\n"
        "import zookeeper_tpu_torch.serving.decode\n"
        "import zookeeper_tpu_torch.data.store, zookeeper_tpu_torch.training.metrics\n"
        "import zookeeper_tpu_torch.training.profiling, zookeeper_tpu_torch.training.benchmark\n"
        "import zookeeper_tpu_torch.training.digits, zookeeper_tpu_torch.training.cifar\n"
        "import zookeeper_tpu_torch.training.convert_packed, zookeeper_tpu_torch.native\n"
        "import zookeeper_tpu_torch.serving.classifier, zookeeper_tpu_torch.serving.latency\n"
        "import zookeeper_tpu_torch.observability\n"
        "import zookeeper_tpu_torch.loadgen, zookeeper_tpu_torch.serving.guardrails\n"
        "import zookeeper_tpu_torch.serving.fleet, zookeeper_tpu_torch.serving.fleet_worker\n"
        "import zookeeper_tpu_torch.serving.serve_fleet\n"
        "from zookeeper_tpu_torch.observability import device, ledger, peaks, recorder\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from zookeeper_tpu_torch.serving import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        InferenceEngine().bind(torch.nn.Identity(), (4,), device="cuda")


def test_lm_serving_raises_without_a_card(monkeypatch):
    """LMServingConfig runs on the card unless asked for the CPU."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import LMServingConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LMServingConfig()
    configure(cfg, {"model.num_layers": 1, "model.d_model": 16, "model.num_heads": 2,
                    "seq_len": 64, "vocab_size": 17, "verbose": False})
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cfg.run()


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory, the smoke script exits non-zero and prints no
    result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_fleet_worker_asked_for_the_card_fails_without_one(tmp_path, monkeypatch):
    """A fleet worker runs on the card unless its config says "cpu": with
    no card it dies before it is ready, and the spawn raises with its log
    tail. The worker inherits this environment, so hiding every card makes
    the test the same on a host that has one."""
    from zookeeper_tpu_torch.serving.fleet_worker import spawn_fleet_workers

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="died before ready") as err:
        spawn_fleet_workers(str(tmp_path), 1, config={"model.d_model": 16}, timeout_s=120)
    assert "no CUDA card" in str(err.value)
