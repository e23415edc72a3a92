"""The wheel of the repo holds every kernel source the port builds from.

The port compiles its CUDA kernels (``zookeeper_tpu_torch/csrc``) and its
native batch assembly (``zookeeper_tpu_torch/native/src``) at first use,
from the installed package's own files: five ``.cu`` sources include a
``.cuh`` header of the same directory. A wheel that lacks any of them
installs a port that cannot build those kernels. The test copies the
sources into a temporary directory (a build writes ``build/`` and
``*.egg-info`` beside them), builds the wheel offline with the installed
setuptools (``pip wheel --no-deps --no-build-isolation --no-index``) and
finds every file of both directories in it.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = "zookeeper_tpu_torch"
SOURCES = ("csrc", os.path.join("native", "src"))


def _source_files():
    files = []
    for sub in SOURCES:
        for path in sorted((ROOT / PORT / sub).iterdir()):
            if path.is_file():
                files.append(f"{PORT}/{sub.replace(os.sep, '/')}/{path.name}")
    return files


def test_wheel_holds_every_kernel_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "build")
    for package in ("zookeeper_tpu", PORT):
        shutil.copytree(ROOT / package, src / package, ignore=ignore)
    out = tmp_path / "dist"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (wheel,) = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    wanted = _source_files()
    # The headers and the native source are the files a wheel once lacked.
    assert any(n.endswith(".cuh") for n in wanted)
    assert any(n.endswith(".cpp") for n in wanted)
    missing = [n for n in wanted if n not in names]
    assert not missing, f"the wheel lacks {missing}"
