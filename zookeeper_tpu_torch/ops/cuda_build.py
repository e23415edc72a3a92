"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
Libraries land in ``zookeeper_tpu_torch/build/`` under a name that
carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads as built. The build runs at first
use (or all at once through :func:`build_all`, one ``nvcc`` per source
started together) and never at import: the CPU tests import every
module on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Tuple

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers, shared memory and spills;
    # the report is kept beside the library (``build_log``).
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C signature of every exported function: (restype, argtypes).
SIGNATURES = {
    "pack_rows": {
        "zk_pack_rows": (_I, [_P, _I, _P, _LL, _I, _P]),
    },
    "conv_gemm_popcount": {
        "zk_conv_gemm_popcount": (
            _I, [_P, _P, _P, _P] + [_I] * 13 + [_P],
        ),
        "zk_conv_gemm_popcount_smem": (_LL, [_I, _I, _I, _I]),
    },
    "packed_weight_matmul": {
        "zk_packed_weight_matmul": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    },
    "resid_pack": {
        "zk_pack_resid": (_I, [_P, _I, _I, _P, _LL, _LL, _I, _P]),
        "zk_unpack_resid_pm1": (_I, [_P, _P, _I, _LL, _LL, _I, _P]),
        "zk_mask_mul_resid": (_I, [_P, _P, _P, _I, _LL, _LL, _I, _P]),
    },
    "flash_forward": {
        "zk_flash_forward": (_I, [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_F, _I, _I, _P]),
    },
    "flash_backward": {
        "zk_flash_backward_dq": (_I, [_P] * 7 + [_I] * 5 + [_LL] * 9 + [_F, _I, _I, _P]),
        "zk_flash_backward_dkv": (_I, [_P] * 8 + [_I] * 5 + [_LL] * 9 + [_F, _I, _I, _P]),
        "zk_flash_backward_variant": (_I, [_I, _I]),
    },
    "xnor_gemm": {
        "zk_xnor_matmul_packed": (_I, [_P, _P, _P] + [_I] * 5 + [_P]),
        "zk_xnor_matmul_packed_scaled": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    },
    "decode_attention": {
        "zk_paged_decode_attention": (
            _I, [_P, _LL, _LL, _P, _P, _P, _P] + [_I] * 5 + [_F, _I, _P],
        ),
        "zk_pool_paged_decode_attention": (
            _I, [_P, _LL, _LL] + [_P] * 7 + [_I] * 8 + [_F, _I, _P],
        ),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from zookeeper_tpu_torch/csrc at first "
        "use."
    )


def _library_path(name: str) -> str:
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for one source unless its library is built; returns
    (process, temporary output, target). The compiler writes to the
    temporary name, renamed into place when it succeeds, so a cut build
    never leaves a broken library behind."""
    target = _library_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish_build(proc: subprocess.Popen, tmp: str, target: str) -> None:
    output, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n{output}"
        )
    with open(f"{target}.log", "w") as f:
        f.write(output)
    os.replace(tmp, target)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_library_path(name))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, ctypes.CDLL]:
    """Compile every named source in parallel (one ``nvcc`` each, all
    started together), then load them. Raises with the compiler's
    output if any build fails."""
    names = list(names)
    with _lock:
        builds = [_start_build(n) for n in names if n not in _loaded]
        errors = []
        for build in builds:
            if build is None:
                continue
            try:
                _finish_build(*build)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _loaded:
                _loaded[n] = _load(n)
        return {n: _loaded[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def build_log(name: str) -> str:
    """The compiler's report for ``csrc/<name>.cu`` (ptxas's registers,
    shared memory and spills per kernel), built on first use."""
    library(name)
    with open(f"{_library_path(name)}.log") as f:
        return f.read()


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA error {status} at launch (see cudaError_t)."
        )
