"""ctypes bindings for the port's native host kernels (``src/zk_native.cpp``).

The port's own copy of ``zookeeper_tpu/native``: the input pipeline's
fused batch assembly (``gather_normalize``, ``gather_augment_normalize``)
plus ``pack_bits`` and ``xnor_gemm``, host references of the packed
binary arithmetic. The library is built with g++ at first use, never at
import, into ``zookeeper_tpu_torch/build/`` under a name that carries a
hash of the source and the flags, so a stale binary is never loaded.
Without g++ every entry point but ``gather_augment_normalize`` falls back
to numpy; that one has no fallback, because the per-example Python path
is its reference and the pipeline keeps using it (``available()``).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "zk_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

#: ``-ffp-contract=off`` keeps each mul and add of the bilinear taps two
#: rounded operations (a contracted FMA would change the last bit), so
#: the augmenting kernel stays bit-identical to numpy. The flags are part
#: of the library's name.
_BUILD_FLAGS = (
    "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
    "-ffp-contract=off",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256()
    h.update(" ".join(_BUILD_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libzk_native-{h.hexdigest()[:12]}.so")


def _build(lib_path: str) -> bool:
    """g++ into a temporary name unique to this process, renamed into
    place when it succeeds (concurrent builders never share a file)."""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *_BUILD_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32, i32, i64, u8 = (ctypes.POINTER(t) for t in (
        ctypes.c_float, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8))
    lib.zk_pack_bits_f32.argtypes = [f32, i32, ctypes.c_int64, ctypes.c_int64]
    lib.zk_gather_normalize_u8.argtypes = [
        u8, i64, f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ]
    lib.zk_gather_augment_normalize_u8.argtypes = [
        u8, i64, f32,                                        # store, indices, out
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # batch, h, w
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # c, out h, out w
        ctypes.c_int64, ctypes.c_int64,                      # seed, epoch
        ctypes.c_int32,                                      # random_resized_crop
        ctypes.c_double, ctypes.c_double,                    # scale range
        ctypes.c_double, ctypes.c_double,                    # log-aspect range
        ctypes.c_int32, ctypes.c_int32,                      # pad_pixels, random_flip
        ctypes.c_float, ctypes.c_float,                      # post_scale, post_shift
    ]
    lib.zk_xnor_gemm_ref.argtypes = [i32, i32, i32, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int32]
    lib.zk_version.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call (one attempt a process);
    None when g++ or the build fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib_path = _library_path()
        except OSError:
            return None
        for _ in range(2):
            if not os.path.exists(lib_path) and not _build(lib_path):
                return None
            try:
                _lib = _bind(ctypes.CDLL(lib_path))
                return _lib
            except OSError:
                # A corrupt or foreign binary: rebuild once.
                try:
                    os.unlink(lib_path)
                except OSError:
                    return None
        return None


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_bits(x: np.ndarray) -> np.ndarray:
    """Pack the sign bits of the last axis (a multiple of 32 long) into
    int32 words: bit j of word w is ``x[..., 32*w + j] >= 0``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    cols = x.shape[-1]
    if cols % 32 != 0:
        raise ValueError(f"Packed axis must be a multiple of 32, got {cols}.")
    out_shape = (*x.shape[:-1], cols // 32)
    lib = _load()
    if lib is None:
        bits = (x.reshape(rows, cols) >= 0).astype(np.uint32).reshape(rows, cols // 32, 32)
        words = (bits << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)
        return words.astype(np.int32).reshape(out_shape)
    out = np.empty((rows, cols // 32), dtype=np.int32)
    lib.zk_pack_bits_f32(_ptr(x.reshape(rows, cols), ctypes.c_float),
                         _ptr(out, ctypes.c_int32), rows, cols)
    return out.reshape(out_shape)


def gather_normalize(store: np.ndarray, indices: np.ndarray, scale: float,
                     shift: float) -> np.ndarray:
    """Fused batch assembly: ``scale * store[indices] + shift`` in float32
    (``store`` [N, ...] uint8; returns [len(indices), ...] float32)."""
    store = np.ascontiguousarray(store)
    if store.dtype != np.uint8:
        raise ValueError("gather_normalize expects a uint8 store.")
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    example_shape = store.shape[1:]
    example_size = int(np.prod(example_shape))
    batch = len(indices)
    lib = _load()
    if lib is None:
        return store[indices].astype(np.float32) * np.float32(scale) + np.float32(shift)
    out = np.empty((batch, example_size), dtype=np.float32)
    lib.zk_gather_normalize_u8(
        _ptr(store.reshape(store.shape[0], example_size), ctypes.c_uint8),
        _ptr(indices, ctypes.c_int64), _ptr(out, ctypes.c_float),
        batch, example_size, float(scale), float(shift),
    )
    return out.reshape(batch, *example_shape)


def gather_augment_normalize(
    store: np.ndarray,
    indices: np.ndarray,
    *,
    out_height: int,
    out_width: int,
    seed: int,
    epoch: int,
    random_resized_crop: bool,
    crop_scale_range=(0.08, 1.0),
    log_aspect_range=(0.0, 0.0),
    pad_pixels: int = 0,
    random_flip: bool = True,
    post_scale: float = 2.0,
    post_shift: float = -1.0,
) -> np.ndarray:
    """Fused augmenting batch assembly over a ``[N, H, W, C]`` uint8
    store: per example a RandomResizedCrop (bilinear) or a reflect pad
    and crop, a flip and the normalization, bit-identical to
    ``ImageClassificationPreprocessing(augment=True)``'s per-example path
    through the shared ``(seed, index, epoch)`` counter RNG. There is no
    numpy fallback: without the library it raises ``RuntimeError``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library unavailable: use the per-example Python "
            "preprocessing path (bit-identical by contract)."
        )
    store = np.ascontiguousarray(store)
    if store.dtype != np.uint8 or store.ndim != 4:
        raise ValueError(
            "gather_augment_normalize expects a [N, H, W, C] uint8 store, "
            f"got {store.dtype} {store.shape}."
        )
    if not random_resized_crop and store.shape[1:3] != (out_height, out_width):
        raise ValueError(
            "pad+crop recipe requires the store's spatial shape "
            f"{store.shape[1:3]} to equal the output ({out_height}, "
            f"{out_width}); only RandomResizedCrop resizes."
        )
    if not random_resized_crop and pad_pixels >= min(out_height, out_width):
        raise ValueError(
            f"pad_pixels={pad_pixels} >= min image side "
            f"{min(out_height, out_width)} is outside the fused kernel's "
            "reflect range: use the Python preprocessing path."
        )
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    batch = len(indices)
    channels = store.shape[3]
    out = np.empty((batch, out_height, out_width, channels), np.float32)
    lib.zk_gather_augment_normalize_u8(
        _ptr(store, ctypes.c_uint8), _ptr(indices, ctypes.c_int64), _ptr(out, ctypes.c_float),
        batch, store.shape[1], store.shape[2], channels, out_height, out_width,
        int(seed), int(epoch), int(bool(random_resized_crop)),
        float(crop_scale_range[0]), float(crop_scale_range[1]),
        float(log_aspect_range[0]), float(log_aspect_range[1]),
        int(pad_pixels), int(bool(random_flip)), float(post_scale), float(post_shift),
    )
    return out


def xnor_gemm(a_packed: np.ndarray, b_packed: np.ndarray, k_true: int) -> np.ndarray:
    """Host XNOR-popcount GEMM on packed operands: a [M, KP] int32, b
    [N, KP] int32 -> [M, N] int32 ``k_true - 2 * popcount(a ^ b)``."""
    a_packed = np.ascontiguousarray(a_packed, dtype=np.int32)
    b_packed = np.ascontiguousarray(b_packed, dtype=np.int32)
    m, kp = a_packed.shape
    n, kp2 = b_packed.shape
    if kp != kp2:
        raise ValueError(f"Packed K mismatch: {kp} vs {kp2}.")
    lib = _load()
    if lib is None:
        xor = np.bitwise_xor(a_packed[:, None, :].view(np.uint32),
                             b_packed[None, :, :].view(np.uint32))
        mismatches = np.unpackbits(xor.view(np.uint8), axis=-1,
                                   bitorder="little").sum(axis=-1, dtype=np.int32)
        return (k_true - 2 * mismatches).astype(np.int32)
    out = np.empty((m, n), dtype=np.int32)
    lib.zk_xnor_gemm_ref(_ptr(a_packed, ctypes.c_int32), _ptr(b_packed, ctypes.c_int32),
                         _ptr(out, ctypes.c_int32), m, n, kp, int(k_true))
    return out
