"""The port's native host kernels (``zookeeper_tpu_torch.native``) and
the pipeline's native batch assembly, on the CPU.

- Each entry point equals the JAX package's (``zookeeper_tpu.native``,
  built from its own copy of the source) bit for bit, and ``pack_bits`` /
  ``xnor_gemm`` an independent numpy reference.
- The augmenting assembly equals the port's per-example Python path bit
  for bit over every recipe of JAX's ``tests/native/test_augment.py``
  and a (seed, epoch) grid, as JAX holds its own pair; so does the
  normalizing mode, which assembles through the kernel's copy branch
  (``x / 255`` then the affine; JAX's ``gather_normalize``, ``scale * x
  + shift``, is within 1e-6 relative of it).
- The pipeline takes the native path where JAX's does (engage, mid-epoch
  resume, a memmap store, ``TrainImageNet``'s loader), and the
  per-example path where the library is absent or the store does not
  fit (the same batches either way).
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import shutil

import numpy as np
import pytest

from zookeeper_tpu import native as jax_native
from zookeeper_tpu_torch import native
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.data import (
    ArraySource,
    ImageClassificationPreprocessing,
    batch_iterator,
)
from zookeeper_tpu_torch.data.store import MemmapSource, write_store

needs_native = pytest.mark.skipif(shutil.which("g++") is None,
                                  reason="no g++: the numpy-fallback configuration")


def make_pre(conf, name):
    pre = ImageClassificationPreprocessing()
    configure(pre, conf, name=name)
    return pre


def force_python(pre):
    """Hide the native spec: the per-example path, the reference."""
    object.__setattr__(pre, "native_batch_spec", lambda training: None)
    return pre


def image_source(shape, n=24, rng_seed=0, n_labels=10):
    rng = np.random.default_rng(rng_seed)
    return ArraySource({
        "image": rng.integers(0, 256, size=(n, *shape), dtype=np.uint8),
        "label": rng.integers(0, n_labels, size=(n,)).astype(np.int64),
    })


RECIPES = {
    "cifar_pad_crop": ({"height": 16, "width": 16, "channels": 3, "augment": True,
                        "pad_pixels": 4}, (16, 16, 3)),
    "rrc_square": ({"height": 16, "width": 16, "channels": 3, "augment": True,
                    "random_resized_crop": True}, (24, 24, 3)),
    "rrc_non_square": ({"height": 12, "width": 12, "channels": 3, "augment": True,
                        "random_resized_crop": True}, (24, 17, 3)),
    "rrc_gray_noflip": ({"height": 8, "width": 8, "channels": 1, "augment": True,
                         "random_resized_crop": True, "random_flip": False,
                         "zero_center": False}, (32, 32, 1)),
    "rrc_upscale": ({"height": 16, "width": 16, "channels": 3, "augment": True,
                     "random_resized_crop": True}, (10, 13, 3)),
    "flip_only": ({"height": 8, "width": 8, "channels": 3, "augment": True,
                   "pad_pixels": 0}, (8, 8, 3)),
}


@needs_native
def test_native_builds_into_the_package_build_dir():
    assert native.available()
    path = native._library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert native._load().zk_version() == 2


def test_pack_bits_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 96)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, np.inf, -np.inf]
    got = native.pack_bits(x)
    bits = (x >= 0).astype(np.uint32).reshape(7, 3, 32)
    ref = (bits << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)
    np.testing.assert_array_equal(got, ref.astype(np.int32))
    np.testing.assert_array_equal(got, jax_native.pack_bits(x))
    assert native.pack_bits(np.ones((2, 3, 64), np.float32)).shape == (2, 3, 2)
    with pytest.raises(ValueError, match="multiple of 32"):
        native.pack_bits(np.ones((2, 31), np.float32))


@pytest.mark.parametrize("zero_center", [True, False])
def test_gather_normalize_matches_jax_and_the_normalize_mode_the_python_path(zero_center):
    """``gather_normalize`` equals JAX's bit for bit (``scale * x +
    shift``). The pipeline's "normalize" mode assembles with the
    augmenting kernel's copy branch (``x / 255`` then the affine), so its
    eval batches equal the per-example path's bit for bit."""
    conf = {"height": 4, "width": 4, "channels": 3, "zero_center": zero_center}
    src = image_source((4, 4, 3), n=10)
    spec = make_pre(conf, "n0").native_batch_spec(False)
    assert spec["mode"] == "normalize"
    idx = np.array([3, 0, 9, 3], np.int64)
    got = native.gather_normalize(src.arrays["image"], idx, spec["scale"], spec["shift"])
    np.testing.assert_array_equal(
        got, jax_native.gather_normalize(src.arrays["image"], idx, spec["scale"], spec["shift"]))
    assert got.dtype == np.float32 and got.shape == (4, 4, 4, 3)
    fast = list(batch_iterator(src, make_pre(conf, "n1"), 5, training=False, shuffle=False))
    slow = list(batch_iterator(src, force_python(make_pre(conf, "n2")), 5, training=False,
                               shuffle=False))
    assert len(fast) == len(slow) == 2
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a["input"], b["input"])
        np.testing.assert_array_equal(a["target"], b["target"])
        # JAX's normalizing kernel is within an ulp of them.
        np.testing.assert_allclose(
            a["input"], jax_native.gather_normalize(src.arrays["image"], np.arange(
                len(a["target"])) + (5 if a is fast[1] else 0), spec["scale"], spec["shift"]),
            rtol=1e-6, atol=1e-6)


def test_gather_normalize_numpy_fallback_is_the_kernel(monkeypatch):
    """Without the library ``gather_normalize`` is numpy's same
    arithmetic, bit for bit."""
    src = image_source((4, 4, 3), n=10)
    idx = np.array([1, 7, 7, 2], np.int64)
    with_lib = native.gather_normalize(src.arrays["image"], idx, 2.0 / 255.0, -1.0)
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(
        with_lib, native.gather_normalize(src.arrays["image"], idx, 2.0 / 255.0, -1.0))


def test_xnor_gemm_matches_jax_and_the_float_product():
    rng = np.random.default_rng(2)
    a = rng.choice([-1.0, 1.0], size=(9, 64)).astype(np.float32)
    b = rng.choice([-1.0, 1.0], size=(64, 5)).astype(np.float32)
    ap, bp = native.pack_bits(a), native.pack_bits(np.ascontiguousarray(b.T))
    got = native.xnor_gemm(ap, bp, 64)
    np.testing.assert_array_equal(got, (a @ b).astype(np.int32))
    np.testing.assert_array_equal(got, jax_native.xnor_gemm(ap, bp, 64))
    with pytest.raises(ValueError, match="Packed K"):
        native.xnor_gemm(ap, bp[:, :1], 64)


@needs_native
@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 2)])
def test_native_augment_bit_identical_to_python_and_jax(recipe, seed, epoch):
    """Whole batches across a (seed, epoch) grid: the port's native path
    equals the port's per-example path and JAX's kernel, bit for bit."""
    conf, shape = RECIPES[recipe]
    src = image_source(shape)
    kw = dict(training=True, shuffle=True, seed=seed, epoch=epoch)
    fast = list(batch_iterator(src, make_pre(conf, f"f{recipe}"), 8, **kw))
    slow = list(batch_iterator(src, force_python(make_pre(conf, f"s{recipe}")), 8, **kw))
    assert len(fast) == len(slow) == 3
    order = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(24)
    spec = make_pre(conf, f"j{recipe}").native_batch_spec(True)
    for b, (a, s) in enumerate(zip(fast, slow)):
        np.testing.assert_array_equal(a["input"], s["input"])
        np.testing.assert_array_equal(a["target"], s["target"])
        assert a["input"].dtype == np.float32 and a["target"].dtype == np.int32
        eh, ew, _ = spec["expected_shape"]
        want = jax_native.gather_augment_normalize(
            src.arrays["image"], order[b * 8:(b + 1) * 8], out_height=eh, out_width=ew,
            seed=seed, epoch=epoch, random_resized_crop=spec["random_resized_crop"],
            crop_scale_range=spec["crop_scale_range"],
            log_aspect_range=spec["log_aspect_range"], pad_pixels=spec["pad_pixels"],
            random_flip=spec["random_flip"], post_scale=spec["post_scale"],
            post_shift=spec["post_shift"])
        np.testing.assert_array_equal(a["input"], want)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(native, name)
    monkeypatch.setattr(native, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


@needs_native
def test_native_augment_engages(monkeypatch):
    conf, shape = RECIPES["cifar_pad_crop"]
    calls = _counting(monkeypatch, "gather_augment_normalize")
    out = list(batch_iterator(image_source(shape), make_pre(conf, "e"), 8, training=True))
    assert len(out) == 3 and len(calls) == 3


def test_native_normalize_engages_and_falls_back_without_the_library(monkeypatch):
    """Eval batches of an output-shaped store take the native copy
    branch; without the library the per-example path gives the same
    bytes."""
    conf = {"height": 4, "width": 4, "channels": 3}
    src = image_source((4, 4, 3), n=10)
    calls = _counting(monkeypatch, "gather_augment_normalize")
    with_lib = list(batch_iterator(src, make_pre(conf, "w"), 5, training=False))
    assert len(calls) == (2 if shutil.which("g++") else 0)
    monkeypatch.setattr(native, "_load", lambda: None)
    without = list(batch_iterator(src, make_pre(conf, "wo"), 5, training=False))
    assert len(calls) == (2 if shutil.which("g++") else 0)
    for a, b in zip(with_lib, without):
        np.testing.assert_array_equal(a["input"], b["input"])


@needs_native
def test_native_augment_mid_epoch_resume():
    """A ``start_batch`` resume through the native path is the
    uninterrupted epoch's suffix, bit for bit."""
    conf, shape = RECIPES["rrc_square"]
    src = image_source(shape, n=32)
    kw = dict(training=True, shuffle=True, seed=5, epoch=3)
    full = list(batch_iterator(src, make_pre(conf, "r0"), 8, **kw))
    resumed = list(batch_iterator(src, make_pre(conf, "r1"), 8, start_batch=2, **kw))
    assert len(full) == 4 and len(resumed) == 2
    for a, b in zip(full[2:], resumed):
        np.testing.assert_array_equal(a["input"], b["input"])
        np.testing.assert_array_equal(a["target"], b["target"])


def test_python_fallback_when_library_absent(monkeypatch):
    """Without the library the pipeline keeps the per-example path, and
    the batches are the same."""
    conf, shape = RECIPES["cifar_pad_crop"]
    src = image_source(shape)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.gather_augment_normalize(src.arrays["image"], np.arange(2), out_height=16,
                                        out_width=16, seed=0, epoch=0,
                                        random_resized_crop=False)
    kw = dict(training=True, shuffle=True, seed=1, epoch=0)
    got = list(batch_iterator(src, make_pre(conf, "fb0"), 8, **kw))
    ref = list(batch_iterator(src, force_python(make_pre(conf, "fb1")), 8, **kw))
    assert len(got) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["input"], b["input"])


def _never(monkeypatch):
    monkeypatch.setattr(native, "gather_augment_normalize", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("the fused kernel must not take this store")))


@needs_native
@pytest.mark.parametrize("store", ["float32", "no_channel_axis", "not_output_shaped",
                                   "pad_not_below_side", "not_contiguous"])
def test_fallback_when_store_unsupported(monkeypatch, store):
    """Stores the kernel does not model keep the per-example path: a
    float32 store, an [N, H, W] store, pad-and-crop over a store that is
    not output-shaped or with ``pad_pixels`` >= its side, a strided
    view."""
    _never(monkeypatch)
    rng = np.random.default_rng(3)
    conf, _ = RECIPES["cifar_pad_crop"]
    images = {
        "float32": rng.random((16, 16, 16, 3)).astype(np.float32),
        "no_channel_axis": rng.integers(0, 256, (16, 16, 16), dtype=np.uint8),
        "not_output_shaped": rng.integers(0, 256, (16, 20, 20, 3), dtype=np.uint8),
        "pad_not_below_side": rng.integers(0, 256, (16, 4, 4, 3), dtype=np.uint8),
        "not_contiguous": rng.integers(0, 256, (16, 16, 32, 3), dtype=np.uint8)[:, :, ::2],
    }[store]
    if store == "no_channel_axis":
        conf = dict(conf, channels=1)
    if store == "pad_not_below_side":
        conf = dict(conf, height=4, width=4, pad_pixels=4)
    src = ArraySource({"image": images, "label": np.zeros(16, np.int64)})
    got = list(batch_iterator(src, make_pre(conf, f"u{store}"), 8, training=True))
    assert len(got) == 2


@needs_native
def test_memmap_store_engages_native_and_matches_memory(tmp_path, monkeypatch):
    """A memmap store (``.features``) assembles natively, the same bytes
    as the in-memory source."""
    conf, shape = RECIPES["rrc_square"]
    src = image_source(shape)
    write_store(str(tmp_path / "s"), src.arrays)
    calls = _counting(monkeypatch, "gather_augment_normalize")
    kw = dict(training=True, shuffle=True, seed=2, epoch=1)
    disk = list(batch_iterator(MemmapSource(str(tmp_path / "s")), make_pre(conf, "m0"), 8,
                               **kw))
    mem = list(batch_iterator(src, force_python(make_pre(conf, "m1")), 8, **kw))
    assert len(calls) == 3
    for a, b in zip(disk, mem):
        np.testing.assert_array_equal(a["input"], b["input"])
        np.testing.assert_array_equal(a["target"], b["target"])


@needs_native
def test_train_imagenet_loader_takes_the_native_path(monkeypatch):
    """``TrainImageNet``'s SyntheticImageNet is a uint8 ArraySource under
    the RandomResizedCrop recipe: its train batches are assembled
    natively, equal to the per-example path."""
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    exp = TrainImageNet()
    configure(exp, {"loader.dataset.image_height": 40, "loader.dataset.image_width": 48,
                    "loader.dataset.num_train_examples": 16,
                    "loader.dataset.num_validation_examples": 4,
                    "loader.preprocessing.height": 32, "loader.preprocessing.width": 32,
                    "loader.num_workers": 0, "batch_size": 4, "device": "cpu"},
              name="experiment")
    calls = _counting(monkeypatch, "gather_augment_normalize")
    fast = list(exp.loader.host_batches("train", epoch=1))
    force_python(exp.loader.preprocessing)
    slow = list(exp.loader.host_batches("train", epoch=1))
    assert len(calls) == len(fast) == 4
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a["input"], b["input"])
        np.testing.assert_array_equal(a["target"], b["target"])
