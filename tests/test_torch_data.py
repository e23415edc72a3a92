"""The port's input pipeline against the JAX package's: the same seed and
epoch give the same bytes, from the synthetic datasets through the
augmentation to the shuffled batches.

The JAX side's batches come from its per-example path (its source
wrapped so that the fused native batch assembly does not engage): that
path is the JAX package's reference, and the port's pipeline is its
copy.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.data import DataLoader as JaxDataLoader
from zookeeper_tpu.data import ImageClassificationPreprocessing as JaxPreprocessing
from zookeeper_tpu.data import SyntheticImageNet as JaxSyntheticImageNet
from zookeeper_tpu.data.augrng import AugRng as JaxAugRng
from zookeeper_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.data import AugRng as PortAugRng
from zookeeper_tpu_torch.data import DataLoader as PortDataLoader
from zookeeper_tpu_torch.data import ImageClassificationPreprocessing as PortPreprocessing
from zookeeper_tpu_torch.data import SyntheticImageNet as PortSyntheticImageNet
from zookeeper_tpu_torch.data import prefetch_to_device

#: SyntheticImageNet (1000 classes) at a small image size and count.
DATASET = {"image_height": 48, "image_width": 40, "num_train_examples": 24,
           "num_validation_examples": 6, "seed": 3}
RRC = {"height": 32, "width": 32, "augment": True, "random_resized_crop": True}
PAD_CROP = {"height": 48, "width": 40, "augment": True, "pad_pixels": 4}


def _both(jax_cls, port_cls, conf, name):
    j, p = jax_cls(), port_cls()
    jax_configure(j, conf, name=name)
    port_configure(p, conf, name=name)
    return j, p


def _assert_same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_synthetic_imagenet_same_bytes():
    j, p = _both(JaxSyntheticImageNet, PortSyntheticImageNet, DATASET, "dataset")
    assert p.resolved_num_classes() == j.resolved_num_classes() == 1000
    for split in ("train", "validation"):
        js, ps = getattr(j, split)(), getattr(p, split)()
        assert len(js) == len(ps)
        for key in ("image", "label"):
            _assert_same_bytes(ps.arrays[key], js.arrays[key])


def test_aug_rng_same_stream():
    j, p = JaxAugRng(7, 123, 2), PortAugRng(7, 123, 2)
    assert [p.next_u64() for _ in range(8)] == [j.next_u64() for _ in range(8)]
    assert p.uniform(0.08, 1.0) == j.uniform(0.08, 1.0) and p.randint(17) == j.randint(17)


@pytest.mark.parametrize("conf", [RRC, PAD_CROP, {"height": 32, "width": 32}],
                         ids=["random_resized_crop", "pad_crop", "center_crop"])
@pytest.mark.parametrize("training", [True, False])
def test_preprocessing_same_bytes(conf, training):
    jd, _ = _both(JaxSyntheticImageNet, PortSyntheticImageNet, DATASET, "dataset")
    source = jd.train()
    jp, pp = _both(JaxPreprocessing, PortPreprocessing, conf, "preprocessing")
    assert pp.input_shape == jp.input_shape
    for i in range(6):
        example = {**source[i], "_seed": np.int64(5), "_index": np.int64(i), "_epoch": np.int64(1)}
        want, got = jp(dict(example), training), pp(dict(example), training)
        _assert_same_bytes(got["input"], want["input"])
        _assert_same_bytes(got["target"], want["target"])


def _loaders(preprocessing, **extra):
    conf = {
        "dataset": "SyntheticImageNet",
        **{f"dataset.{k}": v for k, v in DATASET.items()},
        "preprocessing": "ImageClassificationPreprocessing",
        **{f"preprocessing.{k}": v for k, v in preprocessing.items()},
        "batch_size": 5, "seed": 9, **extra,
    }
    j, p = JaxDataLoader(), PortDataLoader()
    jax_configure(j, {"prefetch": 0, "host_index": 0, "host_count": 1, **conf}, name="loader")
    port_configure(p, conf, name="loader")
    return j, p


def _jax_batches(loader, split, *, epoch):
    """The JAX loader's batches from its per-example path."""
    training = split == "train"
    return jax_batch_iterator(
        loader._source(split).map(lambda example: example),
        loader.preprocessing, loader.batch_size, training=training,
        shuffle=loader.shuffle and training, seed=loader.seed, epoch=epoch,
        drop_remainder=loader.drop_remainder or training,
        num_workers=loader.num_workers,
    )


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same_bytes(g["input"], w["input"])
        _assert_same_bytes(g["target"], w["target"])


@pytest.mark.parametrize("preprocessing", [RRC, PAD_CROP], ids=["rrc", "pad_crop"])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_loader_batches_same_bytes(preprocessing, num_workers):
    j, p = _loaders(preprocessing, num_workers=num_workers)
    assert p.steps_per_epoch() == j.steps_per_epoch() == 4
    for split, epoch in (("train", 0), ("train", 1), ("validation", 0)):
        _assert_same_batches(
            p.host_batches(split, epoch=epoch), _jax_batches(j, split, epoch=epoch)
        )


def test_loader_ragged_validation_batch_same_bytes():
    """Without drop_remainder the validation split ends on a short batch;
    the train split still drops its remainder."""
    j, p = _loaders(RRC, drop_remainder=False)
    got = list(p.host_batches("validation"))
    assert [len(b["target"]) for b in got] == [5, 1]
    _assert_same_batches(got, _jax_batches(j, "validation", epoch=0))
    assert [len(b["target"]) for b in p.host_batches("train")] == [5] * 4


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_device_batches_hold_the_host_bytes(epoch):
    _, p = _loaders(RRC)
    host = list(p.host_batches("train", epoch=epoch))
    dev = list(p.batches("train", device="cpu", epoch=epoch, max_batches=3))
    assert len(dev) == 3
    for h, d in zip(host, dev):
        assert d["input"].dtype == torch.float32 and d["target"].dtype == torch.int32
        np.testing.assert_array_equal(d["input"].numpy(), h["input"])
        np.testing.assert_array_equal(d["target"].numpy(), h["target"])


def test_prefetch_stops_its_thread_and_raises_producer_errors():
    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("source failed")

    it = prefetch_to_device(broken(), "cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
    early = prefetch_to_device(({"x": np.zeros(1)} for _ in range(100)), "cpu")
    next(early)
    early.close()  # joins the producer thread


def test_train_split_smaller_than_a_batch_raises():
    _, p = _loaders(RRC, batch_size=32)
    with pytest.raises(ValueError, match="zero batches"):
        next(p.host_batches("train"))
