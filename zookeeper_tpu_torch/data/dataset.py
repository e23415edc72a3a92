"""Dataset components.

The port's own copy of the part of ``zookeeper_tpu/data/dataset.py``
that needs no download: the abstract ``Dataset`` (``train()``/
``validation()`` sources and the class-count contract), ``ArrayDataset``
over in-memory arrays, the always-available synthetic image datasets
(MNIST-, CIFAR-10- and ImageNet-shaped), the synthetic token corpus
``SyntheticTokens``, the real handwritten digits bundled with
scikit-learn (``SklearnDigits``), the disk-backed ``MemmapDataset`` over
``data.store`` stores and the ``GrainDataset`` adapter. Each gives the
same bytes as the JAX package's for the same seed and files. The TFDS
datasets need a download and are not ported.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.data.source import ArraySource, DataSource
from zookeeper_tpu_torch.data.store import MemmapSource


@component
class Dataset:
    """Abstract dataset: ``train()`` and optionally ``validation()``
    return a :class:`DataSource`. Consumers ask
    :meth:`resolved_num_classes`, which prefers a positive ``num_classes``
    field and otherwise asks :meth:`infer_num_classes`."""

    def train(self) -> DataSource:
        raise NotImplementedError("Dataset subclasses must implement train().")

    def validation(self) -> Optional[DataSource]:
        return None

    def resolved_num_classes(self) -> int:
        nc = getattr(self, "num_classes", None)
        if isinstance(nc, int) and nc > 0:
            return nc
        return int(self.infer_num_classes())

    def infer_num_classes(self) -> int:
        raise ValueError(
            f"{type(self).__name__} cannot infer its class count; set "
            "`num_classes` on the dataset."
        )


@component
class ArrayDataset(Dataset):
    """A dataset over in-memory arrays, given after construction by
    ``with_data`` (or by subclassing); its class count is inferred from
    the integer ``label`` feature."""

    _train_arrays: Optional[Dict[str, np.ndarray]] = None
    _validation_arrays: Optional[Dict[str, np.ndarray]] = None

    def with_data(
        self,
        train: Dict[str, np.ndarray],
        validation: Optional[Dict[str, np.ndarray]] = None,
    ) -> "ArrayDataset":
        self._train_arrays = train
        self._validation_arrays = validation
        return self

    def train(self) -> DataSource:
        if self._train_arrays is None:
            raise ValueError("ArrayDataset has no data; call with_data() first.")
        return ArraySource(self._train_arrays)

    def validation(self) -> Optional[DataSource]:
        if self._validation_arrays is None:
            return None
        return ArraySource(self._validation_arrays)

    def infer_num_classes(self) -> int:
        if self._train_arrays is not None:
            return _labels_to_num_classes(self._train_arrays, "ArrayDataset")
        return super().infer_num_classes()


def _labels_to_num_classes(arrays: Dict[str, np.ndarray], what: str) -> int:
    """max(label) + 1 of the integer ``label`` feature; without one, of the
    only integer feature with one value per example (image-like integer
    arrays never count)."""
    label = arrays.get("label")
    if label is not None and not np.issubdtype(np.asarray(label).dtype, np.integer):
        label = None
    if label is None:
        candidates = [
            v for v in arrays.values()
            if np.issubdtype(np.asarray(v).dtype, np.integer) and np.asarray(v).ndim == 1
        ]
        if len(candidates) == 1:
            label = candidates[0]
    if label is None:
        raise ValueError(
            f"{what} has no scalar integer 'label' feature to infer "
            "num_classes from; set `num_classes` explicitly."
        )
    return int(np.max(label)) + 1


def _synthetic_image_classification(
    num_examples: int,
    image_shape: Tuple[int, int, int],
    num_classes: int,
    seed: int,
) -> Dict[str, np.ndarray]:
    """Deterministic generated image-classification data: class-dependent
    smooth gradients plus seeded noise, as uint8 images and int32
    labels."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    labels = rng.integers(0, num_classes, size=(num_examples,), dtype=np.int32)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=np.float32),
        np.linspace(0, 1, w, dtype=np.float32),
        indexing="ij",
    )
    # Per-class signature pattern: a distinct orientation/frequency per class.
    angles = np.linspace(0.0, np.pi, num_classes, endpoint=False)
    patterns = np.stack(
        [
            np.sin(
                2 * np.pi * (2 + k % 3) * (np.cos(a) * xx + np.sin(a) * yy)
            ).astype(np.float32)
            for k, a in enumerate(angles)
        ]
    )  # [num_classes, h, w]
    base = patterns[labels][..., None]  # [n, h, w, 1]
    noise = rng.normal(0.0, 0.6, size=(num_examples, h, w, c)).astype(np.float32)
    images = np.clip((base + noise) * 0.25 + 0.5, 0.0, 1.0)
    images = (images * 255.0).astype(np.uint8)
    return {"image": images, "label": labels}


@component
class SyntheticImageClassification(Dataset):
    """Always-available synthetic image-classification dataset."""

    num_train_examples: int = Field(1024)
    num_validation_examples: int = Field(256)
    image_height: int = Field(32)
    image_width: int = Field(32)
    image_channels: int = Field(3)
    num_classes: int = Field(10)
    seed: int = Field(0)

    def _arrays(self, n: int, seed: int) -> Dict[str, np.ndarray]:
        return _synthetic_image_classification(
            n,
            (self.image_height, self.image_width, self.image_channels),
            self.num_classes,
            seed,
        )

    def train(self) -> DataSource:
        return ArraySource(self._arrays(self.num_train_examples, self.seed))

    def validation(self) -> DataSource:
        return ArraySource(
            self._arrays(self.num_validation_examples, self.seed + 1)
        )


@component
class SyntheticMnist(SyntheticImageClassification):
    """MNIST-shaped synthetic data (28x28x1, 10 classes)."""

    image_height: int = Field(28)
    image_width: int = Field(28)
    image_channels: int = Field(1)
    num_classes: int = Field(10)


@component
class SyntheticCifar10(SyntheticImageClassification):
    """CIFAR-10-shaped synthetic data (32x32x3, 10 classes)."""

    image_height: int = Field(32)
    image_width: int = Field(32)
    image_channels: int = Field(3)
    num_classes: int = Field(10)


@component
class SyntheticImageNet(SyntheticImageClassification):
    """ImageNet-shaped synthetic data (224x224x3, 1000 classes)."""

    image_height: int = Field(224)
    image_width: int = Field(224)
    image_channels: int = Field(3)
    num_classes: int = Field(1000)
    num_train_examples: int = Field(2048)
    num_validation_examples: int = Field(256)


@component
class SyntheticTokens(Dataset):
    """Synthetic next-token corpus for language-model training: windows
    of ``seq_len`` tokens over one seeded periodic stream (period
    ``pattern_period``), as ``{"tokens", "next"}`` int32 examples, so a
    model can memorize it and its loss falls. Pair with
    ``TokenPreprocessing`` (both inherit ``seq_len`` from the task) and
    ``TransformerLM``."""

    num_train_examples: int = Field(1024)
    num_validation_examples: int = Field(128)
    seq_len: int = Field(64)
    vocab_size: int = Field(256)
    pattern_period: int = Field(17)
    seed: int = Field(0)

    def _windows(self, n: int, seed: int) -> Dict[str, np.ndarray]:
        # The stream is fixed by ``seed``; each split's seed picks its windows.
        base = np.random.default_rng(self.seed).integers(
            0, self.vocab_size, self.pattern_period
        )
        stream = np.tile(base, -(-(4 * self.seq_len) // self.pattern_period) + 1)
        starts = np.random.default_rng(seed).integers(
            0, len(stream) - self.seq_len - 1, n
        )
        idx = starts[:, None] + np.arange(self.seq_len)
        return {
            "tokens": stream[idx].astype(np.int32),
            "next": stream[idx + 1].astype(np.int32),
        }

    def train(self) -> DataSource:
        return ArraySource(self._windows(self.num_train_examples, self.seed + 1))

    def validation(self) -> Optional[DataSource]:
        if self.num_validation_examples <= 0:
            return None
        return ArraySource(self._windows(self.num_validation_examples, self.seed + 2))

    def infer_num_classes(self) -> int:
        return self.vocab_size


@component
class SklearnDigits(Dataset):
    """Real handwritten digits with no download: scikit-learn's bundled
    ``digits`` set (1,797 8x8 grayscale scans of the digits 0-9) as
    uint8 images in [0, 255], split by a seeded permutation into
    validation (the leading ``validation_fraction``) and train. Needs
    scikit-learn, imported at first use."""

    validation_fraction: float = Field(0.2)
    #: Keep only this leading fraction of the train split (validation is
    #: untouched): the few-label regime.
    train_fraction: float = Field(1.0)
    #: Re-label this fraction of the train split to another class,
    #: seeded by ``seed`` (validation is untouched): the noisy-label regime.
    label_noise_fraction: float = Field(0.0)
    num_classes: int = Field(10)
    seed: int = Field(0)

    def _splits(self):
        cache = getattr(self, "_split_cache", None)
        if cache is not None:
            return cache
        try:
            from sklearn.datasets import load_digits
        except ImportError as e:
            raise ImportError(
                "SklearnDigits requires scikit-learn (bundles the data offline)."
            ) from e

        digits = load_digits()
        # Pixel counts in [0, 16] -> uint8 [0, 255], rounded in float32.
        images = np.round(
            digits.images.astype(np.float32) * (255.0 / 16.0)
        ).astype(np.uint8)[..., None]
        labels = digits.target.astype(np.int32)
        order = np.random.default_rng(self.seed).permutation(len(labels))
        images, labels = images[order], labels[order]
        n_val = int(len(labels) * self.validation_fraction)
        if not 0.0 < self.train_fraction <= 1.0:
            raise ValueError(f"train_fraction={self.train_fraction} outside (0, 1].")
        n_train = int(round((len(labels) - n_val) * self.train_fraction))
        if n_train < 1:
            raise ValueError(
                f"train_fraction={self.train_fraction} keeps zero of the "
                f"{len(labels) - n_val} train examples."
            )
        train_labels = labels[n_val : n_val + n_train]
        if not 0.0 <= self.label_noise_fraction <= 1.0:
            raise ValueError(
                f"label_noise_fraction={self.label_noise_fraction} outside [0, 1]."
            )
        if self.label_noise_fraction > 0.0:
            rng = np.random.default_rng(self.seed + 1)
            train_labels = train_labels.copy()
            n_noise = int(round(len(train_labels) * self.label_noise_fraction))
            idx = rng.choice(len(train_labels), size=n_noise, replace=False)
            # Shifted by 1..num_classes-1: every corrupted label is wrong.
            shift = rng.integers(1, self.num_classes, size=n_noise)
            train_labels[idx] = (train_labels[idx] + shift.astype(np.int32)) % self.num_classes
        cache = (
            {"image": images[n_val : n_val + n_train], "label": train_labels},
            {"image": images[:n_val], "label": labels[:n_val]},
        )
        object.__setattr__(self, "_split_cache", cache)
        return cache

    def train(self) -> DataSource:
        return ArraySource(self._splits()[0])

    def validation(self) -> DataSource:
        return ArraySource(self._splits()[1])


@component
class MemmapDataset(Dataset):
    """Disk-backed dataset over ``data.store`` stores: ``directory`` holds
    one store per split (``train/``, ``validation/``), read by memory-
    mapped random access, so the data may exceed host memory. Write the
    stores with ``data.store.MemmapWriter``."""

    directory: str = Field(allow_missing=True)
    train_subdir: str = Field("train")
    validation_subdir: str = Field("validation")
    #: -1 = infer by scanning the label feature once.
    num_classes: int = Field(-1)

    def train(self) -> DataSource:
        return MemmapSource(os.path.join(self.directory, self.train_subdir))

    def validation(self) -> Optional[DataSource]:
        path = os.path.join(self.directory, self.validation_subdir)
        if not os.path.isdir(path):
            return None
        return MemmapSource(path)

    def infer_num_classes(self) -> int:
        return _labels_to_num_classes(self.train().features, "MemmapDataset")


@component
class GrainDataset(Dataset):
    """Any random-access source (``__len__`` + ``__getitem__`` of dict
    examples: a ``grain`` ``MapDataset`` or ``ArrayRecordDataSource``, or
    one of one's own) as a dataset; batching, shuffling and the device
    copy stay with the ``DataLoader``. Sources are live objects, not
    configuration: give them with :meth:`with_sources`. Imports no
    ``grain``."""

    #: Set when known; otherwise inferred from the 'label' of the first
    #: ``infer_scan_limit`` examples.
    num_classes: int = Field(-1)
    infer_scan_limit: int = Field(1024)

    _train_source: Optional[DataSource] = None
    _validation_source: Optional[DataSource] = None

    def with_sources(self, train, validation=None) -> "GrainDataset":
        for name, src in (("train", train), ("validation", validation)):
            if src is None:
                continue
            if not (hasattr(src, "__len__") and hasattr(src, "__getitem__")):
                raise TypeError(
                    f"GrainDataset {name} source {type(src).__name__} does not "
                    "implement the random-access protocol (__len__/__getitem__)."
                )
        self._train_source = train
        self._validation_source = validation
        return self

    def train(self) -> DataSource:
        if self._train_source is None:
            raise ValueError("GrainDataset has no sources; call with_sources() first.")
        return self._train_source

    def validation(self) -> Optional[DataSource]:
        return self._validation_source

    def infer_num_classes(self) -> int:
        if self._train_source is None:
            return super().infer_num_classes()
        n = min(len(self._train_source), self.infer_scan_limit)
        labels = []
        for i in range(n):
            ex = self._train_source[i]
            if "label" not in ex:
                return super().infer_num_classes()
            labels.append(ex["label"])
        if not labels:
            return super().infer_num_classes()
        if n < len(self._train_source):
            warnings.warn(
                f"GrainDataset inferred num_classes from the first {n} of "
                f"{len(self._train_source)} examples; set num_classes "
                "explicitly if higher labels exist beyond the scan limit.",
                stacklevel=2,
            )
        return _labels_to_num_classes({"label": np.asarray(labels)}, "GrainDataset")
