"""Dataset components.

The port's own copy of the part of ``zookeeper_tpu/data/dataset.py``
that training needs: the abstract ``Dataset`` (``train()``/
``validation()`` sources and the class-count contract), ``ArrayDataset``
over in-memory arrays, the always-available synthetic image datasets
(MNIST-, CIFAR-10- and ImageNet-shaped) and the synthetic token corpus
``SyntheticTokens``, each of which generates the same bytes as the JAX
package's for the same seed. The TFDS-, store- and grain-backed datasets
and ``SklearnDigits`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.data.source import ArraySource, DataSource


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
