"""Dataset components.

The port's own copy of the part of ``zookeeper_tpu/data/dataset.py``
that image-classification training needs: the abstract ``Dataset``
(``train()``/``validation()`` sources and the class-count contract) and
the always-available synthetic image datasets, which generate the same
bytes as the JAX package's for the same seed. The TFDS-, store- and
token-backed datasets are not ported yet (ROADMAP.md).
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
class SyntheticImageNet(SyntheticImageClassification):
    """ImageNet-shaped synthetic data (224x224x3, 1000 classes)."""

    image_height: int = Field(224)
    image_width: int = Field(224)
    image_channels: int = Field(3)
    num_classes: int = Field(1000)
    num_train_examples: int = Field(2048)
    num_validation_examples: int = Field(256)
