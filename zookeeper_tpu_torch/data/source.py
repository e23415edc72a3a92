"""Indexable example sources.

The port's own copy of ``zookeeper_tpu/data/source.py``: a ``DataSource``
is a random-access sequence of *examples*, each a flat ``dict[str,
np.ndarray]`` of features. Random access makes the deterministic global
shuffle and exact resume of the pipeline simple. Pure numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Example = Dict[str, np.ndarray]


class DataSource:
    """Abstract random-access source of examples: subclasses implement
    ``__len__`` and ``__getitem__``."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Example:
        raise NotImplementedError


class ArraySource(DataSource):
    """A source backed by a dict of equal-length numpy arrays, axis 0
    indexing examples."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        if not arrays:
            raise ValueError("ArraySource requires at least one feature array.")
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Feature arrays have unequal lengths: {lengths}.")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._length = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, index: int) -> Example:
        if not -self._length <= index < self._length:
            raise IndexError(index)
        return {k: v[index] for k, v in self.arrays.items()}

