"""Indexable example sources.

The port's own copy of ``zookeeper_tpu/data/source.py``: a ``DataSource``
is a random-access sequence of *examples*, each a flat ``dict[str,
np.ndarray]`` of features. Random access makes the deterministic global
shuffle, contiguous sharding and exact resume of the pipeline simple.
The combinators (``map``, ``slice``, ``shard``, ``ConcatSource``) stay
lazy: nothing is read until an example is asked for. Pure numpy.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

Example = Dict[str, np.ndarray]


class DataSource:
    """Abstract random-access source of examples: subclasses implement
    ``__len__`` and ``__getitem__``."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Example:
        raise NotImplementedError

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def map(self, fn: Callable[[Example], Example]) -> "MappedSource":
        return MappedSource(self, fn)

    def slice(self, start: int, stop: int) -> "SliceSource":
        return SliceSource(self, start, stop)

    def shard(self, shard_index: int, shard_count: int) -> "SliceSource":
        """The contiguous ``shard_index``-th of ``shard_count`` shards."""
        n = len(self)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} not in [0, {shard_count}).")
        start = (n * shard_index) // shard_count
        stop = (n * (shard_index + 1)) // shard_count
        return SliceSource(self, start, stop)


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



class MappedSource(DataSource):
    """Applies ``fn`` to each example on access."""

    def __init__(self, parent: DataSource, fn: Callable[[Example], Example]):
        self.parent = parent
        self.fn = fn

    def __len__(self) -> int:
        return len(self.parent)

    def __getitem__(self, index: int) -> Example:
        return self.fn(self.parent[index])


class SliceSource(DataSource):
    """A contiguous sub-range of a parent source (bounds clipped to it)."""

    def __init__(self, parent: DataSource, start: int, stop: int):
        n = len(parent)
        start = max(0, min(start, n))
        stop = max(start, min(stop, n))
        self.parent = parent
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, index: int) -> Example:
        n = len(self)
        if not -n <= index < n:
            raise IndexError(index)
        if index < 0:
            index += n
        return self.parent[self.start + index]


class ConcatSource(DataSource):
    """Several sources read as one, in order."""

    def __init__(self, sources: Sequence[DataSource]):
        if not sources:
            raise ValueError("ConcatSource requires at least one source.")
        self.sources = list(sources)
        self._offsets = np.cumsum([0] + [len(s) for s in self.sources])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int) -> Example:
        n = len(self)
        if not -n <= index < n:
            raise IndexError(index)
        if index < 0:
            index += n
        src = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.sources[src][index - int(self._offsets[src])]
