"""Disk-backed streaming example store.

The port's own copy of ``zookeeper_tpu/data/store.py``, with the same
on-disk format, so a store written by either package is read by the
other: one flat binary file per feature (C-order records of a fixed
shape) plus a ``meta.json`` index::

    store_dir/
      meta.json    # {"num_examples": N, "features": {name: {dtype, shape}}}
      image.bin    # N * prod(shape) * itemsize bytes
      label.bin

Readers ``np.memmap`` each feature file, so the page cache decides what
stays resident and a store larger than host memory streams by random
access; writers append chunk by chunk, so the dataset never has to be in
memory at once either. :class:`MemmapSource` and :func:`wrap_source`
speak grain's random-access protocol (``__len__`` + ``__getitem__``)
without importing grain. Pure numpy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from zookeeper_tpu_torch.data.source import DataSource, Example

_META = "meta.json"


class MemmapWriter:
    """Streaming chunked writer of a :class:`MemmapSource` store::

        with MemmapWriter("/data/train") as w:
            for chunk in chunks:        # dict[str, np.ndarray], any length
                w.append(chunk)

    The first chunk fixes each feature's dtype and shape; a later chunk
    that differs raises. ``meta.json`` is written by ``close()`` only, so
    a writer that failed leaves no readable, truncated store.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._files: Dict[str, Any] = {}
        self._specs: Dict[str, Dict[str, Any]] = {}
        self._count = 0
        self._closed = False

    def append(self, chunk: Mapping[str, np.ndarray]) -> None:
        if self._closed:
            raise ValueError("Writer already closed.")
        arrays = {k: np.ascontiguousarray(v) for k, v in chunk.items()}
        ns = {k: len(v) for k, v in arrays.items()}
        if len(set(ns.values())) != 1:
            raise ValueError(f"Chunk features have unequal lengths: {ns}.")
        n = next(iter(ns.values()))
        if not self._specs:
            for k, v in arrays.items():
                self._specs[k] = {"dtype": str(v.dtype), "shape": list(v.shape[1:])}
                self._files[k] = open(os.path.join(self.directory, f"{k}.bin"), "wb")
        if set(arrays) != set(self._specs):
            raise ValueError(
                f"Chunk features {sorted(arrays)} != store features {sorted(self._specs)}."
            )
        for k, v in arrays.items():
            spec = self._specs[k]
            if str(v.dtype) != spec["dtype"] or list(v.shape[1:]) != spec["shape"]:
                raise ValueError(
                    f"Feature {k!r}: chunk is {v.dtype}{list(v.shape[1:])}, "
                    f"store is {spec['dtype']}{spec['shape']}."
                )
            self._files[k].write(v.tobytes())
        self._count += n

    def _close_files(self) -> None:
        self._closed = True
        for f in self._files.values():
            f.close()

    def close(self) -> None:
        if self._closed:
            return
        self._close_files()
        meta = {"num_examples": self._count, "features": self._specs}
        tmp = os.path.join(self.directory, f"{_META}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(self.directory, _META))

    def __enter__(self) -> "MemmapWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            # Release the files but write no meta.json: the store of a
            # failed writer stays unreadable.
            self._close_files()


def write_store(directory: str, arrays: Mapping[str, np.ndarray]) -> None:
    """Write in-memory arrays as a store in one chunk."""
    with MemmapWriter(directory) as w:
        w.append(arrays)


class MemmapSource(DataSource):
    """Random-access source over a closed :class:`MemmapWriter` store.
    Feature files are mapped read-only; a fetch touches its own pages
    only and returns copies, never views that pin the mapping."""

    def __init__(self, directory: str):
        meta_path = os.path.join(directory, _META)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"No store at {directory!r} (missing {_META}; was the writer closed?)."
            )
        with open(meta_path) as f:
            meta = json.load(f)
        self.directory = directory
        self._length = int(meta["num_examples"])
        self._maps: Dict[str, np.memmap] = {}
        for name, spec in meta["features"].items():
            shape = (self._length, *spec["shape"])
            path = os.path.join(directory, f"{name}.bin")
            expected = int(np.prod(shape)) * np.dtype(spec["dtype"]).itemsize
            actual = os.path.getsize(path)
            if actual != expected:
                raise ValueError(
                    f"Store {directory!r} feature {name!r}: file is {actual} bytes, "
                    f"meta implies {expected}."
                )
            self._maps[name] = np.memmap(path, dtype=spec["dtype"], mode="r", shape=shape)

    def __len__(self) -> int:
        return self._length

    @property
    def features(self) -> Dict[str, np.memmap]:
        """The read-only memmap of each feature (whole-column reads, such
        as a label scan)."""
        return dict(self._maps)

    def __getitem__(self, index: int) -> Example:
        if not -self._length <= index < self._length:
            raise IndexError(index)
        return {k: np.asarray(m[index]) for k, m in self._maps.items()}


class WrappedSource(DataSource):
    """Any random-access object (``__len__`` + ``__getitem__``, grain's
    ``RandomAccessDataSource`` protocol) as a :class:`DataSource`.
    ``transform`` turns a wrapped value into an example; by default a
    mapping's values pass through and any other value lands under
    ``feature_name``."""

    def __init__(
        self,
        wrapped: Any,
        transform: Optional[Callable[[Any], Example]] = None,
        feature_name: str = "value",
    ):
        self.wrapped = wrapped
        self.transform = transform
        self.feature_name = feature_name

    def __len__(self) -> int:
        return len(self.wrapped)

    def __getitem__(self, index: int) -> Example:
        value = self.wrapped[index]
        if self.transform is not None:
            return self.transform(value)
        if isinstance(value, Mapping):
            return {k: np.asarray(v) for k, v in value.items()}
        return {self.feature_name: np.asarray(value)}


def wrap_source(
    obj: Any,
    transform: Optional[Callable[[Any], Example]] = None,
    feature_name: str = "value",
) -> DataSource:
    """``obj`` as a :class:`DataSource` (itself when it already is one)."""
    if isinstance(obj, DataSource):
        return obj
    return WrappedSource(obj, transform, feature_name)
