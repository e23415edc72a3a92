"""Batching and device prefetch.

The port's own copy of ``zookeeper_tpu/data/pipeline.py``:

- :func:`batch_iterator`: the deterministic per-epoch global shuffle
  (the same permutation as the JAX package for the same seed and epoch),
  per-example preprocessing (optionally on a thread pool) and stacking
  into numpy batches;
- :func:`prefetch_to_device`: a background thread that moves each batch
  to the device through pinned host memory with a non-blocking copy on a
  side stream, one batch in flight while the card runs the step;
- :class:`DataLoader`: the component tying a ``Dataset``, a
  ``Preprocessing`` and the batch settings together.

The JAX package's fused native batch assembly, multi-host slicing and
the multi-step slabs are not ported (ROADMAP.md); the per-example path
here is the one the native kernel is held bit-identical to.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from zookeeper_tpu_torch.core import ComponentField, Field, component
from zookeeper_tpu_torch.data.dataset import Dataset
from zookeeper_tpu_torch.data.preprocessing import Preprocessing
from zookeeper_tpu_torch.data.source import DataSource

Batch = Dict[str, np.ndarray]


def batch_iterator(
    source: DataSource,
    preprocessing: Optional[Preprocessing],
    batch_size: int,
    *,
    training: bool,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
    num_workers: int = 0,
    start_batch: int = 0,
) -> Iterator[Batch]:
    """Yield batches of stacked numpy arrays from ``source``, in the
    (seed, epoch)-fixed permutation.

    ``start_batch`` skips the first k batches of the epoch without
    fetching them: the permutation is fixed by (seed, epoch), so batch k
    onward is the uninterrupted epoch's, the mid-epoch resume of a step
    checkpoint (``step % steps_per_epoch == k``)."""
    n = len(source)
    num_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    if training and n > 0 and num_batches == 0:
        raise ValueError(
            f"Train split has {n} examples but the batch is {batch_size} "
            "with drop_remainder: every epoch would yield zero batches."
        )
    if start_batch < 0 or (start_batch > 0 and start_batch >= num_batches):
        # A resume point past the epoch's end would yield an empty epoch
        # forever; an epoch-boundary resume starts the next epoch at 0.
        raise ValueError(
            f"start_batch={start_batch} outside [0, {num_batches}) "
            f"(the epoch has {num_batches} batches)"
        )
    if n == 0:
        return
    if shuffle:
        order = np.random.default_rng(
            np.random.SeedSequence([seed, epoch])
        ).permutation(n)
    else:
        order = np.arange(n)

    def fetch(global_index: int) -> Dict[str, np.ndarray]:
        idx = int(order[global_index])
        example = dict(source[idx])
        example.setdefault("_index", np.int64(idx))
        example.setdefault("_epoch", np.int64(epoch))
        example.setdefault("_seed", np.int64(seed))
        if preprocessing is not None:
            example = preprocessing(example, training)
        return example

    pool = (
        ThreadPoolExecutor(num_workers, thread_name_prefix="zk-data-worker")
        if num_workers > 0
        else None
    )
    try:
        for b in range(start_batch, num_batches):
            indices = range(b * batch_size, min((b + 1) * batch_size, n))
            if pool is not None:
                examples = list(pool.map(fetch, indices))
            else:
                examples = [fetch(i) for i in indices]
            if not examples:
                continue
            keys = examples[0].keys()
            yield {k: np.stack([e[k] for e in examples]) for k in keys}
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


_END = object()


def _stage(batch: Batch, device: torch.device, stream) -> Any:
    """One numpy batch as tensors on ``device``. For a CUDA device the
    host arrays are copied into pinned memory and sent with a
    non-blocking copy on ``stream``; returns ``(tensors, event)`` with
    the event recorded after the copies."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}, None
    with torch.cuda.stream(stream):
        out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def prefetch_to_device(
    iterator: Iterator[Batch], device: Any
) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage host batches on ``device`` from a background thread, one
    batch in flight (queued or being copied) while the caller runs on the
    one it holds. The caller's stream waits on each batch's copy before
    it is handed over, so no host synchronisation is paid."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue[Any]" = queue.Queue(maxsize=1)
    stop = threading.Event()
    err: list = []

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put_or_stop(_stage(batch, device, stream)):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put_or_stop(_END)

    thread = threading.Thread(target=producer, name="zk-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in batch.values():
                    # The copy stream allocated these; tell the allocator
                    # the caller's stream uses them now.
                    t.record_stream(current)
            yield batch
    finally:
        stop.set()
        thread.join()


@component
class DataLoader:
    """Dataset + preprocessing + batching policy. ``batch_size`` is
    inherited from the experiment by scoped field inheritance."""

    dataset: Dataset = ComponentField()
    preprocessing: Preprocessing = ComponentField()
    #: No default: inherits the experiment's ``batch_size``.
    batch_size: int = Field()
    shuffle: bool = Field(True)
    seed: int = Field(0)
    drop_remainder: bool = Field(True)
    num_workers: int = Field(0)

    def _source(self, split: str) -> Optional[DataSource]:
        """The split's source, built once for the loader's lifetime."""
        cache = getattr(self, "_source_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_source_cache", cache)
        if split not in cache:
            cache[split] = (
                self.dataset.train() if split == "train" else self.dataset.validation()
            )
        return cache[split]

    def host_batches(
        self,
        split: str = "train",
        *,
        epoch: int = 0,
        training: Optional[bool] = None,
        start_batch: int = 0,
    ) -> Iterator[Batch]:
        """The split's numpy batches from batch ``start_batch`` of the
        epoch on. ``training=None`` infers train-mode behaviour (shuffle,
        augment, drop-remainder) from the split."""
        if training is None:
            training = split == "train"
        source = self._source(split)
        if source is None:
            raise ValueError(f"Dataset has no '{split}' split.")
        return batch_iterator(
            source,
            self.preprocessing,
            self.batch_size,
            training=training,
            shuffle=self.shuffle and training,
            seed=self.seed,
            epoch=epoch,
            drop_remainder=self.drop_remainder or training,
            num_workers=self.num_workers,
            start_batch=start_batch,
        )

    def batches(
        self,
        split: str = "train",
        *,
        device: Any = "cuda",
        epoch: int = 0,
        training: Optional[bool] = None,
        start_batch: int = 0,
        max_batches: Optional[int] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The split's batches as tensors on ``device`` through
        :func:`prefetch_to_device`, from batch ``start_batch`` of the
        epoch (:func:`batch_iterator`) up to, not including, batch
        ``max_batches``: the cap counts from the epoch's start, as the
        training loop's ``steps_per_epoch`` cutoff does, so a resumed
        epoch ends where the uninterrupted one does."""
        it = self.host_batches(split, epoch=epoch, training=training, start_batch=start_batch)
        if max_batches is not None:
            it = itertools.islice(it, max(0, max_batches - start_batch))
        return prefetch_to_device(it, device)

    def steps_per_epoch(self, split: str = "train") -> int:
        source = self._source(split)
        if source is None:
            raise ValueError(f"Dataset has no '{split}' split.")
        return len(source) // self.batch_size
