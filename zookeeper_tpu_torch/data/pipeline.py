"""Batching and device prefetch.

The port's own copy of ``zookeeper_tpu/data/pipeline.py``:

- :func:`batch_iterator`: the deterministic per-epoch global shuffle
  (the same permutation as the JAX package for the same seed and epoch),
  then either the fused native batch assembly (``native``: one C++ call a
  batch over a uint8 column store, when the preprocessing offers a
  ``native_batch_spec``) or per-example preprocessing (optionally on a
  thread pool) and stacking into numpy batches; the two give the same
  batches, bit for bit;
- :func:`slab_iterator`: ``unroll`` consecutive batches stacked into one
  slab, the fused multi-step loop's input;
- :func:`prefetch_to_device`: a background thread that moves each batch
  or slab to the device through pinned host memory with a non-blocking
  copy on a side stream, ``size`` of them in flight while the card runs
  the step;
- :class:`DataLoader`: the component tying a ``Dataset``, a
  ``Preprocessing`` and the batch settings together.

Under a partitioner each rank builds only its share of every global
batch (``DataLoader.batches(sharding=...)``, a ``parallel.BatchSlice``):
the rows of its data index, as the JAX package's ``host_index``/
``host_count`` slice them, and, for token batches under sequence
parallelism, the sequence columns of its sp index, before the copy to
the card.
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
from zookeeper_tpu_torch.observability.registry import default_registry

Batch = Dict[str, np.ndarray]


def _column_arrays(source: DataSource) -> Optional[Dict[str, np.ndarray]]:
    """Whole-column ndarray views of a source's features, when it has
    them: ``.arrays`` (``ArraySource``) or ``.features``
    (``MemmapSource``'s read-only memmaps). None keeps the per-example
    path."""
    for attr in ("arrays", "features"):
        cols = getattr(source, attr, None)
        if isinstance(cols, dict) and all(isinstance(v, np.ndarray) for v in cols.values()):
            return cols
    return None


def _native_assembly(source: DataSource, preprocessing: Optional[Preprocessing],
                     training: bool, seed: int, epoch: int):
    """``(assemble, labels)`` when the batch can be assembled natively:
    ``assemble(indices)`` gives the float32 inputs of the examples at
    ``indices`` and ``labels`` is the label column; None otherwise. The
    JAX package's conditions: a spec from the preprocessing, a uint8
    C-contiguous image column; "normalize" needs the store already in the
    output shape; "augment" needs either RandomResizedCrop over any [N,
    H, W, C] store of the output's channels, or pad-and-crop over an
    output-shaped store with ``pad_pixels`` below its side (the kernel
    reflects once; numpy's reflect pad repeats for larger pads). Both
    modes run ``gather_augment_normalize``, "normalize" through its copy
    branch (no crop, no flip): ``x / 255`` then the affine, the
    per-example path's arithmetic, so the batches are that path's bit for
    bit (the JAX package's ``gather_normalize`` computes ``scale * x +
    shift``, off in the last bit). It has no numpy fallback: without the
    library the per-example path runs."""
    spec_fn = getattr(preprocessing, "native_batch_spec", None)
    spec = spec_fn(training) if spec_fn is not None else None
    if spec is None:
        return None
    arrays = _column_arrays(source)
    if arrays is None:
        return None
    img, lbl = arrays.get(spec["image_key"]), arrays.get(spec["label_key"])
    if img is None or lbl is None or img.dtype != np.uint8 or not img.flags["C_CONTIGUOUS"]:
        return None
    from zookeeper_tpu_torch import native

    normalize = spec.get("mode", "normalize") == "normalize"
    expected = tuple(spec["expected_shape"])
    if not native.available() or img.ndim != 4:
        return None
    if normalize or not spec["random_resized_crop"]:
        if tuple(img.shape[1:]) != expected or (
                not normalize and spec["pad_pixels"] >= min(expected[:2])):
            return None
    elif img.shape[3] != expected[2]:
        return None
    recipe = ({"random_resized_crop": False, "pad_pixels": 0, "random_flip": False}
              if normalize else
              {k: spec[k] for k in ("random_resized_crop", "crop_scale_range",
                                    "log_aspect_range", "pad_pixels", "random_flip")})

    def assemble(idx):
        return native.gather_augment_normalize(
            img, idx, out_height=expected[0], out_width=expected[1], seed=seed, epoch=epoch,
            post_scale=spec["post_scale"], post_shift=spec["post_shift"], **recipe)

    return assemble, lbl


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
    host_index: int = 0,
    host_count: int = 1,
    seq_index: int = 0,
    seq_count: int = 1,
) -> Iterator[Batch]:
    """Yield batches of stacked numpy arrays from ``source``, in the
    (seed, epoch)-fixed permutation.

    ``batch_size`` is the per-host (per data index) batch size; with
    ``host_count > 1`` each global batch of ``batch_size * host_count``
    examples is split contiguously and this rank builds slice
    ``host_index`` (only those examples are fetched), as in the JAX
    package, and the final partial global batch is always dropped.
    ``seq_count > 1`` then keeps slice ``seq_index`` of axis 1 of every
    array (the sequence columns of token batches, ``tokens`` and ``next``
    alike); the global sequence must divide ``seq_count``.

    ``start_batch`` skips the first k batches of the epoch without
    fetching them: the permutation is fixed by (seed, epoch), so batch k
    onward is the uninterrupted epoch's, the mid-epoch resume of a step
    checkpoint (``step % steps_per_epoch == k``)."""
    if host_count < 1 or not 0 <= host_index < host_count:
        raise ValueError(
            f"host_index={host_index} outside [0, host_count="
            f"{host_count}): every host must own exactly one slice of "
            "the global batch."
        )
    if seq_count < 1 or not 0 <= seq_index < seq_count:
        raise ValueError(f"seq_index={seq_index} outside [0, seq_count={seq_count}).")
    n = len(source)
    global_batch = batch_size * host_count
    if host_count > 1:
        # A batch present on some ranks but not others would leave the
        # rest waiting in the gradient all-reduce.
        drop_remainder = True
    num_batches = n // global_batch if drop_remainder else -(-n // global_batch)
    if training and n > 0 and num_batches == 0:
        if host_count > 1:
            raise ValueError(
                f"Train split has {n} examples but the global batch is "
                f"{global_batch} (batch_size={batch_size} x "
                f"host_count={host_count}) with drop_remainder: every epoch "
                "would yield zero batches."
            )
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

    def rows(b: int) -> range:
        start = b * global_batch + host_index * batch_size
        return range(start, min(start + batch_size, n, (b + 1) * global_batch))

    def columns(batch: Batch) -> Batch:
        if seq_count == 1:
            return batch
        out = {}
        for k, v in batch.items():
            if v.ndim < 2:
                raise ValueError(f"'{k}' has no sequence axis to split over 'sp'.")
            if v.shape[1] % seq_count != 0:
                raise ValueError(
                    f"Sequence length {v.shape[1]} does not divide the 'sp' "
                    f"axis size {seq_count}."
                )
            width = v.shape[1] // seq_count
            out[k] = np.ascontiguousarray(v[:, seq_index * width:(seq_index + 1) * width])
        return out

    assembly = _native_assembly(source, preprocessing, training, seed, epoch)
    if assembly is not None:
        assemble, labels = assembly
        for b in range(start_batch, num_batches):
            r = rows(b)
            idx = order[r.start:r.stop].astype(np.int64)
            if len(idx):
                yield columns({"input": assemble(idx), "target": labels[idx].astype(np.int32)})
        return

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
            indices = rows(b)
            if pool is not None:
                examples = list(pool.map(fetch, indices))
            else:
                examples = [fetch(i) for i in indices]
            if not examples:
                continue
            keys = examples[0].keys()
            yield columns({k: np.stack([e[k] for e in examples]) for k in keys})
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def slab_iterator(
    iterator: Iterator[Batch],
    unroll: int,
    *,
    max_batches: Optional[int] = None,
) -> Iterator[Batch]:
    """Group ``unroll`` consecutive batches into one ``[unroll, batch,
    ...]`` slab, the fused multi-step loop's input
    (``training.step.build_multi_step``).

    Slab ``i`` is batches ``[i * unroll, (i + 1) * unroll)`` of
    ``iterator``, so which example lands in which step never changes: a
    ``start_batch`` resume that is not a multiple of ``unroll`` just
    starts slabbing from that batch. The last slab may be partial.
    Every batch must have the first batch's shapes, across slabs too (a
    partial last batch raises: slabs need ``drop_remainder``).
    ``max_batches`` caps the batches consumed, before stacking, so a cap
    inside a slab truncates it."""
    if unroll < 1:
        raise ValueError(f"unroll={unroll} must be >= 1.")

    def stack(buf):
        return {k: np.stack([b[k] for b in buf]) for k in buf[0]}

    if max_batches is not None and max_batches <= 0:
        return
    buf: list = []
    consumed = 0
    first_sig = None
    for batch in iterator:
        sig = tuple(sorted((k, np.shape(v)) for k, v in batch.items()))
        if first_sig is None:
            first_sig = sig
        elif sig != first_sig:
            raise ValueError(
                "slab_iterator got batches of differing shapes (a "
                "partial final batch?): slabs require drop_remainder "
                "batching."
            )
        buf.append(batch)
        consumed += 1
        if len(buf) == unroll:
            yield stack(buf)
            buf = []
        if max_batches is not None and consumed >= max_batches:
            break
    if buf:
        yield stack(buf)


_END = object()


def _stage(batch: Batch, device: torch.device, stream) -> Any:
    """One numpy batch (or slab) as tensors on ``device``. For a CUDA
    device each host array is copied into pinned memory and sent with one
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


def _hand_over(item, device: torch.device) -> Dict[str, torch.Tensor]:
    """A staged batch for the caller: its stream waits on the copy (no
    host synchronisation) and the allocator learns that stream uses the
    tensors the copy stream allocated."""
    batch, event = item
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in batch.values():
            t.record_stream(current)
    return batch


def _stage_inline(iterator: Iterator[Batch], device: torch.device):
    """``prefetch_to_device(size=0)``: each batch staged on the calling
    thread, on its current stream, when the caller asks for it."""
    for batch in iterator:
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        yield _hand_over(_stage(batch, device, stream), device)


def prefetch_to_device(
    iterator: Iterator[Batch], device: Any, *, size: int = 2, split: Optional[str] = None
) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage host batches (or slabs) on ``device`` from a background
    thread, up to ``size`` staged and waiting while the caller runs on
    the one it holds (``DataLoader.prefetch``). The caller's stream waits
    on each one's copy before it is handed over, so no host
    synchronisation is paid. ``size=0`` stages inline on the calling
    thread, with no thread and nothing in flight.

    The gauge ``zk_prefetch_occupancy{split}`` (default registry) is the
    queue's fill after every put and get: pinned at ``size`` while the
    card is the bottleneck, at 0 when the loop waits on its data (the
    trace's ``data_wait`` spans say the same); 0 again once the loop
    ends."""
    device = torch.device(device)
    if size <= 0:
        yield from _stage_inline(iterator, device)
        return
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    stop = threading.Event()
    err: list = []
    occupancy = default_registry().gauge(
        "zk_prefetch_occupancy",
        help="device-prefetch queue fill (staged batches ready)",
        labels={"split": split} if split else None,
    )

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
                occupancy.set(q.qsize())
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put_or_stop(_END)

    thread = threading.Thread(target=producer, name="zk-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            occupancy.set(q.qsize())
            if item is _END:
                if err:
                    raise err[0]
                return
            yield _hand_over(item, device)
    finally:
        # A dead loop's last fill must not read as a live queue.
        occupancy.set(0)
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
    #: Staged batches (or slabs) in flight on the device ahead of the
    #: step; 0 copies each one on the calling thread when it is asked for.
    prefetch: int = Field(2)

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

    def per_host_batch_size(self, data_count: int = 1) -> int:
        """The rows each of ``data_count`` data indices builds of every
        global batch of ``batch_size``."""
        if self.batch_size % data_count != 0:
            raise ValueError(
                f"Global batch size {self.batch_size} not divisible by "
                f"host count {data_count}."
            )
        return self.batch_size // data_count

    def host_batches(
        self,
        split: str = "train",
        *,
        epoch: int = 0,
        training: Optional[bool] = None,
        start_batch: int = 0,
        sharding: Optional[Any] = None,
    ) -> Iterator[Batch]:
        """The split's numpy batches from batch ``start_batch`` of the
        epoch on: this rank's share of each (``sharding``, a
        ``parallel.BatchSlice``; None = the whole batch).
        ``training=None`` infers train-mode behaviour (shuffle, augment,
        drop-remainder) from the split."""
        if training is None:
            training = split == "train"
        source = self._source(split)
        if source is None:
            raise ValueError(f"Dataset has no '{split}' split.")
        share = {}
        if sharding is not None:
            share = dict(host_index=sharding.data_index, host_count=sharding.data_count,
                         seq_index=sharding.seq_index, seq_count=sharding.seq_count)
        return batch_iterator(
            source,
            self.preprocessing,
            self.per_host_batch_size(share.get("host_count", 1)),
            training=training,
            shuffle=self.shuffle and training,
            seed=self.seed,
            epoch=epoch,
            drop_remainder=self.drop_remainder or training,
            num_workers=self.num_workers,
            start_batch=start_batch,
            **share,
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
        unroll: int = 1,
        sharding: Optional[Any] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The split's batches as tensors on ``device`` through
        :func:`prefetch_to_device` (``prefetch`` deep), from batch
        ``start_batch`` of the epoch (:func:`batch_iterator`) up to, not
        including, batch ``max_batches``: the cap counts from the epoch's
        start, as the training loop's ``steps_per_epoch`` cutoff does, so
        a resumed epoch ends where the uninterrupted one does.
        ``unroll > 1`` yields slabs of ``unroll`` stacked batches
        (:func:`slab_iterator`, the last one truncated at the cap),
        stacked on the host and staged with one copy a tensor.
        ``sharding`` (the partitioner's ``batch_sharding()``) takes this
        rank's share of each batch before the slab is stacked."""
        it = self.host_batches(split, epoch=epoch, training=training, start_batch=start_batch,
                               sharding=sharding)
        cap = None if max_batches is None else max(0, max_batches - start_batch)
        if unroll > 1:
            it = slab_iterator(it, unroll, max_batches=cap)
        elif cap is not None:
            it = itertools.islice(it, cap)
        return prefetch_to_device(it, device, size=self.prefetch, split=split)

    def steps_per_epoch(self, split: str = "train") -> int:
        source = self._source(split)
        if source is None:
            raise ValueError(f"Dataset has no '{split}' split.")
        return len(source) // self.batch_size
