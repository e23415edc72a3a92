"""The port's slabs and prefetch depth on the CPU: ``slab_iterator``
against the JAX package's on the same numpy batches (the same slabs, the
same errors), ``DataLoader.batches(unroll=...)`` against JAX's loader,
and ``DataLoader.prefetch`` 0, 1 and 2 giving the same batches in the
same order."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import numpy as np
import pytest
import torch

import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.data import DataLoader as JaxDataLoader
from zookeeper_tpu.data.pipeline import slab_iterator as jax_slab_iterator
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.data import DataLoader, prefetch_to_device, slab_iterator


def numpy_batches(n, batch=3, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    return [{"input": rng.normal(size=(batch, 2, 2)).astype(np.float32),
             "target": rng.integers(0, 5, batch).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("n,unroll,max_batches", [
    (8, 1, None), (8, 3, None), (8, 4, None), (7, 4, None), (2, 5, None),
    (8, 4, 5), (8, 3, 3), (8, 2, 0), (0, 3, None),
])
def test_slab_iterator_matches_jax(n, unroll, max_batches):
    batches = numpy_batches(n)
    got = list(slab_iterator(iter(batches), unroll, max_batches=max_batches))
    want = list(jax_slab_iterator(iter(batches), unroll, max_batches=max_batches))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    if got:
        # Slab i is batches [i * unroll, (i + 1) * unroll).
        np.testing.assert_array_equal(got[0]["input"][0], batches[0]["input"])
        assert sum(s["input"].shape[0] for s in got) == min(n, max_batches or n)


def test_slab_iterator_rejects_what_jax_rejects():
    for fn in (slab_iterator, jax_slab_iterator):
        with pytest.raises(ValueError, match="unroll"):
            list(fn(iter(numpy_batches(2)), 0))
        ragged = numpy_batches(3) + numpy_batches(1, batch=2)
        with pytest.raises(ValueError, match="differing shapes"):
            list(fn(iter(ragged), 2))  # the odd batch alone in the last slab
        with pytest.raises(ValueError, match="differing shapes"):
            list(fn(iter(numpy_batches(1) + numpy_batches(1, batch=2)), 4))


LOADER = {"dataset": "SyntheticMnist", "dataset.num_train_examples": 80,
          "dataset.num_validation_examples": 16,
          "preprocessing": "ImageClassificationPreprocessing", "preprocessing.height": 28,
          "preprocessing.width": 28, "preprocessing.channels": 1, "batch_size": 8,
          "seed": 3}


def port_loader(**conf):
    loader = DataLoader()
    configure(loader, {**LOADER, **conf}, name="loader")
    return loader


@pytest.mark.parametrize("start_batch,unroll,max_batches", [
    (0, 4, 10), (3, 4, 10), (5, 3, 7), (0, 2, None),
])
def test_loader_slabs_match_jax(start_batch, unroll, max_batches):
    """``batches(unroll=...)`` against JAX's loader: the same slabs from
    a mid-slab ``start_batch`` up to the cap (the port counts
    ``max_batches`` from the epoch's start, JAX from ``start_batch``).
    JAX's loader runs its per-example path, whose bytes the port's
    assembly gives in both of its paths (JAX's native normalizing kernel
    is off in the last bit)."""
    jax_loader = JaxDataLoader()
    jax_configure(jax_loader, {**LOADER, "host_index": 0, "host_count": 1}, name="loader")
    object.__setattr__(jax_loader.preprocessing, "native_batch_spec", lambda training: None)
    want = list(jax_loader.batches(
        "train", epoch=1, start_batch=start_batch, unroll=unroll,
        max_batches=None if max_batches is None else max_batches - start_batch))
    got = list(port_loader().batches("train", device="cpu", epoch=1, start_batch=start_batch,
                                     unroll=unroll, max_batches=max_batches))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("unroll", [1, 3])
def test_prefetch_depths_give_the_same_batches(unroll):
    """``prefetch`` 0 (inline), 1 and 2: the same batches or slabs, in
    the same order."""
    runs = [list(port_loader(prefetch=depth).batches("train", device="cpu", epoch=2,
                                                     unroll=unroll, max_batches=9))
            for depth in (0, 1, 2)]
    assert len(runs[0]) == (9 if unroll == 1 else 3)
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            for k in a:
                assert torch.equal(a[k], b[k])


def test_prefetch_default_depth_is_two():
    assert port_loader().prefetch == 2


@pytest.mark.parametrize("size", [0, 1, 2])
def test_prefetch_propagates_errors_and_stops_early(size):
    def broken():
        yield {"x": np.zeros(2)}
        raise RuntimeError("source died")

    it = prefetch_to_device(broken(), "cpu", size=size)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="source died"):
        next(it)
    early = prefetch_to_device(({"x": np.zeros(1)} for _ in range(100)), "cpu", size=size)
    next(early)
    early.close()
