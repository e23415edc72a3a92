"""The port's sources, disk-backed store and grain adapter against the
JAX package's: the same chunks give the same files and the same
examples, a store written by either package is read by the other bit for
bit, both raise the same errors, and ``MemmapDataset``'s batches equal
the JAX loader's."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import os

import numpy as np
import pytest

from zookeeper_tpu import data as jax_data
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from zookeeper_tpu_torch import data as port_data
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.training import TrainingExperiment

PACKAGES = {"jax": jax_data, "port": port_data}


def _write_split(pkg, directory, n, *, h=8, w=8, c=1, num_classes=5, chunk=64, seed=0):
    """Stream a seeded split to disk chunk by chunk."""
    rng = np.random.default_rng(seed)
    with pkg.MemmapWriter(directory) as writer:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            writer.append({
                "image": rng.integers(0, 255, (m, h, w, c), dtype=np.uint8),
                "label": rng.integers(0, num_classes, (m,), dtype=np.int32),
            })
            done += m


def _store_files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def _same_example(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert type(a[k]) is type(b[k]) is np.ndarray
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# -- sources (tests/data/test_source.py) --------------------------------------


def _make_source(pkg, n=10, offset=0):
    return pkg.ArraySource({
        "x": np.arange(offset, offset + n, dtype=np.float32),
        "y": np.arange(offset, offset + n, dtype=np.int32) * 2,
    })


def _both(fn):
    """``fn(pkg)`` on both packages; their results, port first."""
    return fn(port_data), fn(jax_data)


def test_array_source_basics():
    for pkg in PACKAGES.values():
        s = _make_source(pkg)
        assert len(s) == 10
        ex = s[3]
        assert ex["x"] == 3.0 and ex["y"] == 6
        assert s[-1]["x"] == 9.0
        with pytest.raises(IndexError):
            s[10]


def test_array_source_unequal_lengths():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="unequal lengths"):
            pkg.ArraySource({"a": np.zeros(3), "b": np.zeros(4)})


def test_map_and_iter():
    got, want = _both(lambda pkg: [
        e["x"] for e in _make_source(pkg, 5).map(lambda e: {"x": e["x"] + 1, "y": e["y"]})])
    assert got == want == [1, 2, 3, 4, 5]


def test_slice_and_negative_index():
    for pkg in PACKAGES.values():
        s = _make_source(pkg).slice(2, 6)
        assert isinstance(s, pkg.SliceSource if pkg is port_data else jax_data.source.SliceSource)
        assert len(s) == 4 and s[0]["x"] == 2.0 and s[-1]["x"] == 5.0
        with pytest.raises(IndexError):
            s[4]
    got, want = _both(lambda pkg: [e["x"] for e in _make_source(pkg).slice(-3, 40)])
    assert got == want


def test_shard_partitions_exactly():
    for n, count in ((10, 3), (7, 4), (3, 5)):
        got, want = _both(lambda pkg: [[float(e["x"]) for e in _make_source(pkg, n).shard(i, count)]
                                       for i in range(count)])
        assert got == want
        assert sorted(x for shard in got for x in shard) == list(range(n))
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="shard_index"):
            _make_source(pkg).shard(3, 3)


def test_concat_source():
    for pkg in PACKAGES.values():
        c = pkg.ConcatSource([_make_source(pkg, 3, 0), _make_source(pkg, 4, 100)])
        assert len(c) == 7
        assert [c[i]["x"] for i in (0, 2, 3, -1)] == [0.0, 2.0, 100.0, 103.0]
        with pytest.raises(IndexError):
            c[7]
        with pytest.raises(ValueError, match="at least one"):
            pkg.ConcatSource([])


# -- the store (tests/data/test_store.py) ---------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_writer_reader_round_trip(tmp_path, writer):
    """A store written in two chunks by either package: the same files,
    and both readers give the same examples (copies, not memmap views)."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (40, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (40,), dtype=np.int64)
    dirs = {}
    for name, pkg in PACKAGES.items():
        d = dirs[name] = str(tmp_path / name)
        with pkg.MemmapWriter(d) as w:
            w.append({"image": images[:15], "label": labels[:15]})
            w.append({"image": images[15:], "label": labels[15:]})
    assert _store_files(dirs["port"]) == _store_files(dirs["jax"])
    port_src, jax_src = port_data.MemmapSource(dirs[writer]), jax_data.MemmapSource(dirs[writer])
    assert len(port_src) == len(jax_src) == 40
    for i in (0, 14, 15, 39, -1):
        _same_example(port_src[i], jax_src[i])
        np.testing.assert_array_equal(port_src[i]["image"], images[i])
        assert port_src[i]["label"] == labels[i]
    assert sorted(port_src.features) == ["image", "label"]


def test_writer_rejects_inconsistent_chunks(tmp_path):
    for name, pkg in PACKAGES.items():
        w = pkg.MemmapWriter(str(tmp_path / f"{name}_s"))
        w.append({"x": np.zeros((2, 3), np.float32)})
        with pytest.raises(ValueError, match=r"Chunk features \['y'\] != store features \['x'\]"):
            w.append({"y": np.zeros((2, 3), np.float32)})
        with pytest.raises(ValueError, match=r"chunk is float32\[4\], store is float32\[3\]"):
            w.append({"x": np.zeros((2, 4), np.float32)})
        w2 = pkg.MemmapWriter(str(tmp_path / f"{name}_s2"))
        with pytest.raises(ValueError, match="unequal lengths"):
            w2.append({"a": np.zeros((2, 1), np.float32), "b": np.zeros((3,), np.int32)})
        w.close()
        with pytest.raises(ValueError, match="already closed"):
            w.append({"x": np.zeros((1, 3), np.float32)})


def test_reader_requires_closed_store(tmp_path):
    for name, pkg in PACKAGES.items():
        d = str(tmp_path / name)
        w = pkg.MemmapWriter(d)
        w.append({"x": np.zeros((2, 3), np.float32)})
        with pytest.raises(FileNotFoundError, match="missing meta.json"):
            port_data.MemmapSource(d)
        w.close()
        assert len(port_data.MemmapSource(d)) == len(jax_data.MemmapSource(d)) == 2
    # A writer that failed leaves no readable store.
    d = str(tmp_path / "failed")
    with pytest.raises(RuntimeError):
        with port_data.MemmapWriter(d) as w:
            w.append({"x": np.zeros((2, 3), np.float32)})
            raise RuntimeError("producer died")
    with pytest.raises(FileNotFoundError):
        port_data.MemmapSource(d)


def test_reader_detects_truncated_file(tmp_path):
    d = str(tmp_path / "trunc")
    port_data.write_store(d, {"x": np.arange(64, dtype=np.float32).reshape(8, 8)})
    with open(os.path.join(d, "x.bin"), "r+b") as f:
        f.truncate(100)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="file is 100 bytes, meta implies 256"):
            pkg.MemmapSource(d)


def test_store_streams_without_full_materialization(tmp_path):
    """A store of 20 chunks round-trips by random access, identical across
    the packages' writers and readers."""
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_split(port_data, d_port, 2560, chunk=128)
    _write_split(jax_data, d_jax, 2560, chunk=128)
    assert _store_files(d_port) == _store_files(d_jax)
    src = port_data.MemmapSource(d_port)
    assert len(src) == 2560
    first_images = np.random.default_rng(0).integers(0, 255, (128, 8, 8, 1), dtype=np.uint8)
    np.testing.assert_array_equal(src[17]["image"], first_images[17])
    jax_src = jax_data.MemmapSource(d_port)
    for i in (0, 127, 128, 1999, 2559):
        _same_example(src[i], jax_src[i])


def _experiment_conf(root, **extra):
    return {
        "loader.dataset": "MemmapDataset", "loader.dataset.directory": root,
        "loader.preprocessing": "ImageClassificationPreprocessing",
        "loader.preprocessing.height": 8, "loader.preprocessing.width": 8,
        "loader.preprocessing.channels": 1, "model": "Mlp", "model.hidden_units": (16,),
        "batch_size": 64, "epochs": 1, "verbose": False, **extra,
    }


def test_memmap_dataset_trains_end_to_end(tmp_path):
    """A JAX-written store drives the port's TrainingExperiment, the class
    count inferred from the label file."""
    root = str(tmp_path / "ds")
    _write_split(jax_data, os.path.join(root, "train"), 640, num_classes=5, seed=0)
    _write_split(jax_data, os.path.join(root, "validation"), 128, num_classes=5, seed=1)
    exp = TrainingExperiment()
    port_configure(exp, _experiment_conf(root, device="cpu"), name="experiment")
    assert exp.num_classes == 5
    history = exp.run()
    assert len(history["train"]) == 1 and np.isfinite(history["train"][0]["loss"])
    assert len(history["validation"]) == 1


def test_memmap_dataset_batches_equal_jax_loader(tmp_path):
    """The first epoch's batches (shuffle, augmentation) of the port's
    loader over a store equal the JAX loader's bit for bit."""
    root = str(tmp_path / "ds")
    _write_split(port_data, os.path.join(root, "train"), 96, h=12, w=12, c=3, num_classes=7)
    conf = {"dataset": "MemmapDataset", "dataset.directory": root,
            "preprocessing": "ImageClassificationPreprocessing",
            "preprocessing.height": 12, "preprocessing.width": 12,
            "preprocessing.augment": True, "preprocessing.pad_pixels": 2,
            "batch_size": 16, "seed": 4}
    jl, pl = jax_data.DataLoader(), port_data.DataLoader()
    jax_configure(jl, {"prefetch": 0, "host_index": 0, "host_count": 1, **conf}, name="loader")
    port_configure(pl, conf, name="loader")
    assert pl.dataset.resolved_num_classes() == jl.dataset.resolved_num_classes() == 7
    assert pl.dataset.validation() is None
    got = list(pl.host_batches("train", epoch=0))
    want = list(jax_batch_iterator(jl._source("train").map(lambda e: e), jl.preprocessing, 16,
                                   training=True, shuffle=True, seed=4, epoch=0))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for key in ("input", "target"):
            assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()


def test_array_dataset_infers_num_classes():
    arrays = {"image": np.zeros((10, 2, 2, 1), np.uint8),
              "label": np.array([0, 1, 2, 3, 3, 2, 1, 0, 3, 2], np.int64)}
    for pkg, configure in ((port_data, port_configure), (jax_data, jax_configure)):
        ds = pkg.ArrayDataset()
        configure(ds, {}, name="dataset")
        assert ds.with_data(arrays).resolved_num_classes() == 4


def test_memmap_dataset_explicit_num_classes_wins(tmp_path):
    root = str(tmp_path / "ds")
    _write_split(port_data, os.path.join(root, "train"), 64, num_classes=3)
    for pkg, configure in ((port_data, port_configure), (jax_data, jax_configure)):
        ds = pkg.MemmapDataset()
        configure(ds, {"directory": root, "num_classes": 11}, name="dataset")
        assert ds.resolved_num_classes() == 11


def test_wrap_source_adapts_grain_protocol():
    """Anything with __len__/__getitem__ plugs into the pipeline."""

    class FakeGrainSource:  # not a DataSource
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {"image": np.full((2, 2), i), "label": i % 2}

    class Scalars:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return np.float32(i)

    src = port_data.wrap_source(FakeGrainSource())
    assert isinstance(src, port_data.WrappedSource) and len(src) == 4
    _same_example(src[2], jax_data.wrap_source(FakeGrainSource())[2])
    np.testing.assert_array_equal(src[2]["image"], np.full((2, 2), 2))
    s2 = port_data.wrap_source(Scalars(), feature_name="x")
    assert s2[1]["x"] == 1.0 and s2[1]["x"].dtype == np.float32
    assert port_data.wrap_source(src) is src
    twice = port_data.wrap_source(Scalars(), transform=lambda v: {"y": np.asarray(2 * v)})
    assert twice[2]["y"] == 4.0


def test_meta_json_is_human_readable(tmp_path):
    d = str(tmp_path / "s")
    port_data.write_store(d, {"x": np.zeros((3, 2), np.float32)})
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"num_examples": 3, "features": {"x": {"dtype": "float32", "shape": [2]}}}
    d_jax = str(tmp_path / "j")
    jax_data.write_store(d_jax, {"x": np.zeros((3, 2), np.float32)})
    assert _store_files(d) == _store_files(d_jax)


# -- the grain adapter (tests/data/test_dataset.py) -----------------------------


def _grain_examples(n, seed):
    r = np.random.default_rng(seed)
    return [{"image": r.integers(0, 255, (8, 8, 1)).astype(np.uint8), "label": np.int32(i % 4)}
            for i in range(n)]


def _grain_experiment_conf(**overrides):
    return {
        "loader.preprocessing": "ImageClassificationPreprocessing",
        "loader.preprocessing.height": 8, "loader.preprocessing.width": 8,
        "loader.preprocessing.channels": 1, "loader.dataset": "GrainDataset",
        "model": "Mlp", "model.hidden_units": (8,), "batch_size": 16, "epochs": 1,
        "device": "cpu", "verbose": False, **overrides,
    }


def test_grain_pipeline_trains_end_to_end():
    """A grain MapDataset with a map stage drives the port's training loop."""
    import grain.python as pg

    train = pg.MapDataset.source(_grain_examples(64, 1)).map(lambda ex: ex)
    val = pg.MapDataset.source(_grain_examples(16, 2))
    exp = TrainingExperiment()
    port_configure(exp, _grain_experiment_conf(), name="experiment")
    exp.loader.dataset.with_sources(train, val)
    history = exp.run()
    assert np.isfinite(history["train"][0]["loss"]) and history["validation"]


def test_grain_infer_num_classes_scans_labels():
    import grain.python as pg

    for pkg, configure in ((port_data, port_configure), (jax_data, jax_configure)):
        ds = pkg.GrainDataset()
        configure(ds, {}, name="ds")
        ds.with_sources(pg.MapDataset.source(_grain_examples(64, 1)))
        assert ds.resolved_num_classes() == 4
        capped = pkg.GrainDataset()
        configure(capped, {"infer_scan_limit": 3}, name="ds")
        capped.with_sources(pg.MapDataset.source(_grain_examples(64, 1)))
        with pytest.warns(UserWarning, match="first 3 of 64"):
            assert capped.resolved_num_classes() == 3


def test_grain_rejects_non_random_access_source():
    for pkg, configure in ((port_data, port_configure), (jax_data, jax_configure)):
        ds = pkg.GrainDataset()
        configure(ds, {}, name="ds")
        with pytest.raises(TypeError, match="random-access"):
            ds.with_sources(iter(range(10)))
        with pytest.raises(ValueError, match="with_sources"):
            ds.train()


def test_grain_infer_rejects_empty_and_float_labels():
    import grain.python as pg

    for pkg, configure in ((port_data, port_configure), (jax_data, jax_configure)):
        ds = pkg.GrainDataset()
        configure(ds, {}, name="ds")
        ds.with_sources(pg.MapDataset.source([]))
        with pytest.raises(ValueError, match="num_classes"):
            ds.resolved_num_classes()
        ds2 = pkg.GrainDataset()
        configure(ds2, {}, name="ds2")
        ds2.with_sources(pg.MapDataset.source([{"image": np.zeros((2, 2)),
                                                "label": np.float32(0.9)}]))
        with pytest.raises(ValueError, match="no scalar integer 'label'"):
            ds2.resolved_num_classes()  # float labels must not truncate


def test_array_record_streams_and_trains(tmp_path):
    """ArrayRecord files through grain into the port's training loop: two
    epochs, the loss falling."""
    import pickle

    import grain.python as pg
    from array_record.python.array_record_module import ArrayRecordWriter

    files = {}
    for split, n, seed in (("train", 64, 1), ("val", 16, 2)):
        path = str(tmp_path / f"{split}.array_record")
        writer = ArrayRecordWriter(path, "group_size:1")
        for example in _grain_examples(n, seed):
            writer.write(pickle.dumps(example))
        writer.close()
        files[split] = pg.MapDataset.source(pg.ArrayRecordDataSource([path])).map(pickle.loads)
    assert len(files["train"]) == 64 and len(files["val"]) == 16
    exp = TrainingExperiment()
    port_configure(exp, _grain_experiment_conf(**{"model.hidden_units": (16,), "epochs": 2}),
                   name="experiment")
    exp.loader.dataset.with_sources(files["train"], validation=files["val"])
    losses = [m["loss"] for m in exp.run()["train"]]
    assert len(losses) == 2 and losses[-1] < losses[0]
