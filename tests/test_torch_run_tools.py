"""The tools around a run, the port's against the JAX package's: the
metrics writers (the same jsonl lines, TensorBoard events that read back
as JAX's writer's, the experiment's scalars), the trace breakdown (a
hand-made Chrome trace against JAX's breakdown of the hand-made xplane
built from the same op list), the profiler window, and the latency
protocol."""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.training import TrainingExperiment as JaxTrainingExperiment
from zookeeper_tpu.training import benchmark as jax_benchmark
from zookeeper_tpu.training import metrics as jax_metrics
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.serving import InferenceEngine
from zookeeper_tpu_torch.training import TrainingExperiment, benchmark, metrics, profiling
from zookeeper_tpu_torch.training.profiling import (
    device_op_stats,
    format_breakdown,
    kernel_category,
    op_time_breakdown,
)

# -- metrics writers (tests/training/test_metrics.py) ---------------------------


def _writer(module, cls, conf):
    w = getattr(module, cls)()
    (jax_configure if module is jax_metrics else port_configure)(w, conf, name="writer")
    return w


def test_null_writer_is_noop():
    w = _writer(metrics, "MetricsWriter", {})
    w.write_scalars(0, {"loss": 1.0})
    w.flush()
    w.close()


SCALARS = ((1, {"loss": 0.5, "acc": 0.9}), (2, {"loss": 0.25}),
           (7, {"train/loss": np.float32(1.0 / 3.0), "lr": 1e-3, "count": 3}))


def test_jsonl_writer_lines_equal_jax(tmp_path):
    files = {}
    for name, module in (("port", metrics), ("jax", jax_metrics)):
        files[name] = tmp_path / f"{name}.jsonl"
        w = _writer(module, "JsonlMetricsWriter", {"path": str(files[name])})
        for step, values in SCALARS:
            w.write_scalars(step, values)
        w.close()
        w.write_scalars(9, {"loss": 0.0})  # after close: a no-op
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    lines = [json.loads(l) for l in files["port"].read_text().splitlines()]
    assert lines[:2] == [{"step": 1, "loss": 0.5, "acc": 0.9}, {"step": 2, "loss": 0.25}]


def test_jsonl_writer_unconfigured_is_noop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = _writer(metrics, "JsonlMetricsWriter", {})
    w.write_scalars(1, {"loss": 0.5})
    w.close()
    assert os.listdir(tmp_path) == []


def _read_tb_scalars(log_dir):
    """Scalar summaries read back with TensorBoard's own record reader."""
    import tensorflow as tf

    out = {}
    for path in glob.glob(f"{log_dir}/**/events.out.tfevents*", recursive=True):
        for raw in tf.data.TFRecordDataset(path):
            event = tf.compat.v1.Event.FromString(raw.numpy())
            for value in event.summary.value:
                if value.HasField("simple_value"):
                    out[(event.step, value.tag)] = value.simple_value
                elif value.HasField("tensor"):
                    out[(event.step, value.tag)] = float(tf.make_ndarray(value.tensor))
    return out


def test_tensorboard_writer_reads_back_as_jax(tmp_path):
    """Events read back with the same tags, steps and (float32) values as
    the JAX writer's; writes after close are no-ops."""
    read = {}
    for name, module in (("port", metrics), ("jax", jax_metrics)):
        log_dir = str(tmp_path / name)
        w = _writer(module, "TensorBoardMetricsWriter", {"log_dir": log_dir})
        for step, values in SCALARS:
            w.write_scalars(step, values)
        w.close()
        w.write_scalars(9, {"train/loss": 0.5})
        read[name] = _read_tb_scalars(log_dir)
    assert read["port"] == read["jax"]
    assert read["port"][(7, "train/loss")] == pytest.approx(1.0 / 3.0)
    assert (9, "train/loss") not in read["port"] and len(read["port"]) == 6


def test_tensorboard_writer_needs_tensorboard(tmp_path, monkeypatch):
    """With a log_dir and no tensorboard package the first write raises an
    ImportError naming it; nothing is dropped silently."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = _writer(metrics, "TensorBoardMetricsWriter", {"log_dir": str(tmp_path / "tb")})
    with pytest.raises(ImportError, match="'tensorboard' package"):
        w.write_scalars(1, {"loss": 1.0})
    off = _writer(metrics, "TensorBoardMetricsWriter", {})
    off.write_scalars(1, {"loss": 1.0})  # unconfigured: no import at all


def test_composite_writer_fans_out(tmp_path):
    w = _writer(metrics, "CompositeMetricsWriter", {
        "jsonl.path": str(tmp_path / "m.jsonl"), "tensorboard.log_dir": str(tmp_path / "tb")})
    w.write_scalars(7, {"loss": 2.0})
    w.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {"step": 7, "loss": 2.0}
    assert _read_tb_scalars(str(tmp_path / "tb"))[(7, "loss")] == 2.0


EXPERIMENT = {
    "loader.dataset": "SyntheticMnist", "loader.dataset.num_train_examples": 128,
    "loader.dataset.num_validation_examples": 32,
    "loader.preprocessing": "ImageClassificationPreprocessing",
    "loader.preprocessing.height": 28, "loader.preprocessing.width": 28,
    "loader.preprocessing.channels": 1, "model": "Mlp", "model.hidden_units": (16,),
    "batch_size": 32, "epochs": 2, "verbose": False, "log_every": 2,
}


def test_experiment_writes_metrics(tmp_path):
    """The training loop feeds the writer the JAX loop's records: per step
    under log_every (train/), per epoch (train_epoch/, val/) at the
    epoch's last step, the same keys and steps; TensorBoard gets the same
    tags; metrics_file gets the epoch records."""
    records = {}
    for name, cls, configure, extra in (
        ("port", TrainingExperiment, port_configure, {"device": "cpu"}),
        ("jax", JaxTrainingExperiment, jax_configure,
         {"loader.host_index": 0, "loader.host_count": 1}),
    ):
        exp = cls()
        configure(exp, {**EXPERIMENT, **extra,
                        "writer.jsonl.path": str(tmp_path / f"{name}.jsonl"),
                        "writer.tensorboard.log_dir": str(tmp_path / f"{name}_tb"),
                        "metrics_file": str(tmp_path / f"{name}_epochs.jsonl")},
                  name="experiment")
        history = exp.run()
        lines = [json.loads(l) for l in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        records[name] = lines
        epochs = [json.loads(l) for l in open(tmp_path / f"{name}_epochs.jsonl")]
        assert [e["epoch"] for e in epochs] == [0, 1]
        assert epochs[1]["loss"] == history["train"][1]["loss"]
        assert epochs[1]["val_accuracy"] == history["validation"][1]["accuracy"]
        records[f"{name}_epochs"] = epochs
        records[f"{name}_tb"] = set(_read_tb_scalars(str(tmp_path / f"{name}_tb")))
    assert len(records["port"]) == 6
    assert [(r["step"], sorted(r)) for r in records["port"]] == \
        [(r["step"], sorted(r)) for r in records["jax"]]
    assert [r["step"] for r in records["port"] if "val/accuracy" not in r] == [2, 4, 6, 8]
    assert sorted(records["port_epochs"][0]) == sorted(records["jax_epochs"][0])
    assert records["port_tb"] == records["jax_tb"]
    assert (4, "train/loss") in records["port_tb"] and (8, "val/accuracy") in records["port_tb"]


def test_metrics_file_tags_a_partial_epoch(tmp_path):
    """A run resumed mid-epoch writes its first epoch's record tagged
    ``partial_epoch`` (its aggregates cover the replayed steps only); full
    epochs carry no tag, as the JAX loop's records."""
    conf = {**EXPERIMENT, "device": "cpu", "log_every": 0, "validate": False,
            "loader.dataset.num_validation_examples": 0,
            "checkpointer.directory": str(tmp_path / "run"),
            "checkpointer.save_every_steps": 3, "checkpointer.save_every_epochs": 0}
    first = TrainingExperiment()
    port_configure(first, {**conf, "epochs": 1}, name="experiment")
    first.run()
    assert first.checkpointer.latest_step() == 3  # mid-epoch (4 steps an epoch)
    resumed = TrainingExperiment()
    port_configure(resumed, {**conf, "epochs": 2, "metrics_file": str(tmp_path / "m.jsonl")},
                   name="experiment")
    resumed.run()
    records = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1]
    assert records[0].get("partial_epoch") is True and "partial_epoch" not in records[1]
    assert {"epoch", "loss", "accuracy", "examples_per_sec"} <= set(records[1])


def test_teardown_runs_all_steps_before_raising(tmp_path):
    """A failing checkpointer.wait does not keep writer.flush from running
    (durable metrics first); with no error in flight the failure then
    propagates."""
    exp = TrainingExperiment()
    port_configure(exp, {**EXPERIMENT, "device": "cpu", "epochs": 1,
                         "checkpointer.directory": str(tmp_path / "run")}, name="experiment")
    calls = []

    def broken_wait(*args, **kwargs):
        raise OSError("wait failed")

    object.__setattr__(exp.checkpointer, "wait", broken_wait)
    flush = exp.writer.flush
    object.__setattr__(exp.writer, "flush", lambda: calls.append("flush") or flush())
    with pytest.raises(OSError, match="wait failed"):
        exp.run()
    assert calls == ["flush"]


def test_top_k_accuracy_rank_general():
    """top-k over [b, s, V] logits with [b, s] labels and over [b, V],
    equal to JAX's."""
    import jax.numpy as jnp

    from zookeeper_tpu.training.step import top_k_accuracy as jax_top_k
    from zookeeper_tpu_torch.training import top_k_accuracy

    rng = np.random.default_rng(0)
    for shape in ((2, 8, 11), (16, 11)):
        logits = rng.normal(size=shape).astype(np.float32)
        labels = rng.integers(0, 11, shape[:-1])
        got = float(top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), 5))
        want = float(jax_top_k(jnp.asarray(logits), jnp.asarray(labels), 5))
        top5 = np.argsort(-logits, axis=-1)[..., :5]
        oracle = float((top5 == labels[..., None]).any(-1).mean())
        assert got == pytest.approx(want, abs=1e-6) and got == pytest.approx(oracle, abs=1e-6)


# -- the trace breakdown (tests/training/test_profiling.py) ---------------------

# (JAX op name, JAX category, the CUDA kernel name of the same role, its
# Chrome-trace cat, ms per event, events, flops each, bytes each)
_OPS = (
    ("%fusion.7 = bf16[128,28,28,256] fusion(...)", "convolution fusion",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel",
     3.0, 2, 5.0e9, 1.0e6),
    ("%convert_reduce_fusion.1 = (f32[64], f32[64]) fusion(...)", "loop fusion",
     "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(...)", "kernel",
     2.0, 1, 1.0e6, 500.0e6),
    ("%copy.3 = bf16[8,8] copy(...)", "copy-done", "Memcpy DtoD (Device -> Device)",
     "gpu_memcpy", 1.0, 1, 0, 0),
)
PORT_CATEGORY = {"convolution fusion": "cuBLAS/cuDNN", "loop fusion": "reduction",
                 "copy-done": "copy"}
PEAKS = {"peak_flops_per_sec": 200e12, "peak_bytes_per_sec": 800e9}


def _write_chrome_trace(tmp_path, n_devices=1):
    """A torch.profiler-shaped Chrome trace of the op list on each card,
    with host events that must be ignored."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": 1,
               "ts": 0.0, "dur": 50000.0, "args": {"External id": 1}},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
               "tid": 1, "ts": 1.0, "dur": 5.0, "args": {}},
              {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    ts = 10.0
    for device in range(n_devices):
        for _, _, name, cat, dur_ms, n, flops, nbytes in _OPS:
            for _ in range(n):
                args = {"device": device, "stream": 7}
                if flops:
                    args["flops"] = flops
                if nbytes:
                    args["bytes"] = nbytes
                events.append({"ph": "X", "cat": cat, "name": name, "pid": device,
                               "tid": 7, "ts": ts, "dur": dur_ms * 1e3, "args": args})
                ts += dur_ms * 1e3
    trace = {"schemaVersion": 1, "deviceProperties": [], "traceEvents": events}
    nested = tmp_path / "port" / "run1"
    os.makedirs(nested)
    path = nested / f"host.1.2{profiling.TRACE_SUFFIX}"
    path.write_text(json.dumps(trace))
    return str(tmp_path / "port")


def _write_xplane(tmp_path, n_planes=1):
    """The JAX package's hand-made xplane of the same op list."""
    xplane = pytest.importorskip("tensorflow.tsl.profiler.protobuf.xplane_pb2")
    space = xplane.XSpace()
    for i in range(n_planes):
        plane = space.planes.add()
        plane.name = f"/device:TPU:{i}"
        ids = {}
        for j, key in enumerate(("hlo_category", "flops", "bytes_accessed",
                                 "peak_teraflops_per_second",
                                 "peak_hbm_bw_gigabytes_per_second"), start=1):
            plane.stat_metadata[j].id = j
            plane.stat_metadata[j].name = key
            ids[key] = j
        for key, value in (("peak_teraflops_per_second", 200.0),
                           ("peak_hbm_bw_gigabytes_per_second", 800.0)):
            s = plane.stats.add()
            s.metadata_id = ids[key]
            s.double_value = value
        line = plane.lines.add()
        line.name = "XLA Ops"
        for op_id, (name, category, _, _, dur_ms, n, flops, nbytes) in enumerate(_OPS, 1):
            meta = plane.event_metadata[op_id]
            meta.id = op_id
            meta.name = name
            for key, value in (("hlo_category", category), ("flops", flops),
                               ("bytes_accessed", nbytes)):
                if not value:
                    continue
                s = meta.stats.add()
                s.metadata_id = ids[key]
                if key == "hlo_category":
                    s.str_value = value
                else:
                    s.double_value = value
            for _ in range(n):
                ev = line.events.add()
                ev.metadata_id = op_id
                ev.duration_ps = int(dur_ms * 1e9)
    nested = tmp_path / "jax" / "plugins" / "profile" / "run1"
    os.makedirs(nested)
    (nested / "host0.xplane.pb").write_bytes(space.SerializeToString())
    return str(tmp_path / "jax")


def _jax_breakdown(trace_dir, **kw):
    from zookeeper_tpu.training.profiling import op_time_breakdown as jax_breakdown

    return jax_breakdown(trace_dir, **kw)


def _assert_same_breakdown(got, want):
    """Totals, per-category times and shares (JAX category -> the port's),
    the roofline, and the top list's ranking and columns."""
    assert got["total_ms_per_step"] == pytest.approx(want["total_ms_per_step"])
    assert list(got["by_category"]) == [PORT_CATEGORY[c] for c in want["by_category"]]
    for c, row in want["by_category"].items():
        assert got["by_category"][PORT_CATEGORY[c]] == pytest.approx(row)
    assert got["roofline"] == pytest.approx(want["roofline"])
    port_name = {jax_name: port for jax_name, _, port, *_ in _OPS}
    assert [row[2] for row in got["top_ops"]] == [port_name[row[2]] for row in want["top_ops"]]
    for g, w in zip(got["top_ops"], want["top_ops"]):
        assert g[1] == PORT_CATEGORY[w[1]]
        assert g[0] == pytest.approx(w[0])
        assert (g[3] is None) == (w[3] is None) and (g[4] is None) == (w[4] is None)
        if w[3] is not None:
            assert g[3] == pytest.approx(w[3]) and g[4] == pytest.approx(w[4])


def test_device_op_stats(tmp_path):
    data = device_op_stats(_write_chrome_trace(tmp_path))
    by_name = {op["name"]: op for op in data["ops"]}
    conv = by_name[_OPS[0][2]]
    assert conv["category"] == "cuBLAS/cuDNN" and conv["count"] == 2
    assert conv["seconds"] == pytest.approx(6e-3) and conv["flops"] == pytest.approx(1.0e10)
    assert by_name[_OPS[2][2]]["category"] == "copy"
    # No H100 in deviceProperties: no default peaks, so no roofline.
    assert data["peak_flops_per_sec"] is None and data["peak_bytes_per_sec"] is None


def test_operator_flops_split_over_its_kernels(tmp_path):
    """Flops a with_flops trace puts on the launching operator go to its
    kernels (by external id) in proportion to their durations; an H100 in
    deviceProperties gives the data-sheet peaks."""
    def kernel(name, ts, dur_ms, ext):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
                "dur": dur_ms * 1e3, "args": {"device": 0, "External id": ext}}

    trace = {"deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}], "traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 9e3,
         "args": {"External id": 5, "flops": 8.0e9}},
        kernel("sm90_xmma_gemm_splitk", 10, 1.0, 5),
        kernel("void splitKreduce_kernel<float>", 1010, 3.0, 5),
        kernel("void at::native::vectorized_elementwise_kernel<4>", 4010, 2.0, 6),
    ]}
    path = tmp_path / f"t{profiling.TRACE_SUFFIX}"
    path.write_text(json.dumps(trace))
    data = device_op_stats(str(path))
    flops = {op["name"]: op["flops"] for op in data["ops"]}
    assert flops["sm90_xmma_gemm_splitk"] == pytest.approx(2.0e9)
    assert flops["void splitKreduce_kernel<float>"] == pytest.approx(6.0e9)
    assert flops["void at::native::vectorized_elementwise_kernel<4>"] == 0.0
    assert (data["peak_flops_per_sec"], data["peak_bytes_per_sec"]) == profiling.PEAKS[0][1:]
    b = op_time_breakdown(str(path))
    assert b["roofline"]["compute_bound_ms_per_step"] == pytest.approx(4.0)
    assert b["roofline"]["unattributed_ms_per_step"] == pytest.approx(2.0)


def test_breakdown_equals_jax(tmp_path):
    """The same op list as a Chrome trace and as an xplane: the same
    totals, per-step division, categories, roofline (at the xplane's
    peaks), ranking and rate columns; the rendering reads the same."""
    port_dir, jax_dir = _write_chrome_trace(tmp_path), _write_xplane(tmp_path)
    got = op_time_breakdown(port_dir, steps=2, **PEAKS)
    want = _jax_breakdown(jax_dir, steps=2)
    _assert_same_breakdown(got, want)
    assert got["total_ms_per_step"] == pytest.approx(4.5)
    assert got["roofline"]["unattributed_ms_per_step"] == pytest.approx(0.5)
    text = format_breakdown(got)
    assert "4.50 ms/step" in text and "compute-bound ops 3.00 ms (67%)" in text
    assert "250 GB/s   31%" in text and "roofline lower bounds" in text
    # Without peaks every kernel is unattributed.
    bare = op_time_breakdown(port_dir, steps=2)
    assert bare["roofline"]["unattributed_ms_per_step"] == pytest.approx(4.5)


def test_peak_overrides_change_classification(tmp_path):
    port_dir, jax_dir = _write_chrome_trace(tmp_path), _write_xplane(tmp_path)
    for peaks in ({"peak_flops_per_sec": 1e9, "peak_bytes_per_sec": 800e9},
                  {"peak_flops_per_sec": 1e20, "peak_bytes_per_sec": 1.0}):
        _assert_same_breakdown(op_time_breakdown(port_dir, steps=2, **peaks),
                               _jax_breakdown(jax_dir, steps=2, **peaks))
    b = op_time_breakdown(port_dir, steps=2, peak_flops_per_sec=1e9, peak_bytes_per_sec=800e9)
    assert b["roofline"]["compute_bound_ms_per_step"] == pytest.approx(4.0)


def test_single_device_semantics(tmp_path):
    """A trace of four cards reports one card's numbers, not their sum;
    the substring picks a card."""
    port_dir = _write_chrome_trace(tmp_path, n_devices=4)
    jax_dir = _write_xplane(tmp_path, n_planes=4)
    _assert_same_breakdown(op_time_breakdown(port_dir, steps=2, **PEAKS),
                           _jax_breakdown(jax_dir, steps=2))
    times = device_op_stats(port_dir, device_substring="cuda:3")
    assert sum(op["seconds"] for op in times["ops"]) == pytest.approx(9e-3)


def test_device_filter_and_errors(tmp_path):
    port_dir = _write_chrome_trace(tmp_path)
    with pytest.raises(ValueError, match="no device kernel events matching 'cuda:7'"):
        device_op_stats(port_dir, device_substring="cuda:7")
    with pytest.raises(FileNotFoundError, match=r"No \.pt\.trace\.json trace"):
        device_op_stats(str(tmp_path / "empty"))
    host_only = tmp_path / f"host{profiling.TRACE_SUFFIX}"
    host_only.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1, "args": {}}]}))
    with pytest.raises(ValueError, match="no device kernel events"):
        device_op_stats(str(host_only))


def test_cli_category_filter(tmp_path, capsys):
    """--category and --min-ms narrow the top list, as the JAX CLI does,
    never the totals."""
    from zookeeper_tpu.training.profiling import _main as jax_main
    from zookeeper_tpu_torch.training.profiling import _main

    port_dir, jax_dir = _write_chrome_trace(tmp_path), _write_xplane(tmp_path)
    _main([port_dir, "--steps", "2", "--category", "copy"])
    out = capsys.readouterr().out
    assert "4.50 ms/step" in out
    assert "Memcpy DtoD" in out.split("top ops")[1] and "xmma" not in out.split("top ops")[1]
    for args in ([], ["--min-ms", "1.5"], ["--min-ms", "10.0"], ["--top", "1"]):
        _main([port_dir, "--steps", "2", *args])
        got = capsys.readouterr().out.split("top ops")[1].strip().count("\n")
        jax_main([jax_dir, "--steps", "2", *args])
        want = capsys.readouterr().out.split("top ops")[1].strip().count("\n")
        assert got == want, args


@pytest.mark.parametrize("name, category", [
    ("void pack_rows_vec_kernel<4>(float const*, unsigned int*, long, long)", "K1 pack_rows"),
    ("pack_rows_scalar_kernel(void const*, unsigned int*, long, long, int)", "K1 pack_rows"),
    ("void xnor_gemm_small_m_kernel<true>(unsigned int const*, ...)",
     "K2 xnor_matmul_packed_scaled"),
    ("void xnor_gemm_kernel<64, true>(unsigned int const*, ...)", "K2 xnor_matmul_packed_scaled"),
    ("conv_gemm_s8_kernel(void const*, unsigned int const*, float*, ...)",
     "K3 conv_gemm_popcount"),
    ("void tile_gemm_s8_kernel<false>(void const*, unsigned int const*, int*, ...)",
     "K4 packed_weight_matmul"),
    ("packed_weight_matmul_small_m_kernel(signed char const*, ...)", "K4 packed_weight_matmul"),
    ("void tile_gemm_s8_kernel<true>(void const*, unsigned int const*, int*, ...)",
     "K5 xnor_matmul_packed"),
    ("void xnor_gemm_kernel<32, false>(unsigned int const*, ...)", "K5 xnor_matmul_packed"),
    ("pack_resid_kernel(__nv_bfloat16 const*, unsigned int*, long, int)", "K6 pack_resid"),
    ("unpack_resid_pm1_kernel(unsigned int const*, __nv_bfloat16*, long)",
     "K7 unpack_resid_pm1"),
    ("mask_mul_resid_kernel(unsigned int const*, __nv_bfloat16 const*, ...)",
     "K8 mask_mul_resid"),
    ("void flash_forward_mma_kernel<64, true>(...)", "K9 flash_forward"),
    ("void flash_forward_wide_kernel<float>(...)", "K9 flash_forward"),
    ("void flash_dq_mma_kernel<64>(...)", "K10 flash_backward_dq"),
    ("void flash_dkv_kernel<float>(...)", "K11 flash_backward_dkv"),
    ("void decode_attention_split_kernel<__nv_bfloat16, __nv_bfloat16, false, 64>(...)",
     "K12 paged_decode_attention"),
    ("void decode_attention_split_kernel<__nv_bfloat16, signed char, true, 64>(...)",
     "K13 pool_paged_decode_attention"),
    ("void decode_attention_wide_kernel<float, float, true>(...)",
     "K13 pool_paged_decode_attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS/cuDNN"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>(...)", "cuBLAS/cuDNN"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(...)",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)", "reduction"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, 4>(...)", "copy"),
])
def test_every_port_kernel_has_its_category(name, category):
    """Each port kernel is named by its CUDA function (its template
    arguments tell K2/K5, K4/K5 and K12/K13 apart); none hides under
    "other"."""
    assert kernel_category(name) == category
    assert kernel_category(name, "gpu_memset") == "memset"


def test_port_kernel_sources_are_all_categorized():
    """Every __global__ function in csrc/ falls in a K category."""
    import re

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "zookeeper_tpu_torch", "csrc")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        names |= set(re.findall(r"__global__.{0,300}?\b(\w+_kernel)\s*\(",
                                open(path).read(), re.S))
    assert len(names) >= 15
    for name in names:
        args = "<true>" if "tile_gemm" in name or "small_m" in name else (
            "<__nv_bfloat16, __nv_bfloat16, true, 64>" if "decode" in name else "<64, true>")
        assert kernel_category(f"void {name}{args}(int)").startswith("K"), name


# -- the profiler window --------------------------------------------------------


def _profiled_experiment(tmp_path, **extra):
    exp = TrainingExperiment()
    port_configure(exp, {**EXPERIMENT, "epochs": 1, "log_every": 0, "device": "cpu",
                         "loader.dataset.num_train_examples": 256, "validate": False,
                         "profile_dir": str(tmp_path / "prof"), **extra}, name="experiment")
    return exp


def test_profile_window_writes_a_trace(tmp_path):
    """The window covers steps 5-8 of the first epoch and writes one Chrome
    trace holding those steps' operators."""
    exp = _profiled_experiment(tmp_path)
    exp.run()
    (path,) = glob.glob(str(tmp_path / "prof" / f"*{profiling.TRACE_SUFFIX}"))
    trace = json.load(open(path))
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::addmm" for e in ops)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_profile_window_closes_on_an_exception(tmp_path, monkeypatch):
    """A step that raises inside the window leaves no profiler running: the
    error propagates, no trace is written, and a new window opens."""
    calls = {"n": 0}
    real = TrainingExperiment._train_step_fn

    def failing(self):
        step = real(self)

        def run(state, batch):
            calls["n"] += 1
            if calls["n"] == 6:
                assert torch.autograd.profiler._is_profiler_enabled  # inside the window
                raise RuntimeError("step failed")
            return step(state, batch)

        return run

    monkeypatch.setattr(TrainingExperiment, "_train_step_fn", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        _profiled_experiment(tmp_path).run()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not glob.glob(str(tmp_path / "prof" / "*"))
    monkeypatch.setattr(TrainingExperiment, "_train_step_fn", real)
    _profiled_experiment(tmp_path).run()
    assert len(glob.glob(str(tmp_path / "prof" / f"*{profiling.TRACE_SUFFIX}"))) == 1


# -- the latency protocol (tests/training/test_benchmark.py) ----------------------


def test_time_marginal_on_a_synthetic_clock():
    """Chains whose time is 2 ms a step plus a fixed 5 ms and noise that
    only adds: the marginal is the step time, as JAX's copy computes it."""
    for rounds in (1, 4):
        rng = np.random.default_rng(0)
        noise = {}

        def chain(n):
            noise.setdefault(n, []).append(float(rng.exponential(1e-3)))
            return 2e-3 * n + 5e-3 + (0.0 if len(noise[n]) == rounds else noise[n][-1])

        got = benchmark.time_marginal(chain, 8, 24, rounds)
        rng = np.random.default_rng(0)
        noise = {}
        want = jax_benchmark.time_marginal(chain, 8, 24, rounds)
        assert got == want
        if rounds > 1:
            assert got == pytest.approx(2e-3)


def test_eager_chain_latency_measurable_and_ordered():
    """A heavy apply (20 chained 128x128 products) measures positive and
    slower than one product; a trivial apply floors above zero."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(128, 128)), dtype=torch.float32)
    x = x / 11.3

    def heavy(v):
        for _ in range(20):
            v = v @ x
        return v

    t_heavy = benchmark.eager_chain_latency(heavy, x, length=4, rounds=3)
    t_light = benchmark.eager_chain_latency(lambda v: v @ x, x, length=4, rounds=3)
    assert t_heavy > 1e-6 and t_heavy > t_light
    assert benchmark.eager_chain_latency(lambda v: v + 1.0, torch.ones(4), length=2,
                                         rounds=1) > 0.0


def test_measure_serving_latency_on_engine():
    """A warmed CPU engine: finite mean, ordered percentiles, no bucket
    first run inside the timed window; measure_inference_latency on the
    module."""
    from zookeeper_tpu_torch.models import Mlp

    model = Mlp()
    port_configure(model, {"hidden_units": (16,)}, name="model")
    module = model.initialize(model.build((6,), 4), seed=0)
    engine = InferenceEngine()
    port_configure(engine, {"batch_buckets": (4,)}, name="engine")
    engine.bind(module, (6,), device="cpu")
    engine.warmup()
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    before = engine.warmed_buckets
    mean_s, p50_s, p99_s = benchmark.measure_serving_latency(
        engine, x, n1=2, n2=6, rounds=2, percentile_samples=6, chain_len=2)
    assert engine.warmed_buckets == before == 1
    assert np.isfinite(mean_s) and 0.0 <= p50_s <= p99_s
    assert benchmark.measure_inference_latency(module, (6,), batch_size=3, device="cpu",
                                               length=4, rounds=1) > 0.0
