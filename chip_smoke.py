#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and ``nvcc``. In order:

1. Device: the card's name and power limit (``nvidia-smi``), CUDA version.
2. Build: compiles every kernel of ``zookeeper_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, in parallel.
3. Kernels: K1 ``pack_rows``, K3 ``conv_gemm_popcount`` and K4
   ``packed_weight_matmul`` at every shape the batch-8 QuickNet-Large
   forward gives them plus a ragged shape: each must EQUAL its plain
   PyTorch version on the card (exact integers, or one fp32 multiply of
   one), and each is timed beside its plain version and, where one
   PyTorch call computes the same function, that call.
4. Slice A: ``ServingConfig`` serves seeded requests with QuickNet-Large,
   224x224x3, 1000 classes, bf16, ``binary_compute="xnor_popcount"``,
   packed and BN-folded weights; K1 and K3 must launch 32 times per
   forward, and one batch's logits must equal the plain path's bit for
   bit.
5. Slice B: the same with ``binary_compute="xnor"`` on K4.
6. One JSON line of the kernels, then the result line.

Any failure exits non-zero before the result line is printed. There is
no CPU fallback: without a card, or outside a checkout, the script fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates of an H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, and
#: int8 tensor-core ops/s (the binary +-1 products are counted at the
#: int8 rate, the cheapest type that computes them on tensor cores) and
#: fp32 ops/s outside the tensor cores (K1's compares).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

#: The rate each kernel's operations are counted at.
OPS_RATE = {
    "pack_rows": FP32_OPS_PER_S,
    "conv_gemm_popcount": INT8_OPS_PER_S,
    "packed_weight_matmul": INT8_OPS_PER_S,
}

#: QuickNet-Large at batch 8, 224x224: per section (binary convs, spatial
#: size, channels).
SECTIONS = ((6, 56, 64), (8, 28, 128), (12, 14, 256), (6, 7, 512))
BATCH = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(name: str, nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations") for the work."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_RATE[name] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_ms(torch, fn, reps: int = 21, inner: int = 10) -> float:
    """Median device time of one call, over ``reps`` runs of ``inner``
    back-to-back calls. A device-side sleep first lets the host queue
    the calls ahead of the card, so the events time the card, not the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_phase(torch, bc):
    """Check and time K1, K3 and K4 at the main path's shapes. Returns
    {kernel: {"ms", "plain_ms", "library_ms", "bytes", "ops",
    "max_abs_err"}} summed over one batch-8 forward's launches."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def signs(*shape):
        return torch.where(torch.rand(*shape, generator=g) < 0.5, -1.0, 1.0)

    totals = {
        name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
               "ops": 0.0, "max_abs_err": 0.0}
        for name in ("pack_rows", "conv_gemm_popcount", "packed_weight_matmul")
    }
    totals["pack_rows"]["library_ms"] = None

    def record(name, count, kernel, plain, library, nbytes, ops, shape):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        check(torch.equal(got, want),
              f"{name} at {shape} disagrees with its plain version (max err {err})")
        k_ms, p_ms = time_ms(torch, kernel), time_ms(torch, plain, reps=21, inner=2)
        l_ms = time_ms(torch, library) if library is not None else None
        b_ms, b_by = bound_ms(name, nbytes, ops)
        print(f"kernel {name} {shape}: equal, kernel {k_ms:.6f} ms, plain "
              f"{p_ms:.6f} ms, library {l_ms if l_ms is None else round(l_ms, 6)} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops), "
              f"launches/forward {count}", flush=True)
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if count:
            t["ms"] += count * k_ms
            t["plain_ms"] += count * p_ms
            t["bytes"] += count * nbytes
            t["ops"] += count * ops
            if library is not None and t["library_ms"] is not None:
                t["library_ms"] += count * l_ms

    # (launches per forward, batch, spatial in, channels in, co, stride);
    # the last row of each kernel is a ragged shape off the main path.
    conv_cases = [(n, BATCH, h, c, c, 1) for n, h, c in SECTIONS] + [(0, 2, 9, 17, 33, 2)]
    for count, b, h, ci, co, s in conv_cases:
        x = signs(b, h, h, ci).to(torch.bfloat16).to(dev)
        q = signs(3, 3, ci, co) * (torch.rand(co, generator=g) + 0.1)
        packed, scale = bc.pack_conv_kernel(q)
        packed, scale = packed.to(dev), scale.to(dev)
        ciw = packed.shape[2]
        xp, ho, wo = bc._spatial_pad(x, 3, 3, (s, s), "SAME", 1.0)
        xpc = F.pad(xp, (0, ciw * 32 - ci), value=1.0)
        rows = xpc.reshape(-1, ciw * 32).contiguous()
        m = rows.shape[0]
        record("pack_rows", count, lambda: bc.pack_rows(rows),
               lambda: bc.pack_rows_plain(rows), None,
               m * ciw * 32 * 2 + m * ciw * 4, m * ciw * 32, (m, ciw * 32))
        xq = bc.pack_rows_plain(rows).reshape(*xpc.shape[:3], ciw)
        k_true = 9 * ci
        x_nchw = xp.permute(0, 3, 1, 2)  # +-1 bf16, ones-padded, channels_last
        w_oihw = (q.sign().permute(3, 2, 0, 1).to(torch.bfloat16).to(dev)
                  .contiguous(memory_format=torch.channels_last))
        record("conv_gemm_popcount", count,
               lambda: bc.conv_gemm_popcount(xq, packed, scale, (s, s), k_true),
               lambda: bc.conv_gemm_popcount_plain(xq, packed, scale, (s, s), k_true),
               lambda: F.conv2d(x_nchw, w_oihw, stride=s) * scale[:, None, None],
               xq.numel() * 4 + packed.numel() * 4 + co * 4 + b * ho * wo * co * 4,
               2 * b * ho * wo * co * k_true, tuple(xq.shape))

    # K1's wire-format edges, off the main path, in both dtypes it takes
    # and at ragged word counts: normal values mixed with +-0, +-inf, NaN
    # and +-subnormals (bit 1 for +-0, bit 0 for NaN and every negative).
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                          1e-40, -1e-40])
    for dtype, (m, k) in ((torch.float32, (37, 96)), (torch.bfloat16, (53, 64))):
        v = torch.randn(m, k, generator=g)
        pick = torch.rand(m, k, generator=g) < 0.3
        v[pick] = edges[torch.randint(len(edges), (int(pick.sum()),), generator=g)]
        rows = v.to(dtype).to(dev)
        record("pack_rows", 0, lambda: bc.pack_rows(rows),
               lambda: bc.pack_rows_plain(rows), None,
               rows.numel() * rows.element_size() + m * k // 8, m * k,
               (m, k, str(dtype)))

    gemm_cases = [(n, BATCH * h * h, 9 * c, c) for n, h, c in SECTIONS] + [(0, 37, 70, 33)]
    for count, m, k, n in gemm_cases:
        a = signs(m, k)
        a[torch.rand(m, k, generator=g) < 0.05] = 0.0  # zeros of the spatial padding
        a = a.to(torch.int8).to(dev)
        w = signs(k, n)
        bp = bc.pack_dense_kernel(w)[0].to(dev)
        library = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            w8 = w.to(torch.int8).to(dev).t().contiguous().t()  # column-major
            library = lambda: torch._int_mm(a, w8)  # noqa: E731
        kw = bp.shape[0]
        record("packed_weight_matmul", count, lambda: bc.packed_weight_matmul(a, bp),
               lambda: bc.packed_weight_matmul_plain(a, bp), library,
               m * k + kw * n * 4 + m * n * 4, 2 * m * n * k, (m, k, n))
    return totals


def slice_phase(torch, bc, label: str, binary_compute: str, kernels):
    """Serve seeded requests through the port's ServingConfig; check the
    launches, the logits, and that they equal the plain path's. Returns
    (launches by kernel, timings)."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import ServingConfig

    cfg = ServingConfig()
    configure(cfg, {
        "model": "QuickNetLarge",
        "model.compute_dtype": "bfloat16",
        "model.binary_compute": binary_compute,
        "model.packed_weights": True,
        "model.fold_bn": True,
        "model.binary_flavor": "auto",
        "engine.batch_buckets": (1, BATCH),
        "height": 224, "width": 224, "channels": 3, "num_classes": 1000,
        "requests": 16, "max_request": BATCH, "seed": 0,
        "device": "cuda", "verbose": False,
    })
    t0 = time.perf_counter()
    bc.reset_launches()
    result = cfg.run()  # build, pack, warm both buckets, serve the stream
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    forwards = 2 + int(result["dispatches"])  # warmup of buckets 1 and 8
    print(f"slice {label}: served {result['requests']} requests in "
          f"{int(result['dispatches'])} dispatches, {forwards} forwards, "
          f"launches {launches}, run {time.perf_counter() - t0:.1f} s", flush=True)
    for name in bc.LAUNCHES:
        want = 32 * forwards if name in kernels else 0
        check(launches[name] == want,
              f"slice {label}: {name} launched {launches[name]} times, want {want}")

    engine = cfg.engine
    x = np.random.default_rng(1).normal(size=(BATCH, 224, 224, 3)).astype(np.float32)
    logits = engine.infer(x)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000), f"slice {label}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"slice {label}: non-finite logits")
    before = dict(bc.LAUNCHES)
    with mock.patch.multiple(
        bc, pack_rows=bc.pack_rows_plain,
        conv_gemm_popcount=bc.conv_gemm_popcount_plain,
        packed_weight_matmul=bc.packed_weight_matmul_plain,
    ):
        plain = engine.infer(x)
    torch.cuda.synchronize()
    check(bc.LAUNCHES == before,
          f"slice {label}: the plain-path forward launched kernels "
          f"({before} -> {bc.LAUNCHES}), so it is no plain reference")
    check(torch.equal(logits, plain),
          f"slice {label}: kernel-path logits differ from the plain path "
          f"(max {(logits - plain).abs().max().item()})")

    steps = 20
    engine.infer(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.infer(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = {
        "images_per_s": BATCH * steps / dt,
        "batch8_forward_ms": dt / steps * 1e3,
        "p50_ms": result["latency_p50_ms"],
        "p99_ms": result["latency_p99_ms"],
    }
    print(f"slice {label}: logits equal to the plain path; " + json.dumps(stats), flush=True)
    del cfg, engine
    torch.cuda.empty_cache()
    return launches, stats


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "zookeeper_tpu_torch", "csrc")):
        fail("run from a checkout: zookeeper_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    from zookeeper_tpu_torch.ops import binary_compute as bc
    from zookeeper_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {sorted(cuda_build.SIGNATURES)} with nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    totals = kernel_phase(torch, bc)
    launches_a, stats_a = slice_phase(torch, bc, "A", "xnor_popcount",
                                      ("pack_rows", "conv_gemm_popcount"))
    launches_b, stats_b = slice_phase(torch, bc, "B", "xnor",
                                      ("packed_weight_matmul",))
    print(f"slices on {smi}: A {json.dumps(stats_a)} B {json.dumps(stats_b)}", flush=True)

    meta = {
        "pack_rows": ("zookeeper_tpu/ops/binary_compute.py:527", launches_a),
        "conv_gemm_popcount": ("zookeeper_tpu/ops/binary_compute.py:938", launches_a),
        "packed_weight_matmul": ("zookeeper_tpu/ops/binary_compute.py:745", launches_b),
    }
    rows = []
    for name, t in totals.items():
        replaces, launches = meta[name]
        least_ms, bound_by = bound_ms(name, t["bytes"], t["ops"])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"zookeeper_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "ok": True,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": least_ms,
            "bound_by": bound_by,
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
