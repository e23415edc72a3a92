#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, with no arguments, on a machine with a
CUDA card and ``nvcc``. In order:

1. Device: the card's name and power limit (``nvidia-smi``), CUDA version.
   Deterministic algorithms (cuDNN's deterministic mode and
   ``torch.use_deterministic_algorithms``, with ``CUBLAS_WORKSPACE_CONFIG``
   set before CUDA starts) are on only around the calls held to bit
   equality; everything timed runs in PyTorch's default settings, as the
   entry points do.
2. Build: compiles every kernel of ``zookeeper_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, in parallel.
3. Kernels: K1 ``pack_rows``, K3 ``conv_gemm_popcount`` and K4
   ``packed_weight_matmul`` at every shape the batch-8 QuickNet-Large
   forward gives them plus a ragged shape: each must EQUAL its plain
   PyTorch version on the card (exact integers, or one fp32 multiply of
   one), and each is timed beside its plain version and, where one
   PyTorch call computes the same function, that call.
4. Residual kernels: K6 ``pack_resid`` (sign and mask mode), K7
   ``unpack_resid_pm1`` and K8 ``mask_mul_resid`` at the four
   QuickNet-Large section shapes of a batch-128 bf16 training step, and
   at ragged and edge cases (batch 37, a 2-D fp32 residual, a 5-D one,
   values mixing +-0, +-inf, NaN, +-1 and +-1e-40): each must equal its
   plain version bit for bit, and is timed beside it.
5. Popcount GEMMs: K5 ``xnor_matmul_packed`` and K2
   ``xnor_matmul_packed_scaled`` at BinaryAlexNet's dense shapes (M 1
   and 8, K 9216 and 4096, N 4096), BinaryNet's batch-8 K5 shapes (the
   per-tap and fused convs, the dense layers) and a ragged shape: each
   must equal its plain version bit for bit, and K2 must equal K5's
   output ``.float() * scale`` bit for bit; each is timed beside its
   plain version and ``torch._int_mm`` on int8 +-1 operands (M padded
   where ``_int_mm`` refuses a small M; the line says so).
6. The int8 conv's forward at the four section shapes must give the
   exact integer sums (against a float64 conv, exact for these sums).
7. Serving slices (``SLICES``), each ``ServingConfig.run()`` over 16
   seeded requests at buckets (1, 8): every forward must launch its
   slice's binary kernels (by its bucket) and no other, and one batch's
   logits must equal the plain path's bit for bit. A: QuickNet-Large,
   224x224x3, 1000 classes, bf16, ``binary_compute="xnor_popcount"``,
   packed and BN-folded weights (K1, K3: 32 each). B: the same with
   ``"xnor"`` (K4: 32). C: BinaryAlexNet, 224, bf16, ``"xnor_popcount"``
   packed, no fold (K1 6, K3 4, K2 2). D: BinaryAlexNet with "mxu" convs
   and the packed, BN-folded "xnor" dense stage (K4 2); without the fold
   the same build converts exactly the two dense kernels. E: BinaryNet
   (default widths), 32x32x3, 10 classes, fp32, ``"xnor_popcount"``
   packed, ``binary_flavor="reference"`` (K5 15 per batch-8 forward, 7
   at batch 1); its logits must also equal the same model's under
   ``binary_flavor="auto"`` (K1 7, K3 5, K2 2) bit for bit.
8. Training: ``TrainImageNet`` with QuickNet-Large, 224x224x3, 1000
   classes, bf16, batch 128, ``binary_compute="int8"`` and
   ``pack_residuals=True``. One step from a fixed state (Adam's count at
   1, where the schedule's rate is not 0) must launch K6, K7 and K8 64,
   32 and 32 times, give a finite loss, move the parameters, and give
   the same loss, gradients, parameters, BatchNorm statistics and Adam
   moments bit for bit as the step with the three wrappers swapped for
   their plain versions and as the step with ``pack_residuals=False``.
   Prints the
   step's device time, peak memory with the residuals packed and not,
   the profiler's top device items, and images/s through ``run()``.
9. LM kernels: K9 ``flash_attention`` (bf16 causal at the prefill
   buckets [1, 512, 8, 64] and [1, 2048, 8, 64] and at the long-context
   [4, 8192, 8, 64]; fp32 [1, 512, 8, 64]; ragged s=999; causal=False),
   K12 ``paged_decode_attention`` ([8, 8192, 8, 64] slot caches, lengths
   mixing 0, 1, 15, 16, 2047, 8191 and 9000, bf16 and fp32) and K13
   ``pool_paged_decode_attention`` (a pool of 4096 pages of 16, shuffled
   tables with -1 entries, bf16, fp32 and int8 rows), and K12/K13 again
   at head_dims 20 and 100 (not multiples of 8) and 264 and 384 (past
   256, in chunks), each against its plain
   version (K9 in bf16 within 2^-6 of each output value plus 2e-3, and
   3e-2 overall, 2e-5 in fp32; K12/K13 2e-6 in fp32 and one bf16
   rounding step in bf16), timed beside it and beside SDPA where one
   call computes the same function.
10. LM serving: ``LMServingConfig.run()`` streams 32 requests (prompts
   up to 2048 tokens, 64 new tokens each) through a TransformerLM of 4
   layers, d_model 512, 8 heads, vocab 1024, seq_len 8192, bf16, on 8
   slots, three times: the slot layout (K9 + K12), the paged layout
   (K9 + K13) and the paged layout with int8 rows. Each run must launch
   K9 4 times per prefill and K12 or K13 4 times per decode step;
   prints its result line and one decode step's profiler breakdown,
   and holds K12/K13 on a mid-run step's cache, lengths and table to
   their plain versions (one bf16 rounding step).
11. LM parity (deterministic mode): the same model in fp32 serves a
   12-request stream with slot refills through the kernels and through
   the plain functions, in both layouts: the tokens must be identical
   to each other and to ``greedy_decode``. In bf16 the agreeing tokens
   are counted, and a disagreement is allowed only where the plain
   path's top-two logit gap is below 0.05.
12. LM training kernels: K9 with lse (``flash_forward_lse``), K10
   ``flash_backward_dq`` and K11 ``flash_backward_dkv`` at the training
   step's [4, 8192, 8, 64] bf16 causal, at [1, 2048, 8, 64] bf16 and fp32,
   causal and full, at s=999, at head_dims 128 and 32, at the ragged
   bf16 head_dims 40 and 72 and at head_dim 128 full and at s=999, and
   at [1, 1024, 4, 256] and [1, 512, 2, 320] in bf16 and fp32 (past 128,
   in chunks), each against
   its plain version: K9's out equal bit for bit to the no-lse K9's, lse
   within 1e-5, gradients per element (fp32: 5e-5 + 5e-5|want|, the JAX
   package's flash-gradient tolerance; bf16: 2^-6|want| + 2^-7
   max|want| per element and 2^-7 of |want| in norm, see ``_grad_use``);
   K10 and K11 called twice must give the same bits; the library's
   ``zk_flash_backward_variant`` must send every bf16 shape of head_dim
   <= 128 to the tensor-core kernels and no other (their registers and
   spills, from ptxas, are printed after the build);
   the fp32 gradients of ``flash_attention`` under autograd
   against the dense oracle's; each timed beside its plain version, its
   bound and SDPA (K10 and K11 together beside SDPA's backward).
13. LM training: ``TrainLM`` (the long-context line of
   examples/lm_experiment.py: 4 layers, d_model 512, 8 heads of 64,
   seq_len 8192, batch 4, vocab 1024, bf16) through ``run()`` for 8
   steps and one validation batch. Each step must launch K9-lse, K10 and
   K11 4 times and no other kernel, the eval only the no-lse K9; the
   loss must be finite and fall from the first step to the last. Prints
   the step's device and host time, tokens/s, busy share, peak memory
   and profile. Before it, one fp32 step (2 layers, [2, 2048]) through
   the kernels must match the same step through their plain versions
   (loss within 1e-5 relative, each gradient within 1e-4 of its largest
   magnitude), and so must one bf16 step (the same shape, through the
   tensor-core K10/K11: loss within 2^-7 relative, each gradient within
   2^-6 of its norm in norm, see ``_bf16_step_use``).
14. Head_dim 256: TransformerLM with d_model 1024 and 4 heads (2 layers,
   seq_len 2048, bf16) serves 6 requests through
   ``LMServingConfig.run()`` in the slot and paged layouts (2 K9 per
   prefill, 2 K12/K13 per decode step) and takes one training step
   (2 K9-lse, 2 K10, 2 K11).
15. One JSON line of the kernels (13 rows), then the result line.
"""

import contextlib
import json
import math
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
#: bf16 tensor-core products (the flash forward in bf16).
BF16_OPS_PER_S = 989e12

#: The rate each kernel's operations are counted at (the residual
#: kernels: one fp32 compare or multiply per value).
OPS_RATE = {
    "pack_rows": FP32_OPS_PER_S,
    "conv_gemm_popcount": INT8_OPS_PER_S,
    "packed_weight_matmul": INT8_OPS_PER_S,
    "pack_resid": FP32_OPS_PER_S,
    "unpack_resid_pm1": FP32_OPS_PER_S,
    "mask_mul_resid": FP32_OPS_PER_S,
    # The decode kernels' vector products, and the flash forward in
    # fp32, count at the fp32 rate; the flash forward in bf16 at the
    # bf16 tensor-core rate (``bound_ms``'s ``rate`` argument).
    "flash_forward": FP32_OPS_PER_S,
    "paged_decode_attention": FP32_OPS_PER_S,
    "pool_paged_decode_attention": FP32_OPS_PER_S,
    # The flash backward, like the forward: bf16 calls at the bf16
    # tensor-core rate, fp32 calls at the fp32 rate.
    "flash_forward_lse": FP32_OPS_PER_S,
    "flash_backward_dq": FP32_OPS_PER_S,
    "flash_backward_dkv": FP32_OPS_PER_S,
    # The popcount GEMMs' +-1 products, like K3's, at the int8 rate.
    "xnor_matmul_packed": INT8_OPS_PER_S,
    "xnor_matmul_packed_scaled": INT8_OPS_PER_S,
}

#: Each kernel's source and the TPU kernel it replaces.
KERNELS = {
    "pack_rows": ("pack_rows.cu", "zookeeper_tpu/ops/binary_compute.py:527"),
    "conv_gemm_popcount": ("conv_gemm_popcount.cu", "zookeeper_tpu/ops/binary_compute.py:938"),
    "packed_weight_matmul": ("packed_weight_matmul.cu", "zookeeper_tpu/ops/binary_compute.py:745"),
    "pack_resid": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:204"),
    "unpack_resid_pm1": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:236"),
    "mask_mul_resid": ("resid_pack.cu", "zookeeper_tpu/ops/binary_compute.py:264"),
    "flash_forward": ("flash_forward.cu", "zookeeper_tpu/ops/attention.py:1163"),
    "paged_decode_attention": ("decode_attention.cu", "zookeeper_tpu/ops/attention.py:222"),
    "pool_paged_decode_attention": ("decode_attention.cu", "zookeeper_tpu/ops/attention.py:503"),
    "flash_forward_lse": ("flash_forward.cu", "zookeeper_tpu/ops/attention.py:1163"),
    "flash_backward_dq": ("flash_backward.cu", "zookeeper_tpu/ops/attention.py:1474"),
    "flash_backward_dkv": ("flash_backward.cu", "zookeeper_tpu/ops/attention.py:1492"),
    "xnor_matmul_packed": ("xnor_gemm.cu", "zookeeper_tpu/ops/binary_compute.py:351"),
    "xnor_matmul_packed_scaled": ("xnor_gemm.cu", "zookeeper_tpu/ops/binary_compute.py:600"),
}
XNOR_KERNELS = ("xnor_matmul_packed", "xnor_matmul_packed_scaled")
LM_KERNELS = ("flash_forward", "paged_decode_attention", "pool_paged_decode_attention")
LM_TRAIN_KERNELS = ("flash_forward_lse", "flash_backward_dq", "flash_backward_dkv")
RESID_KERNELS = ("pack_resid", "unpack_resid_pm1", "mask_mul_resid")

#: QuickNet-Large at batch 8, 224x224: per section (binary convs, spatial
#: size, channels).
SECTIONS = ((6, 56, 64), (8, 28, 128), (12, 14, 256), (6, 7, 512))
BATCH = 8
#: The training step's batch, and K6, K7, K8 launches per binary conv.
TRAIN_BATCH = 128
RESID_PER_CONV = {"pack_resid": 2, "unpack_resid_pm1": 1, "mask_mul_resid": 1}
#: Synthetic ImageNet examples generated for the training phase: three
#: batches (the model is not cut; only the dataset is).
TRAIN_EXAMPLES = 3 * TRAIN_BATCH

#: The classifier-serving slices: ServingConfig settings, and the binary
#: kernels each forward must launch, by batch bucket. A and B serve
#: QuickNet-Large (32 binary convs); C serves BinaryAlexNet packed
#: throughout (K1 before each of its 4 binary convs and 2 binary dense
#: layers, K3 in each conv, K2 in each dense layer; no fold: its conv
#: BNs follow a maxpool); D BASELINE's BinaryAlexNet deployment ("mxu"
#: convs, the packed "xnor" dense stage with its BNs folded: K4 in each
#: dense layer); E BinaryNet (default widths) on the "reference" flavor:
#: one K5 per fused conv and dense layer, and 9 per-tap K5 for the first
#: binary conv at batch 8, whose fused patch matrix (8192 x 9 x 128 x 4
#: B = 37.7 MB) is over the 32 MiB fusion limit.
IMAGENET = {"height": 224, "width": 224, "channels": 3, "num_classes": 1000}
SLICES = {
    "A": ({"model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
           "model.fold_bn": True, "model.binary_flavor": "auto", **IMAGENET},
          lambda bucket: {"pack_rows": 32, "conv_gemm_popcount": 32}),
    "B": ({"model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor", "model.packed_weights": True,
           "model.fold_bn": True, "model.binary_flavor": "auto", **IMAGENET},
          lambda bucket: {"packed_weight_matmul": 32}),
    "C": ({"model": "BinaryAlexNet", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True, **IMAGENET},
          lambda bucket: {"pack_rows": 6, "conv_gemm_popcount": 4,
                          "xnor_matmul_packed_scaled": 2}),
    "D": ({"model": "BinaryAlexNet", "model.compute_dtype": "bfloat16",
           "model.binary_compute": "mxu", "model.dense_binary_compute": "xnor",
           "model.dense_packed_weights": True, "model.fold_bn": True, **IMAGENET},
          lambda bucket: {"packed_weight_matmul": 2}),
    "E": ({"model": "BinaryNet", "model.compute_dtype": "float32",
           "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
           "model.binary_flavor": "reference",
           "height": 32, "width": 32, "channels": 3, "num_classes": 10},
          lambda bucket: {"xnor_matmul_packed": 15 if bucket == BATCH else 7}),
}
#: Slice E's fused-flavor twin: K1 + K3 in its 5 binary convs, K1 + K2 in
#: its 2 dense layers.
E_AUTO = {"pack_rows": 7, "conv_gemm_popcount": 5, "xnor_matmul_packed_scaled": 2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for the calls inside, so that two runs of
    the same work can be held to bit equality; the settings before are
    restored after."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
             cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        cudnn.deterministic, cudnn.benchmark = saved[1], saved[2]


def bound_ms(name: str, nbytes: float, ops: float, rate: float = None):
    """(least time in ms, "bytes" or "operations") for the work, its
    operations at ``rate`` (default: the kernel's ``OPS_RATE``)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (rate or OPS_RATE[name]) * 1e3
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
        with deterministic(torch):
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


#: K2 and K5 checks: (M, Kw, N, launches per main-path forward). K2's
#: main path is slice C's batch-8 forward (BinaryAlexNet's two dense
#: layers, K 9216 and 4096, N 4096), K5's slice E's batch-8 forward
#: (BinaryNet: 9 per-tap GEMMs of its first binary conv, one fused GEMM
#: for each of the other four, the two dense layers). Then the dense
#: shapes at batch 1 and a ragged shape, off the main path.
K2_CASES = ((8, 288, 4096, 1), (8, 128, 4096, 1), (1, 288, 4096, 0), (1, 128, 4096, 0),
            (37, 7, 130, 0))
K5_CASES = ((8192, 4, 128, 9), (2048, 36, 256, 1), (2048, 72, 256, 1), (512, 72, 512, 1),
            (512, 144, 512, 1), (8, 256, 1024, 1), (8, 32, 1024, 1),
            (8, 288, 4096, 0), (8, 128, 4096, 0), (1, 288, 4096, 0), (1, 128, 4096, 0),
            (37, 7, 130, 0))


def _int_mm_yardstick(torch, m, k, n, dev, g):
    """``torch._int_mm`` on int8 +-1 operands of the same product, with M
    padded to the least size the installed ``_int_mm`` takes (it refuses
    small M); returns (call, the M it ran at) or (None, None) where it
    takes no such shape."""
    if k % 8 or n % 8:
        return None, None
    b8 = torch.where(torch.rand(k, n, generator=g) < 0.5, -1, 1).to(torch.int8).to(dev)
    b8 = b8.t().contiguous().t()  # column-major, as cuBLASLt's int8 path wants it
    for rows in (m, 17, 24, 32):
        if rows < m:
            continue
        a8 = torch.where(torch.rand(rows, k, generator=g) < 0.5, -1, 1).to(torch.int8).to(dev)
        try:
            torch._int_mm(a8, b8)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (lambda: torch._int_mm(a8, b8)), rows
    return None, None


def xnor_kernel_phase(torch, bc, smi):
    """Check and time K5 and K2 against their plain versions (bit for bit)
    at the shapes of ``K5_CASES``/``K2_CASES``, K2 also against K5's
    output ``.float() * scale``; each beside ``torch._int_mm`` on int8
    +-1 operands (for K2, ``_int_mm(...).float() * scale``). Returns
    per-kernel totals over one main-path forward, as ``kernel_phase``."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                     "ops": 0.0, "max_abs_err": 0.0} for name in XNOR_KERNELS}

    def words(*shape):
        return (torch.randint(0, 2**32, shape, generator=g) - 2**31).to(torch.int32).to(dev)

    for name, cases in (("xnor_matmul_packed", K5_CASES), ("xnor_matmul_packed_scaled", K2_CASES)):
        for m, kw, n, count in cases:
            a, b = words(m, kw), words(kw, n)
            scale = (torch.randn(n, generator=g) * 0.1).to(dev)
            k_true = 32 * kw - 5
            if name == "xnor_matmul_packed":
                kernel = lambda: bc.xnor_matmul_packed(a, b, k_true=k_true)  # noqa: E731
                plain = lambda: bc.xnor_matmul_packed_plain(a, b, k_true=k_true)  # noqa: E731
            else:
                kernel = lambda: bc.xnor_matmul_packed_scaled(a, b, scale, k_true=k_true)  # noqa: E731
                plain = lambda: bc.xnor_matmul_packed_scaled_plain(  # noqa: E731
                    a, b, scale, k_true=k_true)
            with deterministic(torch):
                got, want = kernel(), plain()
                k5 = bc.xnor_matmul_packed(a, b, k_true=k_true)
                torch.cuda.synchronize()
            err = _max_abs_err(torch, got, want)
            check(_same_bits(torch, got, want),
                  f"{name} at {(m, kw, n)} disagrees with its plain version (max err {err})")
            if name == "xnor_matmul_packed_scaled":
                check(_same_bits(torch, got, k5.float() * scale[None, :]),
                      f"K2 at {(m, kw, n)} is not K5 .float() * scale bit for bit")
            mm, rows = _int_mm_yardstick(torch, m, 32 * kw, n, dev, g)
            library = None
            if mm is not None:
                library = mm if name == "xnor_matmul_packed" else (
                    lambda mm=mm: mm().float() * scale[None, :])
            k_ms = time_ms(torch, kernel)
            p_ms = time_ms(torch, plain, reps=5, inner=2)
            l_ms = time_ms(torch, library) if library is not None else None
            nbytes = m * kw * 4 + kw * n * 4 + m * n * 4 + (
                n * 4 if name == "xnor_matmul_packed_scaled" else 0)
            ops = 2 * m * n * 32 * kw
            b_ms, b_by = bound_ms(name, nbytes, ops)
            pad = "" if rows in (None, m) else f" (M padded {m} -> {rows}: _int_mm refuses M={m})"
            print(f"kernel {name} M={m} Kw={kw} N={n} on {smi}: equal bits"
                  f"{', = K5 .float() * scale' if name.endswith('scaled') else ''}, kernel "
                  f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, _int_mm "
                  f"{None if l_ms is None else round(l_ms, 6)} ms{pad}, bound {b_ms:.6f} ms by "
                  f"{b_by} ({nbytes} B, {ops} ops), launches/forward {count}", flush=True)
            t = totals[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if count:
                t["ms"] += count * k_ms
                t["plain_ms"] += count * p_ms
                t["bytes"] += count * nbytes
                t["ops"] += count * ops
                if l_ms is None or t["library_ms"] is None:
                    t["library_ms"] = None
                else:
                    t["library_ms"] += count * l_ms
            del a, b, got, want, k5
    torch.cuda.empty_cache()
    return totals


def _same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bits: a float's bit pattern tells -0 from
    +0 and compares a NaN by its bits (``torch.equal`` calls no NaN
    equal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def _max_abs_err(torch, got, want) -> float:
    """Largest finite difference (0 for tensors with equal bits)."""
    if not got.is_floating_point():
        got, want = got.to(torch.int64), want.to(torch.int64)
    d = (got.double() - want.double()).abs()
    d = d[torch.isfinite(d)]
    return d.max().item() if d.numel() else 0.0


def resid_kernel_phase(torch, bc):
    """Check and time K6 (sign and mask mode), K7 and K8 at the four
    section shapes of the batch-128 bf16 training step, and at ragged and
    edge cases off the main path. Returns per-kernel totals over one
    training step's launches, as :func:`kernel_phase` does."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    totals = {
        name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0.0,
               "ops": 0.0, "max_abs_err": 0.0}
        for name in RESID_KERNELS
    }

    def record(name, count, kernel, plain, nbytes, ops, label):
        with deterministic(torch):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        check(_same_bits(torch, got, want),
              f"{name} at {label} disagrees with its plain version (max err {err})")
        k_ms, p_ms = time_ms(torch, kernel), time_ms(torch, plain, reps=21, inner=2)
        b_ms, b_by = bound_ms(name, nbytes, ops)
        print(f"kernel {name} {label}: equal bits, kernel {k_ms:.6f} ms, plain "
              f"{p_ms:.6f} ms, library none, bound {b_ms:.6f} ms by {b_by} "
              f"({nbytes} B, {ops} ops), launches/step {count}", flush=True)
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += count * k_ms
        t["plain_ms"] += count * p_ms
        t["bytes"] += count * nbytes
        t["ops"] += count * ops

    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                          1.0, -1.0, 1e-40, -1e-40])

    def values(shape, dtype, with_edges):
        v = torch.randn(*shape, generator=g) * 1.5
        if with_edges:
            pick = torch.rand(*shape, generator=g) < 0.25
            v[pick] = edges[torch.randint(len(edges), (int(pick.sum()),), generator=g)]
        return v.to(dtype).to(dev)

    def run_cases(count, shape, dtype, with_edges):
        b, h, w, c = bc._to_4d_shape(shape)
        n, groups, esize = h * w * c, -(-b // 32), torch.tensor([], dtype=dtype).element_size()
        label = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
        x = values(shape, dtype, with_edges)  # the block input (mask mode)
        if with_edges:
            x_sign = values(shape, dtype, True)  # sign mode beyond +-1
        else:
            x_sign = torch.where(torch.rand(*shape, generator=g) < 0.5, -1.0, 1.0).to(dtype).to(dev)
        io = b * n * esize + groups * n * 4
        record("pack_resid", count, lambda: bc.pack_resid(x_sign),
               lambda: bc.pack_resid_plain(x_sign), io, b * n, f"{label} sign")
        record("pack_resid", count, lambda: bc.pack_resid(x, mask_mode=True),
               lambda: bc.pack_resid_plain(x, mask_mode=True), io, b * n, f"{label} mask")
        words = bc.pack_resid_plain(x_sign)
        if with_edges:  # every bit random, the batch pad's included
            words = (torch.randint(0, 2**32, words.shape, generator=g) - 2**31).to(torch.int32).to(dev)
        record("unpack_resid_pm1", count, lambda: bc.unpack_resid_pm1(words, shape, dtype),
               lambda: bc.unpack_resid_pm1_plain(words, shape, dtype), io, b * n, label)
        cot = values(shape, dtype, with_edges)
        mask = bc.pack_resid_plain(x, mask_mode=True)
        record("mask_mul_resid", count, lambda: bc.mask_mul_resid(cot, mask),
               lambda: bc.mask_mul_resid_plain(cot, mask), io + b * n * esize, b * n, label)

    for convs, h, c in SECTIONS:
        run_cases(convs, (TRAIN_BATCH, h, h, c), torch.bfloat16, False)
    for shape, dtype in (((37, 5, 7, 24), torch.bfloat16), ((37, 96), torch.float32),
                         ((33, 2, 3, 5, 7), torch.bfloat16)):
        run_cases(0, shape, dtype, True)
    for name in RESID_KERNELS:
        print(f"kernel {name}: {RESID_PER_CONV[name] * sum(s[0] for s in SECTIONS)} "
              f"launches per training step", flush=True)
    return totals


def int8_exact_phase(torch, bc):
    """The int8 conv's forward on the card (a float32 conv of the +-1
    operands, TF32 allowed, then one fp32 scale multiply) must give the
    exact integer sums at every section shape of the batch-128 step:
    held bit for bit against a float64 conv, exact for |sums| <= 9 * 512,
    times the same scale."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    print(f"int8 conv: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    for _, h, c in SECTIONS:
        x = torch.where(torch.rand(TRAIN_BATCH, h, h, c, generator=g) < 0.5, -1.0, 1.0)
        x = x.to(torch.bfloat16).to(dev)
        sign = torch.where(torch.rand(3, 3, c, c, generator=g) < 0.5, -1.0, 1.0)
        scale = torch.rand(c, generator=g) + 0.1
        k = (sign * scale).to(dev)
        got = bc._int8_conv_forward(x, k, (1, 1), "SAME", 1, True)
        with deterministic(torch):
            sums = F.conv2d(x.double().permute(0, 3, 1, 2),
                            sign.double().permute(3, 2, 0, 1).to(dev), padding=1)
            want = sums.permute(0, 2, 3, 1).float() * k.abs().amax(dim=(0, 1, 2))
            torch.cuda.synchronize()
        check(_same_bits(torch, got, want),
              f"int8 conv at {tuple(x.shape)}: not the exact integer sums "
              f"(max err {_max_abs_err(torch, got, want)})")
        ms = time_ms(torch, lambda: bc._int8_conv_forward(x, k, (1, 1), "SAME", 1, True),
                     reps=5, inner=3)
        print(f"int8 conv {tuple(x.shape)}: exact integer sums "
              f"(max |sum| {sums.abs().max().item():.0f}), {ms:.6f} ms", flush=True)


def _plain_binary(bc):
    """The binary kernels' wrappers swapped for their plain versions."""
    return mock.patch.multiple(
        bc, pack_rows=bc.pack_rows_plain, conv_gemm_popcount=bc.conv_gemm_popcount_plain,
        packed_weight_matmul=bc.packed_weight_matmul_plain,
        xnor_matmul_packed=bc.xnor_matmul_packed_plain,
        xnor_matmul_packed_scaled=bc.xnor_matmul_packed_scaled_plain,
    )


def slice_phase(torch, bc, label: str, smi: str):
    """Serve seeded requests through the port's ServingConfig with slice
    ``label``'s settings; check every forward's launches (by its batch
    bucket), the logits, and that they equal the plain path's. Returns
    (launches by kernel, timings, the config)."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import InferenceEngine, ServingConfig

    settings, per_forward = SLICES[label]
    cfg = ServingConfig()
    configure(cfg, {
        "engine.batch_buckets": (1, BATCH), "requests": 16, "max_request": BATCH,
        "seed": 0, "device": "cuda", "verbose": False, **settings,
    })
    buckets = []
    real_infer = InferenceEngine.infer

    def spy(engine, x):
        buckets.append(engine.bucket_for(len(x)))
        return real_infer(engine, x)

    t0 = time.perf_counter()
    bc.reset_launches()
    with mock.patch.object(InferenceEngine, "infer", spy):
        result = cfg.run()  # build, pack, warm both buckets, serve the stream
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    print(f"slice {label}: served {result['requests']} requests in "
          f"{int(result['dispatches'])} dispatches, {len(buckets)} forwards (buckets "
          f"{ {b: buckets.count(b) for b in sorted(set(buckets))} }), launches {launches}, "
          f"run {time.perf_counter() - t0:.1f} s", flush=True)
    for name in bc.LAUNCHES:
        want = sum(per_forward(b).get(name, 0) for b in buckets)
        check(launches[name] == want,
              f"slice {label}: {name} launched {launches[name]} times, want {want}")

    engine = cfg.engine
    shape = (BATCH, *cfg.input_shape)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    with deterministic(torch):
        logits = engine.infer(x)
        torch.cuda.synchronize()
        check(tuple(logits.shape) == (BATCH, cfg.num_classes),
              f"slice {label}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"slice {label}: non-finite logits")
        before = dict(bc.LAUNCHES)
        with _plain_binary(bc):
            plain = engine.infer(x)
        torch.cuda.synchronize()
    check(bc.LAUNCHES == before,
          f"slice {label}: the plain-path forward launched kernels "
          f"({before} -> {bc.LAUNCHES}), so it is no plain reference")
    check(torch.equal(logits, plain),
          f"slice {label}: kernel-path logits differ from the plain path "
          f"(max {(logits - plain).abs().max().item()})")
    if label == "E":
        _e_flavor_check(torch, bc, engine, x, logits)
    if label == "D":
        _d_conversion_check(cfg)

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
    print(f"slice {label} on {smi}: logits equal to the plain path; " + json.dumps(stats),
          flush=True)
    del cfg, engine
    torch.cuda.empty_cache()
    return launches, stats


def _e_flavor_check(torch, bc, engine, x, logits):
    """Slice E's model under binary_flavor="auto" (the same weights):
    K1 + K3 convs and K1 + K2 dense instead of K5, and the same logits bit
    for bit (the flavors share their integer sums and their one fp32
    multiply)."""
    layers = [m for m in engine._module.modules() if hasattr(m, "binary_flavor")]
    for m in layers:
        m.binary_flavor = "auto"
    try:
        with deterministic(torch):
            bc.reset_launches()
            auto = engine.infer(x)
            torch.cuda.synchronize()
        got = {k: v for k, v in bc.LAUNCHES.items() if v}
    finally:
        for m in layers:
            m.binary_flavor = "reference"
    check(got == E_AUTO, f"slice E under binary_flavor=auto launched {got}, want {E_AUTO}")
    check(_same_bits(torch, auto, logits),
          f"slice E: binary_flavor=auto logits differ from reference's "
          f"(max {_max_abs_err(torch, auto, logits)})")
    print(f"slice E: the same model under binary_flavor=auto launched {got} and gave the "
          f"reference flavor's logits bit for bit", flush=True)


def _d_conversion_check(cfg):
    """Slice D's deployment without the fold converts exactly the two
    dense kernels, as the JAX package's test asserts."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import BinaryAlexNet
    from zookeeper_tpu_torch.models.convert import to_flax_variables
    from zookeeper_tpu_torch.ops.packed import pack_quantconv_params

    model = BinaryAlexNet()
    configure(model, {"compute_dtype": "bfloat16", "binary_compute": "mxu",
                      "dense_binary_compute": "xnor", "dense_packed_weights": True},
              name="model")
    module = model.build(cfg.input_shape, cfg.num_classes)
    params, _ = to_flax_variables(model.initialize(module.float_twin(), seed=0))
    template, _ = to_flax_variables(module)
    packed = pack_quantconv_params(params, template=template)
    converted = sorted(k for k, v in packed.items() if "kernel_packed" in v)
    check(converted == ["QuantDense_0", "QuantDense_1"],
          f"slice D without the fold converted {converted}")
    print(f"slice D: without the fold the template converts exactly {converted}", flush=True)


def _snapshot(state):
    """Copies of everything a train step changes."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    opt = state.opt_state
    return (clone(state.module.state_dict()), clone(opt["mu"]), clone(opt["nu"]),
            opt["count"], state.step)


def _restore(state, snap) -> None:
    module_state, mu, nu, count, step = snap
    state.module.load_state_dict(module_state)
    for key, saved in (("mu", mu), ("nu", nu)):
        for name, t in state.opt_state[key].items():
            t.copy_(saved[name])
    state.opt_state["count"], state.step = count, step


def training_phase(torch, bc, smi):
    """TrainImageNet's QuickNet-Large int8 step with 1-bit residuals:
    launches, finiteness and bit equality against the plain-kernel step
    and the unpacked step from one fixed state; then device time, peak
    memory, the profiler's top items and images/s through ``run()``.
    Returns (launches per step, stats)."""
    from torch.profiler import ProfilerActivity, profile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.imagenet import TrainImageNet

    dev = torch.device("cuda")

    def experiment(pack: bool, epochs: int = 1):
        exp = TrainImageNet()
        configure(exp, {
            "model": "QuickNetLarge",
            "model.compute_dtype": "bfloat16",
            "model.binary_compute": "int8",
            "model.pack_residuals": pack,
            "loader.dataset.num_train_examples": TRAIN_EXAMPLES,
            "batch_size": TRAIN_BATCH, "epochs": epochs, "steps_per_epoch": 3,
            "validate": False, "seed": 0, "device": "cuda", "verbose": False,
        }, name="experiment")
        return exp

    t0 = time.perf_counter()
    exp = experiment(True, epochs=2)
    state = exp.build_state(dev)
    batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
    batch = next(batches)
    batches.close()
    step = exp._train_step_fn()
    # The fixed state takes Adam's count at 1: the warmup schedule's rate
    # is 0 at count 0, and the parameters would not move.
    state.opt_state["count"] = 1
    init = _snapshot(state)
    param_names = [name for name, _ in state.module.named_parameters()]
    n_params = sum(p.numel() for p in state.module.parameters())
    print(f"training: QuickNet-Large ({n_params} parameters) built, "
          f"{TRAIN_EXAMPLES} synthetic ImageNet examples made and one batch "
          f"{tuple(batch['input'].shape)} staged in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def traced_step(st):
        """One step from ``st``; returns its loss, gradients, module state
        (parameters and BatchNorm statistics) and Adam moments."""
        grads = {}
        real = st.tx.update

        def spy(g, opt_state, params):
            grads.update({k: v.detach().clone() for k, v in g.items()})
            real(g, opt_state, params)

        st.tx.update = spy
        try:
            _, metrics = step(st, batch)
        finally:
            del st.tx.update
        torch.cuda.synchronize()
        out = {"loss": metrics["loss"].clone()}
        out.update({f"grad {k}": v for k, v in grads.items()})
        out.update({f"state {k}": v.detach().clone() for k, v in st.module.state_dict().items()})
        for key in ("mu", "nu"):
            out.update({f"{key} {k}": v.clone() for k, v in st.opt_state[key].items()})
        return out

    def same(a, b, label):
        bad = [k for k in a if not _same_bits(torch, a[k], b[k])]
        check(set(a) == set(b) and not bad,
              f"training: {label} differs from the kernel step in {len(bad)} of "
              f"{len(a)} tensors, e.g. {bad[:4]}")
        print(f"training: {label} equals the kernel step bit for bit "
              f"({len(a)} tensors: loss, gradients, parameters, BN statistics, "
              f"Adam moments)", flush=True)

    exp_off = experiment(False)
    state_off = exp_off.build_state(dev)
    with deterministic(torch):
        # (a) the kernel path, from the fixed state.
        _restore(state, init)
        bc.reset_launches()
        res_a = traced_step(state)
        launches = {name: bc.LAUNCHES[name] for name in RESID_KERNELS}
        copies = dict(bc.COPIES)
        for name in bc.LAUNCHES:
            want = RESID_PER_CONV.get(name, 0) * sum(s[0] for s in SECTIONS)
            check(bc.LAUNCHES[name] == want,
                  f"training: {name} launched {bc.LAUNCHES[name]} times in one step, want {want}")
        loss = res_a["loss"].item()
        check(math.isfinite(loss), f"training: loss {loss} is not finite")
        moved = sum(not _same_bits(torch, res_a[f"state {n}"], init[0][n]) for n in param_names)
        check(moved > 0, "training: the step moved no parameter")
        print(f"training: one step, loss {loss:.6f}, launches {launches}, "
              f"strided inputs copied {copies}, {moved} of {len(param_names)} "
              f"parameter tensors moved", flush=True)

        # (b) the three wrappers swapped for their plain versions.
        _restore(state, init)
        before = dict(bc.LAUNCHES)
        with mock.patch.multiple(
            bc, pack_resid=bc.pack_resid_plain,
            unpack_resid_pm1=bc.unpack_resid_pm1_plain,
            mask_mul_resid=bc.mask_mul_resid_plain,
        ):
            res_b = traced_step(state)
        check(bc.LAUNCHES == before,
              f"training: the plain-kernel step launched kernels ({before} -> {bc.LAUNCHES})")
        same(res_a, res_b, "the plain-kernel step")
        del res_b

        # (c) pack_residuals=False, from the same state.
        _restore(state_off, init)
        bc.reset_launches()
        res_c = traced_step(state_off)
        check(all(bc.LAUNCHES[n] == 0 for n in RESID_KERNELS),
              f"training: the unpacked step launched residual kernels {bc.LAUNCHES}")
        same(res_a, res_c, "the pack_residuals=False step")
        del res_a, res_c

    # Peak memory of one step from the fixed state, pack on and off, in
    # the default settings.
    peaks = {}
    for pack, st in ((True, state), (False, state_off)):
        _restore(st, init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(st, batch)
        torch.cuda.synchronize()
        peaks[pack] = (base, torch.cuda.max_memory_allocated())
    (base_on, peak_on), (base_off, peak_off) = peaks[True], peaks[False]
    gib = 2.0**30
    memory = {
        "peak_gib_pack_on": peak_on / gib, "peak_gib_pack_off": peak_off / gib,
        "step_gib_pack_on": (peak_on - base_on) / gib,
        "step_gib_pack_off": (peak_off - base_off) / gib,
    }
    # The step's own memory (peak over what was allocated before it) is
    # compared: both peaks also hold the two train states and the
    # snapshot.
    check(peak_on - base_on < peak_off - base_off,
          f"training: the step's peak memory with packed residuals "
          f"{peak_on - base_on} B is not below the unpacked step's "
          f"{peak_off - base_off} B")
    print(f"training: peak memory {json.dumps(memory)}", flush=True)

    # Device time of one step on a device-resident batch, pack on and off
    # in turns (on, off, off, on), three steps each after a warm step;
    # the host clock around step + synchronize beside it.
    times = {True: [], False: []}
    walls = {True: [], False: []}
    for pack in (True, False, False, True):
        st = state if pack else state_off
        step(st, batch)
        torch.cuda.synchronize()
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            start.record()
            step(st, batch)
            end.record()
            end.synchronize()
            walls[pack].append((time.perf_counter() - t1) * 1e3)
            times[pack].append(start.elapsed_time(end))
    step_ms = {"step_ms_pack_on": statistics.median(times[True]),
               "step_ms_pack_off": statistics.median(times[False]),
               "step_wall_ms_pack_on": statistics.median(walls[True]),
               "step_wall_ms_pack_off": statistics.median(walls[False])}
    print(f"training: time per step {json.dumps(step_ms)} (device, all: "
          f"{json.dumps({str(k): v for k, v in times.items()})})", flush=True)
    del state_off, exp_off
    torch.cuda.empty_cache()

    # The profiler's kernels for one step (pack on): their summed device
    # time against the step's device time gives the busy share.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    attr = ("self_device_time_total" if hasattr(prof.key_averages()[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    launched = sum(e.count for e in kernels)
    busy_share = busy_ms / step_ms["step_ms_pack_on"]
    print(f"training profile: {launched} device activities, {busy_ms:.3f} ms "
          f"busy, {100 * busy_share:.1f}% of the {step_ms['step_ms_pack_on']:.3f} "
          f"ms step; top items:", flush=True)
    for e in sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:15]:
        t = getattr(e, attr) / 1e3
        print(f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{e.count:<5d} {e.key[:110]}",
              flush=True)

    # images/s through run(): two epochs of three steps, host pipeline
    # (RandomResizedCrop on 8 worker threads, pinned prefetch) included.
    bc.reset_launches()
    history = exp.run()
    torch.cuda.synchronize()
    steps = 2 * 3
    for name in RESID_KERNELS:
        want = RESID_PER_CONV[name] * sum(s[0] for s in SECTIONS) * steps
        check(bc.LAUNCHES[name] == want,
              f"training run(): {name} launched {bc.LAUNCHES[name]} times, want {want}")
    losses = [e["loss"] for e in history["train"]]
    check(all(math.isfinite(v) for v in losses), f"training run(): losses {losses}")
    run_stats = {f"images_per_s_epoch{i + 1}": e["examples_per_sec"]
                 for i, e in enumerate(history["train"])}
    print(f"training run(): losses {losses}, {json.dumps(run_stats)}", flush=True)
    stats = {**step_ms, **memory, **run_stats, "device_busy_ms": busy_ms,
             "device_busy_share": busy_share, "device_activities_per_step": launched}
    print(f"training on {smi}: {json.dumps(stats)}", flush=True)
    del exp, state
    torch.cuda.empty_cache()
    return launches, stats


#: The LM serving slice: the long-context TransformerLM of
#: examples/lm_experiment.py served as examples/serve_lm.py serves it.
LM_CONFIG = {
    "model.num_layers": 4, "model.d_model": 512, "model.num_heads": 8,
    "model.mlp_ratio": 4, "model.compute_dtype": "bfloat16",
    "seq_len": 8192, "vocab_size": 1024,
    "engine.slots": 8, "engine.seq_buckets": (512, 2048), "engine.prefill_buckets": (1,),
    "engine.page_size": 16, "engine.decode_attention": "auto",
    "requests": 32, "max_prompt": 2048, "new_tokens": 64, "seed": 0,
    "device": "cuda", "verbose": False,
}
LM_LAYERS, LM_HEADS, LM_HEAD_DIM, LM_SLOTS, LM_CAP, LM_PAGE = 4, 8, 64, 8, 8192, 16
PAGED = {"engine.kv_layout": "paged", "engine.prefix_cache": False}
LM_RUNS = (("slots", {}), ("paged", PAGED), ("paged-int8", {**PAGED, "engine.kv_quant": "int8"}))
#: Lengths of the K12/K13 checks: row-0-only, page edges, the capacity
#: edge, and one past capacity (clamped).
LM_CHECK_LENGTHS = (0, 1, 15, 16, 2047, 8191, 9000, 4000)


def _bf16_step_ok(torch, got, want) -> bool:
    """bf16 outputs of two fp32 computations that differ only in the
    order of their sums: equal up to one bf16 rounding step of the
    value (2^-7 relative), plus 1e-5 for values near 0."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= w.abs() * 2.0**-7 + 1e-5).all())


def _bf16_flash_use(torch, got, want) -> float:
    """How much of the bf16 K9 limit the worst element uses: max of
    |got - want| / (2^-6 |want| + 2e-3). The limit scales with each
    output value (a causal row over n keys of unit-variance values has
    |o| near sqrt(e / n)), with 2e-3 for values that cancel to near 0;
    ok when at most 1."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (w.abs() * 2.0**-6 + 2e-3)).max())


def lm_kernel_phase(torch, A):
    """Check K9, K12 and K13 against their plain versions and time them
    beside it and beside SDPA. Returns {label: per-launch record}."""
    import torch.nn.functional as F

    from zookeeper_tpu_torch.ops.quantizers import quantize_kv_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    records = {}
    max_err = dict.fromkeys(LM_KERNELS, 0.0)

    def record(name, label, kernel, plain, library, nbytes, ops, rate, dtype, heavy=False):
        with deterministic(torch):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if dtype == torch.float32:
            tol = 2e-5 if name == "flash_forward" else 2e-6
            ok = err <= tol
        elif name == "flash_forward":
            use = _bf16_flash_use(torch, got, want)
            tol, ok = f"2^-6|want| + 2e-3 per element (used {use:.3g})", use <= 1 and err <= 3e-2
        else:
            tol, ok = "one bf16 step", _bf16_step_ok(torch, got, want)
        check(ok, f"{name} at {label} disagrees with its plain version (max err {err}, "
                  f"tolerance {tol})")
        reps, inner = (5, 3) if heavy else (21, 10)
        k_ms = time_ms(torch, kernel, reps=reps, inner=inner)
        p_ms = time_ms(torch, plain, reps=5, inner=2)
        l_ms = time_ms(torch, library, reps=reps, inner=inner) if library is not None else None
        b_ms, b_by = bound_ms(name, nbytes, ops, rate)
        print(f"kernel {name} {label}: max err {err:.3g} (tol {tol}), kernel {k_ms:.6f} ms, "
              f"plain {p_ms:.6f} ms, library {l_ms if l_ms is None else round(l_ms, 6)} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops)", flush=True)
        max_err[name] = max(max_err[name], err)
        records[(name, label)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                                  "ops_ms": ops / rate * 1e3}

    # K9: (b, s, dtype, causal); the prefill buckets first.
    for b, s, dtype, causal in ((1, 512, torch.bfloat16, True), (1, 2048, torch.bfloat16, True),
                                (4, 8192, torch.bfloat16, True), (1, 512, torch.float32, True),
                                (1, 999, torch.bfloat16, True), (1, 2048, torch.bfloat16, False)):
        h, d = LM_HEADS, LM_HEAD_DIM
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        size = q.element_size()
        record("flash_forward", f"[{b}, {s}, {h}, {d}] {str(dtype)[6:]} causal={causal}",
               lambda: A.flash_attention(q, k, v, causal=causal),
               lambda: A.flash_attention_plain(q, k, v, causal=causal),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
               4 * b * s * h * d * size, 4 * d * pairs,
               BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S, dtype,
               heavy=s >= 8192)

    # K12: slot caches [8, 8192, 8, 64], lengths at the edges.
    lengths = torch.tensor(LM_CHECK_LENGTHS, dtype=torch.int32, device=dev)
    live = int((lengths.clamp(0, LM_CAP - 1) + 1).sum())
    for dtype in (torch.bfloat16, torch.float32):
        shape = (LM_SLOTS, LM_CAP, LM_HEADS, LM_HEAD_DIM)
        q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM, generator=g, device=dev).to(dtype)
        kc = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vc = torch.randn(*shape, generator=g, device=dev).to(dtype)
        record("paged_decode_attention", f"{list(shape)} {str(dtype)[6:]}",
               lambda: A.paged_decode_attention(q, kc, vc, lengths),
               lambda: A.cached_attention(q, kc, vc, lengths),
               _sdpa_decode(torch, q, kc, vc, lengths),
               *_decode_work(q, live, kc.element_size()), FP32_OPS_PER_S, dtype)
        del kc, vc

    # K13: a pool of 4096 pages of 16, shuffled tables with -1 entries.
    pages, max_pages = 4096, LM_CAP // LM_PAGE
    cpu_g = torch.Generator().manual_seed(3)
    table = torch.randperm(pages, generator=cpu_g)[: LM_SLOTS * max_pages].reshape(LM_SLOTS, max_pages)
    table[torch.rand(LM_SLOTS, max_pages, generator=cpu_g) < 0.1] = -1
    table = table.to(torch.int32).to(dev)
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        shape = (pages, LM_PAGE, LM_HEADS, LM_HEAD_DIM)
        q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM, generator=g, device=dev).to(dtype)
        kp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        kw = {}
        if quant:
            (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
            kw = {"k_scale": ks, "v_scale": vs}
        nbytes, ops = _decode_work(q, live, kp.element_size(), scales=quant)
        record("pool_paged_decode_attention",
               f"{list(shape)} {'int8 rows, q ' if quant else ''}{str(dtype)[6:]}",
               lambda: A.pool_paged_decode_attention(q, kp, vp, table, lengths, **kw),
               lambda: A.pool_decode_attention(q, kp, vp, table, lengths, **kw),
               None, nbytes + table.numel() * 4, ops, FP32_OPS_PER_S, dtype)
        del kp, vp

    # K12/K13 at head_dims that are not multiples of 8 (off the JAX
    # kernel's geometry; the port's kernels serve any head_dim, so the
    # engine never leaves them) and past 256 (264 and 384 run in 256-dim
    # chunks; 264 int8 rows are not 16-byte multiples): 8 slots, capacity
    # 512, 4 heads.
    cap, heads = 512, 4
    odd_lengths = torch.tensor((0, 1, 15, 16, 100, 511, 600, 300), dtype=torch.int32, device=dev)
    odd_live = int((odd_lengths.clamp(0, cap - 1) + 1).sum())
    pages = 256
    table = torch.randperm(pages, generator=cpu_g)[: LM_SLOTS * (cap // LM_PAGE)].reshape(
        LM_SLOTS, cap // LM_PAGE)
    table[torch.rand(table.shape, generator=cpu_g) < 0.1] = -1
    table = table.to(torch.int32).to(dev)
    for d in (20, 100, 264, 384):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(LM_SLOTS, 1, heads, d, generator=g, device=dev).to(dtype)
            kc, vc = (torch.randn(LM_SLOTS, cap, heads, d, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            record("paged_decode_attention", f"[{LM_SLOTS}, {cap}, {heads}, {d}] {str(dtype)[6:]}",
                   lambda: A.paged_decode_attention(q, kc, vc, odd_lengths),
                   lambda: A.cached_attention(q, kc, vc, odd_lengths),
                   _sdpa_decode(torch, q, kc, vc, odd_lengths),
                   *_decode_work(q, odd_live, kc.element_size()), FP32_OPS_PER_S, dtype)
            for quant in (False, True):
                kp, vp = (torch.randn(pages, LM_PAGE, heads, d, generator=g, device=dev).to(dtype)
                          for _ in range(2))
                kw = {}
                if quant:
                    (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
                    kw = {"k_scale": ks, "v_scale": vs}
                nbytes, ops = _decode_work(q, odd_live, kp.element_size(), scales=quant)
                record("pool_paged_decode_attention",
                       f"[{pages}, {LM_PAGE}, {heads}, {d}] "
                       f"{'int8 rows, q ' if quant else ''}{str(dtype)[6:]}",
                       lambda: A.pool_paged_decode_attention(q, kp, vp, table, odd_lengths, **kw),
                       lambda: A.pool_decode_attention(q, kp, vp, table, odd_lengths, **kw),
                       None, nbytes + table.numel() * 4, ops, FP32_OPS_PER_S, dtype)
    torch.cuda.empty_cache()
    return records, max_err


def _decode_work(q, live_rows: int, kv_size: int, scales: bool = False):
    """(bytes, ops) of one decode-attention call: q read and o written
    once, each live K/V row (and its scales) read once, lengths; 4
    flops per K/V value (a multiply-add each for q.k and p.v)."""
    b, _, h, d = q.shape
    per_row = 2 * h * (d * kv_size + (4 if scales else 0))
    return 2 * b * h * d * q.element_size() + live_rows * per_row + 4 * b, 4 * live_rows * h * d


def _sdpa_decode(torch, q, k_cache, v_cache, lengths):
    """The library yardstick of K12: SDPA with a boolean mask over the
    whole capacity (it reads every row)."""
    import torch.nn.functional as F

    cap = k_cache.shape[1]
    mask = (torch.arange(cap, device=q.device)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _lm_config(overrides):
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import LMServingConfig

    cfg = LMServingConfig()
    configure(cfg, {**LM_CONFIG, **overrides})
    return cfg


def _profile_step(torch, engine, tokens, lengths):
    """One decode step under torch.profiler: (wall ms, device busy ms,
    device activities, top items)."""
    from torch.profiler import ProfilerActivity, profile

    engine.decode(tokens, lengths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode(tokens, lengths)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:8]
    return wall_ms, busy_ms, sum(e.count for e in kernels), [
        (getattr(e, attr) / 1e3, e.count, e.key[:100]) for e in top]


def lm_serving_phase(torch, A, smi):
    """Drive LMServingConfig.run() in the three layouts; check launches
    and outputs; profile one decode step; time K12/K13 at a mid-run
    step's real cache, lengths and table. Returns (launches by kernel,
    per-run stats, main-path records)."""
    import numpy as np

    from zookeeper_tpu_torch.serving.decode import DecodeEngine

    launches = dict.fromkeys(LM_KERNELS, 0)
    stats, main = {}, {}
    for label, overrides in LM_RUNS:
        cfg = _lm_config(overrides)
        steps = []
        real_decode = DecodeEngine.decode

        def spy(engine, tokens, lengths, _real=real_decode):
            pool = engine.page_pool
            steps.append((np.array(tokens), np.array(lengths),
                          None if pool is None else pool.table.copy()))
            return _real(engine, tokens, lengths)

        A.reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(DecodeEngine, "decode", spy):
            result = cfg.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = dict(A.LAUNCHES)
        kernel = "paged_decode_attention" if label == "slots" else "pool_paged_decode_attention"
        prefills = int(result["prefills_total"]) + 2  # + the warmup of both buckets
        decodes = int(result["decode_steps_total"]) + 1  # + the warmup step
        print(f"lm {label}: {json.dumps(result)}", flush=True)
        print(f"lm {label}: launches {got}; per prefill dispatch "
              f"{got['flash_forward'] / prefills}, per decode step {got[kernel] / decodes} "
              f"({prefills} prefills, {decodes} decode steps with warmup; run {run_s:.1f} s "
              f"with build and warmup)", flush=True)
        check(result["decode_attention"] == "kernel",
              f"lm {label}: decode attention resolved to {result['decode_attention']}")
        for name in LM_KERNELS:
            want = (LM_LAYERS * prefills if name == "flash_forward"
                    else LM_LAYERS * decodes if name == kernel else 0)
            check(got[name] == want, f"lm {label}: {name} launched {got[name]} times, want {want}")
            launches[name] += got[name]
        check(all(got[name] == 0 for name in LM_TRAIN_KERNELS),
              f"lm {label}: serving launched training kernels {got}")
        check(result["generated_tokens"] == LM_CONFIG["requests"] * LM_CONFIG["new_tokens"],
              f"lm {label}: {result['generated_tokens']} tokens generated")
        outputs = np.concatenate(cfg.outputs)
        check(outputs.min() >= 0 and outputs.max() < LM_CONFIG["vocab_size"],
              f"lm {label}: tokens outside the vocabulary")

        engine = cfg.engine
        tokens, lengths, table = steps[len(steps) // 2]
        if table is not None:
            engine.page_pool.table[:] = table
        wall_ms, busy_ms, acts, top = _profile_step(torch, engine, tokens, lengths)
        print(f"lm {label} decode step profile (lengths {lengths.tolist()}): wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
              f"{acts} device activities; top items:", flush=True)
        for t, count, key in top:
            print(f"  {t:9.4f} ms x{count:<4d} {key}", flush=True)
        stats[label] = {
            "tokens_per_sec": result["tokens_per_sec"], "ttft_p50_ms": result["ttft_p50_ms"],
            "ttft_p99_ms": result["ttft_p99_ms"], "itl_p50_ms": result["itl_p50_ms"],
            "itl_p99_ms": result["itl_p99_ms"], "token_p50_ms": result["token_p50_ms"],
            "decode_mbu": result["decode_mbu"], "step_wall_ms": wall_ms,
            "step_busy_ms": busy_ms, "step_busy_share": busy_ms / wall_ms,
            "step_device_activities": acts,
        }
        if label != "paged-int8":
            main[kernel] = _time_main_step(torch, A, engine, kernel, lengths, table)
        if label == "slots":
            buckets = [engine.seq_bucket_for(p.shape[0])
                       for p in cfg.prompts(min(cfg.max_prompt, engine.max_prompt))]
            main["buckets"] = {sb: buckets.count(sb) / len(buckets) for sb in set(buckets)}
        del cfg, engine
        torch.cuda.empty_cache()
    print(f"lm serving on {smi}: {json.dumps(stats)}", flush=True)
    return launches, stats, main


def _time_main_step(torch, A, engine, kernel, lengths, table):
    """K12 or K13 at one decode step of the run: layer 0's real cache,
    the step's lengths (and table), a seeded q. Per launch."""
    import numpy as np

    dev = engine.device
    layer = engine.cache[0]
    q = torch.randn(LM_SLOTS, 1, LM_HEADS, LM_HEAD_DIM,
                    generator=torch.Generator().manual_seed(4)).to(torch.bfloat16).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    live = int((np.clip(lengths, 0, engine.capacity - 1) + 1).sum())
    if kernel == "paged_decode_attention":
        fn = lambda: A.paged_decode_attention(q, layer["k"], layer["v"], lens)  # noqa: E731
        plain = lambda: A.cached_attention(q, layer["k"], layer["v"], lens)  # noqa: E731
        library = _sdpa_decode(torch, q, layer["k"], layer["v"], lens)
        nbytes, ops = _decode_work(q, live, 2)
    else:
        tab = torch.from_numpy(table).to(dev)
        fn = lambda: A.pool_paged_decode_attention(q, layer["k"], layer["v"], tab, lens)  # noqa: E731
        plain = lambda: A.pool_decode_attention(q, layer["k"], layer["v"], tab, lens)  # noqa: E731
        library = None
        nbytes, ops = _decode_work(q, live, 2)
        nbytes += tab.numel() * 4
    with deterministic(torch):
        got, want = fn(), plain()
        err = _max_abs_err(torch, got, want)
    check(_bf16_step_ok(torch, got, want),
          f"{kernel} at a mid-run decode step disagrees with its plain version (max err "
          f"{err}, tolerance one bf16 step)")
    rec = {"ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain, reps=5, inner=2),
           "library_ms": time_ms(torch, library) if library is not None else None}
    rec["bound_ms"], rec["bound_by"] = bound_ms(kernel, nbytes, ops)
    print(f"kernel {kernel} at a mid-run decode step ({live} live rows of {LM_SLOTS} slots): "
          f"max err {err:.3g}, {json.dumps(rec)}", flush=True)
    return rec


def _serve_stream(engine_cls, sched_cls, configure, module, layout, prompts, budgets):
    engine = engine_cls()
    configure(engine, {"slots": LM_SLOTS, "seq_buckets": (512, 2048), "page_size": LM_PAGE,
                       "decode_attention": "kernel", **layout}, name="engine")
    engine.bind(module, device="cuda")
    sched = sched_cls()
    configure(sched, {}, name="sched")
    sched.bind(engine)
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    out = [s.result() for s in streams]
    del engine, sched
    return out


def _plain_attention(A):
    """The three kernel wrappers swapped for their plain versions."""
    return mock.patch.multiple(A, flash_attention=A.flash_attention_plain,
                               paged_decode_attention=A.cached_attention,
                               pool_paged_decode_attention=A.pool_decode_attention)


def lm_parity_phase(torch, A):
    """fp32: kernel path == plain path == greedy_decode, both layouts,
    with slot refills. bf16: count agreeing tokens; each disagreement
    must sit where the plain path's top-two logit gap is below 0.05."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models.transformer import TransformerLM, greedy_decode
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler

    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 1024, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 700, size=12)]
    budgets = [int(b) for b in rng.integers(1, 17, size=12)]
    summary = {}
    for dtype in ("float32", "bfloat16"):
        model = TransformerLM()
        configure(model, {"num_layers": 4, "d_model": 512, "num_heads": 8, "mlp_ratio": 4,
                          "compute_dtype": dtype}, name="model")
        module = model.initialize(model.build((8192,), 1024), seed=0).cuda()
        for label, layout in (("slots", {}), ("paged", {"kv_layout": "paged",
                                                        "prefix_cache": False})):
            with deterministic(torch):
                A.reset_launches()
                kern = _serve_stream(DecodeEngine, DecodeScheduler, configure, module, layout,
                                     prompts, budgets)
                decode = "pool_paged_decode_attention" if layout else "paged_decode_attention"
                check(A.LAUNCHES["flash_forward"] > 0 and A.LAUNCHES[decode] > 0,
                      f"lm parity {label}: the kernel path launched {A.LAUNCHES}")
                before = dict(A.LAUNCHES)
                with _plain_attention(A):
                    plain = _serve_stream(DecodeEngine, DecodeScheduler, configure, module,
                                          layout, prompts, budgets)
                check(A.LAUNCHES == before,
                      f"lm parity: the plain path launched kernels ({before} -> {A.LAUNCHES})")
                torch.cuda.synchronize()
            total = sum(budgets)
            if dtype == "float32":
                bad = [i for i, (a, b) in enumerate(zip(kern, plain)) if not np.array_equal(a, b)]
                check(not bad, f"lm parity fp32 {label}: kernel and plain tokens differ in "
                               f"streams {bad}")
                # The oracle: full recompute with the dense attention.
                with deterministic(torch), \
                        mock.patch.object(A, "flash_attention", A.attention_reference):
                    for i, (p, b) in enumerate(zip(prompts, budgets)):
                        oracle = greedy_decode(module, torch.from_numpy(p)[None].cuda(), b)
                        check(np.array_equal(oracle[0, p.shape[0]:].cpu().numpy(), kern[i]),
                              f"lm parity fp32 {label}: stream {i} differs from greedy_decode")
                summary[f"fp32 {label}"] = f"{total} of {total} tokens identical (kernel, plain, greedy_decode)"
            else:
                agree = sum(int(np.sum(a == b)) for a, b in zip(kern, plain))
                gaps = []
                for i, (a, b) in enumerate(zip(kern, plain)):
                    diff = np.nonzero(a != b)[0]
                    if diff.size:
                        gaps.append(_plain_gap(torch, A, module, prompts[i], plain[i], int(diff[0])))
                check(all(gap < 0.05 for gap in gaps),
                      f"lm parity bf16 {label}: a disagreement where the plain top-two gap is "
                      f"{max(gaps, default=0.0)} >= 0.05")
                summary[f"bf16 {label}"] = (f"{agree} of {total} tokens agree; first-divergence "
                                            f"top-two gaps {[round(x, 5) for x in gaps]}")
            print(f"lm parity {dtype} {label}: {summary[next(reversed(summary))]}", flush=True)
        del module
        torch.cuda.empty_cache()
    return summary


def _plain_gap(torch, A, module, prompt, plain_tokens, t):
    """Top-two logit gap of the plain path where it emitted token ``t``
    of a stream: the plain decode path's logits, recomputed by feeding
    the stream's own tokens to a fresh plain slot engine."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import DecodeEngine

    engine = DecodeEngine()
    configure(engine, {"slots": LM_SLOTS, "seq_buckets": (512, 2048), "page_size": LM_PAGE,
                       "decode_attention": "kernel"}, name="engine")
    engine.bind(module, device="cuda")
    seen = []
    real = module.decode_step

    def spy(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        seen.append(logits[0].float())
        return logits, cache

    with torch.inference_mode(), _plain_attention(A):
        if t == 0:  # the prefill's logits, at the engine's padded bucket
            dev = engine.device
            tokens = np.zeros((1, engine.seq_bucket_for(prompt.shape[0])), np.int32)
            tokens[0, : prompt.shape[0]] = prompt
            last, _ = module.prefill(torch.from_numpy(tokens).to(dev),
                                     torch.tensor([prompt.shape[0]], device=dev))
            logits = last[0].float()
        else:
            engine.prefill([prompt], [0])
            tokens = np.zeros(LM_SLOTS, np.int32)
            lengths = np.zeros(LM_SLOTS, np.int32)
            with mock.patch.object(module, "decode_step", spy):
                for j in range(t):
                    tokens[0], lengths[0] = plain_tokens[j], prompt.shape[0] + j
                    engine.decode(tokens, lengths)
            logits = seen[-1]
    top2 = torch.topk(logits, 2)
    check(int(top2.indices[0]) == int(plain_tokens[t]),
          f"lm parity: the recomputed plain logits do not give the plain token {t}")
    return float(top2.values[0] - top2.values[1])


#: The LM training slice: the long-context line of examples/lm_experiment.py
#: (TrainLM seq_len=8192 model.d_model=512 model.num_heads=8 batch_size=4
#: model.compute_dtype=bfloat16 loader.dataset.vocab_size=1024), 4 layers.
#: Only the dataset is cut: 8 steps of batch 4 and one validation batch.
LM_TRAIN_CONFIG = {
    "seq_len": 8192, "batch_size": 4,
    "model.num_layers": 4, "model.d_model": 512, "model.num_heads": 8, "model.mlp_ratio": 4,
    "model.compute_dtype": "bfloat16", "loader.dataset.vocab_size": 1024,
    "loader.dataset.num_train_examples": 32, "loader.dataset.num_validation_examples": 4,
    "epochs": 1, "steps_per_epoch": 8, "seed": 0, "device": "cuda", "verbose": False,
}
LM_TRAIN_STEPS = 8
#: The attention shape of every layer of a training step.
LM_TRAIN_SHAPE = (4, 8192, 8, 64)
#: K9 with lse, K10 and K11 checks: (b, s, h, d, dtype name, causal); the
#: main path's shape first, then the prefill-sized shapes in both dtypes
#: and both masks, an awkward length and the other head_dims.
LM_TRAIN_CHECKS = (
    (*LM_TRAIN_SHAPE, "bfloat16", True),
    (1, 2048, 8, 64, "bfloat16", True), (1, 2048, 8, 64, "bfloat16", False),
    (1, 2048, 8, 64, "float32", True), (1, 2048, 8, 64, "float32", False),
    (1, 999, 8, 64, "bfloat16", True), (1, 999, 8, 64, "float32", True),
    (1, 1024, 4, 128, "bfloat16", True), (2, 300, 3, 32, "float32", False),
    # The tensor-core K10/K11's ragged edges: head_dims 40 and 72 (zero-
    # padded to the 64- and 128-dim tiles), head_dim 128 full and at an
    # awkward length.
    (1, 1024, 4, 40, "bfloat16", True), (1, 1024, 4, 72, "bfloat16", True),
    (1, 1024, 4, 128, "bfloat16", False), (1, 999, 4, 128, "bfloat16", True),
    # Past one register tile: head_dims 256 and 320 run in 128-dim chunks.
    (1, 1024, 4, 256, "bfloat16", True), (1, 1024, 4, 256, "float32", True),
    (1, 512, 2, 320, "bfloat16", True), (1, 512, 2, 320, "float32", True),
)


def _flash_work(name, b, s, h, d, size, causal):
    """(bytes, ops) of one flash call: each input read once and each
    output written once; 4d (K9: S and P V), 6d (K10: S, dO V^T, dS K) or
    8d (K11: S, dO V^T, P^T dO, dS^T Q) flops per attended pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    x, stat = b * s * h * d * size, b * h * s * 4  # one [b, s, h, d]; lse or D
    if name == "flash_forward_lse":
        return 4 * x + stat, 4 * d * pairs
    if name == "flash_backward_dq":
        return 5 * x + 2 * stat, 6 * d * pairs
    return 6 * x + 2 * stat, 8 * d * pairs


def _grad_use(torch, got, want, dtype) -> float:
    """How much of the gradient limit the worst element uses (ok when at
    most 1). fp32: 5e-5 + 5e-5 |want| per element, the JAX package's
    flash-gradient tolerance (fp32 sums in another order). bf16: kernel
    and plain version round P and dS to bf16 at the same places, so they
    differ by the fp32 sum order, the final bf16 rounding (up to 2^-7 of
    the value) and, rarely, one P or dS that rounds to the other side
    (moving the sum by one bf16 step, 2^-7, of that term, which may
    dwarf a value that cancels to near 0). So each element within 2^-6
    |want| + 2^-7 max|want|, and the whole within one bf16 step in norm:
    |got - want|_2 <= 2^-7 |want|_2; the larger use of the two."""
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        return float(((g - w).abs() / (5e-5 + 5e-5 * w.abs())).max())
    elem = ((g - w).abs() / (2.0**-6 * w.abs() + 2.0**-7 * w.abs().max())).max()
    norm = torch.linalg.vector_norm(g - w) / (2.0**-7 * torch.linalg.vector_norm(w))
    return float(torch.maximum(elem, norm))


def _backward_variant_wanted(torch, dtype, d) -> str:
    """The K10/K11 kernels a geometry must take: tensor cores for bf16 at
    head_dim <= 128; fp32 keeps the FMA kernels (exact products, as JAX's
    Precision.HIGHEST), and head_dims above 128 the chunked FMA kernels."""
    if d > 128:
        return "fma_wide"
    return "mma" if dtype == torch.bfloat16 else "fma"


def print_kernel_resources(cuda_build, name: str, match: str) -> None:
    """Print ptxas's registers and spills of each kernel of ``name``'s
    library whose mangled name contains ``match``."""
    import re

    kernel = None
    for line in cuda_build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+(flash_\w+?_kernel)I(\w+?)EEv", mangled)
            kernel = mangled
            if base:
                args = re.findall(r"Li(\d+)E", base.group(2) + "E")
                kernel = f"{base.group(1)}<{', '.join(args)}>"
            spills = None
            continue
        if kernel is None or match not in kernel:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"ptxas {name}: {kernel}: {m.group(1)} registers, {spills}", flush=True)
            kernel = None


def _plain_flash_training(A):
    """The training kernels' wrappers swapped for their plain versions."""
    return mock.patch.multiple(
        A,
        flash_forward_lse=lambda q, k, v, causal, scale: A.flash_attention_plain(
            q, k, v, causal=causal, scale=scale, want_lse=True),
        flash_backward_dq=A.flash_backward_dq_plain,
        flash_backward_dkv=A.flash_backward_dkv_plain,
    )


def lm_train_kernel_phase(torch, A):
    """Check K9 with lse, K10 and K11 against their plain versions at the
    shapes of ``LM_TRAIN_CHECKS`` (K9's out also against its no-lse out,
    bit for bit), the autograd path against the dense oracle's gradients
    in fp32, and time each kernel beside its plain version, its bound and
    SDPA (K10 and K11 together beside SDPA's backward, read as forward +
    backward minus forward). Returns ({(kernel, label): record},
    {kernel: max abs err})."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    records = {}
    max_err = dict.fromkeys(LM_TRAIN_KERNELS, 0.0)

    for b, s, h, d, dtype_name, causal in LM_TRAIN_CHECKS:
        dtype = getattr(torch, dtype_name)
        label = f"[{b}, {s}, {h}, {d}] {dtype_name} causal={causal}"
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        kw = {"causal": causal}
        variant = A.flash_backward_variant(dtype, d)
        wanted = _backward_variant_wanted(torch, dtype, d)
        check(variant == wanted, f"flash backward at {label}: variant {variant}, want {wanted}")
        with deterministic(torch):
            out0 = A.flash_attention(q, k, v, **kw)
            out, lse = A.flash_forward_lse(q, k, v, **kw)
            p_out, p_lse = A.flash_attention_plain(q, k, v, want_lse=True, **kw)
            delta = A.flash_backward_delta(out, do)
            ops = (q, k, v, do, lse, delta)
            got = {"flash_backward_dq": (A.flash_backward_dq(*ops, **kw),),
                   "flash_backward_dkv": A.flash_backward_dkv(*ops, **kw)}
            want = {"flash_backward_dq": (A.flash_backward_dq_plain(*ops, **kw),),
                    "flash_backward_dkv": A.flash_backward_dkv_plain(*ops, **kw)}
            again = {"flash_backward_dq": (A.flash_backward_dq(*ops, **kw),),
                     "flash_backward_dkv": A.flash_backward_dkv(*ops, **kw)}
            torch.cuda.synchronize()
        for name in got:
            check(all(_same_bits(torch, x, y) for x, y in zip(got[name], again[name])),
                  f"{name} at {label}: two calls gave different bits")
        check(_same_bits(torch, out, out0),
              f"flash_forward_lse at {label}: out differs from the no-lse K9's")
        notes = [f"K10/K11 variant {variant}, the same bits twice"]
        lse_err = _max_abs_err(torch, lse, p_lse)
        # lse: an fp32 log of an fp32 sum on both sides (|lse| < 20 here).
        check(lse_err <= 1e-5, f"flash_forward_lse at {label}: lse err {lse_err} > 1e-5")
        out_err = _max_abs_err(torch, out, p_out)
        if dtype == torch.float32:
            ok, tol = out_err <= 2e-5, "2e-5"
        else:
            use = _bf16_flash_use(torch, out, p_out)
            ok, tol = use <= 1 and out_err <= 3e-2, f"2^-6|want| + 2e-3 (used {use:.3g})"
        check(ok, f"flash_forward_lse at {label}: out err {out_err} (tolerance {tol})")
        max_err["flash_forward_lse"] = max(max_err["flash_forward_lse"], out_err, lse_err)
        notes.append(f"K9-lse out err {out_err:.3g} (tol {tol}, equal to no-lse out), "
                     f"lse err {lse_err:.3g} (tol 1e-5)")
        for name in ("flash_backward_dq", "flash_backward_dkv"):
            for which, a, w in zip(("dq",) if name == "flash_backward_dq" else ("dk", "dv"),
                                   got[name], want[name]):
                err, use = _max_abs_err(torch, a, w), _grad_use(torch, a, w, dtype)
                check(use <= 1, f"{name} at {label}: {which} err {err}, limit used {use:.3g} > 1")
                max_err[name] = max(max_err[name], err)
                notes.append(f"{which} err {err:.3g} (limit used {use:.3g})")
        del got, want, again, out0, p_out, p_lse

        heavy = s >= 8192
        reps, inner = (5, 3) if heavy else (11, 5)
        kernels = {
            "flash_forward_lse": lambda: A.flash_forward_lse(q, k, v, **kw),
            "flash_backward_dq": lambda: A.flash_backward_dq(*ops, **kw),
            "flash_backward_dkv": lambda: A.flash_backward_dkv(*ops, **kw),
        }
        plains = {
            "flash_forward_lse": lambda: A.flash_attention_plain(q, k, v, want_lse=True, **kw),
            "flash_backward_dq": lambda: A.flash_backward_dq_plain(*ops, **kw),
            "flash_backward_dkv": lambda: A.flash_backward_dkv_plain(*ops, **kw),
        }
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        sdpa_fwd = time_ms(torch, sdpa, reps, inner)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                           reps, inner) - sdpa_fwd
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        times = {}
        for name in LM_TRAIN_KERNELS:
            nbytes, n_ops = _flash_work(name, b, s, h, d, q.element_size(), causal)
            b_ms, b_by = bound_ms(name, nbytes, n_ops, rate)
            rec = {"ms": time_ms(torch, kernels[name], reps, inner),
                   "plain_ms": time_ms(torch, plains[name], 3 if heavy else 5, 1 if heavy else 2),
                   "library_ms": sdpa_fwd if name == "flash_forward_lse" else sdpa_bwd,
                   "bound_ms": b_ms, "bound_by": b_by}
            records[(name, label)] = rec
            times[name] = rec
            print(f"kernel {name} {label}: kernel {rec['ms']:.6f} ms, plain "
                  f"{rec['plain_ms']:.6f} ms, bound {b_ms:.6f} ms by {b_by} ({nbytes} B, "
                  f"{n_ops} ops)", flush=True)
        bwd = times["flash_backward_dq"]["ms"] + times["flash_backward_dkv"]["ms"]
        print(f"lm train kernels {label}: {'; '.join(notes)}; SDPA forward {sdpa_fwd:.6f} ms "
              f"(K9-lse {times['flash_forward_lse']['ms']:.6f}), SDPA backward (fwd+bwd - fwd) "
              f"{sdpa_bwd:.6f} ms (K10+K11 {bwd:.6f}, {bwd / sdpa_bwd:.1f}x)", flush=True)
        del q, k, v, do, out, lse, delta, ops, qt, kt, vt, dot

    # The autograd path in fp32 against the dense oracle's gradients.
    b, s, h, d = 1, 2048, 8, 64
    qkv = [torch.randn(b, s, h, d, generator=g, device=dev).requires_grad_(True)
           for _ in range(3)]
    do = torch.randn(b, s, h, d, generator=g, device=dev)
    with deterministic(torch):
        before = dict(A.LAUNCHES)
        got = torch.autograd.grad(A.flash_attention(*qkv, causal=True), qkv, do)
        launched = {name: A.LAUNCHES[name] - before[name] for name in A.LAUNCHES}
        want = torch.autograd.grad(A.attention_reference(*qkv, causal=True), qkv, do)
        torch.cuda.synchronize()
    check(launched == {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, 1)},
          f"flash_attention under autograd launched {launched}")
    uses = [_grad_use(torch, a, w, torch.float32) for a, w in zip(got, want)]
    check(max(uses) <= 1, f"flash gradients against the dense oracle: limit used {uses}")
    print(f"lm train kernels: fp32 [{b}, {s}, {h}, {d}] causal gradients through "
          f"flash_attention (one K9-lse, K10, K11 launch) against autograd of "
          f"attention_reference: max err "
          f"{[round(_max_abs_err(torch, a, w), 9) for a, w in zip(got, want)]}, "
          f"limit 5e-5 + 5e-5|want| used {[round(u, 4) for u in uses]}", flush=True)
    torch.cuda.empty_cache()
    return records, max_err


def _bf16_step_use(torch, loss_k, loss_p, grads_k, grads_p):
    """How much of the bf16 step limit the worst of loss and gradients
    uses (ok when at most 1). The loss within 2^-7 relative: one bf16
    step; the forward's K9-lse differs from its plain version by the
    order of fp32 sums and the loss is an fp32 mean over every position.
    Each gradient within 2^-6 of its norm, in norm: each layer's K10/K11
    output is within 2^-7 of its plain version's in norm (``_grad_use``'s
    bf16 limit), and the gradients of the bottom layer carry the
    deviations of both layers' attention backward, 2 x 2^-7. Per element
    no limit holds: the products downstream mix the deviations of every
    position, and an element near 0 may move by more than itself.
    Returns (use, name of the worst tensor)."""
    uses = [(abs(loss_k - loss_p) / (2.0**-7 * abs(loss_p)), "loss")]
    for name, g, w in zip(grads_k, grads_k.values(), grads_p.values()):
        diff = torch.linalg.vector_norm((g - w).float())
        uses.append((float(diff / (2.0**-6 * torch.linalg.vector_norm(w.float()))), name))
    return max(uses)


def _step_check(torch, A, experiment, dev, dtype_name):
    """One training step (2 layers, [2, 2048], vocab 1024) through the
    kernels against the same step through their plain versions. fp32:
    the loss within 1e-5 relative and each gradient within 1e-4 of its
    largest magnitude (the CPU tests' step tolerances: the attention sums
    run in another order); bf16: ``_bf16_step_use``."""
    from zookeeper_tpu_torch.training.step import softmax_cross_entropy

    exp = experiment(**{"model.num_layers": 2, "model.compute_dtype": dtype_name,
                        "seq_len": 2048, "batch_size": 2})
    state = exp.build_state(dev)
    batch = next(iter(exp.loader.host_batches("train")))
    tokens, target = (torch.from_numpy(batch[key]).to(dev) for key in ("input", "target"))
    names, params = zip(*state.module.named_parameters())

    def loss_and_grads():
        loss = softmax_cross_entropy(state.module.train()(tokens), target)
        return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))

    what = f"lm training {dtype_name} check"
    with deterministic(torch):
        A.reset_launches()
        loss_k, grads_k = loss_and_grads()
        launched = dict(A.LAUNCHES)
        with _plain_flash_training(A):
            loss_p, grads_p = loss_and_grads()
        torch.cuda.synchronize()
    check(launched == {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, 2)},
          f"{what}: the kernel step launched {launched}")
    check(A.LAUNCHES == launched, f"{what}: the plain step launched kernels "
                                  f"({launched} -> {A.LAUNCHES})")
    worst = max((float((g - grads_p[n]).abs().max() / grads_p[n].abs().max().clamp_min(1e-30)), n)
                for n, g in grads_k.items())
    if dtype_name == "float32":
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_rel <= 1e-5 and worst[0] <= 1e-4,
              f"{what}: loss {loss_k} vs {loss_p}, worst gradient {worst[1]} at {worst[0]} of "
              f"its largest magnitude")
        tol = (f"loss rel {loss_rel:.3g} (tol 1e-5), worst {worst[1]} at {worst[0]:.3g} of its "
               f"largest magnitude (tol 1e-4)")
    else:
        use, where = _bf16_step_use(torch, loss_k, loss_p, grads_k, grads_p)
        check(use <= 1, f"{what}: loss {loss_k} vs {loss_p}, {where} uses {use:.3g} of its limit")
        tol = (f"limit (loss 2^-7 rel, each gradient 2^-6 of its norm) used {use:.3g} at "
               f"{where}; largest element error {worst[0]:.3g} of its tensor's largest "
               f"magnitude at {worst[1]}")
    print(f"lm training: {dtype_name} step (2 layers, [2, 2048], vocab 1024, K10/K11 "
          f"variant {A.flash_backward_variant(getattr(torch, dtype_name), 64)}) through the "
          f"kernels against their plain versions: loss {loss_k:.7f} vs {loss_p:.7f}, "
          f"{len(names)} gradients, {tol}", flush=True)
    del exp, state, grads_k, grads_p
    torch.cuda.empty_cache()


def lm_training_phase(torch, A, smi):
    """TrainLM: one fp32 and one bf16 step at reduced depth and sequence
    through the kernels against the same step through their plain
    versions; then the full-width run() with its launches per step, its
    losses, the step's time, busy share, peak memory and profile.
    Returns (launches over run(), stats)."""
    from torch.profiler import ProfilerActivity, profile

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.lm import TrainLM

    dev = torch.device("cuda")

    def experiment(**overrides):
        exp = TrainLM()
        configure(exp, {**LM_TRAIN_CONFIG, **overrides}, name="experiment")
        return exp

    # (1) 2 layers, seq 2048, batch 2: the kernel step against the plain
    # step, in fp32 (K10/K11 on FMA) and in bf16 (on tensor cores).
    for dtype_name in ("float32", "bfloat16"):
        _step_check(torch, A, experiment, dev, dtype_name)

    # (2) run() at full width; each train step's launches and loss are
    # read around the step, the eval's launches are what is left.
    exp = experiment()
    head_dim = LM_TRAIN_CONFIG["model.d_model"] // LM_TRAIN_CONFIG["model.num_heads"]
    variant = A.flash_backward_variant(torch.bfloat16, head_dim)
    check(variant == "mma", f"lm training run(): K10/K11 take the {variant} kernels at bf16 "
                            f"head_dim {head_dim}, want the tensor-core ones")
    losses, per_step = [], []
    real_step_fn = TrainLM._train_step_fn

    def step_fn(self):
        step = real_step_fn(self)

        def counted(st, b):
            before = dict(A.LAUNCHES)
            st, metrics = step(st, b)
            per_step.append({name: A.LAUNCHES[name] - before[name] for name in A.LAUNCHES})
            losses.append(metrics["loss"])
            return st, metrics

        return counted

    A.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(TrainLM, "_train_step_fn", step_fn):
        history = exp.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    want_step = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, LM_LAYERS)}
    check(len(per_step) == LM_TRAIN_STEPS and all(p == want_step for p in per_step),
          f"lm training run(): launches per step {per_step}, want {want_step} x {LM_TRAIN_STEPS}")
    eval_batches = (LM_TRAIN_CONFIG["loader.dataset.num_validation_examples"]
                    // LM_TRAIN_CONFIG["batch_size"])
    want_run = {**dict.fromkeys(A.LAUNCHES, 0),
                **dict.fromkeys(LM_TRAIN_KERNELS, LM_LAYERS * LM_TRAIN_STEPS),
                "flash_forward": LM_LAYERS * eval_batches}
    check(launches == want_run, f"lm training run(): launches {launches}, want {want_run}")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"lm training run(): losses {losses}")
    check(losses[-1] < losses[0], f"lm training run(): the loss did not fall: {losses}")
    val = history["validation"][0]
    check(math.isfinite(val["loss"]), f"lm training run(): validation {val}")
    tokens_per_step = LM_TRAIN_CONFIG["batch_size"] * LM_TRAIN_CONFIG["seq_len"]
    run_tokens_per_s = history["train"][0]["examples_per_sec"] * LM_TRAIN_CONFIG["seq_len"]
    print(f"lm training run(): {LM_TRAIN_STEPS} steps, K10/K11 variant {variant}, launches "
          f"{launches} (per step "
          f"{per_step[0]}; the eval's {eval_batches} batch ran {launches['flash_forward']} "
          f"no-lse K9), losses {[round(x, 5) for x in losses]}, validation {val}, "
          f"{run_tokens_per_s:.1f} tokens/s through run() (first epoch, first step included), "
          f"run {run_s:.1f} s with build and eval", flush=True)

    # (3) the step in the default settings on a device-resident batch:
    # CUDA events and the host clock over three steps after a warm step.
    state, step = exp.final_state, exp._train_step_fn()
    batches = exp.loader.batches("train", device=dev, epoch=1, max_batches=1)
    batch = next(batches)
    batches.close()
    step(state, batch)
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    step_ms, step_wall_ms = statistics.median(dev_ms), statistics.median(wall_ms)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    acts = sum(e.count for e in kernels)
    print(f"lm training profile: {acts} device activities, {busy_ms:.3f} ms busy, "
          f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step; top items:", flush=True)
    for e in sorted(kernels, key=lambda e: getattr(e, attr), reverse=True)[:12]:
        t = getattr(e, attr) / 1e3
        print(f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{e.count:<5d} {e.key[:100]}", flush=True)
    gib = 2.0**30
    stats = {
        "step_ms": step_ms, "step_wall_ms": step_wall_ms, "step_ms_all": dev_ms,
        "tokens_per_s_step": tokens_per_step / (step_ms / 1e3),
        "tokens_per_s_run": run_tokens_per_s, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / step_ms, "device_activities_per_step": acts,
        "peak_gib": peak / gib, "step_gib": (peak - base) / gib,
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    print(f"lm training on {smi}: {json.dumps(stats)}", flush=True)
    del exp, state, batch
    torch.cuda.empty_cache()
    return launches, stats


#: TransformerLM at head_dim 256 (d_model 1024, 4 heads), 2 layers, seq_len
#: 2048: the geometry the port's kernels refused before they took every
#: head_dim. Served in both layouts, and one training step.
LM_WIDE = {"model.num_layers": 2, "model.d_model": 1024, "model.num_heads": 4,
           "model.mlp_ratio": 4, "model.compute_dtype": "bfloat16", "seq_len": 2048}


def lm_wide_phase(torch, A, smi):
    """Serve a few requests through LMServingConfig.run() at head_dim 256 in
    the slot and paged layouts (2 K9 per prefill, 2 K12/K13 per decode
    step), then take one training step through the train step (2 K9-lse,
    2 K10, 2 K11). Returns the launches."""
    import numpy as np

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.training.lm import TrainLM

    layers = LM_WIDE["model.num_layers"]
    launches = {}
    for label, overrides in (("slots", {}), ("paged", PAGED)):
        cfg = _lm_config({**LM_WIDE, "requests": 6, "max_prompt": 1500, "new_tokens": 8,
                          **overrides})
        A.reset_launches()
        t0 = time.perf_counter()
        result = cfg.run()
        torch.cuda.synchronize()
        got = dict(A.LAUNCHES)
        kernel = "paged_decode_attention" if label == "slots" else "pool_paged_decode_attention"
        prefills = int(result["prefills_total"]) + 2  # + the warmup of both buckets
        decodes = int(result["decode_steps_total"]) + 1  # + the warmup step
        want = {**dict.fromkeys(A.LAUNCHES, 0), "flash_forward": layers * prefills,
                kernel: layers * decodes}
        check(got == want, f"lm head_dim 256 {label}: launches {got}, want {want}")
        outputs = np.concatenate(cfg.outputs)
        check(result["generated_tokens"] == 6 * 8 and outputs.min() >= 0
              and outputs.max() < LM_CONFIG["vocab_size"],
              f"lm head_dim 256 {label}: {result['generated_tokens']} tokens, range "
              f"[{outputs.min()}, {outputs.max()}]")
        launches[label] = got
        print(f"lm head_dim 256 {label} on {smi}: launches {got} ({prefills} prefills, "
              f"{decodes} decode steps with warmup), tokens/s {result['tokens_per_sec']:.1f}, "
              f"run {time.perf_counter() - t0:.1f} s", flush=True)
        del cfg
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    exp = TrainLM()
    configure(exp, {**LM_TRAIN_CONFIG, **LM_WIDE, "batch_size": 2}, name="experiment")
    state, step = exp.build_state(dev), exp._train_step_fn()
    batches = exp.loader.batches("train", device=dev, epoch=0, max_batches=1)
    batch = next(batches)
    batches.close()
    A.reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got = dict(A.LAUNCHES)
    want = {**dict.fromkeys(A.LAUNCHES, 0), **dict.fromkeys(LM_TRAIN_KERNELS, layers)}
    check(got == want, f"lm head_dim 256 training step: launches {got}, want {want}")
    check(math.isfinite(loss), f"lm head_dim 256 training step: loss {loss}")
    launches["train"] = got
    print(f"lm head_dim 256 training step on {smi} ([2, 2048], bf16): launches {got}, loss "
          f"{loss:.5f}, first step {step_s * 1e3:.1f} ms with the kernels' first use", flush=True)
    del exp, state, batch
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "zookeeper_tpu_torch", "csrc")):
        fail("run from a checkout: zookeeper_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    # cuBLAS reads this when CUDA starts: deterministic workspaces.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # Deterministic mode (see ``deterministic``) would also fill every new
    # tensor with NaN, a debugging aid that adds a fill launch per
    # allocation; the results do not depend on it.
    torch.utils.deterministic.fill_uninitialized_memory = False

    from zookeeper_tpu_torch.ops import binary_compute as bc
    from zookeeper_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {sorted(cuda_build.SIGNATURES)} with nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print_kernel_resources(cuda_build, "flash_backward", "_mma_")

    totals = kernel_phase(torch, bc)
    totals.update(resid_kernel_phase(torch, bc))
    totals.update(xnor_kernel_phase(torch, bc, smi))
    int8_exact_phase(torch, bc)
    slices = {label: slice_phase(torch, bc, label, smi) for label in SLICES}
    print(f"slices on {smi}: "
          + " ".join(f"{label} {json.dumps(stats)}" for label, (_, stats) in slices.items()),
          flush=True)
    launches_t, _ = training_phase(torch, bc, smi)

    from zookeeper_tpu_torch.ops import attention as A

    lm_records, lm_err = lm_kernel_phase(torch, A)
    launches_lm, _, lm_main = lm_serving_phase(torch, A, smi)
    parity = lm_parity_phase(torch, A)
    print(f"lm parity: {json.dumps(parity)}", flush=True)
    lm_train_records, lm_train_err = lm_train_kernel_phase(torch, A)
    launches_lt, _ = lm_training_phase(torch, A, smi)
    lm_wide_phase(torch, A, smi)

    # Each kernel's launches on its main path: K1 and K3 serving slice A,
    # K4 slice B, K2 slice C, K5 slice E, K6-K8 the training step.
    main_slice = {"pack_rows": "A", "conv_gemm_popcount": "A", "packed_weight_matmul": "B",
                  "xnor_matmul_packed_scaled": "C", "xnor_matmul_packed": "E"}
    launches = {name: slices[label][0][name] for name, label in main_slice.items()}
    launches.update(launches_t)
    rows = []
    for name, t in totals.items():
        source, replaces = KERNELS[name]
        least_ms, bound_by = bound_ms(name, t["bytes"], t["ops"])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"zookeeper_tpu_torch/csrc/{source}",
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
    # LM kernels, per main-path unit: K9 per prefill dispatch (4 layers)
    # over the slots run's bucket mix; K12 and K13 per decode step (4
    # layers) at a mid-run step of the slots / paged run.
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    flash = dict.fromkeys(keys, 0.0)
    for sb, frac in lm_main["buckets"].items():
        rec = lm_records[("flash_forward",
                          f"[1, {sb}, {LM_HEADS}, {LM_HEAD_DIM}] bfloat16 causal=True")]
        for key in keys:
            flash[key] += LM_LAYERS * frac * rec[key]
    flash["bound_by"] = "operations" if flash["ops_ms"] >= flash["bytes_ms"] else "bytes"
    per_unit = {"flash_forward": flash}
    for name in ("paged_decode_attention", "pool_paged_decode_attention"):
        rec = lm_main[name]
        per_unit[name] = {key: (None if rec[key] is None else LM_LAYERS * rec[key])
                          for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        per_unit[name]["bound_by"] = rec["bound_by"]
    for name in LM_KERNELS:
        source, replaces = KERNELS[name]
        t = per_unit[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"zookeeper_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_lm[name], "ok": True,
            "max_abs_err": lm_err[name], "ms": t["ms"], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # LM training kernels, per training step: 4 launches each (one per
    # layer) at the full-width shape.
    label = "[{}, {}, {}, {}] bfloat16 causal=True".format(*LM_TRAIN_SHAPE)
    library_of = {
        "flash_forward_lse": "SDPA forward",
        "flash_backward_dq": "SDPA backward (fwd+bwd - fwd): dQ, dK, dV together, K10+K11's",
        "flash_backward_dkv": "SDPA backward (fwd+bwd - fwd): dQ, dK, dV together, K10+K11's",
    }
    for name in LM_TRAIN_KERNELS:
        source, replaces = KERNELS[name]
        rec = lm_train_records[(name, label)]
        rows.append({
            "name": name, "route": "cuda", "source": f"zookeeper_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches_lt[name], "ok": True,
            "max_abs_err": lm_train_err[name], "ms": LM_LAYERS * rec["ms"],
            "kernel_ms": LM_LAYERS * rec["ms"], "plain_ms": LM_LAYERS * rec["plain_ms"],
            "bound_ms": LM_LAYERS * rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": LM_LAYERS * rec["library_ms"], "library_of": library_of[name],
        })
        if name != "flash_forward_lse":
            rows[-1]["variant"] = A.flash_backward_variant(torch.bfloat16, LM_TRAIN_SHAPE[3])
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
