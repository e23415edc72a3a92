"""Where the tensor-core flash kernels spend their time: time them beside
copies of their source with one part of the work removed. Also K1 at
every shape the serving paths give it.

    python -m zookeeper_tpu_torch.ablate [--source flash_backward|flash_forward|pack_rows|xnor_gemm]
                                         [--shape B S H D] [--full] [--against OLD.cu]

Builds, in parallel, the source as it is and ablated copies: the
accurate ``expf`` of P replaced by ``__expf`` (one ``ex2.approx``: a
measure of the exponential's cost), and the elementwise phase removed
(P, and in the backward dS, are the raw scores: a measure of the
products, copies and synchronisation alone); these two compute wrong
results and serve only as clocks. The forward's third copy computes the
same results with the generic K/V tile copy in place of its fixed-chunk
one. Times each kernel of the source (K10
and K11 for ``flash_backward.cu``, K9 with lse for ``flash_forward.cu``)
at the LM training step's shape ([4, 8192, 8, 64] bf16 causal by
default) with CUDA events, in two rounds of opposite order, and prints
one JSON line with the card's name and power limit. Runs on the machine
with the card and ``nvcc``. ``--against OLD.cu`` builds another version
of the source (a parent's, unpacked with ``git archive``) beside them,
as the variant "against"; its includes resolve from its own directory
first.

``--source pack_rows`` times K1 at every row shape of ``K1_SHAPES`` (the
batch-8 forwards of slices A and C in bf16, of BinaryNet's fused flavor
in fp32), each build checked against the plain version first; the line
gives each shape's ms a launch, the sum per forward of each slice, and
the time of an empty launch (``torch.cuda._sleep(0)``) timed the same
way.

``--source xnor_gemm`` times K2 and K5 at every row of ``XNOR_ROWS``
(their "small_m" design, M <= 8), with the sums per batch-8 forward of
the dense layers of ``XNOR_FORWARDS`` (slices C, E and E_AUTO): the
source as built, a copy whose small_m kernel decodes both sides to +-1
bytes with K4's ``pm1_bytes`` (the decode first planned for it, kept
for comparison with its two-instruction ``sign_bytes``), one with
blocks of 8 warps in place of 4, and ``--against`` another version.
Every build is checked against the plain version (twice, the same bits)
before it is timed; the line ends with the empty-launch floor, as for
``pack_rows``.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.ops import cuda_build

#: Per source, (text in the source, its replacement) for each ablation.
ABLATIONS = {
    "flash_backward": {
        "as built": [],
        "fast exp": [(f"? expf(__fmul_rn(sc[j][e], scale) - lse_{x}",
                      f"? __expf(__fmul_rn(sc[j][e], scale) - lse_{x}") for x in "rt"],
        "no elementwise": [
            ("valid ? expf(__fmul_rn(sc[j][e], scale) - lse_r[e >> 1]) : 0.0f", "sc[j][e]"),
            ("valid ? expf(__fmul_rn(sc[j][e], scale) - lse_t[col]) : 0.0f", "sc[j][e]"),
        ],
    },
    "flash_forward": {
        "as built": [],
        "fast exp": [("p[e] = expf(sc[j][e] - mx[e >> 1]);",
                      "p[e] = __expf(sc[j][e] - mx[e >> 1]);")],
        # The softmax lambda packs the raw scores and returns: no scale,
        # mask, row max, exponential, sum or rescale.
        "no elementwise": [(
            "auto to_p = [&](auto masked) {",
            "auto to_p = [&](auto masked) {\n"
            "      for (int j = 0; j < MMA_KTILE / 8; ++j) {\n"
            "        pa[j >> 1][2 * (j & 1)] = pack_bf16(sc[j][0], sc[j][1]);\n"
            "        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(sc[j][2], sc[j][3]);\n"
            "      }\n"
            "      return;",
        )],
        # The same outputs, the K/V copy through the generic
        # `load_tile_bf16`: a measure of `copy_rows16`'s saving.
        "generic copy": [("    if (vec) {\n      copy_rows16",
                          "    if (false) {\n      copy_rows16")],
    },
    "pack_rows": {"as built": []},
    "xnor_gemm": {
        "as built": [],
        # The same results with both sides decoded to +-1 bytes by
        # `s8::pm1_bytes` (five instructions a register, K4's decode): the
        # products give the dot itself.
        "pm1 decode": [
            ("      small_m_step(acc, s_row, w, aw[d], x_live);\n", """\
      uint32_t x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = x_live ? s8::pm1_bytes(aw[d] >> (8 * i)) : 0u;
        x[2 * i + 1] = x_live ? s8::pm1_bytes(aw[d] >> (8 * i + 4)) : 0u;
      }
      s8::small_m_products(acc, w, x);
"""),
            ("  constexpr int M_SCALE = -2;\n", "  constexpr int M_SCALE = 1;\n"),
        ],
        # The same results from blocks of 8 warps (32 K words a step).
        "8 warps": [("constexpr int SM_WARPS = 4;\n", "constexpr int SM_WARPS = 8;\n")],
    },
}

#: K1's rows per image, by serving path, in the order a forward packs
#: them: (dtype, ((rows an image, K, launches a forward), ...)). A conv
#: packs its SAME-padded input, (h + k - 1)^2 rows of its channels; a
#: dense layer one row. A: QuickNet-Large's four sections (3x3 at 56, 28,
#: 14, 7). C: BinaryAlexNet's four binary convs (5x5 at 27, 3x3 at 13)
#: and two binary dense layers. E_AUTO: BinaryNet (default widths,
#: ``binary_flavor="auto"``), five binary convs (3x3 at 32, 16, 16, 8, 8)
#: and two dense layers.
K1_SHAPES = {
    "A": ("bfloat16", ((58 * 58, 64, 6), (30 * 30, 128, 8), (16 * 16, 256, 12),
                       (9 * 9, 512, 6))),
    "C": ("bfloat16", ((31 * 31, 64, 1), (15 * 15, 192, 1), (15 * 15, 384, 2),
                       (1, 9216, 1), (1, 4096, 1))),
    "E_AUTO": ("float32", ((34 * 34, 128, 1), (18 * 18, 128, 1), (18 * 18, 256, 1),
                           (10 * 10, 256, 1), (10 * 10, 512, 1), (1, 8192, 1), (1, 1024, 1))),
}
#: The batch the serving paths' K1 rows are timed at.
K1_BATCH = 8

#: K2's and K5's dense layers on the serving paths, (kernel, ((Kw, N),
#: ...)) in the order a forward runs them, one launch each at M = batch.
#: C: BinaryAlexNet's two packed dense layers; E: BinaryNet's two on the
#: "reference" flavor; E_AUTO: the same on "auto".
XNOR_FORWARDS = {
    "C": ("xnor_matmul_packed_scaled", ((288, 4096), (128, 4096))),
    "E": ("xnor_matmul_packed", ((256, 1024), (32, 1024))),
    "E_AUTO": ("xnor_matmul_packed_scaled", ((256, 1024), (32, 1024))),
}

#: The rows (M, Kw, N) at M <= 8 that ``--source xnor_gemm`` times, by
#: kernel, chip_smoke's cases there: the dense layers of
#: ``XNOR_FORWARDS`` at batch 8, slice C's at batch 1, then rows past M,
#: N % 4 != 0 (scalar weight loads), a Kw below one block's share, and a
#: cluster of each size from 2 to 7 on partial column tiles.
_XNOR_RAGGED = ((3, 288, 4096), (6, 37, 72), (8, 7, 130), (8, 64, 8), (5, 96, 130),
                (8, 160, 72), (7, 190, 130), (3, 224, 4100))
XNOR_ROWS = {
    "xnor_matmul_packed_scaled": ((8, 288, 4096), (8, 128, 4096), (8, 256, 1024), (8, 32, 1024),
                                  (1, 288, 4096), (1, 128, 4096), *_XNOR_RAGGED),
    "xnor_matmul_packed": ((8, 256, 1024), (8, 32, 1024), (8, 288, 4096), (8, 128, 4096),
                           (1, 288, 4096), (1, 128, 4096), *_XNOR_RAGGED),
}


def _build(source: str, workdir: str, against: str = None) -> dict:
    with open(os.path.join(cuda_build.CSRC_DIR, f"{source}.cu")) as f:
        text0 = f.read()
    variants = {}
    for name, edits in ABLATIONS[source].items():
        text = text0
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        variants[name] = (text, [])
    if against is not None:
        with open(against) as f:
            variants["against"] = (f.read(), ["-I", os.path.dirname(os.path.abspath(against))])
    procs = {}
    for name, (text, includes) in variants.items():
        stem = os.path.join(workdir, re.sub(r"\W", "_", name))
        with open(f"{stem}.cu", "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *includes, "-I", cuda_build.CSRC_DIR,
             "-o", f"{stem}.so", f"{stem}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), f"{stem}.so")
    libs = {}
    for name, (proc, path) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{output}")
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in cuda_build.SIGNATURES[source].items():
            if not hasattr(lib, fn):  # an older version of the source
                continue
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def _time_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median ms of one call over ``reps`` runs of ``inner`` calls; a
    device-side sleep first lets the host queue the calls ahead of the
    card (for kernels shorter than their launch's host time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", choices=sorted(ABLATIONS), default="flash_backward")
    parser.add_argument("--shape", type=int, nargs=4, default=(4, 8192, 8, 64))
    parser.add_argument("--full", action="store_true", help="full attention, not causal")
    parser.add_argument("--against", metavar="OLD.cu",
                        help="another version of the source, built and timed beside it")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.source == "pack_rows":
        return _pack_rows_main(smi, args.against)
    if args.source == "xnor_gemm":
        return _xnor_gemm_main(smi, args.against)
    b, s, h, d = args.shape
    causal = not args.full
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    if args.source == "flash_forward":
        kernels = {"flash_forward_lse": lambda: A.flash_forward_lse(q, k, v, causal=causal)}
    else:
        out, lse = A.flash_forward_lse(q, k, v, causal=causal)
        ops = (q, k, v, do, lse, A.flash_backward_delta(out, do))
        kernels = {"dq": lambda: A.flash_backward_dq(*ops, causal=causal),
                   "dkv": lambda: A.flash_backward_dkv(*ops, causal=causal)}
    with tempfile.TemporaryDirectory() as workdir:
        libs = _build(args.source, workdir, args.against)
        times = {name: {kernel: [] for kernel in kernels} for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded[args.source] = libs[name]
                for kernel, fn in kernels.items():
                    times[name][kernel].append(_time_ms(fn))
        cuda_build._loaded.pop(args.source)
    print(json.dumps({"device": smi, "source": args.source, "shape": [b, s, h, d],
                      "causal": causal, "ms_per_launch": times}), flush=True)
    return 0


def _pack_rows_main(smi: str, against: str = None) -> int:
    from zookeeper_tpu_torch.ops import binary_compute as bc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {(path, f"{dtype} {K1_BATCH * m}x{k}"):
            torch.randn(K1_BATCH * m, k, generator=g, device=dev).to(getattr(torch, dtype))
            for path, (dtype, shapes) in K1_SHAPES.items() for m, k, _ in shapes}
    with tempfile.TemporaryDirectory() as workdir:
        libs = _build("pack_rows", workdir, against)
        times = {name: {label: [] for _, label in rows} for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded["pack_rows"] = libs[name]
                for (_, label), x in rows.items():
                    if not torch.equal(bc.pack_rows(x), bc.pack_rows_plain(x)):
                        raise RuntimeError(f"pack_rows {name!r} at {label}: not the plain words")
                    times[name][label].append(_time_ms(lambda: bc.pack_rows(x), reps=21, inner=10))
        cuda_build._loaded.pop("pack_rows")
    per_forward = {name: {path: sum(n * statistics.median(t[f"{dtype} {K1_BATCH * m}x{k}"])
                                    for m, k, n in shapes)
                          for path, (dtype, shapes) in K1_SHAPES.items()}
                   for name, t in times.items()}
    floor = _time_ms(lambda: torch.cuda._sleep(0), reps=21, inner=10)
    print(json.dumps({"device": smi, "source": "pack_rows", "ms_per_launch": times,
                      "ms_per_forward": per_forward, "launch_floor_ms": floor}), flush=True)
    return 0


def _xnor_label(name: str, m: int, kw: int, n: int) -> str:
    return f"{'K5' if name == 'xnor_matmul_packed' else 'K2'} {m}x{kw}x{n}"


def _xnor_gemm_main(smi: str, against: str = None) -> int:
    from zookeeper_tpu_torch.ops import binary_compute as bc

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}  # label: (a, b, scale or None for K5, k_true)
    for name, m, kw, n in ((name, *row) for name, r in XNOR_ROWS.items() for row in r):
        a, b = (torch.randint(-(2**31), 2**31, shape, generator=g, device=dev, dtype=torch.int64)
                .to(torch.int32) for shape in ((m, kw), (kw, n)))
        scale = None if name == "xnor_matmul_packed" else torch.randn(n, generator=g, device=dev)
        rows[_xnor_label(name, m, kw, n)] = (a, b, scale, 32 * kw - 5)

    def wrapper(lib):
        def fn(a, b, scale, k_true):
            cuda_build._loaded["xnor_gemm"] = lib
            if scale is None:
                return bc.xnor_matmul_packed(a, b, k_true=k_true)
            return bc.xnor_matmul_packed_scaled(a, b, scale, k_true=k_true)
        return fn

    def plain(a, b, scale, k_true):
        if scale is None:
            return bc.xnor_matmul_packed_plain(a, b, k_true=k_true)
        return bc.xnor_matmul_packed_scaled_plain(a, b, scale, k_true=k_true)

    with tempfile.TemporaryDirectory() as workdir:
        libs = _build("xnor_gemm", workdir, against)
        fns = {name: wrapper(lib) for name, lib in libs.items()}
        for variant, fn in fns.items():
            for label, r in rows.items():
                got, again, want = fn(*r), fn(*r), plain(*r)
                if not all(x.dtype == want.dtype and torch.equal(x.view(torch.int32),
                                                                  want.view(torch.int32))
                           for x in (got, again)):
                    raise RuntimeError(f"xnor_gemm {variant!r} at {label}: not the plain bits")
        times = {variant: {label: [] for label in rows} for variant in fns}
        for order in (list(fns), list(reversed(fns))):
            for variant in order:
                for label, r in rows.items():
                    times[variant][label].append(
                        _time_ms(lambda: fns[variant](*r), reps=21, inner=10))
        cuda_build._loaded.pop("xnor_gemm")
    per_forward = {variant: {path: sum(statistics.median(t[_xnor_label(name, K1_BATCH, kw, n)])
                                       for kw, n in shapes)
                             for path, (name, shapes) in XNOR_FORWARDS.items()}
                   for variant, t in times.items()}
    floor = _time_ms(lambda: torch.cuda._sleep(0), reps=21, inner=10)
    print(json.dumps({"device": smi, "source": "xnor_gemm", "ms_per_launch": times,
                      "ms_per_forward": per_forward, "launch_floor_ms": floor}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
