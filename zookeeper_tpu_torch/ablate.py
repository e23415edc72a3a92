"""Where the tensor-core K10/K11 spend their time: time them beside
copies of ``csrc/flash_backward.cu`` with one part of the work removed.

    python -m zookeeper_tpu_torch.ablate [--shape B S H D] [--full]

Builds, in parallel, the source as it is and two ablated copies: the
accurate ``expf`` of P replaced by ``__expf`` (one ``ex2.approx``: a
measure of the exponential's cost), and the elementwise phase removed
(P and dS are the raw scores: a measure of the products, copies and
synchronisation alone). Both copies compute wrong gradients and serve
only as clocks. Times K10 and K11 of each at the LM training step's
shape ([4, 8192, 8, 64] bf16 causal by default) with CUDA events, in two
rounds of opposite order, and prints one JSON line with the card's name
and power limit. Runs on the machine with the card and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.ops import cuda_build

#: (text in the source, its replacement) for each ablation.
ABLATIONS = {
    "as built": [],
    "fast exp": [(f"? expf(__fmul_rn(sc[j][e], scale) - lse_{x}",
                  f"? __expf(__fmul_rn(sc[j][e], scale) - lse_{x}") for x in "rt"],
    "no elementwise": [
        ("valid ? expf(__fmul_rn(sc[j][e], scale) - lse_r[e >> 1]) : 0.0f", "sc[j][e]"),
        ("valid ? expf(__fmul_rn(sc[j][e], scale) - lse_t[col]) : 0.0f", "sc[j][e]"),
    ],
}


def _build(workdir: str) -> dict:
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_backward.cu")) as f:
        source = f.read()
    procs = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        stem = os.path.join(workdir, name.replace(" ", "_"))
        with open(f"{stem}.cu", "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", f"{stem}.so", f"{stem}.cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), f"{stem}.so")
    libs = {}
    for name, (proc, path) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{output}")
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in cuda_build.SIGNATURES["flash_backward"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def _time_ms(fn, reps: int = 5, inner: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs=4, default=(4, 8192, 8, 64))
    parser.add_argument("--full", action="store_true", help="full attention, not causal")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    b, s, h, d = args.shape
    causal = not args.full
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = A.flash_forward_lse(q, k, v, causal=causal)
    ops = (q, k, v, do, lse, A.flash_backward_delta(out, do))
    with tempfile.TemporaryDirectory() as workdir:
        libs = _build(workdir)
        times = {name: {"dq": [], "dkv": []} for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded["flash_backward"] = libs[name]
                times[name]["dq"].append(_time_ms(lambda: A.flash_backward_dq(*ops, causal=causal)))
                times[name]["dkv"].append(
                    _time_ms(lambda: A.flash_backward_dkv(*ops, causal=causal)))
        cuda_build._loaded.pop("flash_backward")
    print(json.dumps({"device": smi, "shape": [b, s, h, d], "causal": causal,
                      "ms_per_launch": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
