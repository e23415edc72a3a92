"""Where a served forward's time goes on the card.

    python -m zookeeper_tpu_torch.serving.profile_forward \\
        [--binary-compute xnor_popcount|xnor]

Builds packed, BN-folded QuickNet-Large in bf16 at 224x224 through
``ServingConfig`` (weights from a seed), times ``engine.infer`` on one
batch of 8 with the host clock and a ``synchronize``, then traces the
same forwards with ``torch.profiler`` and prints one JSON line: the
forward's wall time, the device time per forward, the device's busy share
(device time over wall time) and the 8 kernels that take the most device
time.
Needs a CUDA card.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.serving import ServingConfig

BATCH = 8
STEPS = 10
TOP = 8


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--binary-compute", default="xnor_popcount",
                        choices=("xnor_popcount", "xnor"))
    args = parser.parse_args(argv)

    import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)

    cfg = ServingConfig()
    configure(cfg, {
        "model": "QuickNetLarge",
        "model.compute_dtype": "bfloat16",
        "model.binary_compute": args.binary_compute,
        "model.packed_weights": True,
        "model.fold_bn": True,
        "engine.batch_buckets": (BATCH,),
        "device": "cuda", "verbose": False,
    })
    engine, _ = cfg.build_service()
    x = np.random.default_rng(0).normal(size=(BATCH, 224, 224, 3)).astype(np.float32)
    engine.infer(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        engine.infer(x)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) / STEPS * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            engine.infer(x)
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / STEPS
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {
        "card": card,
        "binary_compute": args.binary_compute,
        "batch": BATCH,
        "forward_ms": forward_ms,
        "device_ms_per_forward": device_ms if kernels else None,
        "busy_share": device_ms / forward_ms if kernels else None,
        "kernel_launches_per_forward": sum(e.count for e in kernels) / STEPS,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_forward": e.self_device_time_total / 1e3 / STEPS,
             "calls_per_forward": e.count / STEPS}
            for e in top
        ],
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
