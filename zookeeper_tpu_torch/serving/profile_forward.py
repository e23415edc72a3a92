"""Where a served forward's time goes on the card.

    python -m zookeeper_tpu_torch.serving.profile_forward \\
        [--model QuickNetLarge|BinaryAlexNet|BinaryNet|BiRealNet|BinaryDenseNet28|
                 MeliusNet22|BinaryDenseNet37Dilated] \\
        [--binary-compute xnor_popcount|xnor] [--binary-flavor auto|reference] \\
        [--top N]

Builds a packed deployment of the model through ``ServingConfig``
(weights from a seed): QuickNet-Large packed and BN-folded, bf16,
224x224; BinaryAlexNet bf16, 224x224, packed throughout under
"xnor_popcount" or, under "xnor", with "mxu" convs and the packed,
BN-folded dense stage (BASELINE's deployment); BinaryNet fp32, 32x32,
10 classes, packed throughout; Bi-Real-Net-18 packed and BN-folded (its
mean|w| scales), bf16, 224x224; BinaryDenseNet-28 packed (no fold: the
family is pre-activation), bf16, 224x224; MeliusNet-22 with latent
kernels packed at each call, bf16, 224x224; BinaryDenseNet-37-dilated on
"mxu" whatever ``--binary-compute`` says (its dilated convs run there
only). Times
``engine.infer`` on one batch of 8
with the host clock and a ``synchronize``, then traces the same forwards
with ``torch.profiler`` and prints one JSON line: the forward's wall
time, the device time per forward, the device's busy share (device time
over wall time) and the ``--top`` (8) kernels that take the most device
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

#: Each model's deployment, by binary_compute.
MODELS = {
    "QuickNetLarge": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": bc,
        "model.packed_weights": True, "model.fold_bn": True,
    },
    "BinaryAlexNet": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": bc,
        "model.packed_weights": True,
    } if bc == "xnor_popcount" else {
        "model.compute_dtype": "bfloat16", "model.binary_compute": "mxu",
        "model.dense_binary_compute": bc, "model.dense_packed_weights": True,
        "model.fold_bn": True,
    },
    "BinaryNet": lambda bc: {
        "model.compute_dtype": "float32", "model.binary_compute": bc,
        "model.packed_weights": True, "height": 32, "width": 32, "num_classes": 10,
    },
    "BiRealNet": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": bc,
        "model.packed_weights": True, "model.fold_bn": True,
    },
    "BinaryDenseNet28": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": bc,
        "model.packed_weights": True,
    },
    "MeliusNet22": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": bc,
    },
    "BinaryDenseNet37Dilated": lambda bc: {
        "model.compute_dtype": "bfloat16", "model.binary_compute": "mxu",
    },
}
#: The models with a ``binary_flavor`` field.
FLAVORED = ("QuickNetLarge", "BinaryNet")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="QuickNetLarge", choices=tuple(MODELS))
    parser.add_argument("--binary-compute", default="xnor_popcount",
                        choices=("xnor_popcount", "xnor"))
    parser.add_argument("--binary-flavor", default="auto", choices=("auto", "reference"))
    parser.add_argument("--top", type=int, default=TOP, help="kernels listed")
    args = parser.parse_args(argv)

    import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)

    cfg = ServingConfig()
    conf = MODELS[args.model](args.binary_compute)
    if args.model in FLAVORED:
        conf["model.binary_flavor"] = args.binary_flavor
    configure(cfg, {
        **conf, "model": args.model,
        "engine.batch_buckets": (BATCH,), "device": "cuda", "verbose": False,
    })
    engine, _ = cfg.build_service()
    x = np.random.default_rng(0).normal(size=(BATCH, *cfg.input_shape)).astype(np.float32)
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {
        "card": card,
        "model": args.model,
        "binary_compute": conf["model.binary_compute"],
        "binary_flavor": args.binary_flavor if args.model in FLAVORED else None,
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
