"""Time the port's two serving paths in two checkouts, alternated on one
card: this checkout against another (a parent, unpacked with
``git archive``), with observability off, as a user of either serves.

    python -m zookeeper_tpu_torch.ab_serving --against DIR [--rounds 3] [--runs 3]
                                             [--out FILE]

Each leg is a process of its own whose ``sys.path`` starts at one
checkout's root, so it imports that checkout's ``zookeeper_tpu_torch``
and builds (or reuses) that checkout's kernels. The legs run in the
order other, this, this, other, other, this, ... (``--rounds`` a side).
A leg serves, ``--runs`` times after one unmeasured run:

- ``lm``: chip_smoke.py phase 10's paged run (TransformerLM of 4 layers,
  d 512, 8x64 heads, bf16, a page pool of 16-token pages, 8 slots, 32
  requests of 1-2048 prompt tokens, 64 new tokens each) through
  ``LMServingConfig.run()``: tokens/s, inter-token p50/p99, TTFT p50;
  and, at the middle decode step of the unmeasured run (its tokens,
  lengths and page table), the wall ms of a ``DecodeEngine.decode`` call
  (the median of each of 5 batches of 100 calls), and the host operator
  calls and card kernels of one such call (``torch.profiler``);
- ``cnn``: slice A (QuickNet-Large, bf16, packed ``xnor_popcount``, 224x224,
  buckets (1, 8)) through ``ServingConfig.run()`` on 64 requests of 1-8
  rows: requests/s and latency p50/p99; then 20 batch-8 forwards through
  ``InferenceEngine.infer`` (synchronised): ms a forward; and once a leg,
  the host operator calls and card kernels of one forward
  (``torch.profiler``).

Each leg also hashes the tokens of every LM run and the logits of one
seeded batch-8 forward; the script exits 1 unless every run of both
checkouts gave the same tokens and the same logits. It prints each
leg's line, then one JSON summary (per metric and side: the runs, the
median, the range, change/other of the medians, and whether the ranges
overlap), with the card's name and power limit. Runs on a machine with
one card and ``nvcc``.
"""

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

#: chip_smoke.py's ``LM_CONFIG`` with its ``PAGED`` overrides (phase 10).
LM = {
    "model.num_layers": 4, "model.d_model": 512, "model.num_heads": 8,
    "model.mlp_ratio": 4, "model.compute_dtype": "bfloat16",
    "seq_len": 8192, "vocab_size": 1024,
    "engine.slots": 8, "engine.seq_buckets": (512, 2048), "engine.prefill_buckets": (1,),
    "engine.page_size": 16, "engine.decode_attention": "auto",
    "engine.kv_layout": "paged", "engine.prefix_cache": False,
    "requests": 32, "max_prompt": 2048, "new_tokens": 64, "seed": 0,
    "device": "cuda", "verbose": False,
}
#: chip_smoke.py's slice A, served as its ``slice_phase`` serves it.
CNN = {
    "model": "QuickNetLarge", "model.compute_dtype": "bfloat16",
    "model.binary_compute": "xnor_popcount", "model.packed_weights": True,
    "model.fold_bn": True, "model.binary_flavor": "auto",
    "height": 224, "width": 224, "channels": 3, "num_classes": 1000,
    "engine.batch_buckets": (1, 8), "requests": 64, "max_request": 8,
    "seed": 0, "device": "cuda", "verbose": False,
}
LM_KEYS = ("tokens_per_sec", "itl_p50_ms", "itl_p99_ms", "ttft_p50_ms")
CNN_KEYS = ("qps", "latency_p50_ms", "latency_p99_ms")
#: Batch-8 forwards timed through ``InferenceEngine.infer``.
FORWARDS = 20
#: Decode steps timed at one mid-run state: batches, calls a batch.
DECODE_REPS, DECODE_CALLS = 5, 100


def run_leg(lm: dict, cnn: dict, runs: int) -> dict:
    """One leg in this process: the LM stream and slice A, each ``runs``
    times after one unmeasured run. Returns the measurements and the
    answers' hashes."""
    import numpy as np
    import torch

    import zookeeper_tpu_torch
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import ServingConfig
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, LMServingConfig

    cuda = lm["device"] == "cuda"
    t0 = time.perf_counter()
    if cuda:
        from zookeeper_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    out = {"root": os.path.dirname(os.path.dirname(os.path.abspath(zookeeper_tpu_torch.__file__))),
           "build_s": time.perf_counter() - t0, "lm": [], "cnn": [], "forward_ms": []}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tokens = set()
    steps = []
    real_decode = DecodeEngine.decode

    def spy(engine, tokens, lengths):
        pool = engine.page_pool
        steps.append((np.array(tokens), np.array(lengths),
                      None if pool is None else pool.table.copy()))
        return real_decode(engine, tokens, lengths)

    for i in range(runs + 1):
        cfg = LMServingConfig()
        configure(cfg, lm)
        # The unmeasured run keeps every decode step's inputs.
        with mock.patch.object(DecodeEngine, "decode", spy) if not i else \
                contextlib.nullcontext():
            result = cfg.run()
        tokens.add(hashlib.sha256(np.concatenate(cfg.outputs).tobytes()).hexdigest())
        if i:
            out["lm"].append({k: result[k] for k in LM_KEYS})
        else:
            out["decode_step_ms"] = _decode_step_ms(cfg.engine, *steps[len(steps) // 2])
            out["decode_ops"], out["decode_kernels"] = _profiled_ops(
                torch, lambda: cfg.engine.decode(*steps[len(steps) // 2][:2]), sync)
        del cfg
        if cuda:
            torch.cuda.empty_cache()
    logits = set()
    x = np.random.default_rng(1).normal(size=(8, cnn["height"], cnn["width"], cnn["channels"]))
    x = x.astype(np.float32)
    for i in range(runs + 1):
        cfg = ServingConfig()
        configure(cfg, cnn)
        result = cfg.run()
        engine = cfg.engine
        logits.add(hashlib.sha256(engine.infer(x).float().cpu().numpy().tobytes()).hexdigest())
        if i:
            out["cnn"].append({k: result[k] for k in CNN_KEYS})
            sync()
            t1 = time.perf_counter()
            for _ in range(FORWARDS):
                engine.infer(x)
            sync()
            out["forward_ms"].append((time.perf_counter() - t1) / FORWARDS * 1e3)
        if i == runs:
            out["forward_ops"], out["forward_kernels"] = _profiled_ops(
                torch, lambda: engine.infer(x), sync)
        del cfg, engine
        if cuda:
            torch.cuda.empty_cache()
    out["lm_tokens"] = sorted(tokens)
    out["cnn_logits"] = sorted(logits)
    return out


def _decode_step_ms(engine, tokens, lengths, table) -> list:
    """Wall ms of one ``DecodeEngine.decode`` call (it ends in its
    readback) at a mid-run step's tokens, lengths and page table: the
    median of each of ``DECODE_REPS`` batches of ``DECODE_CALLS`` calls."""
    if table is not None:
        engine.page_pool.table[:] = table
    engine.decode(tokens, lengths)
    out = []
    for _ in range(DECODE_REPS):
        times = []
        for _ in range(DECODE_CALLS):
            t0 = time.perf_counter()
            engine.decode(tokens, lengths)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(times))
    return out


def _profiled_ops(torch, call, sync):
    """Operator calls on the host and kernels on the card of one ``call()``
    (a batch-8 forward, or a decode step at the fixed mid-run state, whose
    page table ``_decode_step_ms`` left in place), under
    ``torch.profiler``, after one unprofiled call: the work the two
    checkouts issue, beside their times."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    call()
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) \
            as prof:
        call()
        sync()
    events = prof.key_averages()
    device = torch.autograd.DeviceType
    return (sum(e.count for e in events if e.device_type == device.CPU),
            sum(e.count for e in events if e.device_type == device.CUDA))


def _leg_main(root: str, spec: str) -> None:
    # The script's own directory (``zookeeper_tpu_torch/``) must not
    # shadow top-level names; the leg's checkout comes first.
    sys.path[0] = root
    os.chdir(root)
    s = json.loads(spec)
    print(json.dumps(run_leg(s["lm"], s["cnn"], s["runs"])), flush=True)


def _summary(legs, this: str, other: str) -> dict:
    series = {}
    for side, leg in legs:
        rows = {f"lm.{k}": [r[k] for r in leg["lm"]] for k in LM_KEYS}
        rows.update({f"cnn.{k}": [r[k] for r in leg["cnn"]] for k in CNN_KEYS})
        rows["cnn.forward_ms"] = leg["forward_ms"]
        rows["lm.decode_step_ms"] = leg["decode_step_ms"]
        for metric, values in rows.items():
            series.setdefault(metric, {}).setdefault(side, []).extend(values)
    out = {}
    for metric, sides in series.items():
        a, b = sides[this], sides[other]
        ma, mb = statistics.median(a), statistics.median(b)
        out[metric] = {
            "change": a, "other": b, "median_change": ma, "median_other": mb,
            "range_change": [min(a), max(a)], "range_other": [min(b), max(b)],
            "change_over_other": ma / mb if mb else None,
            "ranges_overlap": min(a) <= max(b) and min(b) <= max(a),
        }
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="the other checkout's root")
    parser.add_argument("--rounds", type=int, default=3, help="legs a side")
    parser.add_argument("--runs", type=int, default=3, help="measured runs a leg")
    parser.add_argument("--out", help="write the legs and the summary here as JSON")
    parser.add_argument("--leg", nargs=2, metavar=("ROOT", "SPEC"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.leg:
        _leg_main(*args.leg)
        return
    if not args.against:
        parser.error("--against DIR is required")
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.against)
    if not os.path.isdir(os.path.join(other, "zookeeper_tpu_torch")):
        parser.error(f"{other} holds no zookeeper_tpu_torch/")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    spec = json.dumps({"lm": LM, "cnn": CNN, "runs": args.runs})
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    env.pop("PYTHONPATH", None)
    order = []
    for r in range(args.rounds):
        order += [("other", other), ("change", this)] if r % 2 == 0 else \
            [("change", this), ("other", other)]
    legs = []
    for side, root in order:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", root, spec],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"the {side} leg ({root}) exited {proc.returncode}")
        leg = json.loads(proc.stdout.strip().splitlines()[-1])
        leg["side"], leg["wall_s"] = side, time.perf_counter() - t0
        print(json.dumps(leg), flush=True)
        legs.append((side, leg))
    hashes = {what: {side: sorted({h for s, leg in legs if s == side for h in leg[what]})
                     for side in ("other", "change")} for what in ("lm_tokens", "cnn_logits")}
    same = all(len({h for hs in sides.values() for h in hs}) == 1 for sides in hashes.values())
    # The host operators and kernels of one forward and one fixed-state
    # decode step: counts, the same in every leg of a checkout.
    work = {f"{what}_{unit}": {side: sorted({leg.get(f"{what}_{unit}") for s, leg in legs
                                             if s == side})
                               for side in ("other", "change")}
            for what in ("forward", "decode") for unit in ("ops", "kernels")}
    summary = {"card": smi, "order": [side for side, _ in legs],
               "answers_equal": same, "answers": hashes, "work": work,
               "metrics": _summary(legs, "change", "other")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"legs": [leg for _, leg in legs], "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    if not same:
        raise SystemExit("the tokens or logits differ between runs or checkouts")


if __name__ == "__main__":
    main()
