"""Latency measurement: the repo's two-chain-length protocol on the card.

The port of ``zookeeper_tpu/training/benchmark.py``. A chain of
back-to-back calls ends in one host readback of an element of its last
output, which is the completion barrier (a ``perf_counter`` around
launches alone times the launches, not the card). Each chain length takes
its minimum over ``rounds`` (the minimum over additive non-negative noise
is sound), and the marginal over two lengths cancels the fixed cost of a
chain's start and end while the per-call cost stays in.
"""

import time
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch


def time_marginal(run_chain, n1: int, n2: int, rounds: int) -> float:
    """Per-step marginal time via two-chain-length differencing, the JAX
    package's protocol (BASELINE.md methodology) unchanged.

    ``run_chain(n)`` runs ``n`` chained steps ended by a host readback
    and returns wall seconds. Each chain length takes its min over
    ``rounds`` INDEPENDENTLY (min over additive non-negative noise is
    sound), then the marginal is taken once — min over per-round
    *differences* would be biased fast whenever a jitter spike landed
    on a short chain. May return <= 0 under pathological jitter;
    callers decide how to handle.
    """
    t1_min = t2_min = None
    for _ in range(rounds):
        t1 = run_chain(n1)
        t2 = run_chain(n2)
        t1_min = t1 if t1_min is None else min(t1_min, t1)
        t2_min = t2 if t2_min is None else min(t2_min, t2)
    return (t2_min - t1_min) / (n2 - n1)


def _readback(out: torch.Tensor) -> float:
    """The chain's completion barrier: one element of the last output
    copied to the host."""
    return float(out.reshape(-1)[0])


def measure_fused_loop_time(
    multi_step: Callable[[Any, Any], Tuple[Any, Any]],
    state: Any,
    slab: Any,
    *,
    rounds: int = 4,
    n1: int = 8,
    n2: int = 24,
) -> Tuple[float, Any]:
    """Wall seconds per step of the fused loop in its steady state: the
    host's call of the multi-step (on the card a graph replay, with the
    slab's copy into the graph's buffers) and the card's work, end to
    end. Chains of ``n`` back-to-back calls of ``multi_step(state,
    slab)`` on the same ``slab``, each ended by one host readback of the
    last loss, timed by :func:`time_marginal`; the per-slab marginal over
    the slab's ``k`` steps. It trains ``state`` on the way, so time a
    copy the run does not need. Returns ``(seconds_per_step, state)``;
    the time may be non-positive under pathological jitter."""
    unroll = int(next(iter(slab.values())).shape[0])
    holder = {"state": state}

    def run_chain(n: int) -> float:
        st = holder["state"]
        metrics = None
        t0 = time.perf_counter()
        for _ in range(n):
            st, metrics = multi_step(st, slab)
        holder["state"] = st
        _readback(metrics["loss"].reshape(-1)[-1:])
        return time.perf_counter() - t0

    run_chain(2)  # a new multi-step's eager warm-up slab, then its capture
    per_slab = time_marginal(run_chain, n1, n2, rounds)
    return per_slab / unroll, holder["state"]


def measure_serving_latency(
    engine: Any,
    x: Any,
    *,
    n1: int = 8,
    n2: int = 24,
    rounds: int = 6,
    percentile_samples: int = 24,
    chain_len: int = 4,
) -> Tuple[float, float, float]:
    """Steady-state latency of one ``InferenceEngine.infer`` dispatch (the
    engine's Python, the host-to-card copy, the padded forward):

    - the mean per dispatch from :func:`time_marginal` over chains of
      back-to-back dispatches;
    - p50/p99 over ``percentile_samples`` short chains of ``chain_len``
      dispatches each (chain time / ``chain_len``), which keeps the
      dispatch-to-dispatch spread a single marginal averages away.

    Warm the engine first (``warmup()``). Returns ``(mean_s, p50_s,
    p99_s)``; the mean may be non-positive under pathological jitter.
    """

    def run_chain(k: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = engine.infer(x)
        _readback(out)
        return time.perf_counter() - t0

    run_chain(2)  # warm the dispatch path
    mean_s = time_marginal(run_chain, n1, n2, rounds)
    samples = np.asarray(
        sorted(run_chain(chain_len) / chain_len for _ in range(percentile_samples))
    )
    return (
        mean_s,
        float(np.percentile(samples, 50)),
        float(np.percentile(samples, 99)),
    )


def eager_chain_latency(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    length: int = 50,
    rounds: int = 4,
    escalate: bool = True,
) -> float:
    """Marginal seconds per ``apply_fn(x)`` call over chains of eager
    calls, the counterpart of the JAX package's ``scan_chain_latency``.

    Each call's input carries a data-dependent scalar of the previous
    output, as the scan does. Unlike one compiled scan, every call here
    launches its kernels from the host, so the time includes the host's
    launch cost (the cost a caller of the eager module pays). A
    non-positive marginal retries once at 4x the length and 2x the
    rounds (``escalate``) before it is floored at 1 ns.
    """

    def run_chain(k: int) -> float:
        t0 = time.perf_counter()
        xx = x
        y = None
        with torch.inference_mode():
            for _ in range(k):
                y = apply_fn(xx)
                xx = x + (y.sum() * 1e-12).to(x.dtype)
        _readback(y)
        return time.perf_counter() - t0

    run_chain(2)  # warm the launch path
    marginal = time_marginal(run_chain, length, 2 * length, rounds)
    if marginal <= 0 and escalate:
        return eager_chain_latency(apply_fn, x, length=4 * length, rounds=2 * rounds,
                                   escalate=False)
    return max(marginal, 1e-9)


def measure_inference_latency(
    module: torch.nn.Module,
    input_shape: Sequence[int],
    *,
    batch_size: int = 1,
    dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    length: int = 50,
    rounds: int = 4,
    seed: int = 0,
) -> float:
    """Seconds per eval-mode forward of ``module`` at ``batch_size`` on
    ``device`` (:func:`eager_chain_latency` on a seeded input)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(batch_size, *input_shape))).to(device=device,
                                                                         dtype=dtype)
    module.eval()
    return eager_chain_latency(module, x, length=length, rounds=rounds)
