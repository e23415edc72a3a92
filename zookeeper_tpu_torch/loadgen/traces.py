"""Deterministic arrival traces for replaying load against a service.

The port of ``zookeeper_tpu/loadgen/traces.py``. A trace is a list of
:class:`TraceRequest` (arrival offset, prompt tokens, generation budget,
deadline, optional session) plus the seed that made it. Every sampled
value comes from ``AugRng(seed, request_index, FIELD_STREAM)`` (the
port's ``data.augrng``, the same splitmix64 stream as the JAX package's):
one stream per (request, field), so a knob of one field never moves the
draws of another, and one seed gives the same trace, byte for byte, in
both packages and on any host. Nothing here reads a clock: arrivals are
offsets in ms from the trace's start, which the replay maps onto real
time.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

from zookeeper_tpu_torch.data.augrng import AugRng

__all__ = [
    "Trace",
    "TraceRequest",
    "diurnal_ramp",
    "from_request_log",
    "poisson_burst",
    "session_mix",
]

# Per-field stream ids (the AugRng ``epoch`` coordinate): each sampled
# quantity draws from its own counter stream keyed on the REQUEST
# index, so field draws never interleave.
_S_ARRIVAL = 0
_S_PROMPT_LEN = 1
_S_OUT_LEN = 2
_S_TOKENS = 3
_S_SESSION = 4


@dataclasses.dataclass
class TraceRequest:
    """One request in a trace: WHEN it arrives (ms offset from trace
    start), WHAT it asks (prompt tokens + generation budget +
    deadline), and WHO it is (optional multi-turn session key)."""

    index: int
    at_ms: float
    prompt: List[int]
    max_new_tokens: int = 16
    deadline_ms: Optional[float] = None
    session: Optional[str] = None
    #: Generator-assigned phase label ("base"/"burst"/"cooldown"/...)
    #: the SLO report aggregates per-phase percentiles under.
    phase: str = "base"


@dataclasses.dataclass
class Trace:
    """A named, seed-keyed request schedule. ``requests`` is sorted by
    ``at_ms`` (generators guarantee it; ``load`` re-sorts)."""

    name: str
    seed: int
    requests: List[TraceRequest]

    @property
    def duration_ms(self) -> float:
        return self.requests[-1].at_ms if self.requests else 0.0

    def phases(self) -> List[str]:
        """Phase labels in first-appearance order."""
        seen: List[str] = []
        for r in self.requests:
            if r.phase not in seen:
                seen.append(r.phase)
        return seen

    def stats(self) -> Dict[str, Any]:
        """Workload-shape summary (also the bench's informational
        keys): count, duration, mean prompt/output lengths, sessions."""
        n = len(self.requests)
        if n == 0:
            return {"requests": 0}
        return {
            "requests": n,
            "duration_ms": round(self.duration_ms, 3),
            "mean_prompt_tokens": round(
                sum(len(r.prompt) for r in self.requests) / n, 2
            ),
            "max_prompt_tokens": max(len(r.prompt) for r in self.requests),
            "mean_new_tokens": round(
                sum(r.max_new_tokens for r in self.requests) / n, 2
            ),
            "sessions": len(
                {r.session for r in self.requests if r.session is not None}
            ),
            "phases": {
                p: sum(1 for r in self.requests if r.phase == p)
                for p in self.phases()
            },
        }

    # -- (de)serialization -----------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "name": self.name,
                    "seed": self.seed,
                    "requests": [
                        dataclasses.asdict(r) for r in self.requests
                    ],
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            raw = json.load(f)
        reqs = [TraceRequest(**r) for r in raw["requests"]]
        reqs.sort(key=lambda r: (r.at_ms, r.index))
        return cls(
            name=str(raw["name"]), seed=int(raw["seed"]), requests=reqs
        )


# -- sampling primitives -------------------------------------------------


def _exp_gap_ms(rng: AugRng, rate_rps: float) -> float:
    """One exponential inter-arrival gap for a Poisson process at
    ``rate_rps``. ``-log(1-u)`` with u in [0,1) never takes log(0)."""
    u = rng.uniform(0.0, 1.0)
    return -math.log(1.0 - u) / rate_rps * 1e3


def _pareto_int(rng: AugRng, lo: int, hi: int, alpha: float) -> int:
    """Bounded-Pareto integer in [lo, hi]: inverse-transform
    ``lo / u**(1/alpha)`` clamped at ``hi`` — the heavy tail real
    prompt/output length distributions show (most short, a few huge)."""
    u = rng.uniform(0.0, 1.0)
    u = max(u, 1e-12)  # u=0 would be an infinite draw
    return min(hi, max(lo, int(lo / u ** (1.0 / alpha))))


def _prompt(rng: AugRng, length: int, vocab: int) -> List[int]:
    """Tokens in [1, vocab): 0 is reserved (pad/eos in the tiny serving
    configs), so a generated prompt can never fake an EOS."""
    return [1 + rng.randint(vocab - 1) for _ in range(length)]


def _fill(
    reqs: List[TraceRequest],
    seed: int,
    *,
    vocab: int,
    prompt_lo: int,
    prompt_hi: int,
    out_lo: int,
    out_hi: int,
    alpha: float,
    deadline_ms: Optional[float],
) -> None:
    """Sample prompt/output sizes + tokens for requests that carry only
    arrival metadata. Heavy-tailed in BOTH dimensions."""
    for r in reqs:
        plen = _pareto_int(
            AugRng(seed, r.index, _S_PROMPT_LEN), prompt_lo, prompt_hi, alpha
        )
        r.prompt = _prompt(AugRng(seed, r.index, _S_TOKENS), plen, vocab)
        r.max_new_tokens = _pareto_int(
            AugRng(seed, r.index, _S_OUT_LEN), out_lo, out_hi, alpha
        )
        r.deadline_ms = deadline_ms


# -- generators ----------------------------------------------------------


def poisson_burst(
    seed: int,
    *,
    base_rate_rps: float = 20.0,
    burst_rate_rps: float = 200.0,
    base_s: float = 1.0,
    burst_s: float = 1.0,
    cooldown_s: float = 1.0,
    vocab: int = 64,
    prompt_len: int = 4,
    max_prompt_len: int = 24,
    new_tokens: int = 4,
    max_new_tokens: int = 16,
    tail_alpha: float = 1.5,
    deadline_ms: Optional[float] = None,
    name: str = "poisson_burst",
) -> Trace:
    """Piecewise-constant-rate Poisson arrivals: a ``base`` phase, a
    ``burst`` phase at ``burst_rate_rps`` (the overload the guardrails
    exist for), and a ``cooldown`` phase back at base rate (where the
    system should RECOVER — brown-out release, breaker close). Prompt
    and output lengths are bounded-Pareto heavy-tailed."""
    if base_rate_rps <= 0 or burst_rate_rps <= 0:
        raise ValueError("arrival rates must be > 0 rps.")
    phases = [
        ("base", base_s, base_rate_rps),
        ("burst", burst_s, burst_rate_rps),
        ("cooldown", cooldown_s, base_rate_rps),
    ]
    reqs: List[TraceRequest] = []
    t_ms, index = 0.0, 0
    for phase, dur_s, rate in phases:
        end_ms = t_ms + dur_s * 1e3
        while True:
            t_ms += _exp_gap_ms(AugRng(seed, index, _S_ARRIVAL), rate)
            if t_ms >= end_ms:
                t_ms = end_ms
                break
            reqs.append(
                TraceRequest(index=index, at_ms=t_ms, prompt=[], phase=phase)
            )
            index += 1
    _fill(
        reqs,
        seed,
        vocab=vocab,
        prompt_lo=prompt_len,
        prompt_hi=max_prompt_len,
        out_lo=new_tokens,
        out_hi=max_new_tokens,
        alpha=tail_alpha,
        deadline_ms=deadline_ms,
    )
    return Trace(name=name, seed=seed, requests=reqs)


def diurnal_ramp(
    seed: int,
    *,
    peak_rate_rps: float = 100.0,
    trough_frac: float = 0.1,
    duration_s: float = 4.0,
    cycles: float = 1.0,
    vocab: int = 64,
    prompt_len: int = 4,
    max_prompt_len: int = 24,
    new_tokens: int = 4,
    max_new_tokens: int = 16,
    tail_alpha: float = 1.5,
    deadline_ms: Optional[float] = None,
    name: str = "diurnal_ramp",
) -> Trace:
    """Sinusoidal-rate arrivals via thinning: candidates are drawn at
    the peak rate and kept with probability ``rate(t)/peak`` — the
    standard non-homogeneous Poisson construction, exact and purely
    counter-keyed. Phases label the half-cycles (``ramp_up``/
    ``ramp_down``) so the report shows how the system tracks a moving
    operating point rather than a step."""
    if peak_rate_rps <= 0 or not (0.0 <= trough_frac <= 1.0):
        raise ValueError(
            "peak_rate_rps must be > 0 and trough_frac in [0, 1]."
        )
    end_ms = duration_s * 1e3
    omega = 2.0 * math.pi * cycles / end_ms
    reqs: List[TraceRequest] = []
    t_ms, index, candidate = 0.0, 0, 0
    while True:
        rng = AugRng(seed, candidate, _S_ARRIVAL)
        t_ms += _exp_gap_ms(rng, peak_rate_rps)
        candidate += 1
        if t_ms >= end_ms:
            break
        # rate(t)/peak: trough..1.0 sinusoid starting at the trough.
        level = trough_frac + (1.0 - trough_frac) * 0.5 * (
            1.0 - math.cos(omega * t_ms)
        )
        if rng.uniform(0.0, 1.0) >= level:
            continue  # thinned
        rising = math.sin(omega * t_ms) >= 0.0
        reqs.append(
            TraceRequest(
                index=index,
                at_ms=t_ms,
                prompt=[],
                phase="ramp_up" if rising else "ramp_down",
            )
        )
        index += 1
    _fill(
        reqs,
        seed,
        vocab=vocab,
        prompt_lo=prompt_len,
        prompt_hi=max_prompt_len,
        out_lo=new_tokens,
        out_hi=max_new_tokens,
        alpha=tail_alpha,
        deadline_ms=deadline_ms,
    )
    return Trace(name=name, seed=seed, requests=reqs)


def session_mix(
    seed: int,
    *,
    sessions: int = 8,
    turns: int = 4,
    rate_rps: float = 50.0,
    shared_prefix_len: int = 8,
    turn_tokens: int = 4,
    vocab: int = 64,
    new_tokens: int = 4,
    max_new_tokens: int = 16,
    tail_alpha: float = 1.5,
    deadline_ms: Optional[float] = None,
    name: str = "session_mix",
) -> Trace:
    """Multi-turn conversations over a COMMON system prefix: every
    session's turn-k prompt is ``shared_prefix + session_tokens[: k *
    turn_tokens]`` — the growing-prefix shape that exercises the radix
    cache (turn k re-enters turn k-1's pages) and the router's session
    pinning. Turns arrive round-robin across sessions on one Poisson
    clock, so sessions INTERLEAVE (the cache-thrash case, not the
    one-conversation-at-a-time one)."""
    if sessions < 1 or turns < 1:
        raise ValueError("sessions and turns must be >= 1.")
    shared = _prompt(
        AugRng(seed, 0, _S_SESSION), shared_prefix_len, vocab
    )
    # Each session's private token tail, drawn once up front; turn k
    # exposes a prefix of it — strictly growing, never rewritten.
    tails = [
        _prompt(
            AugRng(seed, 1 + s, _S_SESSION), turns * turn_tokens, vocab
        )
        for s in range(sessions)
    ]
    reqs: List[TraceRequest] = []
    t_ms, index = 0.0, 0
    for turn in range(turns):
        for s in range(sessions):
            t_ms += _exp_gap_ms(AugRng(seed, index, _S_ARRIVAL), rate_rps)
            reqs.append(
                TraceRequest(
                    index=index,
                    at_ms=t_ms,
                    prompt=shared + tails[s][: (turn + 1) * turn_tokens],
                    max_new_tokens=_pareto_int(
                        AugRng(seed, index, _S_OUT_LEN),
                        new_tokens,
                        max_new_tokens,
                        tail_alpha,
                    ),
                    deadline_ms=deadline_ms,
                    session=f"s{s}",
                    phase=f"turn{turn}",
                )
            )
            index += 1
    return Trace(name=name, seed=seed, requests=reqs)


def from_request_log(
    records: Iterable[Dict[str, Any]],
    *,
    seed: int,
    vocab: int = 64,
    default_new_tokens: int = 8,
    deadline_ms: Optional[float] = None,
    name: str = "replayed_log",
) -> Trace:
    """Rebuild a replayable trace from recorded ``RequestLog`` entries
    (``tail()`` dicts or a flight-recorder bundle's requests section):
    arrivals come from ``enqueue_ns`` offsets, generation budgets from
    the recorded ``tokens`` count, prompt SIZES from ``rows`` when
    present. Token CONTENT is not recorded, so prompts are synthesized
    from ``seed`` — the replay reproduces the log's arrival process and
    size mix, not its exact text."""
    recs = [r for r in records if r.get("enqueue_ns") is not None]
    recs.sort(key=lambda r: r["enqueue_ns"])
    if not recs:
        return Trace(name=name, seed=seed, requests=[])
    t0 = recs[0]["enqueue_ns"]
    reqs: List[TraceRequest] = []
    for i, rec in enumerate(recs):
        plen = int(rec.get("rows") or 0)
        if plen < 1:
            plen = _pareto_int(AugRng(seed, i, _S_PROMPT_LEN), 2, 16, 1.5)
        reqs.append(
            TraceRequest(
                index=i,
                at_ms=(rec["enqueue_ns"] - t0) / 1e6,
                prompt=_prompt(AugRng(seed, i, _S_TOKENS), plen, vocab),
                max_new_tokens=int(
                    rec.get("tokens") or default_new_tokens
                ),
                deadline_ms=deadline_ms,
                phase="replay",
            )
        )
    return Trace(name=name, seed=seed, requests=reqs)
