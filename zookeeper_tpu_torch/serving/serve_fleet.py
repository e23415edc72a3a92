"""Fleet serving as a task, the port of ``examples/serve_fleet.py``'s
``ServeFleet``: a ``FleetRouter`` in front of freshly spawned worker
processes (``serving.fleet_worker``), each a paged ``LMServingConfig``
with the radix prefix cache on, driven by a seeded multi-turn stream
(``sessions`` x ``turns``, each turn the last one plus ``tail_tokens``)::

    # 2 replicas, 3 sessions x 2 turns, on the card:
    python -m zookeeper_tpu_torch.serving ServeFleet
    # the same on the CPU:
    python -m zookeeper_tpu_torch.serving ServeFleet device=cpu
    # the no-affinity baseline (affinity_hits 0, cold later turns):
    python -m zookeeper_tpu_torch.serving ServeFleet policy=round_robin
    # the router's live /metrics and /statusz while the stream runs:
    python -m zookeeper_tpu_torch.serving ServeFleet metrics_port=8080

It prints one JSON line: the routing totals (``routed_total``,
``affinity_hits``, ``rerouted``, ``healthy_replicas``), the tokens and
tokens/s, ``warm_shared_tokens`` (each later turn's prompt tokens the
worker's cache served), the first turn's and the later turns' TTFT
p50 and the routing decision's p50. Under ``policy=affinity`` with
``turns >= 2`` every ``warm_shared_tokens`` entry is positive; the
tokens do not depend on the policy.
"""

import json
import shutil
import tempfile
import time

import numpy as np

from zookeeper_tpu_torch.core import Field, task
from zookeeper_tpu_torch.serving.fleet import FleetRouter, ReplicaHandle
from zookeeper_tpu_torch.serving.fleet_worker import spawn_fleet_workers, stop_fleet_workers
from zookeeper_tpu_torch.training.experiment import Experiment


@task
class ServeFleet(Experiment):
    """Route a seeded multi-turn session stream through a freshly spawned
    fleet of worker processes."""

    #: The fleet and its routing policy ("affinity" or "round_robin").
    replicas: int = Field(2)
    policy: str = Field("affinity")
    #: The stream: sessions x turns, turn t+1 = turn t + ``tail_tokens``.
    sessions: int = Field(3)
    turns: int = Field(2)
    #: The first turn's prompt length.
    shared_tokens: int = Field(48)
    tail_tokens: int = Field(8)
    new_tokens: int = Field(8)
    #: Every worker's model and engine.
    num_layers: int = Field(2)
    d_model: int = Field(64)
    num_heads: int = Field(4)
    vocab_size: int = Field(61)
    page_size: int = Field(16)
    slots: int = Field(4)
    seed: int = Field(0)
    #: The router's endpoint: -1 off, 0 an ephemeral port.
    metrics_port: int = Field(-1)
    verbose: bool = Field(True)
    #: Where the workers' models run: "cuda" (a worker fails without a
    #: card) or "cpu".
    device: str = Field("cuda")

    def run(self):
        if self.turns < 1 or self.sessions < 1 or self.replicas < 1:
            raise ValueError(
                "ServeFleet needs replicas/sessions/turns >= 1 "
                f"(got {self.replicas}/{self.sessions}/{self.turns})."
            )
        max_prompt = self.shared_tokens + (self.turns - 1) * self.tail_tokens
        seq_len = max(64, 2 * (max_prompt + self.new_tokens))
        conf = {
            "model.num_layers": self.num_layers,
            "model.d_model": self.d_model,
            "model.num_heads": self.num_heads,
            "model.max_seq_len": seq_len,
            "seq_len": seq_len,
            "vocab_size": self.vocab_size,
            "seed": self.seed,
            "engine.kv_layout": "paged",
            "engine.page_size": self.page_size,
            "engine.slots": self.slots,
            "engine.seq_buckets": (16, max_prompt),
            "engine.prefill_buckets": (1,),
            "requests": 0,
            "verbose": False,
            "device": self.device,
        }
        # Seeded, so a rerun (and the round-robin baseline) sees the same
        # prompts.
        rng = np.random.default_rng(self.seed + 11)
        session_ids = [f"s{i}" for i in range(self.sessions)]
        prompts = {}
        for sid in session_ids:
            base = rng.integers(1, self.vocab_size, size=self.shared_tokens).tolist()
            turn_prompts = [list(base)]
            for _ in range(self.turns - 1):
                base = base + rng.integers(1, self.vocab_size, size=self.tail_tokens).tolist()
                turn_prompts.append(list(base))
            prompts[sid] = turn_prompts

        workdir = tempfile.mkdtemp(prefix="zk_serve_fleet_")
        workers = []
        router = None
        try:
            workers = spawn_fleet_workers(workdir, num_workers=self.replicas, config=conf)
            router = FleetRouter([ReplicaHandle.from_worker(w) for w in workers],
                                 page_size=self.page_size, policy=self.policy)
            if self.metrics_port >= 0:
                obs = router.start_observability(port=self.metrics_port)
                if self.verbose:
                    print(f"router observability: {obs.url}/metrics", flush=True)
            warm_shared = []
            ttft_by_turn = {t: [] for t in range(self.turns)}
            generated = 0
            t0 = time.perf_counter()
            # Turn-major: every session's turn t lands before any turn t+1.
            for turn in range(self.turns):
                for sid in session_ids:
                    resp = router.submit(prompts[sid][turn],
                                         session=sid if self.policy == "affinity" else None,
                                         max_new_tokens=self.new_tokens)
                    ttft_by_turn[turn].append(float(resp.ttft_ms))
                    generated += int(resp.tokens.shape[0])
                    if turn > 0:
                        warm_shared.append(int(resp.shared_tokens))
                    if self.verbose:
                        print(f"  {resp.rid} session={sid} turn={turn} -> {resp.worker_id} "
                              f"shared={resp.shared_tokens} ttft={resp.ttft_ms:.2f}ms",
                              flush=True)
            dt = time.perf_counter() - t0
            snap = router.metrics.snapshot()
            status = router.status()
            result = {
                "policy": self.policy,
                "replicas": self.replicas,
                "sessions": self.sessions,
                "turns": self.turns,
                "requests": self.sessions * self.turns,
                "generated_tokens": generated,
                "tokens_per_sec": round(generated / dt, 1),
                "routed_total": status["routed_total"],
                "affinity_hits": status["affinity_hits_total"],
                "rerouted": status["rerouted_total"],
                "healthy_replicas": status["healthy_replicas"],
                "warm_shared_tokens": warm_shared,
                "turn1_ttft_p50_ms": round(float(np.percentile(ttft_by_turn[0], 50)), 3),
                "route_ms_p50": snap.get("fleet_route_ms_p50"),
            }
            if self.turns > 1:
                warm = [x for t in range(1, self.turns) for x in ttft_by_turn[t]]
                result["warm_ttft_p50_ms"] = round(float(np.percentile(warm, 50)), 3)
            print(json.dumps(result), flush=True)
            return result
        finally:
            # close() stops the endpoint it started.
            if router is not None:
                router.close()
            stop_fleet_workers(workers)
            shutil.rmtree(workdir, ignore_errors=True)
