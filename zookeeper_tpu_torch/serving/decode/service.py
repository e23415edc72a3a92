"""The LM decode service config: model -> warmed decode engine ->
continuous-batching scheduler.

The port of ``zookeeper_tpu/serving/decode/service.py``'s
``LMServingConfig``, a ``@task`` driven by the port's ``key=value``
CLI::

    python -m zookeeper_tpu_torch.serving.decode LMServingConfig \\
        model.num_layers=4 model.d_model=512 model.num_heads=8 \\
        model.compute_dtype=bfloat16 seq_len=8192 vocab_size=1024 \\
        engine.seq_buckets='(512,2048)' max_prompt=2048 new_tokens=64

``build_service()`` builds the model, loads its weights from
``checkpoint`` (a model-only export or a ``Checkpointer`` directory's
latest step, the EMA or the raw weights as ``weights`` picks them:
``ServingConfig``'s loader) or initializes them from ``seed``, binds and
warms the engine on ``device`` under ``partitioner`` and binds the
scheduler. Under ``torchrun`` (``runtime`` forms the group) every rank
runs the same ``run()`` on the same seeded stream and holds its share of
the weights and the KV cache (``DecodeEngine.bind(partitioner=...)``);
the threaded scheduler (``scheduler.synchronous=False``) and deadlines
serve there chief-led (rank 0 decides each iteration, see
``DecodeScheduler``); only the chief prints::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m zookeeper_tpu_torch.serving.decode LMServingConfig ... \
        partitioner=MeshPartitioner partitioner.mesh_shape='(1,2)' \
        partitioner.mesh_axes='(data,model)'

``run()`` serves the JAX ``run()``'s seeded prompt stream and prints one
JSON line: tokens/s, TTFT and inter-token percentiles, the resolved
decode attention, the KV layout, the pool fill and the prefix cache's
hit rate, whether speculation served (``speculative``, ``spec_k``,
``spec_acceptance_rate``) and ``decode_mbu`` (see
``DecodeEngine.decode_mbu``: counted from the shapes, where the JAX
figure comes from XLA's cost analysis). ``speculative.enabled=True``
serves the draft/verify schedule with ``speculative.draft_model``
(weights from ``speculative.draft_checkpoint`` or the seed); a draft
that cannot be loaded or bound falls back to plain decode with a
warning, and the line says ``"speculative": false``.

**Observability**, off by default, as ``ServingConfig`` has it:
``metrics_port`` >= 0 starts the endpoint (``/metrics``: every
``zk_decode_*``, ``zk_spec_*``, ``zk_prefill_*``, ``zk_kv_pool_*``,
``zk_prefix_cache_*`` and ``zk_transfer_*`` series of ``metrics``, the
engine's ``zk_decode_kv_bytes`` and ``zk_decode_mbu``, the device
probe's ``zk_hbm_*``; ``/statusz``: the ``decode`` section
(``scheduler.status()``), the ``requests`` RequestLog tail and the
``programs`` ledger; ``/trace``; ``POST /debugz``), and
``flight_recorder_dir`` arms the recorder (``flight_recorder_interval_s``
apart). ``run()`` keeps them up until its report is printed; every exit
path tears down through ``run_teardown_steps``.

**Overload guardrails**, off by default: ``guard.enabled=True`` binds
``guard`` (``serving.guardrails.OverloadGuard``) into the scheduler, so a
request predicted to miss its deadline (``scheduler.default_deadline_ms``
or the submit's ``deadline_ms``) is shed at submit with
``PredictedMissError``, and ``guard.brownout_after>0`` adds the
brown-out (capped ``max_new_tokens``, speculation off, applied only with
the slot array drained). Its ``zk_guard_*`` series render at
``/metrics`` and its state in the ``guardrails`` section of
``/statusz``::

    python -m zookeeper_tpu_torch.serving.decode LMServingConfig device=cpu \
        ... guard.enabled=True guard.brownout_after=4 \
        scheduler.default_deadline_ms=500
"""

import json
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from zookeeper_tpu_torch.core import ComponentField, Field, pretty_print, task
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.transformer import TransformerLM
from zookeeper_tpu_torch.parallel.distributed import DistributedRuntime
from zookeeper_tpu_torch.parallel.partitioner import Partitioner, SingleDevicePartitioner
from zookeeper_tpu_torch.serving.decode.engine import DecodeEngine
from zookeeper_tpu_torch.serving.decode.metrics import DecodeMetrics
from zookeeper_tpu_torch.serving.decode.scheduler import DecodeScheduler
from zookeeper_tpu_torch.serving.decode.speculative import SpeculativeDecoding
from zookeeper_tpu_torch.serving.guardrails import OverloadGuard
from zookeeper_tpu_torch.serving.service import ObservedService, run_teardown_steps

logger = logging.getLogger(__name__)

__all__ = ["LMServingConfig"]


@task
class LMServingConfig(ObservedService):
    """Stream tokens for a seeded synthetic prompt stream through the
    decode engine and scheduler, and report tokens/s and latencies."""

    model: Model = ComponentField(TransformerLM)
    #: The layout to serve under (the training one); the default is one
    #: card.
    partitioner: Partitioner = ComponentField(SingleDevicePartitioner)
    #: Forms the process group under a launcher (``torchrun``).
    runtime: DistributedRuntime = ComponentField(DistributedRuntime)
    engine: DecodeEngine = ComponentField(DecodeEngine)
    scheduler: DecodeScheduler = ComponentField(DecodeScheduler)
    metrics: DecodeMetrics = ComponentField(DecodeMetrics)
    #: Speculative decoding: ``speculative.enabled=True speculative.k=4
    #: speculative.draft_checkpoint=DIR``. A draft that cannot be loaded or
    #: bound falls back to plain decode, loudly.
    speculative: SpeculativeDecoding = ComponentField(SpeculativeDecoding)
    #: Overload guardrails: ``guard.enabled=True`` sheds requests
    #: predicted to miss their deadline at submit, ``guard.brownout_after``
    #: > 0 adds the brown-out. Off by default.
    guard: OverloadGuard = ComponentField(OverloadGuard)

    #: The deployment artifact: a ``save_model`` export or a
    #: ``Checkpointer`` directory (its latest step). None serves weights
    #: initialized from ``seed``.
    checkpoint: Optional[str] = Field(None)
    #: "auto" serves the EMA when the checkpoint carries one, "ema"
    #: requires it, "raw" the training parameters
    #: (``training.checkpoint.select_inference_weights``).
    weights: str = Field("auto")
    #: The positional capacity the model is built with, and the vocab.
    seq_len: int = Field(128)
    vocab_size: int = Field(256)
    #: Seeds the weights and the prompt stream.
    seed: int = Field(0)
    #: Run every prefill bucket and one decode step before serving.
    warmup: bool = Field(True)
    #: ``run()``'s stream: request count, longest prompt, tokens each.
    requests: int = Field(32)
    max_prompt: int = Field(12)
    new_tokens: int = Field(16)
    verbose: bool = Field(True)
    #: Where the model runs: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")
    #: The live endpoint's port: -1 off, 0 an ephemeral port
    #: (``obs_server.port``).
    metrics_port: int = Field(-1)
    #: Where the flight recorder writes its bundles; None: off.
    flight_recorder_dir: Optional[str] = Field(None)
    #: Least seconds between two bundles (``POST /debugz`` bypasses it).
    flight_recorder_interval_s: float = Field(30.0)

    def build_service(self):
        """Build the model, load or initialize its weights, bind and warm
        the engine, bind the scheduler. Returns ``(engine, scheduler)``."""
        if self.weights not in ("auto", "ema", "raw"):
            raise ValueError(f"weights={self.weights!r} unknown; choose auto/ema/raw.")
        if self.requests < 0 or self.max_prompt < 1 or self.new_tokens < 1:
            raise ValueError(
                f"requests={self.requests} must be >= 0, max_prompt="
                f"{self.max_prompt} and new_tokens={self.new_tokens} >= 1."
            )
        module = self._build_module()
        self.runtime.initialize(self.device)
        self.partitioner.setup()
        self.engine.bind(module, partitioner=self.partitioner, device=self.device)
        if self.warmup:
            self.engine.warmup()
        self.guard.bind()
        self.scheduler.bind(self.engine, metrics=self.metrics,
                            speculative=self._resolve_speculative(),
                            guard=self.guard if self.guard.enabled else None)
        self._start_observability()
        return self.engine, self.scheduler

    def _request_log(self):
        return self.scheduler.request_log

    def _status_providers(self):
        """The ``/statusz`` (and bundle) sections: ``decode``, ``requests``
        and ``guardrails``."""
        return {"decode": self.scheduler.status, "requests": self._request_log_status,
                "guardrails": self.guard.status}

    def _obs_registries(self):
        return super()._obs_registries() + [self.guard.registry]

    def _teardown_service(self, *, suppress: bool = False) -> None:
        """Every exit path's teardown (``run_teardown_steps``): the
        endpoint and its probe, the recorder, the scheduler."""
        run_teardown_steps(self._obs_teardown_steps() + [self.scheduler.close],
                           suppress=suppress)

    def _build_module(self):
        """The model's module with its weights loaded or initialized."""
        return self._load(self.model, self.model.build((self.seq_len,), self.vocab_size),
                          self.checkpoint, self.weights)

    def _load(self, model: Model, module, checkpoint: Optional[str], weights: str):
        """``module`` (built by ``model``) with its weights read from
        ``checkpoint`` (``weights`` picks EMA or raw) or initialized from
        ``seed``."""
        if not checkpoint:
            return model.initialize(module, seed=self.seed)
        from zookeeper_tpu_torch.training.checkpoint import (
            export_trees,
            load_inference_model,
            load_into_module,
        )

        params_like, state_like = export_trees(module)
        params, model_state = load_inference_model(
            checkpoint, weights=weights, params_like=params_like,
            model_state_like=state_like,
        )
        load_into_module(module, params, model_state)
        return module

    def _resolve_speculative(self) -> Optional[SpeculativeDecoding]:
        """The bound speculative schedule, or None: plain decode when it
        is off, and also (with a warning) when the draft cannot be loaded
        or bound, so the teacher keeps serving."""
        sp = self.speculative
        if not sp.enabled:
            return None
        draft = sp.draft_model.build((self.seq_len,), self.vocab_size)
        try:
            if not sp.draft_checkpoint:
                logger.warning(
                    "speculative.enabled with no draft_checkpoint: serving a draft "
                    "initialized from the seed (acceptance near chance unless it has the "
                    "teacher's geometry)")
            draft = self._load(sp.draft_model, draft, sp.draft_checkpoint, sp.draft_weights)
            return sp.bind(self.engine, draft, partitioner=self.partitioner)
        except (OSError, ValueError) as e:
            logger.warning("speculative decoding DISABLED, the draft is unavailable (%s); "
                           "serving plain greedy decode", e)
            if self.verbose and self.partitioner.is_chief:
                print(f"speculative decoding disabled: {e}", flush=True)
            return None

    def prompts(self, max_prompt: int) -> List[np.ndarray]:
        """The seeded stream ``run()`` serves (the JAX ``run()``'s):
        ``requests`` prompts of 1..``max_prompt`` tokens in [1, vocab)."""
        rng = np.random.default_rng(self.seed)
        out = []
        for _ in range(self.requests):
            n = int(rng.integers(1, max_prompt + 1))
            out.append(rng.integers(1, self.vocab_size, size=n).astype(np.int32))
        return out

    def run(self) -> Dict[str, Any]:
        """Serve the stream, check every stream's output, print and return
        one JSON-able result. The generated tokens stay in
        ``self.outputs``."""
        if self.verbose and self.partitioner.is_chief:
            print(pretty_print(self), flush=True)
        engine, scheduler = self.build_service()
        try:
            prompts = self.prompts(min(self.max_prompt, engine.max_prompt))
            t0 = time.perf_counter()
            streams = [scheduler.submit(p, max_new_tokens=self.new_tokens) for p in prompts]
            scheduler.drain()
            dt = time.perf_counter() - t0
            outputs = [s.result() for s in streams]
            for out in outputs:
                if out.ndim != 1 or not 1 <= out.shape[0] <= self.new_tokens or (
                    out.size and (out.min() < 0 or out.max() >= self.vocab_size)
                ):
                    raise RuntimeError(f"bad stream output: {out!r}")
            object.__setattr__(self, "outputs", outputs)
            tokens = sum(int(o.shape[0]) for o in outputs)
            device = engine.device
            spec = scheduler._speculative
            result = {
                **{k: round(float(v), 4) for k, v in self.metrics.snapshot().items()},
                "model": type(self.model).__name__,
                "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
                "slots": int(engine.slots),
                "seq_buckets": [int(s) for s in engine.seq_buckets],
                "kv_capacity": engine.capacity,
                "decode_attention": engine.decode_attention_flavor,
                "decode_mbu": round(engine.decode_mbu, 4),
                "kv_layout": str(engine.kv_layout),
                **({"kv_pool_fill": round(engine.page_pool.used_pages
                                          / engine.page_pool.num_pages, 4),
                    "prefix_cache_hit_rate": round(engine.page_pool.prefix_hit_rate, 4)}
                   if engine.paged else {}),
                # What served: a speculative config whose draft fell back says
                # false here.
                "speculative": spec is not None,
                "spec_k": int(spec.k) if spec is not None else 0,
                **({"spec_acceptance_rate": round(spec.acceptance_rate, 4)}
                   if spec is not None else {}),
                "requests": self.requests,
                "generated_tokens": tokens,
                "tokens_per_sec": round(tokens / dt, 1) if dt > 0 else 0.0,
                "partitioner": type(self.partitioner).__name__,
                "cache_replicated": engine.cache_replicated,
            }
        except BaseException:
            self._teardown_service(suppress=True)
            raise
        return self.finish_report(result)

    def finish_report(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Print ``result`` as one JSON line (the chief, when verbose),
        tear the service down and return it; a subclass adds its keys
        here."""
        try:
            if self.verbose and self.partitioner.is_chief:
                print(json.dumps(result), flush=True)
        finally:
            self._teardown_service()
        return result
