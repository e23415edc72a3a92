"""Shared set-up of the port's decode-feature tests against the JAX
package (``test_torch_prefix_cache.py``, ``test_torch_chunked_prefill.py``,
``test_torch_speculative.py``): one small LM on the same weights in both
packages (the JAX init carried across with the port's converter), both
packages' decode engines and schedulers configured alike, and the
seeded streams.
"""

import copy

import jax
import numpy as np
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models.transformer import TransformerLM as JaxLM
from zookeeper_tpu.serving.decode import DecodeEngine as JaxEngine
from zookeeper_tpu.serving.decode import DecodeMetrics as JaxMetrics
from zookeeper_tpu.serving.decode import DecodeScheduler as JaxScheduler
from zookeeper_tpu.serving.decode import SpeculativeDecoding as JaxSpeculative
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.models.convert import from_flax_lm_variables
from zookeeper_tpu_torch.models.transformer import TransformerLM, greedy_decode
from zookeeper_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeMetrics,
    DecodeScheduler,
    SpeculativeDecoding,
)

VOCAB, SEQ, PAGE = 61, 64, 4
GEOMETRY = {"num_layers": 2, "d_model": 32, "num_heads": 2, "max_seq_len": SEQ}
#: Both engines: 3 slots, prompt buckets 8 and 16, the paged pool at page
#: size 4; the JAX decode attention is its reference einsum.
ENGINE = {"slots": 3, "seq_buckets": (8, 16), "kv_capacity": SEQ, "page_size": PAGE}
PAGED = {"kv_layout": "paged"}


def build_lm(geometry=GEOMETRY, seed=0):
    """``(JAX module, JAX params, port module)`` on the same weights,
    fp32, the JAX module on the dense attention (as the JAX decode tests'
    oracles run)."""
    jm = JaxLM()
    jax_configure(jm, {**geometry, "attention": "dense"}, name="lm")
    jmod = jm.build((SEQ,), VOCAB)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, _ = jax.jit(lambda: jm.initialize(jmod, (SEQ,), seed=seed))()
    pm = TransformerLM()
    configure(pm, dict(geometry), name="lm")
    mod = pm.build((SEQ,), VOCAB)
    mod.load_state_dict(from_flax_lm_variables(params))
    return jmod, params, mod


def negated(lm):
    """A second weight set of ``lm`` (``build_lm``'s triple) without
    another JAX init: every JAX parameter negated, as ``(JAX params,
    port module)``."""
    _, params, mod = lm
    params_b = jax.tree.map(lambda a: -np.asarray(a), params)
    mod_b = copy.deepcopy(mod)
    mod_b.load_state_dict(from_flax_lm_variables(params_b))
    return params_b, mod_b


def port_engine(mod, **conf):
    engine = DecodeEngine()
    configure(engine, {**ENGINE, "decode_attention": "kernel", **conf}, name="engine")
    return engine.bind(mod, device="cpu")


def jax_engine(jmod, params, **conf):
    engine = JaxEngine()
    jax_configure(engine, {**ENGINE, "decode_attention": "reference", **conf}, name="engine")
    engine.bind(jmod, params, None)
    return engine


def port_spec(engine, draft_mod, k):
    spec = SpeculativeDecoding()
    configure(spec, {"enabled": True, "k": k}, name="spec")
    return spec.bind(engine, draft_mod)


def jax_spec(engine, draft_jmod, draft_params, k):
    spec = JaxSpeculative()
    jax_configure(spec, {"enabled": True, "k": k}, name="spec")
    return spec.bind(engine, draft_jmod, draft_params, None)


def serve(port, engine, prompts, budgets, spec=None, **sched_conf):
    """The prompts through a synchronous scheduler of ``engine``'s
    package (``port``: the port's): ``(tokens per stream, metrics,
    streams)``."""
    sched_cls, metrics_cls, conf = ((DecodeScheduler, DecodeMetrics, configure) if port
                                    else (JaxScheduler, JaxMetrics, jax_configure))
    metrics = metrics_cls()
    conf(metrics, {}, name="metrics")
    sched = sched_cls()
    conf(sched, dict(sched_conf), name="sched")
    sched.bind(engine, metrics=metrics, speculative=spec)
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    return [np.asarray(s.result()) for s in streams], metrics, streams


def greedy(mod, prompt, steps):
    """The port's full-recompute greedy continuation of ``prompt``."""
    return greedy_decode(mod, torch.from_numpy(np.array(prompt))[None], steps)[0,
                                                                               len(prompt):].numpy()


def shared_prefix_prompts(seed, prefix_lens, n_each, suffix_max=6):
    """Prompts that share prefixes: for each length in ``prefix_lens`` (on
    and off a page edge) one prefix, ``n_each`` prompts of it with seeded
    1..``suffix_max``-token suffixes, and an exact repeat of the prefix.
    Interleaved so warm admissions meet prefixes others inserted."""
    rng = np.random.default_rng(seed)
    groups = []
    for n in prefix_lens:
        prefix = rng.integers(1, VOCAB, size=n).astype(np.int32)
        group = [np.concatenate([prefix, rng.integers(1, VOCAB, size=int(
            rng.integers(1, suffix_max + 1))).astype(np.int32)]) for _ in range(n_each)]
        groups.append(group + [prefix.copy()])
    out = []
    for i in range(max(len(g) for g in groups)):
        out.extend(g[i] for g in groups if i < len(g))
    return out


def pool_state(pool):
    """Everything the allocators must agree on, as plain Python."""
    return {
        "table": pool.table.tolist(),
        "counts": pool.counts.tolist(),
        "refcount": pool.refcount.tolist(),
        "free": list(pool._free),
        "cow_pages": pool.cow_pages,
        "exhausted": pool.exhausted_events,
        "hit_rate": pool.prefix_hit_rate,
        "leaks": pool.leak_check(),
        "status": pool.status(),
    }
