"""Rank programs for the port's serving-under-partitioners CPU tests.

Run through ``torch_parallel_workers.spawn`` on gloo ranks. Each program
builds the port's engines under a partitioner from weights the test
converted from the JAX package, serves the same requests on every rank
and saves what the test compares (``torch.save`` files in ``out_dir``).
Like ``torch_shard_workers``, this module imports torch and the port
only, never JAX.
"""

import logging

import numpy as np
import torch

from torch_parallel_workers import _save


def _partitioner(name, conf, rules):
    import zookeeper_tpu_torch.parallel as parallel
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.parallel import rules as R

    part = getattr(parallel, name)()
    configure(part, dict(conf), name="partitioner")
    if rules is not None:
        part.with_rules(getattr(R, rules)())
    part.setup()
    return part


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _lm_module(geometry, vocab, state):
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import TransformerLM

    model = TransformerLM()
    configure(model, dict(geometry), name="model")
    module = model.build((geometry["max_seq_len"],), vocab)
    module.load_state_dict(state)
    return module


def decode_legs(rank, world, out_dir, lm, prompts, budgets, legs):
    """Every leg ``(label, partitioner, conf, rules, engine conf)``: the
    LM (``lm = (geometry, vocab, state_dict)``) bound to a
    ``DecodeEngine`` under the partitioner, the prompts served through the
    synchronous ``DecodeScheduler``: the tokens, whether the cache
    replicated and the warnings, this rank's cache blocks and bytes, the
    blocks' model groups, the engine's dispatches, and (paged) every
    layer's pool and the pool's status after the run."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler

    handler = _Warnings()
    logging.getLogger("zookeeper_tpu_torch.serving.decode.engine").addHandler(handler)
    out = {}
    for label, name, conf, rules, engine_conf in legs:
        part = _partitioner(name, conf, rules)
        module = _lm_module(*lm)
        engine = DecodeEngine()
        configure(engine, dict(engine_conf), name="engine")
        handler.messages.clear()
        engine.bind(module, partitioner=part, device="cpu")
        engine.warmup()
        sched = DecodeScheduler()
        configure(sched, {}, name="sched")
        sched.bind(engine)
        streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        sched.drain()
        block = module.block0
        out[label] = {
            "tokens": [np.asarray(s.result()) for s in streams],
            "replicated": engine.cache_replicated,
            "warnings": list(handler.messages),
            "cache_shape": tuple(engine.cache[0]["k"].shape),
            "kv_bytes": engine.kv_cache_nbytes,
            "tp": (block._tp_attn is not None, block._tp_mlp is not None),
            "qkv_shape": tuple(block.qkv.weight.shape),
            "pool": ([{k: t.clone() for k, t in layer.items()} for layer in engine.cache]
                     if engine.paged else None),
            "dispatches": engine.dispatches,
            "pool_status": engine.pool_status(),
        }
    _save(out_dir, "decode", rank, out)


def infer_legs(rank, world, out_dir, legs, batches):
    """Every leg ``(label, model, conf, weights, shape, classes,
    partitioner, conf, rules, buckets)``: the model built and loaded, bound to an
    ``InferenceEngine`` under the partitioner and warmed, and each batch
    of ``batches`` served through the synchronous ``MicroBatcher``: the
    outputs, the buckets' forward plans, and the packed layers' blocks."""
    import zookeeper_tpu_torch.models as models
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import InferenceEngine, MicroBatcher

    out = {}
    for label, model_name, model_conf, state, shape, classes, name, conf, rules, buckets in legs:
        model = getattr(models, model_name)()
        configure(model, dict(model_conf), name="model")
        module = model.build(shape, classes)
        module.load_state_dict(state)
        part = _partitioner(name, conf, rules)
        engine = InferenceEngine()
        configure(engine, {"batch_buckets": tuple(buckets)}, name="engine")
        engine.bind(module, shape, device="cpu", partitioner=part)
        warmed = engine.warmup()
        batcher = MicroBatcher()
        configure(batcher, {}, name="batcher")
        batcher.bind(engine)
        handles = [batcher.submit(x) for x in batches]
        batcher.flush()
        plans = {b: engine.forward_plan(b) for b in buckets}
        out[label] = {
            "outputs": [h.result() for h in handles],
            "warmed": warmed,
            "split": {b: p.split for b, p in plans.items()},
            "packed": {n: tuple(t.shape) for n, t in module.named_buffers()
                       if n.endswith("kernel_packed")},
            "tp_layers": sorted(n for n, m in module.named_modules()
                                if getattr(m, "_tp", None) is not None),
        }
        batcher.close()
    _save(out_dir, "infer", rank, out)


def refusals(rank, world, out_dir, lm):
    """In front of engines whose partitioner spans the ranks, the
    clock-driven modes raise: the threaded scheduler and batcher, default
    deadlines and a request deadline. The messages are saved."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.serving import InferenceEngine, MicroBatcher
    from zookeeper_tpu_torch.serving.decode import DecodeEngine, DecodeScheduler

    engine = DecodeEngine()
    configure(engine, {"slots": 2, "seq_buckets": (8,)}, name="engine")
    engine.bind(_lm_module(*lm), partitioner=_partitioner("DataParallelPartitioner", {}, None),
                device="cpu")
    infer = InferenceEngine()
    configure(infer, {"batch_buckets": (2,)}, name="engine")
    infer.bind(torch.nn.Linear(3, 2), (3,), device="cpu",
               partitioner=_partitioner("DataParallelPartitioner", {}, None))
    messages = {}
    for label, cls, conf, target in (
        ("scheduler async", DecodeScheduler, {"synchronous": False}, engine),
        ("scheduler deadline", DecodeScheduler, {"default_deadline_ms": 5.0}, engine),
        ("batcher async", MicroBatcher, {"synchronous": False}, infer),
        ("batcher deadline", MicroBatcher, {"default_deadline_ms": 5.0}, infer),
    ):
        obj = cls()
        configure(obj, dict(conf), name="obj")
        try:
            obj.bind(target)
            messages[label] = None
        except ValueError as e:
            messages[label] = str(e)
    for label, cls, target, request in (
        ("scheduler submit", DecodeScheduler, engine, np.ones(3, np.int32)),
        ("batcher submit", MicroBatcher, infer, np.ones((1, 3), np.float32)),
    ):
        obj = cls()
        configure(obj, {}, name="obj")
        obj.bind(target)
        try:
            obj.submit(request, deadline_ms=10.0)
            messages[label] = None
        except ValueError as e:
            messages[label] = str(e)
    _save(out_dir, "refusals", rank, messages)


def tp_block_decode(rank, world, out_dir, lm, tokens, lengths):
    """A one-rank model group on every block of the LM: the decode step's
    logits and cache rows, beside the same module's with no group."""
    from zookeeper_tpu_torch.parallel import transformer_tp_rules
    from zookeeper_tpu_torch.parallel.shards import MeshGroups, plan_inference
    from zookeeper_tpu_torch.serving.decode import allocate_kv_cache

    geometry, vocab, state = lm
    whole, tp = _lm_module(*lm), _lm_module(*lm)
    plan_inference(tp, transformer_tp_rules(), MeshGroups({"model": 1}, 0),
                   ("model",)).apply_module(tp)
    out = {"groups": [(b._tp_attn is not None, b._tp_mlp is not None) for b in tp.blocks]}
    for key, module in (("whole", whole), ("tp", tp)):
        cache = allocate_kv_cache(geometry["num_layers"], len(tokens), geometry["max_seq_len"],
                                  geometry["num_heads"], geometry["d_model"] //
                                  geometry["num_heads"], torch.float32)
        with torch.inference_mode():
            logits, cache = module.decode_step(torch.from_numpy(tokens),
                                               torch.from_numpy(lengths), cache)
        out[key] = (logits.clone(), [{k: t.clone() for k, t in layer.items()}
                                     for layer in cache])
    _save(out_dir, "tp_block", rank, out)
