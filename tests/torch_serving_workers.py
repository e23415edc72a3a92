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


def _save_mlp_step(directory, state, step):
    """Save an Mlp (flattened 1 x 1 x 6 input) with ``state`` as training
    step ``step`` through the port's ``Checkpointer``."""
    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import Mlp
    from zookeeper_tpu_torch.training import Checkpointer
    from zookeeper_tpu_torch.training.optimizer import Sgd
    from zookeeper_tpu_torch.training.state import TrainState

    model = Mlp()
    configure(model, {"hidden_units": (16,)}, name="model")
    module = model.build((1, 1, 6), 4)
    module.load_state_dict(state)
    ckpt = Checkpointer()
    configure(ckpt, {"directory": directory}, name="ckpt")
    opt = Sgd()
    configure(opt, {}, name="optimizer")
    tx = opt.build(total_steps=1)
    ckpt.save(TrainState(step=step, module=module, tx=tx,
                         opt_state=tx.init(dict(module.named_parameters()))), step=step)
    ckpt.wait()
    ckpt.close()


def _outcome(handle):
    """A request's rows, or the name of its error."""
    try:
        out = handle.result(timeout=60)
        return out.tolist() if hasattr(out, "tolist") else out
    except Exception as e:
        return type(e).__name__


def seq_requests(vocab):
    """The token requests of the sequence-bucketed leg, in two groups of
    one length each (5 and 12 positions: one under each of the sequence
    buckets 8 and 16)."""
    rng = np.random.default_rng(28)
    return [[rng.integers(1, vocab, size=(rows, length)).astype(np.int32) for rows in (1, 2)]
            for length in (5, 12)]


def chief_led(rank, world, out_dir, lm, mlp, mlp_b, batches, prompts, budgets):
    """Chief-led dispatch on every rank: the threaded ``MicroBatcher``
    with deadlines in front of a data-parallel ``InferenceEngine`` (a
    ``deadline_ms=0`` request among them), the same with rank 1 missing a
    request (``ChiefLedError`` after a short wait), the threaded batcher
    in front of a data-parallel ``InferenceEngine`` with sequence buckets
    (the LM scoring :func:`seq_requests`), the threaded
    ``DecodeScheduler`` with deadlines in front of a data-parallel
    ``DecodeEngine`` (an expired stream and a staged swap of the same
    weights), ``ServingConfig(watch=True)`` swapping in a step rank 0
    saves while it serves, and the two refusals that stay (a speculative
    draft, disaggregated serving). Saves each rank's outcomes and
    dispatch logs."""
    import os

    import torch.distributed as dist

    from zookeeper_tpu_torch.core import configure
    from zookeeper_tpu_torch.models import Mlp
    from zookeeper_tpu_torch.parallel import distributed
    from zookeeper_tpu_torch.serving import (
        DisaggServingConfig,
        InferenceEngine,
        MicroBatcher,
        ServingConfig,
    )
    from zookeeper_tpu_torch.serving.decode import (
        DecodeEngine,
        DecodeMetrics,
        DecodeScheduler,
        SpeculativeDecoding,
    )
    from zookeeper_tpu_torch.training.checkpoint import export_trees

    out = {}

    def describe(a):
        if isinstance(a, (list, tuple)):
            return tuple(describe(v) for v in a)
        return tuple(np.shape(a)) if hasattr(a, "shape") else (
            int(a) if isinstance(a, (int, np.integer)) else type(a).__name__)

    def logged(obj, name, log):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            log.append((name, *[describe(a) for a in args]))
            return fn(*args, **kwargs)

        object.__setattr__(obj, name, wrapper)

    def mlp_engine():
        model = Mlp()
        configure(model, {"hidden_units": (16,)}, name="model")
        module = model.build((6,), 4)
        module.load_state_dict(mlp)
        engine = InferenceEngine()
        configure(engine, {"batch_buckets": (2, 4, 8)}, name="engine")
        engine.bind(module, (6,), device="cpu",
                    partitioner=_partitioner("DataParallelPartitioner", {}, None))
        engine.warmup()
        return engine

    # The threaded batcher with deadlines: one request already expired.
    engine = mlp_engine()
    log = []
    logged(engine, "infer", log)
    batcher = MicroBatcher()
    configure(batcher, {"synchronous": False, "max_delay_ms": 5.0,
                        "default_deadline_ms": 60000.0}, name="batcher")
    try:
        batcher.bind(engine)
        handles = [batcher.submit(x) for x in batches[:2]]
        handles.append(batcher.submit(batches[2], deadline_ms=0))
        handles += [batcher.submit(x) for x in batches[3:]]
        out["batcher"] = {"outcomes": [_outcome(h) for h in handles], "dispatches": log,
                          "led": batcher._led.link is not None}
    finally:
        batcher.close()

    # A follower that never receives a request the chief dispatches.
    saved_wait = distributed.FOLLOWER_WAIT_S
    distributed.FOLLOWER_WAIT_S = 0.5
    batcher = MicroBatcher()
    configure(batcher, {"synchronous": False, "max_delay_ms": 1.0,
                        "default_deadline_ms": 60000.0}, name="batcher")
    try:
        batcher.bind(engine)
        lost = [batcher.submit(batches[0])]
        if rank == 0:
            lost.append(batcher.submit(batches[1]))
        out["lost"] = [_outcome(h) for h in lost]
    finally:
        batcher.close()
        distributed.FOLLOWER_WAIT_S = saved_wait

    # Sequence buckets behind the threaded batcher: the LM scores token
    # requests of two lengths, one group (one length) at a time.
    seq_engine = InferenceEngine()
    configure(seq_engine, {"batch_buckets": (2, 4), "seq_buckets": (8, 16)}, name="engine")
    seq_engine.bind(_lm_module(*lm), (lm[0]["max_seq_len"],), dtype=torch.int32,
                    device="cpu", partitioner=_partitioner("DataParallelPartitioner", {}, None))
    warm = seq_engine.warmup()
    slog = []
    logged(seq_engine, "infer", slog)
    batcher = MicroBatcher()
    configure(batcher, {"synchronous": False, "max_delay_ms": 5.0}, name="batcher")
    try:
        batcher.bind(seq_engine)
        answers = []
        for group in seq_requests(lm[1]):
            answers += [_outcome(h) for h in [batcher.submit(x) for x in group]]
        out["seq"] = {"outcomes": answers, "dispatches": slog, "warm": warm,
                      "compile_count": seq_engine.compile_count,
                      "recompiles": seq_engine.recompiles_detected,
                      "led": batcher._led.link is not None}
    finally:
        batcher.close()

    # The threaded decode scheduler with deadlines and a staged swap.
    module = _lm_module(*lm)
    dec = DecodeEngine()
    configure(dec, {"slots": 4, "seq_buckets": (8, 16), "kv_capacity": lm[0]["max_seq_len"],
                    "decode_attention": "kernel"}, name="engine")
    dec.bind(module, partitioner=_partitioner("MeshPartitioner", {
        "mesh_shape": (2, 1), "mesh_axes": ("data", "model"), "data_axes": ("data",)},
        "transformer_tp_rules"), device="cpu")
    dec.warmup()
    dlog = []
    logged(dec, "prefill", dlog)
    logged(dec, "swap_weights", dlog)
    metrics = DecodeMetrics()
    configure(metrics, {}, name="metrics")
    sched = DecodeScheduler()
    configure(sched, {"synchronous": False, "default_deadline_ms": 60000.0}, name="sched")
    try:
        sched.bind(dec, metrics=metrics)
        streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts[:3], budgets)]
        streams.append(sched.submit(prompts[3], max_new_tokens=budgets[3], deadline_ms=0))
        sched.request_swap(*export_trees(module), step=7)
        streams += [sched.submit(p, max_new_tokens=b)
                    for p, b in zip(prompts[4:], budgets[4:])]
        out["decode"] = {"outcomes": [_outcome(s) for s in streams], "dispatches": dlog,
                         "weights_step": metrics.weights_step,
                         "counts": dict(dec.dispatches), "led": sched._led.link is not None}
    finally:
        sched.close()

    # The synchronous scheduler with a default deadline: chief-led too.
    sched = DecodeScheduler()
    configure(sched, {"default_deadline_ms": 60000.0}, name="sched")
    try:
        sched.bind(dec)
        streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts[:2], budgets)]
        streams.append(sched.submit(prompts[2], max_new_tokens=budgets[2], deadline_ms=0))
        sched.drain()
        out["decode_sync"] = {"outcomes": [_outcome(s) for s in streams],
                              "led": sched._led.link is not None}
    finally:
        sched.close()

    # The refusals that stay at world size > 1.
    messages = {}
    spec = SpeculativeDecoding()
    configure(spec, {"enabled": True, "k": 2}, name="speculative")
    try:
        spec.bind(dec, _lm_module(*lm))
        messages["speculative"] = None
    except ValueError as e:
        messages["speculative"] = str(e)
    disagg = DisaggServingConfig()
    configure(disagg, {"model.num_layers": 1, "model.d_model": 32, "model.num_heads": 4,
                       "seq_len": 64, "vocab_size": 61, "device": "cpu", "verbose": False},
              name="disagg")
    try:
        disagg.build_service()
        messages["disagg"] = None
    except ValueError as e:
        messages["disagg"] = str(e)
    out["refusals"] = messages

    # ServingConfig(watch=True): rank 0 saves step 2 while the ranks serve.
    directory = os.path.join(out_dir, "watch")
    if rank == 0:
        _save_mlp_step(directory, mlp, 1)
    dist.barrier()
    cfg = ServingConfig()
    configure(cfg, {"model": "Mlp", "model.hidden_units": (16,), "height": 1, "width": 1,
                    "channels": 6, "num_classes": 4, "device": "cpu", "checkpoint": directory,
                    "weights": "raw", "watch": True, "watch_poll_s": 3600.0,
                    "partitioner": "DataParallelPartitioner",
                    "engine.batch_buckets": (2, 4, 8), "verbose": False}, name="serving")
    _, batcher = cfg.build_service()
    try:
        shaped = [x.reshape(-1, 1, 1, 6) for x in batches]
        before = [batcher.submit(x) for x in shaped]
        batcher.flush()
        if rank == 0:
            _save_mlp_step(directory, mlp_b, 2)
        dist.barrier()
        cfg.watcher.poll_once()  # the chief's proposes; a follower's does nothing
        after = [batcher.submit(x) for x in shaped]
        batcher.flush()
        out["watch"] = {"before": [_outcome(h) for h in before],
                        "after": [_outcome(h) for h in after],
                        "step": cfg.watcher.current_step, "swaps": cfg.watcher.swaps,
                        "status": cfg.status()}
    finally:
        cfg._teardown_service()
    _save(out_dir, "chief_led", rank, out)


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
