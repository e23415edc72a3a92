"""Serving under partitioners: the port against the JAX package.

- The layout specs: ``variables_sharding``, ``decode_cache_sharding`` and
  ``page_pool_sharding`` of the Mesh, FSDP and sequence-parallel
  partitioners equal JAX's on the same trees.
- The sharded decode wrappers: each (data, model) rank's K12/K13 call on
  its block, composed in one process, equals JAX's
  ``sharded_paged_decode_attention`` / ``sharded_pool_paged_decode_
  attention`` on a (2, 2) mesh of virtual CPU devices (their Pallas
  kernels in interpret mode).
- Greedy tokens on 2 and 4 gloo ranks: the ``DecodeEngine`` under data
  x model meshes (2, 1), (1, 2), (2, 2) and (1, 4) with
  ``transformer_tp_rules``, a (1, 4) mesh with no rules (replicated
  weights, heads-sharded cache), FSDP and sequence parallelism (tp 2),
  in the slot, paged and paged-int8 layouts, and slots=3 on a 2-way data
  axis (the replicated fallback, with JAX's warning): every rank's tokens
  equal the JAX single-device oracles' (``greedy_decode``; the JAX
  engine for int8 rows) on the same converted weights; the pool copies
  are equal across data ranks; each rank holds its cache block.
- The ``InferenceEngine`` under ``DataParallelPartitioner`` with buckets
  (1, 4, 8) against JAX's on 8 virtual devices (JAX's own tolerance),
  and a packed QuickNet under ``conv_model_tp_rules`` against JAX's
  packed forward (``test_torch_quicknet.py``'s tolerance) and equal bit
  for bit to the port's own unsharded forward, each packed conv holding
  its ``co`` block.
- Chief-led dispatch at world size 2: the threaded batcher and the
  threaded decode scheduler with deadlines serve JAX's answers and the
  greedy oracle's tokens with the same dispatches on both ranks, an
  expiry and a staged swap land alike on both, a follower that lacks a
  request fails that dispatch everywhere, the threaded batcher in front
  of a data-parallel engine with sequence buckets serves JAX's LM logits,
  ``ServingConfig(watch=True)`` swaps a step in at the same dispatch on
  both ranks; the speculative draft and disaggregated serving still
  refuse.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
import torch_serving_workers as serving_workers
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu_torch.core import configure as port_configure

VOCAB, SEQ = 61, 64
GEOMETRY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "max_seq_len": SEQ}
ENGINE = {"slots": 4, "seq_buckets": (8, 16), "kv_capacity": SEQ, "page_size": 4,
          "decode_attention": "kernel"}
PAGED = {"kv_layout": "paged", "prefix_cache": False}
LAYOUTS = {"slots": {}, "paged": PAGED, "int8": {**PAGED, "kv_quant": "int8"}}
_TP = ("MeshPartitioner", "transformer_tp_rules")


def _mesh(shape):
    return {"mesh_shape": shape, "mesh_axes": ("data", "model"), "data_axes": ("data",)}


#: (label, world, partitioner, conf, rules, layouts, engine overrides).
DECODE_LEGS = (
    ("dp2", 2, _TP[0], _mesh((2, 1)), _TP[1], ("slots", "paged", "int8"), {}),
    ("tp2", 2, _TP[0], _mesh((1, 2)), _TP[1], ("slots", "paged", "int8"), {}),
    ("fsdp2", 2, "FsdpPartitioner", {"min_weight_size": 1}, None, ("slots", "paged"), {}),
    ("dp2tp2", 4, _TP[0], _mesh((2, 2)), _TP[1], ("slots", "paged", "int8"), {}),
    ("tp4", 4, _TP[0], _mesh((1, 4)), _TP[1], ("slots", "paged", "int8"), {}),
    ("heads4", 4, "MeshPartitioner", _mesh((1, 4)), None, ("slots",), {}),
    ("sp2tp2", 4, "SequenceParallelPartitioner", {"sp": 2, "tp": 2}, None, ("slots",), {}),
    ("fallback", 4, _TP[0], _mesh((2, 2)), _TP[1], ("slots", "paged"), {"slots": 3}),
)


#: The radix prefix cache and chunked prefill at world size 2, on a
#: stream of shared prefixes (label, partitioner, conf, rules, engine).
FEATURE_LEGS = (
    ("dp2 warm", _TP[0], _mesh((2, 1)), _TP[1], {**ENGINE, "kv_layout": "paged"}),
    ("tp2 warm chunked", _TP[0], _mesh((1, 2)), _TP[1],
     {**ENGINE, "kv_layout": "paged", "prefill_chunk_tokens": 4}),
)


def _legs(world):
    return [(f"{label} {layout}", name, conf, rules, {**ENGINE, **LAYOUTS[layout], **extra})
            for label, w, name, conf, rules, layouts, extra in DECODE_LEGS if w == world
            for layout in layouts]


# -- the models and their oracles (JAX, in the pytest process) ----------------


@functools.lru_cache(maxsize=1)
def _lm():
    from zookeeper_tpu.models.transformer import TransformerLM as JaxLM
    from zookeeper_tpu_torch.models.convert import from_flax_lm_variables

    jm = JaxLM()
    jax_configure(jm, {**GEOMETRY, "attention": "dense"}, name="lm")
    jmod = jm.build((SEQ,), VOCAB)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, _ = jax.jit(lambda: jm.initialize(jmod, (SEQ,), seed=0))()
    state = {k: v.clone() for k, v in from_flax_lm_variables(params).items()}
    return jmod, params, state


@functools.lru_cache(maxsize=1)
def _stream():
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(2, 15, size=6)]
    budgets = [int(b) for b in rng.integers(3, 7, size=6)]
    return prompts, budgets


@functools.lru_cache(maxsize=1)
def _feature_stream():
    """Eight prompts that share 3-6 tokens of one prefix (on and off the
    4-token page edge) before seeded suffixes, and their budgets."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, VOCAB, size=6).astype(np.int32)
    prompts = [np.concatenate([prefix[:int(n)], rng.integers(1, VOCAB, size=int(m))
                               .astype(np.int32)])
               for n, m in zip(rng.integers(3, 7, size=8), rng.integers(1, 6, size=8))]
    budgets = [int(b) for b in rng.integers(2, 6, size=8)]
    return prompts, budgets


@functools.lru_cache(maxsize=1)
def _oracles():
    """The JAX single-device oracles: ``greedy_decode`` (full recompute)
    for the float layouts, the JAX engine (single device, int8 pool,
    reference attention) for int8 rows."""
    from zookeeper_tpu.models.transformer import greedy_decode
    from zookeeper_tpu.serving.decode import DecodeEngine, DecodeScheduler

    jmod, params, _ = _lm()
    prompts, budgets = _stream()
    greedy = [np.asarray(greedy_decode(jmod, {"params": params}, p[None], b))[0, len(p):]
              for p, b in zip(prompts, budgets)]
    engine = DecodeEngine()
    jax_configure(engine, {**ENGINE, **LAYOUTS["int8"], "decode_attention": "reference"},
                  name="engine")
    engine.bind(jmod, params, None)
    sched = DecodeScheduler()
    jax_configure(sched, {}, name="sched")
    sched.bind(engine)
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    feature_prompts, feature_budgets = _feature_stream()
    features = [np.asarray(greedy_decode(jmod, {"params": params}, p[None], b))[0, len(p):]
                for p, b in zip(feature_prompts, feature_budgets)]
    return {"float": greedy, "int8": [np.asarray(s.result()) for s in streams],
            "features": features}


CLASSES = 4
QUICKNET = {"blocks_per_section": (1, 1), "section_features": (32, 64),
            "binary_compute": "xnor_popcount", "packed_weights": True, "fold_bn": True}
QN_SHAPE = (16, 16, 3)
MLP_SHAPE = (6,)


@functools.lru_cache(maxsize=1)
def _quicknet():
    """A small packed, BN-folded QuickNet from JAX's pack of seeded float
    weights: (the JAX module, its variables, the port's state_dict)."""
    from zookeeper_tpu.models import QuickNet as JaxQuickNet
    from zookeeper_tpu.ops.packed import pack_quantconv_params
    from zookeeper_tpu_torch.models.convert import from_flax_variables

    model = JaxQuickNet()
    jax_configure(model, {**QUICKNET, "packed_weights": False, "fold_bn": False,
                          "binary_compute": "mxu"}, name="model")
    module = model.build(QN_SHAPE, num_classes=CLASSES)
    params, state = model.initialize(module, QN_SHAPE, seed=5)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                         state["batch_stats"])
    packed, packed_stats = pack_quantconv_params(params, fold_bn=True, batch_stats=stats)
    np_tree = lambda t: jax.tree.map(lambda v: np.array(v), t)  # noqa: E731
    packed, packed_stats = np_tree(packed), np_tree(packed_stats)
    jmodel = JaxQuickNet()
    jax_configure(jmodel, {**QUICKNET, "pallas_interpret": True}, name="model")
    jmod = jmodel.build(QN_SHAPE, num_classes=CLASSES)
    variables = {"params": packed, "batch_stats": packed_stats}
    state_dict = from_flax_variables(packed, {"batch_stats": packed_stats})
    return jmod, variables, {k: v.clone() for k, v in state_dict.items()}


@functools.lru_cache(maxsize=1)
def _mlp():
    from zookeeper_tpu.models.simple import Mlp as JaxMlp
    from zookeeper_tpu_torch.models.convert import from_flax_variables

    model = JaxMlp()
    jax_configure(model, {"hidden_units": (16,)}, name="model")
    module = model.build(MLP_SHAPE, CLASSES)
    params, state = model.initialize(module, MLP_SHAPE, seed=0)
    params = jax.tree.map(lambda v: np.array(v), params)
    state_dict = from_flax_variables(params, {})
    return module, params, {k: v.clone() for k, v in state_dict.items()}


@functools.lru_cache(maxsize=1)
def _mlp_b():
    """A second weight set of the Mlp (every parameter negated): (the JAX
    params, the port's state_dict)."""
    from zookeeper_tpu_torch.models.convert import from_flax_variables

    params = jax.tree.map(lambda v: -np.asarray(v), _mlp()[1])
    return params, {k: v.clone() for k, v in from_flax_variables(params, {}).items()}


def _batches(shape):
    rng = np.random.default_rng(3)
    return [rng.normal(size=(n, *shape)).astype(np.float32) for n in (1, 3, 8, 5, 4)]


INFER_LEGS_4 = (
    ("mlp dp", "Mlp", {"hidden_units": (16,)}, "mlp", MLP_SHAPE, "DataParallelPartitioner",
     {}, None, (1, 4, 8)),
    ("quicknet tp4", "QuickNet", QUICKNET, "quicknet", QN_SHAPE, "MeshPartitioner",
     _mesh((1, 4)), "conv_model_tp_rules", (1, 4)),
    ("quicknet dp2tp2", "QuickNet", QUICKNET, "quicknet", QN_SHAPE, "MeshPartitioner",
     _mesh((2, 2)), "conv_model_tp_rules", (1, 4)),
    ("quicknet fsdp", "QuickNet", QUICKNET, "quicknet", QN_SHAPE, "FsdpPartitioner",
     {"min_weight_size": 1}, None, (1, 4)),
)


def _infer_legs():
    states = {"mlp": _mlp()[2], "quicknet": _quicknet()[2]}
    return [(label, model, conf, states[key], shape, CLASSES, name, pconf, rules, buckets)
            for label, model, conf, key, shape, name, pconf, rules, buckets in INFER_LEGS_4]


def _all_legs(rank, world, out_dir, lm, stream, decode, infer, qn_batches, mlp_batches,
              features, chief):
    serving_workers.decode_legs(rank, world, out_dir, lm, *stream, decode)
    if features:
        serving_workers.decode_legs(rank, world, out_dir + "/features", lm, *features)
    if infer:
        mlp = [leg for leg in infer if leg[1] == "Mlp"]
        qn = [leg for leg in infer if leg[1] != "Mlp"]
        serving_workers.infer_legs(rank, world, out_dir + "/mlp", mlp, mlp_batches)
        serving_workers.infer_legs(rank, world, out_dir + "/qn", qn, qn_batches)
    if world == 2:
        serving_workers.chief_led(rank, world, out_dir, lm, *chief)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What every rank of the 2- and 4-rank clusters served."""
    lm = (GEOMETRY, VOCAB, _lm()[2])
    out = {}
    for world in (2, 4):
        out_dir = tmp_path_factory.mktemp(f"serve{world}")
        for sub in ("mlp", "qn", "features"):
            (out_dir / sub).mkdir()
        infer = _infer_legs() if world == 4 else []
        features = (*_feature_stream(), FEATURE_LEGS) if world == 2 else None
        chief = (_mlp()[2], _mlp_b()[1], _batches(MLP_SHAPE), *_stream())
        workers.spawn(_all_legs, world, str(out_dir), lm, _stream(), _legs(world), infer,
                      _batches(QN_SHAPE), _batches(MLP_SHAPE), features, chief, timeout=240)
        out[world] = {"decode": workers.load(str(out_dir), "decode", world)}
        if features:
            out[world]["features"] = workers.load(str(out_dir / "features"), "decode", world)
        if infer:
            out[world]["mlp"] = workers.load(str(out_dir / "mlp"), "infer", world)
            out[world]["qn"] = workers.load(str(out_dir / "qn"), "infer", world)
        if world == 2:
            out[world]["chief"] = workers.load(str(out_dir), "chief_led", world)
    return out


# -- layout specs ---------------------------------------------------------------


def _spec(s):
    """A spec as a tuple, one-axis tuples as the axis (as both packages
    normalise them), trailing Nones dropped."""
    parts = [p[0] if isinstance(p, tuple) and len(p) == 1 else
             (tuple(p) if isinstance(p, (tuple, list)) else p) for p in tuple(s)]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") and not (
            hasattr(tree, "spec") or type(tree).__name__ == "PartitionSpec"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _pair(name, conf, sizes):
    """JAX's partitioner on the virtual devices and the port's with the
    same mesh sizes (set as a group of that size would set them)."""
    import zookeeper_tpu.parallel as jax_parallel
    import zookeeper_tpu_torch.parallel as port_parallel

    jax_part = getattr(jax_parallel, name)()
    jax_configure(jax_part, {**conf, "num_devices": int(np.prod(list(sizes.values())))}
                  if name != "SequenceParallelPartitioner" else dict(conf), name="p")
    jax_part.setup()
    port_part = getattr(port_parallel, name)()
    port_configure(port_part, dict(conf), name="p")
    object.__setattr__(port_part, "_sizes", dict(sizes))
    return jax_part, port_part


PARTITIONERS = {
    "mesh tp": ("MeshPartitioner", _mesh((2, 2)), {"data": 2, "model": 2}),
    "fsdp": ("FsdpPartitioner", {"min_weight_size": 64}, {"fsdp": 8}),
    "sp tp": ("SequenceParallelPartitioner", {"sp": 2, "tp": 2, "dp": 2},
              {"data": 2, "sp": 2, "model": 2}),
}


def _trees():
    from zookeeper_tpu.serving.decode import allocate_kv_cache, allocate_page_pool

    _, params, _ = _lm()
    qn = _quicknet()[1]
    return {
        "lm": {"params": jax.tree.map(np.asarray, params)},
        "quicknet": qn,
        "cache": jax.tree.map(np.asarray, allocate_kv_cache(2, 8, 16, 4, 8, jnp.float32)),
        "pool": jax.tree.map(np.asarray,
                             allocate_page_pool(2, 12, 4, 4, 8, jnp.float32, quant="int8")),
    }


@pytest.mark.parametrize("part", list(PARTITIONERS))
def test_layout_specs_match_jax(part):
    """variables_sharding (LM with the TP rules, the packed QuickNet with
    conv_model_tp_rules; FSDP derives its rules from each tree),
    decode_cache_sharding and page_pool_sharding: the port's spec of
    every leaf equals JAX's."""
    from zookeeper_tpu.parallel import conv_model_tp_rules as jax_conv_rules
    from zookeeper_tpu.parallel import transformer_tp_rules as jax_tp_rules
    from zookeeper_tpu_torch.parallel import conv_model_tp_rules, transformer_tp_rules

    name, conf, sizes = PARTITIONERS[part]
    trees = _trees()
    for tree, (jax_rules, port_rules) in (("lm", (jax_tp_rules, transformer_tp_rules)),
                                          ("quicknet", (jax_conv_rules, conv_model_tp_rules)),
                                          ("cache", (None, None)), ("pool", (None, None))):
        jax_part, port_part = _pair(name, conf, sizes)
        if jax_rules is not None and name == "MeshPartitioner":
            jax_part.with_rules(jax_rules())
            port_part.with_rules(port_rules())
        method = {"cache": "decode_cache_sharding", "pool": "page_pool_sharding"}.get(
            tree, "variables_sharding")
        want = _leaves(getattr(jax_part, method)(trees[tree]))
        got = _leaves(getattr(port_part, method)(trees[tree]))
        assert set(got) == set(want), (tree, sorted(set(got) ^ set(want)))
        for path, sharding in want.items():
            assert _spec(got[path]) == _spec(sharding.spec), (part, tree, path)
        if tree in ("cache", "pool") and name == "MeshPartitioner":
            assert _spec(got["0/k"]) == (("data", None, "model") if tree == "cache"
                                         else (None, None, "model"))


# -- the sharded decode wrappers ------------------------------------------------


def _blocks(x, spec, coords, sizes):
    """The block of ``x`` rank ``coords`` holds under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = x.shape[dim] // sizes[axis]
        x = x.narrow(dim, coords[axis] * n, n)
    return x.contiguous()


@pytest.mark.parametrize("pool", [None, "none", "int8"], ids=["slots", "pool", "pool-int8"])
def test_sharded_decode_wrappers_match_jax(pool):
    """Each of the four (data, model) ranks of a (2, 2) mesh runs K12 or
    K13 (their plain versions on the CPU) on its blocks, composed in one
    process; the assembled output equals JAX's sharded wrapper on a (2, 2)
    mesh of virtual devices (Pallas in interpret mode) within the fp32
    decode tolerance, and each rank's block is the whole call's block
    bit for bit."""
    from jax.sharding import Mesh

    from zookeeper_tpu.ops import attention as jax_attention
    from zookeeper_tpu_torch.ops import attention as A

    rng = np.random.default_rng(11)
    b, cap, h, d, ps = 4, 32, 4, 16, 8
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sizes = {"data": 2, "model": 2}
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    lens = np.array([0, 17, 31, 9], np.int32)
    kw = dict(mesh=sizes, data_axes=("data",), model_axis="model")
    if pool is None:
        k, v = (rng.normal(size=(b, cap, h, d)).astype(np.float32) for _ in range(2))
        want = jax_attention.sharded_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), mesh=mesh,
            data_axes=("data",), model_axis="model")
        specs = {"q": ("data", None, "model"), "k": ("data", None, "model"),
                 "v": ("data", None, "model"), "lens": ("data",)}
        whole = A.paged_decode_attention(*(torch.from_numpy(t) for t in (q, k, v, lens)))
        call = lambda blk: A.sharded_paged_decode_attention(  # noqa: E731
            blk["q"], blk["k"], blk["v"], blk["lens"], **kw)
    else:
        pages = b * cap // ps
        table = rng.permutation(pages).reshape(b, cap // ps).astype(np.int32)
        scales = {}
        if pool == "int8":
            k, v = (rng.integers(-127, 128, size=(pages, ps, h, d)).astype(np.int8)
                    for _ in range(2))
            scales = {n: rng.uniform(0.01, 0.05, size=(pages, ps, h)).astype(np.float32)
                      for n in ("k_scale", "v_scale")}
        else:
            k, v = (rng.normal(size=(pages, ps, h, d)).astype(np.float32) for _ in range(2))
        want = jax_attention.sharded_pool_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(lens), mesh=mesh, data_axes=("data",), model_axis="model",
            **{n: jnp.asarray(s) for n, s in scales.items()})
        heads = (None, None, "model")
        specs = {"q": ("data", None, "model"), "k": heads, "v": heads, "table": ("data",),
                 "lens": ("data",), "k_scale": heads, "v_scale": heads}
        whole = A.pool_paged_decode_attention(
            *(torch.from_numpy(t) for t in (q, k, v, table, lens)),
            **{n: torch.from_numpy(s) for n, s in scales.items()})
        call = lambda blk: A.sharded_pool_paged_decode_attention(  # noqa: E731
            blk["q"], blk["k"], blk["v"], blk["table"], blk["lens"],
            **{n: blk[n] for n in scales}, **kw)
    full = {"q": q, "k": k, "v": v, "lens": lens}
    if pool is not None:
        full["table"] = table
        full.update(scales)
    got = torch.zeros(b, 1, h, d)
    for r in range(4):
        coords = {"data": r // 2, "model": r % 2}
        blk = {n: _blocks(torch.from_numpy(np.ascontiguousarray(t)), specs[n], coords, sizes)
               for n, t in full.items()}
        out = call(blk)
        assert torch.equal(out, _blocks(whole, specs["q"], coords, sizes)), r
        got[coords["data"] * 2:(coords["data"] + 1) * 2, :,
            coords["model"] * 2:(coords["model"] + 1) * 2] = out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="not mesh axes"):
        A.sharded_paged_decode_attention(torch.from_numpy(q), torch.zeros(b, cap, h, d),
                                         torch.zeros(b, cap, h, d), torch.from_numpy(lens),
                                         mesh={"data": 2}, model_axis="model")


def test_int8_head_shard_scales_equal_the_whole_pools():
    """``quantize_kv_rows`` scales per row and per head: a rank's heads
    quantize to the whole pool's int8 rows and scales at those heads."""
    from zookeeper_tpu_torch.ops.quantizers import quantize_kv_rows

    rows = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 8, 16)).astype(np.float32))
    q, s = quantize_kv_rows(rows)
    for r in range(4):
        q_r, s_r = quantize_kv_rows(rows[:, 2 * r:2 * r + 2].contiguous())
        assert torch.equal(q_r, q[:, 2 * r:2 * r + 2]) and torch.equal(s_r, s[:, 2 * r:2 * r + 2])


# -- greedy tokens on gloo ranks ------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_decode_tokens_equal_the_jax_oracles(ranks, world):
    """Every leg's tokens, on every rank, equal the JAX single-device
    oracles' on the same converted weights."""
    oracles = _oracles()
    results = ranks[world]["decode"]
    for label, *_ in _legs(world):
        oracle = oracles["int8" if label.endswith("int8") else "float"]
        for r, res in enumerate(results):
            for got, want in zip(res[label]["tokens"], oracle):
                np.testing.assert_array_equal(got, want, err_msg=f"{label} rank {r}")


def test_prefix_cache_and_chunks_at_world_size_two_equal_the_oracles(ranks):
    """The radix prefix cache (dp2: every rank runs the whole warm group;
    its pool copies stay equal) and chunked prefill with it (tp2: the
    window's heads relayed and its partials summed): every rank's tokens
    equal the JAX greedy oracle's, warm admissions and copies happened,
    nothing leaked, and the ranks' host state agrees."""
    oracles = _oracles()["features"]
    results = ranks[2]["features"]
    for label, *_ in FEATURE_LEGS:
        for r, res in enumerate(results):
            got = res[label]
            for i, (tokens, want) in enumerate(zip(got["tokens"], oracles)):
                np.testing.assert_array_equal(tokens, want, err_msg=f"{label} rank {r} #{i}")
            status = got["pool_status"]
            assert status["leaked"] == 0 and status["prefix_hits"] > 0, label
            assert status["cow_pages"] > 0, label
            assert got["dispatches"] == results[0][label]["dispatches"], label
            assert status == results[0][label]["pool_status"], label
        d = results[0][label]["dispatches"]
        assert d["prefill_chunk" if "chunked" in label else "prefill_warm"] > 0, label
        if label.startswith("dp2"):
            for got, want in zip(results[1][label]["pool"], results[0][label]["pool"]):
                for name in want:
                    assert torch.equal(got[name], want[name]), (label, name)


def test_each_rank_holds_its_block_of_the_kv_state(ranks):
    """The local cache and pool shapes and byte counts of each mesh, the
    blocks' model groups, and the replicated fallback with JAX's warning
    (slots=3 on a 2-way data axis), in which every rank holds the whole
    cache."""
    hd = GEOMETRY["d_model"] // GEOMETRY["num_heads"]
    want = {  # label: (cache slots, cache heads, tp groups, qkv rows held)
        "dp2": (2, 4, (True, True), 96), "tp2": (4, 2, (True, True), 48),
        "fsdp2": (2, 4, (False, False), 48), "dp2tp2": (2, 2, (True, True), 48),
        "tp4": (4, 1, (True, True), 24), "heads4": (4, 1, (False, False), 96),
        "sp2tp2": (4, 4, (True, True), 48), "fallback": (3, 4, (True, True), 48),
    }
    for world in (2, 4):
        for res in ranks[world]["decode"]:
            for label, got in res.items():
                leg, layout = label.split()
                slots, heads, tp, rows = want[leg]
                assert got["tp"] == tp, label
                assert got["replicated"] == (leg == "fallback"), label
                assert any("REPLICATED" in m for m in got["warnings"]) == (leg == "fallback")
                if layout == "slots":
                    assert got["cache_shape"] == (slots, SEQ, heads, hd), label
                    assert got["kv_bytes"] == 2 * 2 * slots * SEQ * heads * hd * 4, label
                else:
                    pages = (3 if leg == "fallback" else 4) * SEQ // 4
                    assert got["cache_shape"] == (pages, 4, heads, hd), label
                # FSDP holds its block of the rows between dispatches.
                assert got["qkv_shape"][0] == rows, label


def test_pool_copies_equal_across_data_ranks(ranks):
    """Every data rank holds the whole page pool; after the stream the
    copies are equal bit for bit (each took every slot's new rows)."""
    checked = 0
    for world, legs in ((2, ("dp2",)), (4, ("dp2tp2", "fallback"))):
        results = ranks[world]["decode"]
        for leg in legs:
            for layout in ("paged", "int8"):
                label = f"{leg} {layout}"
                if label not in results[0]:
                    continue
                model = 2 if leg != "dp2" else 1
                for r, res in enumerate(results):
                    peer = results[r % model]  # data index 0 of the same model index
                    for a, b in zip(res[label]["pool"], peer[label]["pool"]):
                        for name in a:
                            assert torch.equal(a[name], b[name]), (label, r, name)
                            checked += 1
    assert checked > 0


# -- the inference engine ---------------------------------------------------------


def test_inference_engine_data_parallel_matches_jax(ranks):
    """The Mlp under DataParallelPartitioner on 4 ranks (buckets 4 and 8
    split over the ranks, 1 replicated) against JAX's
    DataParallelPartitioner engine on 8 virtual devices (8 split, 1 and 4
    replicated), with JAX's own tolerance."""
    from zookeeper_tpu.parallel import DataParallelPartitioner
    from zookeeper_tpu.serving import InferenceEngine as JaxEngine

    module, params, _ = _mlp()
    part = DataParallelPartitioner()
    jax_configure(part, {}, name="partitioner")
    engine = JaxEngine()
    jax_configure(engine, {"batch_buckets": (1, 4, 8)}, name="engine")
    engine.bind(module.apply, params, {}, MLP_SHAPE, partitioner=part)
    for res in ranks[4]["mlp"]:
        got = res["mlp dp"]
        assert got["split"] == {1: False, 4: True, 8: True} and got["warmed"] == 3
        for x, out in zip(_batches(MLP_SHAPE), got["outputs"]):
            np.testing.assert_allclose(out, np.asarray(engine.infer(x)), rtol=1e-5, atol=1e-6)


def test_packed_quicknet_under_conv_tp_matches_jax(ranks):
    """The packed QuickNet under conv_model_tp_rules ((1, 4) and (2, 2))
    and FSDP: every rank's logits equal the port's unsharded forward
    within 1e-6 of their largest magnitude (the binary convs are exact on
    their blocks, see the next test; the float stem convs and the head
    round by their channel count on the CPU) and JAX's packed forward
    within test_torch_quicknet.py's tolerance; under TP each packed conv
    holds its ``co`` block of ``kernel_packed``."""
    from zookeeper_tpu_torch.models import QuickNet

    jmod, variables, state = _quicknet()
    model = QuickNet()
    port_configure(model, dict(QUICKNET), name="model")
    whole = model.build(QN_SHAPE, CLASSES)
    whole.load_state_dict(state)
    full_packed = {n: tuple(t.shape) for n, t in whole.named_buffers()
                   if n.endswith("kernel_packed")}
    apply = jax.jit(lambda v, x: jmod.apply(v, x, training=False))
    for res in ranks[4]["qn"]:
        for label in ("quicknet tp4", "quicknet dp2tp2", "quicknet fsdp"):
            got = res[label]
            for x, out in zip(_batches(QN_SHAPE), got["outputs"]):
                with torch.inference_mode():
                    mine = whole(torch.from_numpy(x)).numpy()
                np.testing.assert_allclose(out, mine, rtol=0, atol=1e-6 * np.abs(mine).max(),
                                           err_msg=label)
                want = np.asarray(apply(variables, jnp.asarray(x)))
                np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * np.abs(want).max())
            if label == "quicknet fsdp":
                continue
            tp = 4 if label == "quicknet tp4" else 2
            assert any(n.startswith("QuantConv") for n in got["tp_layers"]), label
            for name, shape in got["packed"].items():
                assert shape == (*full_packed[name][:3], full_packed[name][3] // tp), name


@pytest.mark.parametrize("mode", ["xnor_popcount", "xnor"])
@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_packed_layers_compute_their_channel_blocks_bitwise(layer, mode, monkeypatch):
    """A packed QuantConv (``conv_model_tp_rules``) and a packed QuantDense
    (its ``kernel_packed`` [ceil(K/32), N] on N) at tp=4, each rank's
    shards built by the port's plan and composed in one process: each
    holds its block of ``kernel_packed`` and ``kernel_scale`` (and of the
    bias, where the rules shard it), and its output equals the whole layer's channels bit for bit (integer
    sums, one multiply by the scale)."""
    import copy

    from zookeeper_tpu_torch.ops import layers as L
    from zookeeper_tpu_torch.ops.layers import QuantConv, QuantDense
    from zookeeper_tpu_torch.parallel import PartitionSpec, conv_model_tp_rules
    from zookeeper_tpu_torch.parallel.shards import MeshGroups, plan_inference

    class Composed(MeshGroups):
        def group(self, axes):
            return None

    g = torch.Generator().manual_seed(3)
    holder = torch.nn.Module()
    if layer == "conv":
        holder.QuantConv_0 = QuantConv(40, 64, (3, 3), binary_compute=mode, packed_weights=True,
                                       use_bias=True)
        rules, x = conv_model_tp_rules(), torch.randn(2, 7, 7, 40, generator=g)
    else:
        holder.QuantDense_0 = QuantDense(72, 48, "ste_sign", "ste_sign", binary_compute=mode,
                                         packed_weights=True)
        rules = [(r"QuantDense_\d+/(kernel_packed)$", PartitionSpec(None, "model")),
                 (r"QuantDense_\d+/(kernel_scale|bias)$", PartitionSpec("model"))]
        x = torch.randn(5, 72, generator=g)
    (whole,) = holder.children()
    with torch.no_grad():
        whole.kernel_packed.copy_(torch.randint(-2**31, 2**31 - 1, whole.kernel_packed.shape,
                                                generator=g, dtype=torch.int64).to(torch.int32))
        whole.kernel_scale.copy_(torch.rand(whole.kernel_scale.shape, generator=g) + 0.5)
        whole.bias.copy_(torch.randn(whole.bias.shape, generator=g))
    with torch.inference_mode():
        want = whole(x)
    n = whole.kernel_scale.shape[0] // 4
    # Each rank's block without its model group's collectives: the
    # harness compares the channels.
    monkeypatch.setattr(L, "_tp_input", lambda x, tp: x)
    monkeypatch.setattr(L, "_tp_output", lambda y, tp: y)
    for r in range(4):
        m = copy.deepcopy(holder)
        plan = plan_inference(m, rules, Composed({"model": 4}, r), ("model",))
        plan.apply_module(m)
        (sub,) = m.children()
        assert sub._tp is not None and sub.kernel_packed.shape[-1] == n
        assert sub.kernel_scale.shape == (n,)
        # conv_model_tp_rules leave a conv's bias whole (the layer adds its
        # block); the dense rules here shard it.
        assert sub.bias.shape == ((4 * n,) if layer == "conv" else (n,))
        with torch.inference_mode():
            got = sub(x)
        assert torch.equal(got, want[..., r * n:(r + 1) * n]), r


def _jax_mlp(params, x):
    return np.asarray(_mlp()[0].apply({"params": params}, x.reshape(x.shape[0], -1)))


def test_chief_led_threaded_batcher_serves_jax_answers_with_one_expiry(ranks):
    """The threaded batcher with deadlines at world size 2: chief-led, the
    same dispatches on both ranks, JAX's answers, and the request sent
    already expired fails with the deadline error on both ranks."""
    _, params, _ = _mlp()
    results = [r["batcher"] for r in ranks[2]["chief"]]
    assert all(r["led"] for r in results)
    assert results[0]["dispatches"] == results[1]["dispatches"] and results[0]["dispatches"]
    for res in results:
        for i, (x, got) in enumerate(zip(_batches(MLP_SHAPE), res["outcomes"])):
            if i == 2:
                assert got == "DeadlineExpiredError"
                continue
            np.testing.assert_allclose(np.asarray(got), _jax_mlp(params, x), rtol=1e-5,
                                       atol=1e-6)


def test_chief_led_seq_bucketed_batcher_serves_jax_logits_on_both_ranks(ranks):
    """The threaded batcher in front of a data-parallel ``InferenceEngine``
    with sequence buckets (8, 16) at world size 2: chief-led, every pair
    warmed once and none recompiled, the same dispatches (the pair checked
    by the dispatch guard) on both ranks, and the LM's logits on the real
    positions equal JAX's exact-length forward on both."""
    jmod, params, _ = _lm()
    results = [r["seq"] for r in ranks[2]["chief"]]
    assert all(r["led"] for r in results)
    assert results[0]["dispatches"] == results[1]["dispatches"] and results[0]["dispatches"]
    requests = [x for group in serving_workers.seq_requests(VOCAB) for x in group]
    for res in results:
        assert res["warm"] == res["compile_count"] == 4 and res["recompiles"] == 0
        for x, got in zip(requests, res["outcomes"]):
            want = np.asarray(jmod.apply({"params": params}, x, training=False))
            np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)


def test_chief_led_dispatch_fails_on_every_rank_when_a_follower_lacks_a_request(ranks):
    """Rank 1 never submits the chief's second request: after the bounded
    wait that dispatch fails with ``ChiefLedError`` (on the chief, the
    request rank 1 lacks), and neither rank hangs."""
    chief, follower = (r["lost"] for r in ranks[2]["chief"])
    assert chief[1] == "ChiefLedError" and len(follower) == 1
    assert chief[0] == follower[0]  # the first request's fate is shared


def test_chief_led_threaded_scheduler_streams_jax_tokens_with_expiry_and_swap(ranks):
    """The threaded decode scheduler with deadlines at world size 2:
    the greedy oracle's tokens on both ranks, the stream sent already
    expired failed on both, the staged swap applied at the same boundary
    (the same prefill groups before it), and the same dispatches."""
    oracle = _oracles()["float"]
    results = [r["decode"] for r in ranks[2]["chief"]]
    assert all(r["led"] for r in results)
    assert results[0]["dispatches"] == results[1]["dispatches"]
    assert ("swap_weights",) in [d[:1] for d in results[0]["dispatches"]]
    assert results[0]["counts"] == results[1]["counts"]
    for res in results:
        assert res["weights_step"] == 7
        for i, (got, want) in enumerate(zip(res["outcomes"], oracle)):
            if i == 3:
                assert got == "DeadlineExpiredError"
            else:
                np.testing.assert_array_equal(got, want)


def test_chief_led_synchronous_scheduler_with_a_deadline_streams_jax_tokens(ranks):
    """The synchronous scheduler with ``default_deadline_ms`` at world size
    2 runs chief-led: the oracle's tokens on both ranks, the stream sent
    expired failed on both."""
    oracle = _oracles()["float"]
    for res in (r["decode_sync"] for r in ranks[2]["chief"]):
        assert res["led"]
        np.testing.assert_array_equal(res["outcomes"][0], oracle[0])
        np.testing.assert_array_equal(res["outcomes"][1], oracle[1])
        assert res["outcomes"][2] == "DeadlineExpiredError"


def test_watched_swap_lands_at_the_same_dispatch_on_both_ranks(ranks):
    """``ServingConfig(watch=True)`` at world size 2: both ranks load the
    chief's baseline step, the step rank 0 saves while they serve swaps
    in on both before the next dispatch, and the answers are JAX's with
    each step's weights."""
    _, params, _ = _mlp()
    params_b = _mlp_b()[0]
    for res in (r["watch"] for r in ranks[2]["chief"]):
        assert res["step"] == 2 and res["swaps"] == 1
        assert res["status"]["serving_weights_step"] == 2 and res["status"]["watcher_alive"]
        for x, got_a, got_b in zip(_batches(MLP_SHAPE), res["before"], res["after"]):
            np.testing.assert_allclose(np.asarray(got_a), _jax_mlp(params, x), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(np.asarray(got_b), _jax_mlp(params_b, x), rtol=1e-5,
                                       atol=1e-6)


def test_speculative_and_disaggregated_refusals_stay_at_world_size_two(ranks):
    for res in ranks[2]["chief"]:
        messages = res["refusals"]
        assert set(messages) == {"speculative", "disagg"}
        for label, message in messages.items():
            assert message is not None and "Queue 1 item 4" in message, label
