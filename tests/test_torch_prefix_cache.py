"""The port's radix prefix cache against the JAX package.

- ``prefix_key``: ``common_prefix``, the match and insert walks and
  ``PrefixIndex`` give JAX's answers on seeded token sequences.
- ``PagePool`` / ``RadixPrefixCache``: a seeded sequence of admissions
  (prefixes ending on and off a page edge, exact repeats), releases,
  inserts, page growth, evictions under pool pressure, invalidations and
  a reset through both packages; after every operation the plans, the
  table, counts, refcounts, the free list, ``cow_pages``, the hit rate,
  ``leak_check`` and ``status`` are equal.
- The engine: ``prefill_warm`` after a cold prefill and ``copy_page``
  give JAX's first tokens, and every pool row within 1e-5 (exact fp32
  products on both sides, only the order of sums differs).
- The scheduler on a shared-prefix stream (warm admissions, copies at a
  mid-page divergence, LRU eviction in a small pool): tokens equal to
  JAX's and to the port's full-recompute greedy oracle, the same hit
  rate, copies and evictions, no leaked page, and every page's refcount
  equal to its references (slots and cache nodes).
- ``LMServingConfig.run()`` on the paged layout at its defaults (prefix
  cache on): its report's prefix keys equal JAX's.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.serving.decode import pages as jax_pages
from zookeeper_tpu.serving.decode import prefix_key as jax_key
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.serving.decode import LMServingConfig, PagePool
from zookeeper_tpu_torch.serving.decode import prefix_key as port_key

ATOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


# -- prefix_key ----------------------------------------------------------------


class _Node:
    def __init__(self, chunk):
        self.chunk = chunk
        self.children = {}


def test_prefix_key_walks_and_index_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.integers(0, 3, size=int(rng.integers(0, 9))).tolist()
        b = rng.integers(0, 3, size=int(rng.integers(0, 9))).tolist()
        assert port_key.common_prefix(a, b) == jax_key.common_prefix(a, b)
    roots = {"port": _Node(()), "jax": _Node(())}
    walks = {"port": port_key, "jax": jax_key}
    index = {"port": port_key.PrefixIndex(3, max_nodes=12),
             "jax": jax_key.PrefixIndex(3, max_nodes=12)}
    for step in range(60):
        tokens = rng.integers(0, 3, size=int(rng.integers(1, 11))).tolist()
        got = {}
        for side, key in walks.items():
            created = key.walk_insert(roots[side], tokens, 3, lambda c, i, p: _Node(c),
                                      tail=bool(step % 2))
            t, visited = key.walk_match(roots[side], tokens[: len(tokens) - step % 3], 3)
            probe = rng.integers(0, 3, size=7).tolist() if side == "port" else probe
            got[side] = ([(n.chunk, c) for n, c in created], t, [n.chunk for n in visited],
                         index[side].observe(tokens), index[side].match(probe),
                         index[side].predict(probe), index[side].nodes, index[side].resets)
        assert got["port"] == got["jax"], step
    assert index["port"].resets > 0
    for bad in ({"page_size": 0}, {"page_size": 2, "max_nodes": 0}):
        with pytest.raises(ValueError):
            port_key.PrefixIndex(**bad)


# -- the allocator and the trie --------------------------------------------------


def _pools(**kw):
    conf = {"num_pages": 12, "page_size": 4, "slots": 3, "max_pages_per_slot": 5, **kw}
    return PagePool(**conf), jax_pages.PagePool(**conf)


def test_page_pool_operations_match_jax():
    """A seeded walk of every pool operation; the two pools' whole state
    is compared after each one (and its return value)."""
    port, ref = _pools()
    rng = np.random.default_rng(3)
    prefixes = [rng.integers(1, 9, size=n).astype(np.int32) for n in (8, 6, 5)]
    held = {}
    ops = []
    for step in range(160):
        r = rng.random()
        free = [s for s in range(3) if s not in held]
        if r < 0.4 and free:
            slot = free[0]
            base = prefixes[int(rng.integers(0, 3))]
            cut = int(rng.integers(1, len(base) + 1))
            prompt = np.concatenate([base[:cut], rng.integers(1, 9, size=int(
                rng.integers(0, 5))).astype(np.int32)])
            ops.append(("assign_prompt", slot, prompt))
            held[slot] = prompt
        elif r < 0.6 and held:
            slot = sorted(held)[int(rng.integers(0, len(held)))]
            ops.append(("insert_prefix", slot, held[slot]))
        elif r < 0.72 and held:
            slot = sorted(held)[int(rng.integers(0, len(held)))]
            ops.append(("ensure_rows", slot, len(held[slot]) + int(rng.integers(1, 8))))
        elif r < 0.9 and held:
            slot = sorted(held)[int(rng.integers(0, len(held)))]
            ops.append(("release_slot", slot))
            del held[slot]
        elif r < 0.95:
            ops.append(("evict_lru", int(rng.integers(1, 4))))
        elif r < 0.985:
            ops.append(("invalidate_prefix",))
        else:
            ops.append(("reset",))
            held.clear()
    seen = set()
    for op in ops:
        name, *args = op
        outs = []
        for pool in (port, ref):
            if name == "evict_lru":
                outs.append(pool.prefix.evict_lru(*args))
            else:
                try:
                    outs.append(getattr(pool, name)(*args))
                except ValueError as e:  # ensure_rows past the table
                    outs.append(("ValueError", str(e)))
        if name == "assign_prompt" and outs[0] is None:
            held.pop(args[0], None)  # the pool could not serve it
        assert outs[0] == outs[1], op
        assert F.pool_state(port) == F.pool_state(ref), op
        seen.add(name)
        if name == "assign_prompt" and outs[0] is not None:
            seen.add("cow" if outs[0]["cow"] else "cold" if not outs[0]["shared_tokens"]
                     else "warm")
    assert {"cow", "warm", "cold", "evict_lru", "reset", "invalidate_prefix"} <= seen
    st = port.status()
    assert st["prefix_hits"] > 0 and st["prefix_evicted_pages"] > 0 and port.cow_pages > 0


def test_prefix_cache_off_and_pool_edges_match_jax():
    port, ref = _pools(prefix_cache=False)
    assert port.prefix is None and port.prefix_hit_rate == -1.0
    for pool in (port, ref):
        pool.assign_prompt(0, np.arange(1, 7))
        pool.insert_prefix(0, np.arange(1, 7))
    assert F.pool_state(port) == F.pool_state(ref)
    assert port.invalidate_prefix() == ref.invalidate_prefix() == 0
    with pytest.raises(AssertionError, match="release first"):
        port.assign_prompt(0, np.arange(3))
    with pytest.raises(ValueError, match="below max_pages_per_slot"):
        PagePool(num_pages=2, page_size=4, slots=1, max_pages_per_slot=3)


# -- the engine's warm prefill and page copy --------------------------------------


def _pool_rows_close(port_engine, jax_engine, pages=None):
    for got, want in zip(port_engine.cache, jax_engine._cache):
        for name in ("k", "v"):
            g, w = got[name].numpy(), np.asarray(want[name])
            if pages is not None:
                g, w = g[pages], w[pages]
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_prefill_warm_and_copy_page_match_jax(lm):
    """A cold prefill of a prefix, then warm admissions that share it on
    a page edge and mid-page (with the copy): the first tokens equal
    JAX's and the pool rows the slots hold are within 1e-5."""
    jmod, params, mod = lm
    port = F.port_engine(mod, **F.PAGED, prefill_buckets=(1, 2))
    ref = F.jax_engine(jmod, params, **F.PAGED, prefill_buckets=(1, 2))
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, F.VOCAB, size=10).astype(np.int32)
    first = {}
    for name, engine in (("port", port), ("jax", ref)):
        engine.admit_slot(0, prefix)
        cold = engine.prefill([prefix], [0])
        engine.insert_prefix(0, prefix)
        warm_prompts = [np.concatenate([prefix[:8], [3, 5, 7]]).astype(np.int32),
                        np.concatenate([prefix[:9], [11, 2]]).astype(np.int32)]
        plans = [engine.admit_slot(s, p) for s, p in zip((1, 2), warm_prompts)]
        assert [p["shared_tokens"] for p in plans] == [8, 9]
        warm = engine.prefill_warm(warm_prompts, [1, 2], [8, 9])
        first[name] = (cold, warm, engine.page_pool.cow_pages)
    np.testing.assert_array_equal(first["port"][0], first["jax"][0])
    np.testing.assert_array_equal(first["port"][1], first["jax"][1])
    assert first["port"][2] == first["jax"][2] == 1
    assert F.pool_state(port.page_pool) == F.pool_state(ref.page_pool)
    held = sorted(set(port.page_pool.table[port.page_pool.table >= 0].tolist()))
    _pool_rows_close(port, ref, held)
    # copy_page alone: every layer's rows of one page onto another.
    port.copy_page(held[0], held[-1])
    ref.copy_page(held[0], held[-1])
    _pool_rows_close(port, ref, held)
    for layer in port.cache:
        assert torch.equal(layer["k"][held[0]], layer["k"][held[-1]])
    assert port.dispatches == {"prefill": 1, "prefill_warm": 1, "copy_page": 2}
    with pytest.raises(ValueError, match="suffix token"):
        port.prefill_warm([prefix], [0], [10])


def test_copy_page_copies_int8_scales(lm):
    _, _, mod = lm
    engine = F.port_engine(mod, **F.PAGED, kv_quant="int8")
    for layer in engine.cache:
        for name, buf in layer.items():
            buf[2] = torch.arange(buf[2].numel()).reshape(buf[2].shape).to(buf.dtype)
    engine.copy_page(2, 7)
    for layer in engine.cache:
        assert sorted(layer) == ["k", "k_scale", "v", "v_scale"]
        for buf in layer.values():
            assert torch.equal(buf[7], buf[2])
    slots = F.port_engine(mod)
    with pytest.raises(RuntimeError, match="paged-layout"):
        slots.copy_page(0, 1)
    assert slots.admit_slot(0, np.arange(1, 5)) == {"shared_tokens": 0, "cow": None}
    assert slots.insert_prefix(0, np.arange(1, 5)) == 0


# -- whole streams ------------------------------------------------------------------


def _refs_consistent(pool):
    """Each page's refcount equals the slots' and the trie's references."""
    want = np.zeros_like(pool.refcount)
    for s in range(pool.slots):
        for p in pool.table[s, : pool.counts[s]]:
            want[p] += 1
    stack = list(pool.prefix._root.children.values()) if pool.prefix is not None else []
    while stack:
        node = stack.pop()
        want[node.page] += 1
        stack.extend(node.children.values())
    return np.array_equal(want, pool.refcount)


@pytest.mark.parametrize("conf", [{}, {"pool_pages": 20, "prefill_buckets": (1, 2)}],
                         ids=["worst-case-pool", "small-pool-grouped"])
def test_shared_prefix_stream_matches_jax_and_greedy(lm, conf):
    """Prefixes of 8 (a page edge) and 6 and 9 tokens (mid-page), their
    repeats and seeded suffixes, on three slots: the warm path, copies
    at the divergence, and (small pool) LRU eviction."""
    jmod, params, mod = lm
    prompts = F.shared_prefix_prompts(11, (8, 6, 9), 3)
    budgets = [int(b) for b in np.random.default_rng(12).integers(1, 7, size=len(prompts))]
    port = F.port_engine(mod, **F.PAGED, **conf)
    port.warmup()
    got, metrics, streams = F.serve(True, port, prompts, budgets)
    ref = F.jax_engine(jmod, params, **F.PAGED, **conf)
    want, jax_metrics, jax_streams = F.serve(False, ref, prompts, budgets)
    for p, g, w, b in zip(prompts, got, want, budgets):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, F.greedy(mod, p, b))
    assert [s.shared_tokens for s in streams] == [s.shared_tokens for s in jax_streams]
    pool, jpool = port.page_pool, ref.page_pool
    assert pool.prefix_hit_rate == jpool.prefix_hit_rate > 0
    assert pool.cow_pages == jpool.cow_pages > 0
    assert pool.prefix.evicted_pages == jpool.prefix.evicted_pages
    if conf:
        assert pool.prefix.evicted_pages > 0
    assert F.pool_state(pool) == F.pool_state(jpool)
    assert pool.leak_check() == 0 and _refs_consistent(pool)
    assert metrics.gauges["prefix_cache_hit_rate"] == pytest.approx(pool.prefix_hit_rate)
    for key in ("tokens_total", "requests_total", "prefills_total", "decode_steps_total"):
        assert metrics.totals[key] == jax_metrics.totals[key], key
    assert port.dispatches["prefill_warm"] > 0


def test_lm_serving_config_paged_defaults_match_jax():
    """``engine.kv_layout=paged`` at its defaults binds with the prefix
    cache on; the report's pool and prefix keys equal JAX's (its run
    through the same seeded stream: a first token shared mid-page)."""
    from zookeeper_tpu.serving.decode import LMServingConfig as JaxConfig

    conf = {"model.num_layers": 1, "model.d_model": 16, "model.num_heads": 2, "seq_len": 32,
            "vocab_size": 5, "requests": 8, "max_prompt": 12, "new_tokens": 3,
            "engine.seq_buckets": (16,), "engine.kv_layout": "paged", "engine.page_size": 4,
            "verbose": False, "seed": 2}
    cfg = LMServingConfig()
    configure(cfg, {**conf, "device": "cpu"})
    got = cfg.run()
    ref = JaxConfig()
    jax_configure(ref, {**conf, "engine.decode_attention": "reference"})
    want = ref.run()
    assert cfg.engine.prefix_cache and cfg.engine.page_pool.prefix is not None
    for key in ("prefix_cache_hit_rate", "kv_pool_fill", "kv_layout", "speculative", "spec_k",
                "generated_tokens", "requests_total", "prefills_total"):
        assert got[key] == want[key], key
    assert got["prefix_cache_hit_rate"] > 0
