"""The port's chunked prefill against the JAX package.

- ``append_kv_rows``: the per-slot multi-row write equals JAX's, its
  start clamped to ``capacity - w`` as a dynamic-update-slice clamps it.
- The engine's ``prefill_chunk``: a prompt appended in chunks (crossing
  page edges, grouped lanes) gives JAX's last-position tokens, the
  monolithic prefill's first token, and pool rows within 1e-5 of JAX's.
- The scheduler: long prompts arriving while streams decode, chunked at
  3 and 8 tokens under an explicit and an automatic ``token_budget``
  (and with the prefix cache skipping cached chunks): tokens equal to
  JAX's, to the monolithic prefill's and to the greedy oracle; the chunk
  counts, prefill totals and the status section equal JAX's.
- The settings JAX refuses, the port refuses.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu.serving.decode.cache import append_kv_rows as jax_append
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.serving.decode import DecodeScheduler, append_kv_rows

ATOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_append_kv_rows_matches_jax_with_the_clamp(dtype):
    rng = np.random.default_rng(0)
    buf = rng.integers(-50, 50, size=(4, 12, 2, 3)).astype(dtype)
    rows = rng.normal(size=(4, 5, 2, 3)).astype(np.float32) * 20
    starts = np.array([0, 3, 7, 11], np.int32)  # 7 + 5 = 12 fits; 11 clamps to 7
    want = np.asarray(jax_append(jnp.asarray(buf), jnp.asarray(rows), jnp.asarray(starts)))
    got = torch.from_numpy(buf.copy())
    out = append_kv_rows(got, torch.from_numpy(rows), torch.from_numpy(starts))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy()[3, 7:], buf[3, 7:])  # the clamped write


def test_prefill_chunk_matches_jax_and_the_monolithic_prefill(lm):
    """Two prompts (15 and 11 tokens) appended in chunks of 5 and 3 in
    grouped dispatches, after their pages were admitted: each dispatch's
    tokens equal JAX's, the final chunk's equals the monolithic prefill's
    first token, and the slots' pool rows agree with JAX's."""
    jmod, params, mod = lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, F.VOCAB, size=n).astype(np.int32) for n in (15, 11)]
    conf = {**F.PAGED, "prefill_buckets": (1, 2), "prefix_cache": False,
            "prefill_chunk_tokens": 5}
    port = F.port_engine(mod, **conf)
    ref = F.jax_engine(jmod, params, **conf)
    mono = F.port_engine(mod, **F.PAGED, prefix_cache=False, prefill_buckets=(1, 2))
    for i, p in enumerate(prompts):
        for engine in (port, ref, mono):
            engine.admit_slot(i, p)
    want_first = mono.prefill(prompts, [0, 1])
    cuts = [(0, 5, 0, 3), (5, 10, 3, 6), (10, 15, 6, 9), (None, None, 9, 11)]
    for a0, a1, b0, b1 in cuts:
        lanes = [(0, prompts[0][a0:a1], a0)] if a0 is not None else []
        lanes.append((1, prompts[1][b0:b1], b0))
        got = port.prefill_chunk([c for _, c, _ in lanes], [s for s, _, _ in lanes],
                                 [o for _, _, o in lanes])
        want = ref.prefill_chunk([c for _, c, _ in lanes], [s for s, _, _ in lanes],
                                 [o for _, _, o in lanes])
        np.testing.assert_array_equal(got, want)
        if a1 == 15:
            assert got[0] == want_first[0]
    assert got[-1] == want_first[1]
    held = sorted(port.page_pool.table[port.page_pool.table >= 0].tolist())
    for got_l, want_l, mono_l in zip(port.cache, ref._cache, mono.cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(got_l[name].numpy()[held], np.asarray(want_l[name])[held],
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(got_l[name].numpy()[held], mono_l[name].numpy()[held],
                                       rtol=0, atol=ATOL)
    assert port.dispatches["prefill_chunk"] == 4
    with pytest.raises(ValueError, match=">= 1 token"):
        port.prefill_chunk([np.zeros(0, np.int32)], [0], [0])


def _long_stream():
    """Three streams that decode for long, then long prompts (13-16
    tokens) arriving while they do, and short ones."""
    rng = np.random.default_rng(4)
    sizes = [2, 3, 2, 16, 13, 4, 15, 1]
    prompts = [rng.integers(1, F.VOCAB, size=n).astype(np.int32) for n in sizes]
    budgets = [12, 10, 11, 4, 5, 3, 6, 2]
    return prompts, budgets


@pytest.mark.parametrize(
    "conf,budget",
    [({"prefill_chunk_tokens": 3, "prefix_cache": False}, 0),
     ({"prefill_chunk_tokens": 8, "prefix_cache": False}, 5),
     ({"prefill_chunk_tokens": 3, "prefill_buckets": (1, 2)}, 2)],
    ids=["chunk3-auto-budget", "chunk8-budget5", "chunk3-budget2-grouped-prefix-cache"],
)
def test_chunked_stream_matches_jax_and_monolithic(lm, conf, budget):
    jmod, params, mod = lm
    prompts, budgets = _long_stream()
    port = F.port_engine(mod, **F.PAGED, **conf)
    port.warmup()
    sched_conf = {"token_budget": budget}
    got, metrics, _ = F.serve(True, port, prompts, budgets, **sched_conf)
    ref = F.jax_engine(jmod, params, **F.PAGED, **conf)
    want, jax_metrics, _ = F.serve(False, ref, prompts, budgets, **sched_conf)
    mono, _, _ = F.serve(True, F.port_engine(mod, **F.PAGED, prefix_cache=False), prompts,
                         budgets)
    for p, g, w, m, b in zip(prompts, got, want, mono, budgets):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)
        np.testing.assert_array_equal(g, F.greedy(mod, p, b))
    totals, jax_totals = metrics.totals, jax_metrics.totals
    for key in ("prefill_chunks_total", "prefills_total", "requests_total", "tokens_total",
                "decode_steps_total"):
        assert totals[key] == jax_totals[key], key
    assert totals["prefill_chunks_total"] > len(prompts)
    snap = metrics.snapshot()
    assert snap["prefill_stall_p99_ms"] >= snap["prefill_stall_p50_ms"] > 0
    pool = port.page_pool
    assert pool.leak_check() == 0 and F.pool_state(pool) == F.pool_state(ref.page_pool)


def test_chunked_status_matches_jax(lm):
    jmod, params, mod = lm
    status = {}
    for name, engine, sched_cls, conf_fn in (
            ("port", F.port_engine(mod, **F.PAGED, prefill_chunk_tokens=4), DecodeScheduler,
             configure),
            ("jax", F.jax_engine(jmod, params, **F.PAGED, prefill_chunk_tokens=4),
             F.JaxScheduler, F.jax_configure)):
        sched = sched_cls()
        conf_fn(sched, {}, name="sched")
        sched.bind(engine)
        sched.submit(np.arange(1, 15, dtype=np.int32), max_new_tokens=3)
        sched._step_once()  # admission, then chunks of 4 and 3 (the budget 3 + 4)
        status[name] = sched.status()
        sched.drain()
    assert status["port"]["chunked_prefill"] == status["jax"]["chunked_prefill"]
    assert status["port"]["chunked_prefill"]["pending_prefill_tokens"] == 7
    assert status["port"]["speculative"] == {"enabled": False}


@pytest.mark.parametrize(
    "conf,error",
    [({"prefill_chunk_tokens": 4}, "requires kv_layout='paged'"),
     ({**F.PAGED, "prefill_chunk_tokens": 17}, "exceeds the largest seq bucket"),
     ({**F.PAGED, "prefill_chunk_tokens": -1}, "expected 0")],
)
def test_refused_settings_match_jax(lm, conf, error):
    jmod, params, mod = lm
    with pytest.raises(ValueError, match=error):
        F.port_engine(mod, **conf)
    with pytest.raises(ValueError):
        F.jax_engine(jmod, params, **conf)


def test_scheduler_refuses_a_negative_budget(lm):
    _, _, mod = lm
    sched = DecodeScheduler()
    configure(sched, {"token_budget": -1}, name="sched")
    with pytest.raises(ValueError, match="token_budget"):
        sched.bind(F.port_engine(mod))
