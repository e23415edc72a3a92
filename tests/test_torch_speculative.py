"""The port's speculative decoding against the JAX package.

- ``verify_cached_attention`` / ``pool_verify_attention``: fp32 rows
  within 1e-5 of JAX's; bf16 rows within one bf16 step of the value
  (2^-7 relative, plus 1e-6 near 0: both sum in fp32 in another order,
  then round to bf16); an int8 pool within 1e-5 (its dequantized view is
  exact on both sides). At ``w == 1`` each is the single-position oracle
  bit for bit.
- ``decode_verify`` / ``decode_verify_paged``: logits within 1e-5 of
  JAX's, every cache row and pool row too (the valid mask and dropped
  writes included); the engine's ``verify`` gives JAX's tokens from the
  same prefilled state.
- The scheduler's speculative streams at k 2 and 4, with a fresh 1-layer
  draft and with the teacher's own weights as the draft, on the slot
  layout and the paged pool (and chunked): tokens equal to JAX's, to the
  plain scheduler's and to the greedy oracle; the draft and accepted
  totals and the accept lengths equal JAX's.
- ``bind``'s checks; ``LMServingConfig.run()`` with speculation: the
  report's keys equal JAX's, and an unreadable draft falls back to plain
  decode, reported as such.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu import ops as jax_ops
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.parallel.partitioner import SingleDevicePartitioner
from zookeeper_tpu_torch.serving.decode import LMServingConfig, SpeculativeDecoding

ATOL = 1e-5
DRAFT = {"num_layers": 1, "d_model": 32, "num_heads": 2, "max_seq_len": F.SEQ}


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


@pytest.fixture(scope="module")
def draft():
    """A fresh 1-layer draft (its own JAX init, carried across)."""
    return F.build_lm(DRAFT, seed=17)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the attention ------------------------------------------------------------------


def _close(got, want, dtype):
    g = np.asarray(got, np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    tol = ATOL if dtype == "float32" else np.abs(w) * 2.0**-7 + 1e-6
    assert np.all(np.abs(g - w) <= tol), float(np.max(np.abs(g - w)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_cached_attention_matches_jax(dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 5, 2, 8), (3, 20, 2, 8), (3, 20, 2, 8)))
    lengths = np.array([0, 9, 15], np.int32)  # 15 + 5 = the capacity
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ops.verify_cached_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                           jnp.asarray(lengths))
    got = A.verify_cached_attention(*(_t(x).to(td) for x in (q, k, v)), _t(lengths))
    assert got.dtype == td and got.shape == (3, 5, 2, 8)
    _close(got.float(), want, dtype)
    one = A.verify_cached_attention(_t(q[:, :1]).to(td), _t(k).to(td), _t(v).to(td),
                                    _t(lengths))
    assert torch.equal(one, A.cached_attention(_t(q[:, :1]).to(td), _t(k).to(td),
                                               _t(v).to(td), _t(lengths)))


@pytest.mark.parametrize("rows", ["float32", "bfloat16", "int8"])
def test_pool_verify_attention_matches_jax(rows):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
    table = np.array([[3, 0, -1, 5], [1, 2, 4, -1]], np.int32)
    lengths = np.array([6, 9], np.int32)
    scales = {}
    if rows == "int8":
        pools = [rng.integers(-127, 128, size=(6, 4, 2, 8)).astype(np.int8) for _ in range(2)]
        scales = {n: rng.uniform(0.01, 0.05, size=(6, 4, 2)).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
        qd = "float32"
    else:
        pools = [rng.normal(size=(6, 4, 2, 8)).astype(np.float32) for _ in range(2)]
        qd = rows
    jd, td = getattr(jnp, qd), getattr(torch, qd)
    jpools = [jnp.asarray(p) if rows == "int8" else jnp.asarray(p, jd) for p in pools]
    tpools = [_t(p) if rows == "int8" else _t(p).to(td) for p in pools]
    want = jax_ops.pool_verify_attention(jnp.asarray(q, jd), *jpools, jnp.asarray(table),
                                         jnp.asarray(lengths),
                                         **{n: jnp.asarray(s) for n, s in scales.items()})
    got = A.pool_verify_attention(_t(q).to(td), *tpools, _t(table), _t(lengths),
                                  **{n: _t(s) for n, s in scales.items()})
    _close(got.float(), want, qd)
    one = A.pool_verify_attention(_t(q[:, :1]).to(td), *tpools, _t(table), _t(lengths),
                                  **{n: _t(s) for n, s in scales.items()})
    assert torch.equal(one, A.pool_decode_attention(_t(q[:, :1]).to(td), *tpools, _t(table),
                                                    _t(lengths),
                                                    **{n: _t(s) for n, s in scales.items()}))


# -- the module's verify steps ------------------------------------------------------------


def test_decode_verify_matches_jax_with_cache_rows(lm):
    jmod, params, mod = lm
    rng = np.random.default_rng(2)
    cache_np = [{n: rng.normal(size=(3, F.SEQ, 2, 16)).astype(np.float32) for n in ("k", "v")}
                for _ in range(2)]
    tokens = rng.integers(1, F.VOCAB, size=(3, 4)).astype(np.int32)
    lengths = np.array([0, 30, F.SEQ - 2], np.int32)  # the last one clamped
    want_logits, want_cache = jmod.apply(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(lengths),
        tuple({n: jnp.asarray(v) for n, v in layer.items()} for layer in cache_np),
        method="decode_verify")
    cache = tuple({n: _t(v) for n, v in layer.items()} for layer in cache_np)
    with torch.no_grad():
        got_logits, got_cache = mod.decode_verify(_t(tokens), _t(lengths), cache)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    for got, want in zip(got_cache, want_cache):
        for n in ("k", "v"):
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("valid", [None, (3, 0, 2)], ids=["all-rows", "valid-mask"])
def test_decode_verify_paged_matches_jax_with_pool_rows(lm, quant, valid):
    """A window of 3 over a pool: crossing a page edge, a slot on an
    unallocated entry and one running past its table drop their writes;
    with ``valid`` the padding rows drop theirs."""
    from zookeeper_tpu_torch.serving.decode import allocate_page_pool

    jmod, params, mod = lm
    rng = np.random.default_rng(3)
    pool = allocate_page_pool(2, 10, 4, 2, 16, torch.float32, quant=quant)
    for layer in pool:
        for n in ("k", "v"):
            if quant == "int8":
                layer[n].copy_(_t(rng.integers(-127, 128, size=layer[n].shape)))
                layer[n + "_scale"].copy_(_t(rng.uniform(0.01, 0.05, size=layer[n + "_scale"].shape)
                                             .astype(np.float32)))
            else:
                layer[n].copy_(_t(rng.normal(size=layer[n].shape)))
    table = np.array([[3, 7, -1, -1], [0, 1, 2, 4], [5, -1, -1, -1]], np.int32)
    tokens = rng.integers(1, F.VOCAB, size=(3, 3)).astype(np.int32)
    lengths = np.array([3, 15, 3], np.int32)
    kw = {} if valid is None else {"valid": np.array(valid, np.int32)}
    jax_pool = tuple({k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in pool)
    want_logits, want_pool = jmod.apply(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(lengths), jax_pool,
        jnp.asarray(table), method="decode_verify_paged",
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got_logits, got_pool = mod.decode_verify_paged(_t(tokens), _t(lengths), pool, _t(table),
                                                       **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    for got, want in zip(got_pool, want_pool):
        for n in got:
            if got[n].dtype == torch.int8:
                np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
            else:
                np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=0,
                                           atol=ATOL)


@pytest.mark.parametrize("layout", [{}, F.PAGED], ids=["slots", "paged"])
def test_engine_verify_matches_jax(lm, layout):
    jmod, params, mod = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, F.VOCAB, size=n).astype(np.int32) for n in (5, 12, 3)]
    window = rng.integers(1, F.VOCAB, size=(3, 5)).astype(np.int32)
    lengths = np.array([5, 12, 3], np.int32)
    out = {}
    layout = {**layout, "prefill_buckets": (3,)}
    for name, engine in (("port", F.port_engine(mod, **layout)),
                         ("jax", F.jax_engine(jmod, params, **layout))):
        for s, p in enumerate(prompts):
            engine.admit_slot(s, p)
            engine.ensure_rows(s, len(p) + 5)
        first = engine.prefill(prompts, [0, 1, 2])
        out[name] = (first, engine.verify(window, lengths))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][1].shape == (3, 5) and out["port"][1].dtype == np.int32


# -- whole streams ---------------------------------------------------------------------


def _stream(seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, F.VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 15, size=8)]
    budgets = [int(b) for b in rng.integers(1, 12, size=8)]
    return prompts, budgets


@pytest.mark.parametrize(
    "k,which,layout",
    [(2, "fresh", {}), (4, "fresh", F.PAGED), (2, "teacher", F.PAGED), (4, "teacher", {}),
     (2, "fresh", {**F.PAGED, "prefill_chunk_tokens": 4})],
    ids=["k2-fresh-slots", "k4-fresh-paged", "k2-teacher-paged", "k4-teacher-slots",
         "k2-fresh-paged-chunked"],
)
def test_speculative_streams_match_jax_and_greedy(lm, draft, k, which, layout):
    jmod, params, mod = lm
    djmod, dparams, dmod = draft if which == "fresh" else lm
    prompts, budgets = _stream(5)
    port = F.port_engine(mod, **layout)
    port.warmup()
    spec = F.port_spec(port, dmod, k)
    got, metrics, streams = F.serve(True, port, prompts, budgets, spec=spec)
    ref = F.jax_engine(jmod, params, **layout)
    jspec = F.jax_spec(ref, djmod, dparams, k)
    want, jax_metrics, jax_streams = F.serve(False, ref, prompts, budgets, spec=jspec)
    plain, _, _ = F.serve(True, F.port_engine(mod, **layout), prompts, budgets)
    for p, g, w, pl, b in zip(prompts, got, want, plain, budgets):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, pl)
        np.testing.assert_array_equal(g, F.greedy(mod, p, b))
    totals, jax_totals = metrics.totals, jax_metrics.totals
    for key in ("spec_draft_tokens_total", "spec_accepted_tokens_total", "decode_steps_total",
                "tokens_total", "prefill_chunks_total"):
        assert totals[key] == jax_totals[key], key
    assert totals["spec_draft_tokens_total"] > 0
    counts = jax_metrics._obs()["hist"]["spec_accept_length"]._counts
    assert metrics.spec_accept_lengths == {a: n for a, n in enumerate(counts[:k + 1]) if n}
    assert spec.acceptance_rate == jspec.acceptance_rate
    assert [(s._spec_proposed, s._spec_accepted) for s in streams] == \
        [(s._spec_proposed, s._spec_accepted) for s in jax_streams]
    if which == "teacher":
        assert spec.acceptance_rate == 1.0
    draft_engine = spec.draft_engine
    assert not draft_engine.paged and draft_engine.ledger_prefix == "draft_"
    assert draft_engine.dispatches["verify"] > 0 and port.dispatches["verify"] > 0
    if port.paged:
        assert port.page_pool.leak_check() == 0


def test_bind_checks(lm, draft):
    jmod, params, mod = lm
    _, _, dmod = draft
    engine = F.port_engine(mod)
    spec = SpeculativeDecoding()
    configure(spec, {"enabled": True, "k": 0}, name="spec")
    with pytest.raises(ValueError, match="k=0"):
        spec.bind(engine, dmod)
    other = F.TransformerLM()
    configure(other, DRAFT, name="other")
    with pytest.raises(ValueError, match="vocab_size 7"):
        F.port_spec(engine, other.build((F.SEQ,), 7), 2)
    short = F.TransformerLM()
    configure(short, {**DRAFT, "max_seq_len": 12}, name="short")
    with pytest.raises(ValueError, match="positional table"):
        F.port_spec(engine, short.build((12,), F.VOCAB), 2)
    with pytest.raises(RuntimeError, match="not bound"):
        SpeculativeDecoding().draft_engine
    unbound = F.port_engine(mod)
    sched = F.DecodeScheduler()
    configure(sched, {}, name="sched")
    with pytest.raises(ValueError, match="same DecodeEngine"):
        sched.bind(unbound, speculative=F.port_spec(engine, dmod, 2))
    with pytest.raises(ValueError, match="verify width"):
        engine.verify(np.zeros((3, F.SEQ + 1), np.int32), np.zeros(3, np.int32))


class _TwoRanks(SingleDevicePartitioner):
    def process_span(self) -> int:
        return 2


def test_draft_at_world_size_two_raises_naming_the_roadmap(lm, draft):
    _, _, mod = lm
    spec = SpeculativeDecoding()
    configure(spec, {"enabled": True, "k": 2}, name="spec")
    with pytest.raises(ValueError, match="speculative draft.*ROADMAP.md Queue 1 item 4"):
        spec.bind(F.port_engine(mod), draft[2], partitioner=_TwoRanks())


_SERVICE = {"model.num_layers": 2, "model.d_model": 16, "model.num_heads": 2, "seq_len": 32,
            "vocab_size": 29, "requests": 5, "max_prompt": 10, "new_tokens": 6,
            "engine.seq_buckets": (16,), "engine.slots": 2, "verbose": False, "seed": 3,
            "speculative.enabled": True, "speculative.k": 3,
            "speculative.draft_model.num_layers": 2, "speculative.draft_model.d_model": 16,
            "speculative.draft_model.num_heads": 2}


@pytest.mark.parametrize("layout", [{}, {"engine.kv_layout": "paged", "engine.page_size": 4}],
                         ids=["slots", "paged"])
def test_lm_serving_config_speculative_matches_jax(layout):
    """The draft at the teacher's geometry and seed is the teacher: every
    draft is accepted on both sides (the windows near the token limit run
    plain)."""
    from zookeeper_tpu.serving.decode import LMServingConfig as JaxConfig

    cfg = LMServingConfig()
    configure(cfg, {**_SERVICE, **layout, "device": "cpu"})
    got = cfg.run()
    ref = JaxConfig()
    jax_configure(ref, {**_SERVICE, **layout, "engine.decode_attention": "reference"})
    want = ref.run()
    for key in ("speculative", "spec_k", "spec_acceptance_rate", "spec_draft_tokens_total",
                "spec_accepted_tokens_total", "generated_tokens", "decode_steps_total"):
        assert got[key] == want[key], key
    assert got["speculative"] is True and got["spec_acceptance_rate"] == 1.0


def test_unreadable_draft_falls_back_to_plain_decode(tmp_path, capsys):
    cfg = LMServingConfig()
    configure(cfg, {**_SERVICE, "device": "cpu", "verbose": True,
                    "speculative.draft_checkpoint": str(tmp_path / "missing")})
    result = cfg.run()
    assert result["speculative"] is False and result["spec_k"] == 0
    assert "spec_acceptance_rate" not in result
    assert "speculative decoding disabled" in capsys.readouterr().out
    assert result["generated_tokens"] == 30
