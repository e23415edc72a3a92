"""The port's TransformerLM decode-serving path against the JAX package:
the module's forward, prefill and decode steps (logits and cache rows),
the weight converter, and whole token streams through both decode
engines and schedulers, on the same weights (converted from the JAX
init) and the same seeded prompts.

Logits and cache contents agree at 1e-5 in fp32 (exact fp32 products on
both sides; only the order of the sums differs). Token streams are
required to be identical: to each other, to the JAX engine's (its
decode kernels in interpret mode, as the JAX tests run them) and to both
frameworks' full-recompute ``greedy_decode`` oracles.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import json
import subprocess
import sys

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models.transformer import TransformerLM as JaxLM
from zookeeper_tpu.models.transformer import greedy_decode as jax_greedy_decode
from zookeeper_tpu.serving.decode import DecodeEngine as JaxDecodeEngine
from zookeeper_tpu.serving.decode import DecodeScheduler as JaxDecodeScheduler
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.models.convert import from_flax_lm_variables, to_flax_lm_variables
from zookeeper_tpu_torch.models.transformer import TransformerLM, greedy_decode
from zookeeper_tpu_torch.ops import attention as A
from zookeeper_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeScheduler,
    LMServingConfig,
    PagePool,
    allocate_kv_cache,
    allocate_page_pool,
)

VOCAB, SEQ = 61, 64
GEOMETRY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "max_seq_len": SEQ}
ATOL = 1e-5
ENGINE = {"slots": 3, "seq_buckets": (8, 16), "kv_capacity": SEQ, "page_size": 4}


@pytest.fixture(scope="module")
def lm():
    """(JAX module, JAX params, port module) on the same weights."""
    jm = JaxLM()
    jax_configure(jm, dict(GEOMETRY), name="lm")
    jmod = jm.build((SEQ,), VOCAB)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, _ = jax.jit(lambda: jm.initialize(jmod, (SEQ,), seed=0))()
    pm = TransformerLM()
    configure(pm, dict(GEOMETRY), name="lm")
    mod = pm.build((SEQ,), VOCAB)
    mod.load_state_dict(from_flax_lm_variables(params))
    return jmod, params, mod


@pytest.fixture(scope="module")
def stream_case(lm):
    """Twelve seeded prompts, staggered budgets, and the JAX package's
    greedy oracle for each (run once: it compiles one program per total
    length; its module takes the dense attention, as the JAX decode
    tests' oracle does, on the same weights)."""
    _, params, _ = lm
    jm = JaxLM()
    jax_configure(jm, {**GEOMETRY, "attention": "dense"}, name="lm")
    dense = jm.build((SEQ,), VOCAB)
    prompts = _prompts(7, 12)
    budgets = [int(b) for b in np.random.default_rng(8).integers(1, 9, size=12)]
    oracles = [np.asarray(jax_greedy_decode(dense, {"params": params}, p[None], b))[0, p.shape[0]:]
               for p, b in zip(prompts, budgets)]
    return prompts, budgets, oracles


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


def _prompts(seed, n, max_len=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(rng.integers(1, max_len + 1))).astype(np.int32)
            for _ in range(n)]


# -- the module ----------------------------------------------------------------


def test_converter_round_trip(lm):
    _, params, mod = lm
    back = to_flax_lm_variables(mod)
    assert sorted(back) == sorted(params)
    for scope, leaves in params.items():
        if isinstance(leaves, dict):
            for name, sub in leaves.items():
                for leaf, value in (sub.items() if isinstance(sub, dict) else [(None, sub)]):
                    got = back[scope][name] if leaf is None else back[scope][name][leaf]
                    np.testing.assert_array_equal(got, np.asarray(value))
        else:
            np.testing.assert_array_equal(back[scope], np.asarray(leaves))
    assert tuple(mod.state_dict()["block0.qkv.weight"].shape) == (96, 32)


def test_forward_and_prefill_match_jax(lm):
    jmod, params, mod = lm
    tokens = np.random.default_rng(0).integers(1, VOCAB, size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    want = jmod.apply({"params": params}, jnp.asarray(tokens))
    want_last, want_kv = jmod.apply({"params": params}, jnp.asarray(tokens),
                                    jnp.asarray(lengths), method="prefill")
    with torch.no_grad():
        got = mod(_t(tokens))
        got_last, got_kv = mod.prefill(_t(tokens), _t(lengths))
    _close(got, want)
    _close(got_last, want_last)
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        _close(gk, wk)
        _close(gv, wv)


def test_decode_step_matches_jax_with_cache_rows(lm):
    """One decode step from a prefilled slot cache: logits, and every
    cache row (the new row at clamp(lengths), the rest untouched),
    including a slot at the capacity edge."""
    jmod, params, mod = lm
    rng = np.random.default_rng(1)
    cache_np = [{name: rng.normal(size=(3, SEQ, 4, 8)).astype(np.float32)
                 for name in ("k", "v")} for _ in range(2)]
    tokens = np.array([5, 17, 60], np.int32)
    lengths = np.array([0, 13, SEQ + 2], np.int32)
    want_logits, want_cache = jmod.apply(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(lengths),
        tuple({k: jnp.asarray(v) for k, v in layer.items()} for layer in cache_np),
        method="decode_step")
    cache = tuple({k: _t(v) for k, v in layer.items()} for layer in cache_np)
    with torch.no_grad():
        got_logits, got_cache = mod.decode_step(_t(tokens), _t(lengths), cache)
    _close(got_logits, want_logits)
    for got, want in zip(got_cache, want_cache):
        for name in ("k", "v"):
            _close(got[name], want[name])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_step_paged_matches_jax_with_pool_rows(lm, quant):
    """One paged step: writes through the table (an unallocated entry and
    a slot past its table drop theirs), logits and every pool row."""
    jmod, params, mod = lm
    rng = np.random.default_rng(2)
    pool = allocate_page_pool(2, 12, 4, 4, 8, torch.float32, quant=quant)
    for layer in pool:
        for name in ("k", "v"):
            if quant == "int8":
                layer[name].copy_(torch.from_numpy(rng.integers(-127, 128, size=layer[name].shape)))
                layer[name + "_scale"].copy_(torch.from_numpy(
                    rng.uniform(0.01, 0.05, size=layer[name + "_scale"].shape).astype(np.float32)))
            else:
                layer[name].copy_(torch.from_numpy(rng.normal(size=layer[name].shape)))
    table = np.array([[3, 7, -1, -1], [0, 1, 2, 4], [5, -1, -1, -1]], np.int32)
    tokens = np.array([5, 17, 60], np.int32)
    lengths = np.array([6, 16, 4], np.int32)  # slot 1 past its table, slot 2 on a -1 page
    jax_pool = tuple({k: jnp.asarray(v.numpy()) for k, v in layer.items()} for layer in pool)
    want_logits, want_pool = jmod.apply(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(lengths), jax_pool,
        jnp.asarray(table), method="decode_step_paged")
    with torch.no_grad():
        got_logits, got_pool = mod.decode_step_paged(_t(tokens), _t(lengths), pool,
                                                     _t(table))
    _close(got_logits, want_logits)
    for got, want in zip(got_pool, want_pool):
        assert sorted(got) == sorted(want)
        for name in got:
            if got[name].dtype == torch.int8:
                np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
            else:
                _close(got[name], want[name])


# -- whole streams through both engines ---------------------------------------


def _port_engine(mod, **conf):
    engine = DecodeEngine()
    configure(engine, {**ENGINE, "decode_attention": "kernel", **conf}, name="engine")
    return engine.bind(mod, device="cpu")


def _jax_engine(jmod, params, **conf):
    engine = JaxDecodeEngine()
    jax_configure(engine, {**ENGINE, "decode_attention": "pallas", **conf}, name="engine")
    engine.bind(jmod, params, None)
    return engine


def _serve(sched_cls, configure_fn, engine, prompts, budgets):
    sched = sched_cls()
    configure_fn(sched, {}, name="sched")
    sched.bind(engine)
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    return [np.asarray(s.result()) for s in streams]


PAGED = {"kv_layout": "paged", "prefix_cache": False}


@pytest.mark.parametrize(
    "layout",
    [{}, PAGED, {**PAGED, "kv_quant": "int8"},
     {"prefill_buckets": (2, 3)}, {**PAGED, "prefill_buckets": (2, 3)}],
    ids=["slots", "paged", "paged-int8", "slots-grouped", "paged-grouped"],
)
def test_streams_match_jax_engine_and_oracles(lm, stream_case, layout):
    """Twelve requests on three slots (staggered budgets, so finished
    slots are refilled mid-stream and freed pages reused): the port's
    engine (its kernel wrappers running their plain versions on the
    CPU) and the JAX engine (its Pallas kernels in interpret mode) emit
    the same tokens, equal to both greedy oracles. The grouped cases
    admit up to three prompts per prefill dispatch and pad a group of
    one to two rows."""
    jmod, params, mod = lm
    prompts, budgets, jax_oracles = stream_case
    port = _port_engine(mod, **layout)
    assert port.decode_attention_flavor == "kernel"
    port.warmup()
    got = _serve(DecodeScheduler, configure, port, prompts, budgets)
    want = _serve(JaxDecodeScheduler, jax_configure, _jax_engine(jmod, params, **layout),
                  prompts, budgets)
    assert A.LAUNCHES == dict.fromkeys(A.LAUNCHES, 0)
    for p, g, w, b, jax_oracle in zip(prompts, got, want, budgets, jax_oracles):
        np.testing.assert_array_equal(g, w)
        assert g.shape == (b,)
        oracle = greedy_decode(mod, _t(p)[None], b)[0, p.shape[0]:].numpy()
        np.testing.assert_array_equal(g, oracle)
        np.testing.assert_array_equal(g, jax_oracle)
    if port.paged:
        assert port.page_pool.used_pages == 0 and port.page_pool.leak_check() == 0


def test_capacity_truncates_at_the_token_limit(lm):
    _, _, mod = lm
    engine = _port_engine(mod, kv_capacity=20)
    sched = DecodeScheduler()
    configure(sched, {}, name="sched")
    sched.bind(engine)
    stream = sched.submit(np.arange(1, 15, dtype=np.int32), max_new_tokens=50)
    sched.drain()
    assert stream.finish_reason == "capacity"
    assert 14 + stream.result().shape[0] == engine.token_limit == 20


# -- the service and its CLI --------------------------------------------------


def test_lm_serving_cli_prints_one_json_line(tmp_path):
    cmd = [
        sys.executable, "-m", "zookeeper_tpu_torch.serving.decode", "LMServingConfig",
        "model.num_layers=2", "model.d_model=32", "model.num_heads=4", "seq_len=64",
        f"vocab_size={VOCAB}", "device=cpu", "requests=5", "max_prompt=12",
        "new_tokens=4", "engine.slots=2", "engine.seq_buckets=(8,16)",
        "engine.kv_layout=paged", "engine.page_size=4",
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["generated_tokens"] == result["tokens_total"] == 20
    assert result["requests"] == 5 and result["device"] == "cpu"
    assert result["kv_layout"] == "paged" and result["decode_attention"] == "reference"
    assert result["ttft_p99_ms"] >= result["ttft_p50_ms"] > 0
    assert result["itl_p99_ms"] >= result["itl_p50_ms"] > 0
    assert result["decode_mbu"] == -1.0  # no device number from a CPU run


def test_service_serves_the_jax_prompt_stream():
    cfg = LMServingConfig()
    configure(cfg, {"model.num_layers": 1, "model.d_model": 16, "model.num_heads": 2,
                    "seq_len": 32, "vocab_size": 29, "device": "cpu", "requests": 4,
                    "max_prompt": 12, "new_tokens": 3, "engine.seq_buckets": (16,),
                    "verbose": False, "seed": 5})
    result = cfg.run()
    rng = np.random.default_rng(5)
    for prompt in cfg.prompts(12):
        n = int(rng.integers(1, 13))
        np.testing.assert_array_equal(prompt, rng.integers(1, 29, size=n).astype(np.int32))
    assert result["generated_tokens"] == 12 and len(cfg.outputs) == 4


# -- the page transfer and the swap refuse what JAX refuses -----------------


@pytest.mark.parametrize("method", ["export_pages", "import_pages", "swap_weights"])
def test_deferred_paths_raise(lm, method):
    """The page transfer needs the paged layout, and a swap the bound
    structure: on a slot-layout engine the transfer raises JAX's
    ``RuntimeError`` and a swap of another architecture JAX's
    ``ValueError`` (both packages). The working paths are held in
    ``test_torch_disagg.py`` and ``test_torch_serving_faults.py``."""
    jmod, params, mod = lm
    engines = {"port": _port_engine(mod), "jax": _jax_engine(jmod, params)}
    for side, engine in engines.items():
        if method == "swap_weights":
            bad = ({"params": {}}, None) if side == "jax" else ({}, {})
            with pytest.raises(ValueError, match="does not match the bound structure"):
                engine.swap_weights(*bad)
        else:
            with pytest.raises(RuntimeError, match="paged-layout program"):
                getattr(engine, method)(*(([0],) if method == "export_pages" else (None, [0])))


def test_cache_and_pool_allocation():
    cache = allocate_kv_cache(2, 3, 16, 4, 8, torch.bfloat16)
    assert len(cache) == 2 and cache[0]["k"].shape == (3, 16, 4, 8)
    assert cache[1]["v"].dtype == torch.bfloat16 and not cache[1]["v"].any()
    pool = allocate_page_pool(1, 5, 4, 2, 8, torch.float32, quant="int8")
    assert pool[0]["k"].dtype == torch.int8 and bool((pool[0]["k_scale"] == 1).all())
    pp = PagePool(num_pages=5, page_size=4, slots=2, max_pages_per_slot=3)
    assert pp.assign_prompt(0, np.ones(5)) == {"shared_tokens": 0, "cow": None}
    assert pp.assign_prompt(1, np.ones(8)) == {"shared_tokens": 0, "cow": None}
    assert pp.free_pages == 1 and pp.ensure_rows(0, 9) and pp.free_pages == 0
    assert not pp.ensure_rows(1, 9) and pp.exhausted_events == 1
    pp.release_slot(0)
    assert pp.ensure_rows(1, 12) and pp.used_pages == 3 and pp.leak_check() == 0
    assert pp.table[0].tolist() == [-1, -1, -1]


def test_unsupported_geometry_degrades_to_the_reference(caplog):
    """head_dim 4 is off the JAX decode kernel's geometry, so the JAX
    engine degrades "pallas" to its reference with a warning. The port's
    K12 serves any head_dim up to 256, so its engine keeps calling the
    kernel wrapper (on CPU tensors its plain version), warns about
    nothing, and emits the JAX engine's tokens."""
    geometry = {"num_layers": 1, "d_model": 16, "num_heads": 4, "max_seq_len": 32}
    assert not A.decode_attention_supported(4, 4)
    jm = JaxLM()
    jax_configure(jm, dict(geometry), name="lm")
    jmod = jm.build((32,), VOCAB)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, _ = jax.jit(lambda: jm.initialize(jmod, (32,), seed=1))()
    pm = TransformerLM()
    configure(pm, dict(geometry), name="lm")
    mod = pm.build((32,), VOCAB)
    mod.load_state_dict(from_flax_lm_variables(params))
    conf = {"slots": 2, "seq_buckets": (8,), "kv_capacity": 32, "page_size": 4}
    with caplog.at_level("WARNING"):
        port = _port_engine(mod, **conf, decode_attention="pallas")
    assert port.decode_attention_flavor == "kernel" and not caplog.records
    prompts, budgets = _prompts(5, 4, max_len=8), [4, 2, 5, 3]
    got = _serve(DecodeScheduler, configure, port, prompts, budgets)
    jax_engine = _jax_engine(jmod, params, **conf)
    assert jax_engine.decode_attention_flavor == "reference"
    want = _serve(JaxDecodeScheduler, jax_configure, jax_engine, prompts, budgets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_scheduler_admission_control_and_status(lm):
    """Shedding past ``shed_above``, an expired deadline, occupancy
    gauges and the status section, and ``close()`` failing what is
    left."""
    from zookeeper_tpu_torch.serving import DeadlineExpiredError, RejectedError
    from zookeeper_tpu_torch.serving.decode import DecodeMetrics

    _, _, mod = lm
    engine = _port_engine(mod, kv_layout="paged", prefix_cache=False)
    metrics = DecodeMetrics()
    sched = DecodeScheduler()
    configure(sched, {"shed_above": 2}, name="sched")
    sched.bind(engine, metrics=metrics)
    prompts = _prompts(3, 4)
    expired = sched.submit(prompts[0], deadline_ms=0)
    kept = sched.submit(prompts[1], max_new_tokens=3)
    with pytest.raises(RejectedError):
        sched.submit(prompts[2])
    assert sched.queue_depth == 2 and metrics.totals["rejected_total"] == 1
    with pytest.raises(DeadlineExpiredError):
        expired.result()
    assert kept.result().shape == (3,) and kept.finish_reason == "length"
    status = sched.status()
    assert status["kv_layout"] == "paged" and status["kv_pool"]["leaked"] == 0
    assert status["active_slots"] == 0 and status["decode_attention"] == "kernel"
    gauges = metrics.gauges
    assert gauges["active_slots"] == 0 and gauges["kv_pool_free_pages"] == engine.page_pool.num_pages
    pending = sched.submit(prompts[3])
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        pending.result()


def test_async_worker_serves_concurrent_submitters(lm):
    """The worker thread with submitters on three threads (switch
    interval shortened): every stream completes with the tokens the
    synchronous scheduler gives."""
    import threading

    _, _, mod = lm
    prompts = _prompts(4, 9)
    budgets = [3] * len(prompts)
    want = _serve(DecodeScheduler, configure, _port_engine(mod), prompts, budgets)
    sched = DecodeScheduler()
    configure(sched, {"synchronous": False}, name="sched")
    sched.bind(_port_engine(mod))
    streams = [None] * len(prompts)

    def submit(indices):
        for i in indices:
            streams[i] = sched.submit(prompts[i], max_new_tokens=budgets[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(range(k, len(prompts), 3),))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        got = [s.result(timeout=60) for s in streams]
    finally:
        sys.setswitchinterval(old)
        sched.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
