"""The port's disaggregated prefill/decode serving against the JAX package.

Every case of JAX's ``tests/serving/test_disagg.py`` that needs no
observability runs through both packages on the same LM, the same role
geometry and the same stream (``tests/torch_decode_features.py``), with
both roles overlapping on the one CPU device as JAX's tier-1 runs them:

- tokens equal JAX's disaggregated tokens, the single engine's and the
  port's full-recompute greedy oracle, fp and int8 rows;
- both roles' pool state (tables, counts, refcounts, free lists, the
  prefix cache) equal JAX's after the stream, and ``leak_check() == 0``;
- the transfer counters (handoffs, pages, real bytes) and the status
  sections equal JAX's; the host bounce moves the same tokens and counts
  every handoff;
- speculation with a fresh draft and with the teacher as its draft, on
  the decode role: plain greedy's tokens;
- a queued deadline, ``close`` with handoffs parked, a staged weight swap
  across both roles, the bad-geometry and mismatched-pair binds, the
  partitioner's validation, and both fault legs (``fail_page_transfer``,
  ``prefill_role_crash_at``): the same victims, errors, survivors'
  tokens and leak-free pools as JAX;
- K9 runs on the prefill role only: the decode role's prefill dispatches
  stay at its warm-up's.

The engines of each package are built once per module and reset between
cases (``_reset_cache``), so both packages see the same history.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import copy

import numpy as np
import pytest
import torch

import torch_decode_features as F
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu.serving import DisaggPartitioner as JaxPartitioner
from zookeeper_tpu.serving import DisaggScheduler as JaxDisaggScheduler
from zookeeper_tpu.serving import PageTransfer as JaxPageTransfer
from zookeeper_tpu.serving import PageTransferError as JaxPageTransferError
from zookeeper_tpu.serving import WorkerCrashedError as JaxWorkerCrashedError
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.serving import (
    DisaggPartitioner,
    DisaggScheduler,
    DisaggServingConfig,
    PageTransfer,
    PageTransferError,
    WorkerCrashedError,
)
from zookeeper_tpu_torch.serving.decode import DecodeMetrics
from zookeeper_tpu_torch.training.checkpoint import export_trees

PREFILL = {**F.PAGED, "slots": 2, "prefill_buckets": (1, 2)}
DECODE = {**F.PAGED, "slots": 2, "prefix_cache": False}


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    # More than the lanes and the slots: freed lanes and slots refill
    # mid-stream and transferred pages land in recycled pages.
    return [rng.integers(1, F.VOCAB, size=int(rng.integers(1, 16))).astype(np.int32)
            for _ in range(7)]


def _roles(lm, **conf):
    jmod, params, mod = lm
    mod = copy.deepcopy(mod)  # swapped in place by the swap case; the fixture's stays
    return {"port": (F.port_engine(mod, **PREFILL, **conf), F.port_engine(mod, **DECODE, **conf)),
            "jax": (F.jax_engine(jmod, params, **PREFILL, **conf),
                    F.jax_engine(jmod, params, **DECODE, **conf))}


@pytest.fixture(scope="module")
def roles(lm):
    return _roles(lm)


@pytest.fixture(scope="module")
def roles_int8(lm):
    return _roles(lm, kv_quant="int8")


def stack(side, engines, *, host_bounce=False, spec=None, **sched_conf):
    """A disaggregated scheduler of one package over its (reset) role
    engines: ``(scheduler, transfer, metrics)``."""
    port = side == "port"
    pre, dec = engines[side]
    for engine in (pre, dec):
        engine._reset_cache()
    conf = configure if port else jax_configure
    metrics = (DecodeMetrics if port else F.JaxMetrics)()
    conf(metrics, {}, name="metrics")
    transfer = (PageTransfer if port else JaxPageTransfer)()
    conf(transfer, {"host_bounce": host_bounce}, name="transfer")
    transfer.bind(pre, dec, metrics=metrics)
    sched = (DisaggScheduler if port else JaxDisaggScheduler)()
    conf(sched, dict(sched_conf), name="sched")
    sched.bind(pre, dec, transfer, metrics=metrics, speculative=spec)
    return sched, transfer, metrics


def serve(sched, prompts, budgets):
    streams = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.drain()
    return streams


def leak_free(engines):
    return all(e.page_pool.leak_check() == 0 for e in engines)


def _outcome(streams):
    """Each stream's tokens so far and its error type's name (None: ok)."""
    return [(s.tokens_so_far.tolist(), None if s.error is None else type(s.error).__name__)
            for s in streams]


_ERRORS = {"PageTransferError": (PageTransferError, JaxPageTransferError),
           "WorkerCrashedError": (WorkerCrashedError, JaxWorkerCrashedError)}


def _same_outcomes(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [e for _, e in got] == [e for _, e in want]


# -- tokens, pools, counters ----------------------------------------------------


@pytest.mark.parametrize("rows", ["fp", "int8"])
def test_disagg_tokens_pools_and_counters_match_jax(lm, prompts, roles, roles_int8, rows):
    """The disaggregated stream equals JAX's token for token, the single
    engine's and the greedy oracle (fp; int8 rows move verbatim, so the
    int8 stream equals the single int8 engine's); both roles' pools and
    the transfer counters and status equal JAX's."""
    engines = roles if rows == "fp" else roles_int8
    budgets = [8] * len(prompts)
    got, want = {}, {}
    for side, out in (("port", got), ("jax", want)):
        sched, transfer, metrics = stack(side, engines)
        out["tokens"] = [s.result().tolist() for s in serve(sched, prompts, budgets)]
        out["pools"] = [F.pool_state(e.page_pool) for e in engines[side]]
        out["transfer"] = transfer.status()
        out["totals"] = {k: metrics.totals[k] for k in (
            "transfer_handoffs_total", "transfer_pages_total", "transfer_bytes",
            "tokens_total", "requests_total", "prefills_total", "decode_steps_total")}
        st = sched.status()
        out["status"] = (st["role_topology"], st["prefill"]["lanes"],
                         st["prefill"]["busy_lanes"], st["prefill"]["parked_handoffs"],
                         st["prefill"]["kv_pool"], st["transfer"], st["kv_pool"])
        assert leak_free(engines[side])
    assert got["tokens"] == want["tokens"]
    assert got["pools"] == want["pools"]
    assert got["totals"] == want["totals"]
    ts = got["transfer"]
    for key in ("handoffs_total", "pages_total", "bytes_total", "host_bounces",
                "host_bounce_forced", "transfer_width"):
        assert ts[key] == want["transfer"][key], key
    assert ts["transfer_ms_p50"] > 0 and ts["handoffs_total"] == len(prompts)
    g, w = got["status"], want["status"]
    assert g[:5] == w[:5] and g[6] == w[6]
    assert {k: v for k, v in g[5].items() if k != "transfer_ms_p50"} == \
        {k: v for k, v in w[5].items() if k != "transfer_ms_p50"}
    jmod, params, mod = lm
    single = F.port_engine(mod, **F.PAGED, slots=2, **({"kv_quant": "int8"} if rows == "int8"
                                                        else {}))
    base, _, _ = F.serve(True, single, prompts, budgets)
    assert [b.tolist() for b in base] == got["tokens"]
    if rows == "fp":
        for p, t in zip(prompts, got["tokens"]):
            np.testing.assert_array_equal(t, F.greedy(mod, p, 8))


def test_host_bounce_moves_the_same_tokens_and_counts_every_handoff(lm, prompts, roles):
    """``host_bounce=True``: the direct path's tokens (JAX's), every
    handoff counted as a bounce in both packages."""
    got, want = {}, {}
    for side, out in (("port", got), ("jax", want)):
        sched, transfer, _ = stack(side, roles, host_bounce=True)
        out["tokens"] = [s.result().tolist() for s in serve(sched, prompts[:4], [6] * 4)]
        out["status"] = transfer.status()
        assert leak_free(roles[side])
    assert got["tokens"] == want["tokens"]
    for status in (got["status"], want["status"]):
        assert status["host_bounce_forced"] is True
        assert status["host_bounces"] == status["handoffs_total"] == 4
    sched, transfer, _ = stack("port", roles)
    direct = [s.result().tolist() for s in serve(sched, prompts[:4], [6] * 4)]
    assert direct == got["tokens"] and transfer.status()["host_bounces"] == 0


@pytest.mark.parametrize("draft", ["fresh", "teacher"])
def test_speculative_decode_role_keeps_greedy_tokens(lm, prompts, roles, draft):
    """The draft lives with the decode role and prefills at the decode
    admission: a fresh 1-layer draft (windows mostly rejected) and the
    teacher as its own draft (every window accepted) both give JAX's
    plain disaggregated tokens."""
    jmod, params, mod = lm
    draft_mod = F.build_lm({**F.GEOMETRY, "num_layers": 1}, seed=17)[2] if draft == "fresh" \
        else mod
    spec = F.port_spec(roles["port"][1], draft_mod, k=3)
    sched, _, metrics = stack("port", roles, spec=spec)
    got = [s.result().tolist() for s in serve(sched, prompts, [8] * len(prompts))]
    jsched, _, _ = stack("jax", roles)
    want = [s.result().tolist() for s in serve(jsched, prompts, [8] * len(prompts))]
    assert got == want
    assert leak_free(roles["port"])
    assert metrics.totals["spec_draft_tokens_total"] > 0
    if draft == "teacher":
        assert spec.acceptance_rate == 1.0


def test_launches_stay_on_their_roles_after_warmup(lm, prompts):
    """Each role warms what it runs (``DisaggServingConfig``'s warm-ups),
    then serving dispatches prefills (K9) on the prefill role only,
    decode steps (K13) on the decode role only, and one export and one
    import a handoff."""
    _, _, mod = lm
    engines = {"port": (F.port_engine(mod, **PREFILL), F.port_engine(mod, **DECODE))}
    pre_engine, dec_engine = engines["port"]
    pre_engine.warmup(decode=False)
    dec_engine.warmup(prefill=False)
    for engine in engines["port"]:
        engine.warmup_transfer()
    before = [dict(e.dispatches) for e in engines["port"]]
    assert "decode" not in before[0] and "prefill" not in before[1]
    sched, transfer, _ = stack("port", engines)
    serve(sched, prompts, [8] * len(prompts))
    pre, dec = (dict(e.dispatches) for e in engines["port"])
    assert "prefill" not in dec and "decode" not in pre
    assert pre["prefill"] > before[0]["prefill"] and dec["decode"] > before[1]["decode"]
    assert pre["export_pages"] - before[0]["export_pages"] == transfer.handoffs == len(prompts)
    assert dec["import_pages"] - before[1]["import_pages"] == len(prompts)


# -- deadlines, close, swap -------------------------------------------------------


def test_queued_deadline_and_close_match_jax(roles):
    """``deadline_ms=0`` fails its stream before any prefill while live
    traffic serves; ``close()`` with handoffs parked fails the pending
    streams cleanly. Both pools stay leak-free, as in JAX."""
    p = np.array([1, 2, 3], np.int32)
    got, want = {}, {}
    for side, out in (("port", got), ("jax", want)):
        sched, _, metrics = stack(side, roles)
        doomed = sched.submit(p, max_new_tokens=4, deadline_ms=0)
        alive = sched.submit(p, max_new_tokens=4)
        sched.drain()
        out["deadline"] = (_outcome([doomed, alive]),
                           metrics.totals["deadline_expired_total"])
        assert leak_free(roles[side])
        engines = {side: roles[side]}
        sched, _, _ = stack(side, engines)
        streams = [sched.submit(p, max_new_tokens=32) for _ in range(3)]
        sched._step_once()
        out["parked"] = sched.parked
        sched.close()
        out["close"] = [(s.done, s.error is not None, s.tokens_so_far.tolist())
                        for s in streams]
        assert leak_free(roles[side])
    assert got == want
    assert got["deadline"][1] == 1 and got["deadline"][0][0] == ([], "DeadlineExpiredError")


def test_staged_swap_applies_on_both_roles_at_the_drained_boundary(lm, roles):
    """``request_swap`` mid-stream: in-flight streams finish on the old
    weights, the queued one after the swap runs wholly on the new ones
    (prefill role swapped and its prefix cache dropped, then the decode
    role), as in JAX."""
    params_b, mod_b = F.negated(lm)
    port_b = export_trees(mod_b)
    rng = np.random.default_rng(9)
    p1 = rng.integers(1, F.VOCAB, size=6).astype(np.int32)
    p2 = rng.integers(1, F.VOCAB, size=9).astype(np.int32)
    got, want = {}, {}
    for side, out in (("port", got), ("jax", want)):
        sched, _, metrics = stack(side, roles)
        s1 = sched.submit(p1, max_new_tokens=8)
        s2 = sched.submit(p2, max_new_tokens=5)
        sched._pump()
        sched._pump()
        if side == "port":
            sched.request_swap(*port_b, step=7)
        else:
            sched.request_swap(params_b, None, step=7)
        sched._pump()
        assert sched.swap_pending
        post = sched.submit(p1, max_new_tokens=5)
        sched.drain()
        assert not sched.swap_pending
        out["tokens"] = [s.result().tolist() for s in (s1, s2, post)]
        out["swaps"] = metrics.totals["weight_swaps_total"]
        assert leak_free(roles[side])
    assert got == want and got["swaps"] == 1
    assert got["tokens"][0] == F.greedy(lm[2], p1, 8).tolist()
    assert got["tokens"][2] == F.greedy(mod_b, p1, 5).tolist()
    # Back to the module's weights for the cases after this one.
    for side, params in (("port", export_trees(lm[2])), ("jax", (lm[1], None))):
        for engine in roles[side]:
            engine.swap_weights(*params)


def test_swap_staged_with_a_handoff_parked_applies_after_it(lm, roles):
    """One decode slot, two prompts: after the first iteration one stream
    decodes and one waits parked. A swap staged then lets the parked
    stream land and finish on the old weights, and applies after it (the
    JAX scheduler stops landing handoffs while a swap is pending, so its
    drain never returns here); a stream submitted after runs on the new."""
    _, _, mod = lm
    params_b, mod_b = F.negated(lm)
    engines = {"port": (F.port_engine(copy.deepcopy(mod), **PREFILL),
                        F.port_engine(copy.deepcopy(mod), **{**DECODE, "slots": 1}))}
    sched, _, metrics = stack("port", engines)
    a, b = (np.array(p, np.int32) for p in ([1, 2, 3], [4, 5, 6, 7]))
    s1, s2 = sched.submit(a, max_new_tokens=4), sched.submit(b, max_new_tokens=4)
    sched._pump()
    assert sched.parked == 1
    sched.request_swap(*export_trees(mod_b))
    post = sched.submit(a, max_new_tokens=4)
    sched.drain()
    assert not sched.swap_pending and metrics.totals["weight_swaps_total"] == 1
    assert s1.result().tolist() == F.greedy(mod, a, 4).tolist()
    assert s2.result().tolist() == F.greedy(mod, b, 4).tolist()
    assert post.result().tolist() == F.greedy(mod_b, a, 4).tolist()
    assert leak_free(engines["port"])


# -- construction validation --------------------------------------------------


def _raises_alike(port_call, jax_call, exc, match):
    with pytest.raises(exc, match=match):
        port_call()
    with pytest.raises(exc, match=match):
        jax_call()


def test_transfer_and_scheduler_bind_reject_bad_geometry(lm, roles):
    """A slot-layout role, a page-size mismatch, an unbound mover, a
    transfer bound to another pair and a narrower transfer width raise
    as JAX's do."""
    jmod, params, mod = lm
    eng = {"port": lambda **c: F.port_engine(mod, **c),
           "jax": lambda **c: F.jax_engine(jmod, params, **c)}
    made = {side: {"paged": make(**F.PAGED), "ring": make(),
                   "ps": make(**F.PAGED, page_size=8),
                   "narrow": make(**F.PAGED, seq_buckets=(8, 48))}
            for side, make in eng.items()}
    movers = {"port": (PageTransfer, configure), "jax": (JaxPageTransfer, jax_configure)}

    def mover(side):
        cls, conf = movers[side]
        t = cls()
        conf(t, {}, name="t")
        return t

    for src, dst, match in (("ring", "paged", "paged"), ("paged", "ps", "page_size"),
                            ("narrow", "paged", "transfer_width")):
        _raises_alike(lambda: mover("port").bind(made["port"][src], made["port"][dst]),
                      lambda: mover("jax").bind(made["jax"][src], made["jax"][dst]),
                      ValueError, match)
    _raises_alike(lambda: mover("port").move([0], [0]), lambda: mover("jax").move([0], [0]),
                  RuntimeError, "not bound")
    pairs = {}
    for side, cls in (("port", DisaggScheduler), ("jax", JaxDisaggScheduler)):
        t = mover(side).bind(made[side]["paged"], roles[side][1])
        sched = cls()
        (configure if side == "port" else jax_configure)(sched, {}, name="s")
        pairs[side] = (sched, t)
    _raises_alike(lambda: pairs["port"][0].bind(roles["port"][0], roles["port"][1],
                                                pairs["port"][1]),
                  lambda: pairs["jax"][0].bind(roles["jax"][0], roles["jax"][1],
                                               pairs["jax"][1]),
                  ValueError, "different engine pair")
    with pytest.raises(RuntimeError, match="paged-layout"):
        made["port"]["ring"].export_pages([0])
    with pytest.raises(ValueError, match=r"1\.\.4 pages per block"):
        roles["port"][0].export_pages(list(range(5)))


def test_partitioner_validates_and_overlaps_on_one_device():
    """0 devices must be >= 1, too many exceed the host, and with one
    device both roles overlap on it, flagged, as JAX's; a role of two
    devices names ROADMAP in the port."""
    import jax

    n_jax = len(jax.devices())
    for port_conf, jax_conf, match in (
            ({"prefill_devices": 0}, {"prefill_devices": 0}, "must be"),
            ({"prefill_devices": 2}, {"prefill_devices": n_jax + 1}, "exceed")):
        port, jax_p = DisaggPartitioner(), JaxPartitioner()
        configure(port, {**port_conf, "device": "cpu"}, name="p")
        jax_configure(jax_p, jax_conf, name="p")
        _raises_alike(port.setup, jax_p.setup, ValueError, match)
    port, jax_p = DisaggPartitioner(), JaxPartitioner()
    configure(port, {"device": "cpu"}, name="p")
    jax_configure(jax_p, {}, name="p")
    desc, jdesc = port.describe(), jax_p.describe()
    # One device (the port's CPU): overlapping roles, flagged.
    assert desc["disjoint"] is False and not port.disjoint
    assert desc["prefill_devices"] == desc["decode_devices"] == ["cpu"]
    assert jdesc["disjoint"] is (n_jax > 1) and jax_p.mesh is jax_p.decode.mesh
    assert port.mesh is port.decode.mesh is None
    assert port.prefill_device == port.decode_device == torch.device("cpu")
    wide = DisaggPartitioner()
    configure(wide, {"device": "cpu"}, name="p")
    object.__setattr__(wide, "_devices", lambda: [torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="ROADMAP"):
        wide.setup()


# -- fault legs -----------------------------------------------------------------


def test_injected_transfer_failure_is_victim_only_and_leak_free(lm, prompts, roles):
    """``fail_page_transfer=1``: the first handoff's stream fails with
    ``PageTransferError`` (its first token readable), every other stream
    serves JAX's tokens, both pools end leak-free, 4 handoffs counted, and
    the service serves again after."""
    got, want = {}, {}
    for side, out, plan_cls, fx in (("port", got, FaultPlan, faults),
                                    ("jax", want, JaxFaultPlan, jax_faults)):
        sched, _, metrics = stack(side, roles)
        with fx.injected(plan_cls(fail_page_transfer=1)):
            streams = serve(sched, prompts[:5], [8] * 5)
        out["outcome"] = _outcome(streams)
        out["handoffs"] = metrics.totals["transfer_handoffs_total"]
        assert leak_free(roles[side])
        again = sched.submit(prompts[0], max_new_tokens=4)
        sched.drain()
        out["again"] = again.result().tolist()
        assert leak_free(roles[side])
    _same_outcomes(got["outcome"], want["outcome"])
    assert [e for _, e in got["outcome"]].count("PageTransferError") == 1
    assert [len(t) for t, e in got["outcome"] if e] == [1]
    assert got["handoffs"] == want["handoffs"] == 4 and got["again"] == want["again"]


def test_prefill_role_crash_mid_handoff_decode_side_survives(lm, roles):
    """``prefill_role_crash_at=2``: the second handoff finds the prefill
    role dead; the crossed stream finishes with its tokens, every stream on
    the prefill side fails with ``WorkerCrashedError`` (first tokens
    readable), one restart is counted, both pools end leak-free and the
    recovered role serves, the same as JAX."""
    prompts = [np.array([1, 2, 3, 4, 5], np.int32), np.array([6, 7, 8], np.int32),
               np.array([9, 10, 11, 12], np.int32), np.array([13, 14], np.int32)]
    got, want = {}, {}
    for side, out, plan_cls, fx in (("port", got, FaultPlan, faults),
                                    ("jax", want, JaxFaultPlan, jax_faults)):
        sched, _, metrics = stack(side, roles)
        with fx.injected(plan_cls(prefill_role_crash_at=2)):
            streams = serve(sched, prompts, [8] * 4)
        out["outcome"] = _outcome(streams)
        for s in streams:
            if s.error is not None:
                with pytest.raises(_ERRORS["WorkerCrashedError"], match="prefill role"):
                    s.result()
        out["restarts"] = metrics.totals["worker_restarts_total"]
        assert leak_free(roles[side])
        again = sched.submit(prompts[0], max_new_tokens=4)
        sched.drain()
        out["again"] = again.result().tolist()
        assert leak_free(roles[side])
    _same_outcomes(got["outcome"], want["outcome"])
    errors = [e for _, e in got["outcome"]]
    assert "WorkerCrashedError" in errors and None in errors
    assert all(len(t) >= 1 for t, _ in got["outcome"])
    assert got["restarts"] == want["restarts"] == 1 and got["again"] == want["again"]


# -- the service ------------------------------------------------------------------


def test_disagg_serving_config_run_reports_the_transfer(lm):
    """``DisaggServingConfig.run()`` at a tiny size on the CPU: the
    single engine's tokens for the same seeded stream, overlapping roles
    reported, one handoff for each request that outlived its first
    token, and a chunked role degraded to monolithic prefill."""
    conf = {"model.num_layers": 2, "model.d_model": 32, "model.num_heads": 4, "seq_len": 64,
            "vocab_size": 61, "requests": 6, "max_prompt": 12, "new_tokens": 5,
            "device": "cpu", "verbose": False, "engine.slots": 3,
            "engine.seq_buckets": (8, 16), "prefill_engine.seq_buckets": (8, 16),
            "engine.page_size": 4, "prefill_engine.page_size": 4,
            "prefill_engine.prefill_chunk_tokens": 4}
    cfg = DisaggServingConfig()
    configure(cfg, dict(conf), name="disagg")
    result = cfg.run()
    from zookeeper_tpu_torch.serving.decode import LMServingConfig

    single = LMServingConfig()
    configure(single, {k: v for k, v in conf.items() if not k.startswith("prefill_engine")},
              name="lm")
    single.run()
    assert [o.tolist() for o in cfg.outputs] == [o.tolist() for o in single.outputs]
    assert result["role"] == "disagg" and result["disjoint_roles"] is False
    assert result["transfer_handoffs"] == 6 == result["transfer_handoffs_total"]
    assert result["transfer_host_bounces"] == 0 and result["prefill_lanes"] == 4
    assert cfg.scheduler.prefill_engine.dispatches.get("prefill_chunk", 0) == 0


# -- the service's observability --------------------------------------------------


def _statusz(port):
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=10) as r:
        return json.loads(r.read().decode())


def _series(registries, render):
    """The exposition's sample names with their labels, values dropped."""
    return sorted(ln.rsplit(" ", 1)[0] for ln in render(registries).splitlines()
                  if ln and not ln.startswith("#"))


def test_service_statusz_sections_and_request_log_equal_jax():
    """Both packages' ``DisaggServingConfig`` with ``metrics_port=0``,
    three prompts served: ``/statusz`` has the same sections (``prefill``,
    ``transfer`` and ``topology`` beside the decode role's), the same
    keys in each and the same values where time and device names play no
    part; the RequestLog is ``"disagg"`` in both, with the same outcomes;
    the service's series carry the same names and labels."""
    from zookeeper_tpu.observability.export import render_prometheus as jax_render
    from zookeeper_tpu.serving import DisaggServingConfig as JaxConfig
    from zookeeper_tpu_torch.observability.export import render_prometheus

    conf = {"model.num_layers": 1, "model.d_model": 32, "model.num_heads": 4,
            "seq_len": 64, "vocab_size": 61, "engine.slots": 2, "engine.seq_buckets": (8,),
            "engine.page_size": 4, "prefill_engine.slots": 2,
            "prefill_engine.seq_buckets": (8,), "prefill_engine.page_size": 4,
            "prefill_engine.prefill_buckets": (1, 2), "requests": 0, "max_prompt": 6,
            "new_tokens": 3, "warmup": False, "verbose": False, "metrics_port": 0}
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 7, 5)]
    seen = {}
    for side, cls, conf_fn, extra in (
            ("port", DisaggServingConfig, configure, {"device": "cpu"}),
            ("jax", JaxConfig, jax_configure, {"model.attention": "dense"})):
        cfg = cls()
        conf_fn(cfg, {**conf, **extra}, name=f"disagg_{side}")
        _, sched = cfg.build_service()
        try:
            streams = [sched.submit(p, max_new_tokens=3) for p in prompts]
            sched.drain()
            assert all(s.result().shape == (3,) for s in streams)
            render = render_prometheus if side == "port" else jax_render
            seen[side] = (_statusz(cfg.obs_server.port), sched.request_log,
                          _series([cfg.metrics.registry, cfg.guard.registry], render))
        finally:
            cfg._teardown_service(suppress=True)
    (got, log, series), (want, jax_log, jax_series) = seen["port"], seen["jax"]
    assert set(got) == set(want) >= {"decode", "requests", "guardrails", "prefill",
                                     "transfer", "topology", "programs"}
    for section in ("prefill", "transfer", "topology"):
        assert set(got[section]) == set(want[section]), section
    for key in ("lanes", "parked_handoffs", "kv_pool", "recompiles_detected"):
        assert got["prefill"][key] == want["prefill"][key], key
    assert got["prefill"]["decode_attention"] in ("kernel", "reference")
    for key in ("handoffs_total", "pages_total", "bytes_total", "host_bounces",
                "transfer_width"):
        assert got["transfer"][key] == want["transfer"][key], key
    assert got["topology"]["disjoint"] is False  # one CPU device: the roles overlap
    assert log.name == jax_log.name == "disagg"
    for name in ("service", "recorded_total", "by_outcome"):
        assert got["requests"][name] == want["requests"][name], name
    assert [r["outcome"] for r in log.tail()] == [r["outcome"] for r in jax_log.tail()]
    assert series == jax_series
