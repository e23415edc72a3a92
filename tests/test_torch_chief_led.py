"""Chief-led dispatch in one process: the protocol engaged through its
seam (``parallel.distributed.forced_chief_led``) in front of engines that
span one rank, so the chief's side runs whole with no follower. The
two-rank legs are in ``tests/test_torch_sharded_serving.py``.

- the threaded and the synchronous ``MicroBatcher`` with deadlines serve
  the answers of the batcher without the protocol, and a request sent
  already expired fails with the deadline error;
- the threaded and the synchronous ``DecodeScheduler`` with deadlines
  stream the tokens of the scheduler without it, with JAX's greedy
  tokens, and a staged swap applies;
- shedding, the overload guard and disaggregated serving are refused
  under it; a crash of the chief's worker fails its requests and the
  next submit serves;
- ``ChiefLink`` over a one-rank gloo group carries short and long
  records and the agreement; with no group (world size 1) nothing
  engages the protocol.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_decode_features as F
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.resilience import FaultPlan, faults
from zookeeper_tpu_torch.serving import (
    DeadlineExpiredError,
    DisaggScheduler,
    InferenceEngine,
    MicroBatcher,
    OverloadGuard,
    PageTransfer,
    WorkerCrashedError,
)
from zookeeper_tpu_torch.serving.decode import DecodeScheduler
from zookeeper_tpu_torch.training.checkpoint import export_trees


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    eng = InferenceEngine()
    configure(eng, {"batch_buckets": (2, 4)}, name="engine")
    eng.bind(torch.nn.Linear(3, 2), (3,), device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def lm():
    return F.build_lm()


def _rows():
    return [np.random.default_rng(i).normal(size=(i % 3 + 1, 3)).astype(np.float32)
            for i in range(6)]


def _batcher(engine, led, **conf):
    b = MicroBatcher()
    configure(b, dict(conf), name="batcher")
    if led:
        with distributed.forced_chief_led():
            b.bind(engine)
    else:
        b.bind(engine)
    return b


@pytest.mark.parametrize("synchronous", [False, True])
def test_led_batcher_serves_the_unled_answers_and_expires_alike(engine, synchronous):
    want = _batcher(engine, False)
    expected = [want.submit(x) for x in _rows()]
    want.flush()
    b = _batcher(engine, True, synchronous=synchronous, default_deadline_ms=60000.0,
                 max_delay_ms=1.0)
    try:
        assert b._led.link is not None and b._led.link.is_chief
        doomed = b.submit(_rows()[0], deadline_ms=0)
        handles = [b.submit(x) for x in _rows()]
        for got, exp in zip(handles, expected):
            np.testing.assert_array_equal(got.result(timeout=30), exp.result())
        with pytest.raises(DeadlineExpiredError):
            doomed.result(timeout=30)
    finally:
        b.close()
        want.close()


def test_a_request_deadline_engages_the_synchronous_batcher_at_submit(engine):
    b = _batcher(engine, False)
    try:
        with distributed.forced_chief_led():
            h = b.submit(_rows()[1], deadline_ms=60000.0)
        assert b._led.link is not None
        assert h.result().shape == (2, 2)
    finally:
        b.close()


def _scheduler(lm, led, paged=False, **conf):
    _, _, mod = lm
    engine = F.port_engine(mod, **(F.PAGED if paged else {}))
    sched = DecodeScheduler()
    configure(sched, dict(conf), name="sched")
    if led:
        with distributed.forced_chief_led():
            sched.bind(engine)
    else:
        sched.bind(engine)
    return engine, sched


def _prompts():
    rng = np.random.default_rng(12)
    return [rng.integers(1, F.VOCAB, size=int(n)).astype(np.int32)
            for n in rng.integers(2, 15, size=5)]


@pytest.mark.parametrize("synchronous", [False, True])
def test_led_scheduler_streams_the_unled_tokens_with_expiry_and_swap(lm, synchronous):
    _, _, mod = lm
    base_engine, base = _scheduler(lm, False)
    want = [base.submit(p, max_new_tokens=4) for p in _prompts()]
    base.drain()
    base.close()
    engine, sched = _scheduler(lm, True, paged=True, synchronous=synchronous,
                               default_deadline_ms=60000.0)
    try:
        assert sched._led.link is not None
        streams = [sched.submit(p, max_new_tokens=4) for p in _prompts()[:3]]
        doomed = sched.submit(_prompts()[0], max_new_tokens=4, deadline_ms=0)
        sched.request_swap(*export_trees(mod), step=5)
        streams += [sched.submit(p, max_new_tokens=4) for p in _prompts()[3:]]
        for got, exp in zip(streams, want):
            np.testing.assert_array_equal(got.result(timeout=60), exp.result())
        for p, got in zip(_prompts(), streams):
            np.testing.assert_array_equal(got.result(), F.greedy(mod, p, 4))
        with pytest.raises(DeadlineExpiredError):
            doomed.result(timeout=60)
        sched.drain()
        assert not sched.swap_pending and engine.page_pool.leak_check() == 0
    finally:
        sched.close()


def test_shedding_the_guard_and_disaggregation_are_refused_led(engine, lm):
    with pytest.raises(ValueError, match="shed_above_rows"):
        _batcher(engine, True, synchronous=False, shed_above_rows=4)
    guard = OverloadGuard()
    configure(guard, {"enabled": True}, name="guard")
    guard.bind()
    b = MicroBatcher()
    configure(b, {"synchronous": False}, name="batcher")
    with distributed.forced_chief_led(), pytest.raises(ValueError, match="guard"):
        b.bind(engine, guard=guard)
    with pytest.raises(ValueError, match="shed_above"):
        _scheduler(lm, True, synchronous=False, shed_above=2)
    _, _, mod = lm
    pre = F.port_engine(mod, **F.PAGED, slots=2, prefill_buckets=(1, 2))
    dec = F.port_engine(mod, **F.PAGED, slots=2, prefix_cache=False)
    transfer = PageTransfer()
    configure(transfer, {}, name="transfer")
    transfer.bind(pre, dec)
    sched = DisaggScheduler()
    configure(sched, {"synchronous": False}, name="sched")
    with distributed.forced_chief_led(), pytest.raises(ValueError, match="Queue 1 item 4"):
        sched.bind(pre, dec, transfer)


def test_a_crash_of_the_chiefs_worker_fails_its_requests_and_the_next_submit_serves(engine):
    b = _batcher(engine, True, synchronous=False, default_deadline_ms=60000.0)
    try:
        with faults.injected(FaultPlan(serving_worker_crash=1)):
            doomed = b.submit(_rows()[0])
            with pytest.raises(WorkerCrashedError):
                doomed.result(timeout=30)
        assert b.submit(_rows()[1]).result(timeout=30).shape == (2, 2)
    finally:
        b.close()


def test_without_a_group_or_the_seam_nothing_engages(engine, lm):
    b = _batcher(engine, False, synchronous=False, default_deadline_ms=100.0)
    try:
        assert b._led.link is None and not distributed.chief_led(engine)
        assert b.submit(_rows()[2], deadline_ms=5000.0).result(timeout=30).shape == (3, 2)
        assert b._led.link is None
    finally:
        b.close()
    _, sched = _scheduler(lm, False, synchronous=False, default_deadline_ms=100.0)
    assert sched._led.link is None
    sched.close()


def test_chief_link_carries_records_and_the_agreement_over_gloo():
    assert distributed.ChiefLink().exchange([1, 2, 3]) == [1, 2, 3]  # no group: as is
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        link = distributed.ChiefLink()
        assert link.is_chief and link.world == 1
        for record in ([distributed.RECORD_END], list(range(31)), list(range(-50, 100))):
            assert link.exchange(record) == record
        assert link.agree(True) is True and link.agree(False) is False
        assert distributed.broadcast_from_chief(7) == 7
        assert distributed.broadcast_from_chief(None) is None
    finally:
        dist.destroy_process_group()
