"""The port's cross-host coordination primitives against the JAX package's.

Each case of ``tests/resilience/test_coordination.py`` runs twice, once
through ``zookeeper_tpu.resilience`` and once through
``zookeeper_tpu_torch.resilience`` (N coordinators in one process, the
peers on threads), and the outcomes must be equal: the payloads each
round returns, the errors and their messages, the flags polled, and the
relative paths of every file left under the shared root. Then a JAX
coordinator and a port coordinator play the two hosts of one group over
one directory, in both seatings.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import os
import threading
from types import SimpleNamespace

import pytest

from zookeeper_tpu.resilience import CoordinatorLostError as JaxCoordinatorLostError
from zookeeper_tpu.resilience import FaultPlan as JaxFaultPlan
from zookeeper_tpu.resilience import FileCoordinator as JaxFileCoordinator
from zookeeper_tpu.resilience import NullCoordinator as JaxNullCoordinator
from zookeeper_tpu.resilience import faults as jax_faults
from zookeeper_tpu_torch.resilience import (
    CoordinatorLostError,
    FaultPlan,
    FileCoordinator,
    NullCoordinator,
    faults,
)

pytestmark = pytest.mark.chaos

JAX = SimpleNamespace(File=JaxFileCoordinator, Null=JaxNullCoordinator,
                      Lost=JaxCoordinatorLostError, Plan=JaxFaultPlan, faults=jax_faults)
PORT = SimpleNamespace(File=FileCoordinator, Null=NullCoordinator, Lost=CoordinatorLostError,
                       Plan=FaultPlan, faults=faults)


def files(root):
    """Every file under ``root``, as relative paths."""
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(out)


def pair(ns, root):
    return [ns.File(str(root), pid, 2, timeout_s=10.0) for pid in range(2)]


def on_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t


def exchange_allgathers_ordered_payloads(ns, root):
    a, b = pair(ns, root)
    out = {}

    def run(coord, payload):
        out[coord.process_index] = coord.exchange("greet", payload)

    t = on_thread(lambda: run(b, {"v": 1}))
    run(a, {"v": 0})
    t.join()
    assert out[0] == out[1] == [{"v": 0}, {"v": 1}]
    return out


def exchange_rounds_do_not_bleed(ns, root):
    a, b = pair(ns, root)
    peer = []
    t = on_thread(lambda: peer.extend([b.exchange("k", "b1"), b.exchange("k", "b2")]))
    mine = [a.exchange("k", "a1"), a.exchange("k", "a2")]
    t.join()
    assert mine == peer == [["a1", "b1"], ["a2", "b2"]]
    return mine


def exchange_timeout_raises_lost(ns, root):
    a, _ = pair(ns, root)
    with pytest.raises(ns.Lost, match="host\\(s\\) \\[1\\]") as e:
        a.exchange("alone", 1, timeout_s=0.2)
    return str(e.value)


def generation_namespaces_rounds(ns, root):
    a, b = pair(ns, root)
    t = on_thread(lambda: b.exchange("k", "old"))
    old = a.exchange("k", "old")
    t.join()
    a.generation = b.generation = 1
    with pytest.raises(ns.Lost) as e:
        a.exchange("k", "new", timeout_s=0.2)
    return old, str(e.value)


def flags_publish_poll_and_generation(ns, root):
    a, b = pair(ns, root)
    seen = [a.poll_flags("preempt")]
    b.publish_flag("preempt", {"origin": 1, "step": 4})
    seen.append(a.poll_flags("preempt"))
    b.publish_flag("preempt", {"origin": 1, "step": 6})  # a republish overwrites
    seen.append(a.poll_flags("preempt"))
    a.publish_flag("preempt", {"origin": 0, "step": 6})
    seen.append(b.poll_flags("preempt"))
    a.generation = 1  # a new generation starts without flags
    seen.append(a.poll_flags("preempt"))
    assert seen == [[], [{"origin": 1, "step": 4}], [{"origin": 1, "step": 6}],
                    [{"origin": 0, "step": 6}, {"origin": 1, "step": 6}], []]
    return seen


def injected_coordinator_loss_is_deterministic(ns, root):
    a, b = pair(ns, root)
    with ns.faults.injected(ns.Plan(coordinator_loss=1)):
        with pytest.raises(ns.Lost, match="injected") as e:
            a.exchange("k", 1)
        t = on_thread(lambda: b.exchange("k2", "b"))  # one-shot: the next completes
        got = a.exchange("k2", "a")
        t.join()
    assert got == ["a", "b"]
    return str(e.value), got


def bad_process_index_rejected(ns, root):
    with pytest.raises(ValueError, match="process_index") as e:
        ns.File(str(root), 2, 2)
    return str(e.value)


def null_coordinator_degenerates(ns, root):
    c = ns.Null()
    out = [c.process_count, c.exchange("k", {"x": 1}), c.poll_flags("preempt")]
    c.publish_flag("preempt", {"origin": 0})
    out.append(c.poll_flags("preempt"))
    assert out == [1, [{"x": 1}], [], [{"origin": 0}]]
    return out


def new_incarnation_purges_own_stale_files(ns, root):
    a, b = pair(ns, root)
    b.publish_flag("preempt", {"origin": 1, "step": 4})
    t = on_thread(lambda: b.exchange("verdict", "old-b"))
    a.exchange("verdict", "old-a")
    t.join()
    before = files(root)
    a2, b2 = pair(ns, root)  # the job died; a new incarnation starts
    purged = files(root)
    flags = a2.poll_flags("preempt")
    t = on_thread(lambda: b2.exchange("verdict", "new-b"))
    got = a2.exchange("verdict", "new-a")
    t.join()
    assert flags == [] and got == ["new-a", "new-b"] and purged == []
    return before, purged, flags, got


def exchange_and_flags_carry_none_payloads(ns, root):
    a, b = pair(ns, root)
    t = on_thread(lambda: b.exchange("k", None))
    got = a.exchange("k", None)
    t.join()
    a.publish_flag("f", None)
    assert got == [None, None] and b.poll_flags("f") == [None]
    return got, b.poll_flags("f")


SCENARIOS = [
    exchange_allgathers_ordered_payloads, exchange_rounds_do_not_bleed,
    exchange_timeout_raises_lost, generation_namespaces_rounds,
    flags_publish_poll_and_generation, injected_coordinator_loss_is_deterministic,
    bad_process_index_rejected, null_coordinator_degenerates,
    new_incarnation_purges_own_stale_files, exchange_and_flags_carry_none_payloads,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(tmp_path, scenario):
    want = scenario(JAX, tmp_path / "jax")
    got = scenario(PORT, tmp_path / "port")
    assert got == want
    assert files(tmp_path / "port") == files(tmp_path / "jax")


@pytest.mark.parametrize("seating", ["jax_host0", "port_host0"])
def test_jax_and_port_coordinators_share_a_group(tmp_path, seating):
    """Host 0 from one package and host 1 from the other complete an
    exchange (two rounds of one key), see each other's flags, and leave the
    files one package's pair leaves."""
    first, second = (JAX, PORT) if seating == "jax_host0" else (PORT, JAX)
    a = first.File(str(tmp_path / "mixed"), 0, 2, timeout_s=10.0)
    b = second.File(str(tmp_path / "mixed"), 1, 2, timeout_s=10.0)
    peer = []
    t = on_thread(lambda: peer.extend([b.exchange("verdict", {"outcome": "ok", "pid": 1}),
                                       b.exchange("verdict", None)]))
    mine = [a.exchange("verdict", {"outcome": "ok", "pid": 0}), a.exchange("verdict", None)]
    t.join()
    want = [[{"outcome": "ok", "pid": 0}, {"outcome": "ok", "pid": 1}], [None, None]]
    assert mine == peer == want
    b.publish_flag("preempt", {"origin": 1, "step": 4})
    a.publish_flag("preempt", {"origin": 0, "step": 5})
    flags = [{"origin": 0, "step": 5}, {"origin": 1, "step": 4}]
    assert a.poll_flags("preempt") == b.poll_flags("preempt") == flags
    # One package's pair walking the same rounds leaves the same files.
    c, d = pair(JAX, tmp_path / "jax")
    t = on_thread(lambda: (d.exchange("verdict", 1), d.exchange("verdict", 2)))
    c.exchange("verdict", 1), c.exchange("verdict", 2)
    t.join()
    d.publish_flag("preempt", 1), c.publish_flag("preempt", 0)
    assert files(tmp_path / "mixed") == files(tmp_path / "jax")
