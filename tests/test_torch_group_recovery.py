"""The port's coordinated group recovery against the JAX package's.

Each case of ``tests/resilience/test_group_recovery.py`` runs through
both packages: the experiment (an Adam ``Mlp`` on ``SyntheticMnist``, 4
steps an epoch, 2 epochs) plays host 0 of a 2-host group over a
``FileCoordinator`` under ``run_with_recovery(coordinator=...)``, while a
stub thread plays host 1 (publishing a drain flag, joining the verdict
exchanges). The outcomes must be equal: the restarts, each cause's type,
step and ``saved``, the verdict lists the stub received, which exception
propagates, and the relative paths of the coordinator's files and of the
checkpoint directory's steps. The port's run starts from JAX's built
state; its final parameters are held to JAX's final state at the
tolerances of ``tests/test_torch_resume_vs_jax.py`` (the same run: its
``ADAM_RUN``) and equal the port's uninterrupted run bit for bit. The
trace events, gauges, counter and flight-recorder bundle that JAX's cases
also read are compared in ``test_torch_obs_recovery.py``.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import threading

import pytest

import test_torch_resume_vs_jax as resume
from test_torch_sharded_checkpoint import layout
import zookeeper_tpu_torch.data  # noqa: F401  (registers the datasets)
import zookeeper_tpu_torch.models  # noqa: F401  (registers the models)
from zookeeper_tpu import resilience as jax_resilience
from zookeeper_tpu import training as jax_training
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu_torch import resilience as port_resilience
from zookeeper_tpu_torch import training as port_training
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.convert import flax_train_state, load_flax_train_state

pytestmark = pytest.mark.chaos

#: JAX's case configuration, at ``test_torch_resume_vs_jax.py``'s seed and
#: learning rate (the run whose every decision clears the bounds' margins).
RUN = {k: v for k, v in resume.ADAM_RUN.items() if k != "steps_per_epoch"}


def ckpt_conf(root):
    return {"checkpointer.directory": str(root), "checkpointer.save_every_epochs": 0,
            "checkpointer.save_every_steps": 0}


class Side:
    """One package: its experiment (the port's from JAX's start state),
    resilience API and final parameters."""

    def __init__(self, name, start=None):
        self.name, self.start = name, start
        self.res = jax_resilience if name == "jax" else port_resilience

    def experiment(self, extra=None):
        conf = {**RUN, **(extra or {})}
        if self.name == "jax":
            exp = jax_training.TrainingExperiment()
            jax_configure(exp, {**conf, **resume.JAX_ONLY}, name="group_exp")
            return exp
        exp = port_training.TrainingExperiment()
        port_configure(exp, {**conf, "device": "cpu"}, name="group_exp")
        start, build = self.start, exp.build_state
        object.__setattr__(exp, "build_state",
                           lambda device: load_flax_train_state(build(device), **start))
        return exp

    def flat_final(self, exp):
        """The finished state in JAX's flat layout (``resume._flat``)."""
        if self.name == "jax":
            return resume._flat(resume._jax_numpy_state(exp.final_state))
        return resume._flat(flax_train_state(exp.final_state))

    def recover(self, exp, coord, **kw):
        return self.res.run_with_recovery(exp, coordinator=coord, max_restarts=2,
                                          backoff_s=0.0, sleep=lambda s: None, **kw)


class PeerStub:
    """Host 1, on a thread: optionally starts a drain, then sends
    "recoverable" for ``restarts`` verdict rounds and "ok" after."""

    def __init__(self, side, root, restarts=1, originate_at_step=None, hard_fail=False):
        self.coord = side.res.FileCoordinator(str(root), 1, 2, timeout_s=60.0)
        self.restarts, self.originate_at_step = restarts, originate_at_step
        self.hard_fail = hard_fail
        self.verdicts, self.error = [], None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def join(self):
        self._thread.join(timeout=120)
        assert not self._thread.is_alive()
        if self.error is not None:
            raise self.error

    def _run(self):
        try:
            if self.hard_fail:
                self.coord.publish_flag("preempt", {"origin": 1, "step": 0, "signal": None})
                self.verdicts.append(self.coord.exchange(
                    "supervisor_verdict", {"outcome": "stop", "cause": "RuntimeError",
                                           "origin": 1}))
                return
            for attempt in range(self.restarts + 1):
                self.coord.generation = attempt
                if attempt == 0 and self.originate_at_step is not None:
                    self.coord.publish_flag("preempt", {
                        "origin": 1, "step": int(self.originate_at_step), "signal": None})
                outcome = "recoverable" if attempt < self.restarts else "ok"
                self.verdicts.append(self.coord.exchange(
                    "supervisor_verdict", {"outcome": outcome, "cause": None, "origin": None}))
        except BaseException as e:  # surfaced by join()
            self.error = e


def causes(result):
    return [(type(c).__name__, c.step, c.saved) for c in result.causes]


@pytest.fixture(scope="module")
def start():
    exp = jax_training.TrainingExperiment()
    jax_configure(exp, {**RUN, **resume.JAX_ONLY}, name="group_exp")
    return resume._jax_numpy_state(exp.build_state())


@pytest.fixture(scope="module")
def oracles(start):
    """Each package's uninterrupted run: ``{name: flat final state}``."""
    out = {}
    for side in (Side("jax"), Side("port", start)):
        exp = side.experiment()
        exp.run()
        out[side.name] = side.flat_final(exp)
    return out


def peer_originated_drain(side, tmp):
    exp = side.experiment(ckpt_conf(tmp / "ckpt"))
    coord = side.res.FileCoordinator(str(tmp / "coord"), 0, 2, timeout_s=60.0)
    stub = PeerStub(side, tmp / "coord", restarts=1, originate_at_step=0).start()
    result = side.recover(exp, coord)
    stub.join()
    assert result.restarts == 1 and causes(result) == [("Preempted", 4, True)]
    assert exp.group_coordinator is None
    return {"restarts": result.restarts, "causes": causes(result),
            "verdicts": stub.verdicts}, side.flat_final(exp)


def test_peer_originated_drain_and_bit_identical_resume(tmp_path, start, oracles):
    """A peer's stop flag drains this host at flag step 0 + the margin 4
    (one synchronous save, ``Preempted``), the supervisors restart in step,
    and the resumed run ends on the uninterrupted run's bits."""
    want, jax_final = peer_originated_drain(Side("jax"), tmp_path / "jax")
    got, port_final = peer_originated_drain(Side("port", start), tmp_path / "port")
    assert got == want
    # Host 0's verdict names the host that started the drain.
    assert got["verdicts"][0][0] == {"outcome": "recoverable", "cause": "Preempted", "origin": 1}
    for root in ("coord", "ckpt"):
        assert layout(tmp_path / "port" / root) == layout(tmp_path / "jax" / root)
    assert set(port_final) == set(oracles["port"])
    bad = [k for k in port_final if not (port_final[k] == oracles["port"][k]).all()]
    assert bad == []
    for k in jax_final:  # JAX's own claim, its run against its oracle
        assert (jax_final[k] == oracles["jax"][k]).all(), k
    assert resume._misses(port_final, jax_final, "adam") == []
    # The bounds fail the start state's parameters.
    begun = resume._flat(start)
    assert resume._misses(resume._replaced(port_final, "params/", lambda k, v: begun[k]),
                          jax_final, "adam")


def local_kill(side, tmp):
    exp = side.experiment(ckpt_conf(tmp / "ckpt"))
    coord = side.res.FileCoordinator(str(tmp / "coord"), 0, 2, timeout_s=60.0)
    stub = PeerStub(side, tmp / "coord", restarts=1).start()
    with side.res.faults.injected(side.res.FaultPlan(kill_process_at_step={0: 2})):
        result = side.recover(exp, coord)
    stub.join()
    assert result.restarts == 1 and causes(result)[0][:2] == ("Preempted", 6)
    assert result.restore_ms and result.restore_ms[-1] > 0
    return {"restarts": result.restarts, "causes": causes(result), "verdicts": stub.verdicts,
            "restore_ms_samples": len(result.restore_ms)}


def test_local_kill_publishes_flag_with_origin(tmp_path, start):
    """``kill_process_at_step`` keyed to this host: its flag at boundary 2
    carries origin 0, the group exits at 2 + 4, the verdict names origin 0
    and cause ``Preempted``, and the resumed run's restore latency is
    measured."""
    want = local_kill(Side("jax"), tmp_path / "jax")
    got = local_kill(Side("port", start), tmp_path / "port")
    assert got == want
    assert got["verdicts"][0][0] == {"outcome": "recoverable", "cause": "Preempted", "origin": 0}
    for root in ("coord", "ckpt"):
        assert layout(tmp_path / "port" / root) == layout(tmp_path / "jax" / root)


@pytest.mark.parametrize("name", ["jax", "port"])
def test_kill_process_at_step_other_host_does_not_fire_locally(name, start):
    """A plan naming host 1 does not preempt host 0 (nothing relays it)."""
    side = Side(name, start)
    exp = side.experiment()
    with side.res.faults.injected(side.res.FaultPlan(kill_process_at_step={1: 1})):
        history = exp.run()
    assert len(history["train"]) == 2


def hard_failure(side, tmp):
    exp = side.experiment(ckpt_conf(tmp / "ckpt"))
    coord = side.res.FileCoordinator(str(tmp / "coord"), 0, 2, timeout_s=60.0)
    stub = PeerStub(side, tmp / "coord", hard_fail=True).start()
    with pytest.raises(side.res.Preempted) as e:
        side.recover(exp, coord)
    stub.join()
    return {"raised": (type(e.value).__name__, e.value.step, e.value.saved),
            "verdicts": stub.verdicts}


def test_peer_hard_failure_stops_group(tmp_path, start):
    """A peer's "stop" verdict stops this host too: its own Preempted
    propagates instead of a restart."""
    want = hard_failure(Side("jax"), tmp_path / "jax")
    got = hard_failure(Side("port", start), tmp_path / "port")
    assert got == want
    assert [v["outcome"] for v in got["verdicts"][0]] == ["recoverable", "stop"]
    assert layout(tmp_path / "port" / "coord") == layout(tmp_path / "jax" / "coord")


def verdict_loss(side, tmp):
    exp = side.experiment(ckpt_conf(tmp / "ckpt"))
    coord = side.res.FileCoordinator(str(tmp / "coord"), 0, 2, timeout_s=60.0)
    # The peer only starts the drain; the loss fires in this host's
    # verdict exchange (the drain polls flags without exchanging).
    peer = side.res.FileCoordinator(str(tmp / "coord"), 1, 2)
    peer.publish_flag("preempt", {"origin": 1, "step": 0, "signal": None})
    with side.res.faults.injected(side.res.FaultPlan(coordinator_loss=1)):
        with pytest.raises(side.res.GroupPeerFailure) as e:
            side.recover(exp, coord, group_timeout_s=5.0)
    return {"raised": type(e.value).__name__, "from": type(e.value.__cause__).__name__,
            "message": str(e.value)}


def test_verdict_coordinator_loss_raises_group_peer_failure(tmp_path, start):
    want = verdict_loss(Side("jax"), tmp_path / "jax")
    got = verdict_loss(Side("port", start), tmp_path / "port")
    assert got == want
    assert got["raised"] == "GroupPeerFailure" and got["from"] == "Preempted"
    assert layout(tmp_path / "port" / "coord") == layout(tmp_path / "jax" / "coord")


def test_single_process_coordinator_is_inert(start, oracles):
    """A coordinator of one process leaves the supervised run the plain
    run, bit for bit."""
    side = Side("port", start)
    exp = side.experiment()
    result = port_resilience.run_with_recovery(exp, coordinator=port_resilience.NullCoordinator())
    assert result.restarts == 0
    final = side.flat_final(exp)
    assert all((final[k] == oracles["port"][k]).all() for k in final)
    jax_side = Side("jax")
    jax_exp = jax_side.experiment()
    assert jax_resilience.run_with_recovery(
        jax_exp, coordinator=jax_resilience.NullCoordinator()).restarts == 0
    jax_final = jax_side.flat_final(jax_exp)
    assert all((jax_final[k] == oracles["jax"][k]).all() for k in jax_final)
