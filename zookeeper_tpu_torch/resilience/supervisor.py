"""The restart supervisor: keep training alive across recoverable exits.

The port of ``zookeeper_tpu/resilience/supervisor.py``.
``run_with_recovery(experiment)`` runs ``experiment.run()``, and when it
exits with a recoverable status, :class:`Preempted` (SIGTERM or an
injected kill, the state already saved) or :class:`NonFiniteLossError`
(``nan_policy="halt"``), runs it again; the experiment's
``Checkpointer.restore_state`` picks up at the newest restorable step (an
exact mid-epoch resume). Restarts are budgeted (``max_restarts``) with
exponential backoff, and each resumed run's restore latency (restart to
its first train step) is measured. Unrecoverable exceptions (config
errors, structure mismatches, bugs) propagate at once.

Group mode: with a ``coordinator`` over more than one process, every
host of the job runs this function with its own coordinator over one
shared root. The coordinator is wired into the experiment's boundary
check, so any host's preemption drains and saves every host at one
agreed step; after every exit the hosts exchange a restart verdict and
restart together, or raise :class:`GroupPeerFailure` when a peer exited
unrecoverably or the coordinator was lost.

Observability: a restart of one process marks the trace with
``supervisor_restart`` (attempt, cause, backoff) and asks the installed
flight recorder for a bundle of the state the run died in; a group
restart marks ``group_restart`` (with the host that started the drain,
``origin``), counts ``zk_group_restarts_total`` and bundles with
``origin`` in the manifest; a group's resumed run publishes
``zk_group_restore_ms``; a run that completes after restarts marks
``supervisor_recovered``.
"""

import logging
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.resilience.coordination import (
    CoordinatorLostError,
    HostCoordinator,
    NullCoordinator,
)
from zookeeper_tpu_torch.resilience.faults import NonFiniteLossError, Preempted

logger = logging.getLogger(__name__)


class GroupPeerFailure(RuntimeError):
    """A peer host of the process group exited unrecoverably, or the
    coordinator was lost during the restart verdict: the group cannot
    restart as a whole, so this host's supervisor stops too instead of
    re-forming a partial group that would wedge in its first collective."""


#: Exits a restart can fix: the state to resume from is on disk and the
#: cause is transient (preemption) or halted by policy (a non-finite loss
#: whose bad step the restore discards). A ``Preempted`` carrying SIGINT is
#: the operator stopping the job and is not restarted.
RECOVERABLE = (Preempted, NonFiniteLossError)


@dataclass
class RecoveryResult:
    """What the supervisor saw across the supervised run."""

    #: The final ``experiment.run()`` return value.
    history: Any
    #: Restarts performed (0 = the first run completed).
    restarts: int
    #: The recoverable exceptions that caused each restart, in order.
    causes: List[BaseException] = field(default_factory=list)
    #: Per resumed run that reached its first train step: ms from the
    #: restart to that step.
    restore_ms: List[float] = field(default_factory=list)
    #: Per preempted run: ms its preemption path waited on async writes
    #: before the final synchronous save (0.0 in sync mode).
    save_wait_ms: List[float] = field(default_factory=list)


def run_with_recovery(
    experiment: Any,
    *,
    max_restarts: int = 3,
    backoff_s: float = 1.0,
    backoff_factor: float = 2.0,
    max_backoff_s: float = 60.0,
    recover_on: Tuple[Type[BaseException], ...] = RECOVERABLE,
    sleep: Callable[[float], None] = time.sleep,
    coordinator: Optional[HostCoordinator] = None,
    group_timeout_s: float = 120.0,
) -> RecoveryResult:
    """Run ``experiment.run()`` under a restart budget: at most
    ``max_restarts`` reruns, ``backoff_s * backoff_factor**i`` (capped at
    ``max_backoff_s``) apart (``sleep`` is injectable for tests). When the
    budget is spent the last recoverable exception propagates. The same
    experiment object is rerun, so its checkpoint directory carries over.

    With a ``coordinator`` over ``process_count > 1`` hosts (module
    docstring), each attempt's rounds are namespaced by
    ``coordinator.generation = attempt``, and after each exit the hosts
    exchange verdicts (deadline ``group_timeout_s``): any "stop" stops
    every host (this host's own exception, else
    :class:`GroupPeerFailure`); any "recoverable" restarts every host on
    the same backoff; all "ok" returns."""
    if max_restarts < 0:
        raise ValueError(f"max_restarts={max_restarts} must be >= 0.")
    if backoff_s < 0 or backoff_factor < 1.0:
        raise ValueError(
            f"backoff_s={backoff_s} must be >= 0 and "
            f"backoff_factor={backoff_factor} >= 1."
        )
    group = coordinator is not None and getattr(coordinator, "process_count", 1) > 1
    # One process exchanges with itself: the verdict is its own outcome.
    coord = coordinator if group else NullCoordinator()
    if group:
        experiment.group_coordinator = coordinator
    causes: List[BaseException] = []
    restore_ms: List[float] = []
    save_wait_ms: List[float] = []
    try:
        for attempt in range(max_restarts + 1):
            t_start = time.perf_counter()
            # Attempt N's flags and rounds never satisfy attempt N+1's.
            coord.generation = attempt
            history, cause, outcome = None, None, "ok"
            try:
                history = experiment.run()
            except recover_on as e:
                cause = e
                _record_save_wait_ms(experiment, e, save_wait_ms)
                if isinstance(e, Preempted) and e.signum == _signal.SIGINT:
                    # The operator's stop: the "stop" verdict stops the
                    # peers too.
                    logger.warning("SIGINT preemption (operator stop) — not restarting: %s",
                                   e)
                    outcome = "stop"
                else:
                    outcome = "recoverable"
            except BaseException as e:
                # A hard failure still publishes its verdict: the peers
                # wait in the exchange.
                cause = e
                outcome = "stop"
            n_restore = len(restore_ms)
            _record_restore_ms(experiment, attempt, t_start, restore_ms)
            if group and len(restore_ms) > n_restore:
                default_registry().gauge(
                    "zk_group_restore_ms",
                    help="latest group restart -> first post-resume train step, ms",
                ).set(restore_ms[-1])
            origin = getattr(getattr(experiment, "guard", None), "preemption_origin", None)
            try:
                verdicts = coord.exchange(
                    "supervisor_verdict",
                    {"outcome": outcome, "cause": type(cause).__name__ if cause else None,
                     "origin": origin},
                    timeout_s=group_timeout_s,
                )
            except CoordinatorLostError as ce:
                logger.error("group restart verdict lost (%s); not re-forming a partial "
                             "process group", ce)
                raise GroupPeerFailure(str(ce)) from (cause if cause is not None else ce)
            outcomes = [v.get("outcome") for v in verdicts]
            if "stop" in outcomes:
                if cause is not None:
                    raise cause
                raise GroupPeerFailure(
                    f"peer host(s) exited unrecoverably (verdicts: {outcomes}); this "
                    "host's run succeeded but the group cannot re-form"
                )
            if "recoverable" not in outcomes:
                if attempt > 0:
                    _trace.event("supervisor_recovered", attrs={"restarts": attempt})
                return RecoveryResult(history=history, restarts=attempt, causes=causes,
                                      restore_ms=restore_ms, save_wait_ms=save_wait_ms)
            if cause is not None:
                causes.append(cause)
            if attempt >= max_restarts:
                logger.warning("restart budget exhausted (%d restart(s)); last "
                               "recoverable exit propagates", max_restarts)
                if cause is not None:
                    raise cause
                raise GroupPeerFailure(
                    "group restart budget exhausted while peers still want to restart")
            delay = min(max_backoff_s, backoff_s * (backoff_factor**attempt))
            origin_pid = next((v.get("origin") for v in verdicts
                               if v.get("origin") is not None), None)
            cause_name = next((v.get("cause") for v in verdicts if v.get("cause")), None)
            logger.warning(
                "recoverable exit (origin host %s, cause %s); restart %d/%d after "
                "%.1fs backoff", origin_pid, cause_name, attempt + 1, max_restarts, delay,
            )
            if group:
                _trace.event("group_restart", attrs={"attempt": attempt + 1, "cause": cause_name,
                                                     "origin": origin_pid, "backoff_s": delay})
                default_registry().counter(
                    "zk_group_restarts_total",
                    help="coordinated whole-process-group restarts",
                ).inc()
                # The manifest names the host that started the drain.
                _recorder.notify("group_restart", step=getattr(cause, "step", None),
                                 attrs={"attempt": attempt + 1, "cause": cause_name,
                                        "origin": origin_pid,
                                        "process_index": coordinator.process_index})
            else:
                _trace.event("supervisor_restart", attrs={
                    "attempt": attempt + 1, "cause": type(cause).__name__, "backoff_s": delay})
                # A bundle of the state the run died in, before the rerun
                # overwrites it.
                _recorder.notify("supervisor_restart", step=getattr(cause, "step", None),
                                 attrs={"attempt": attempt + 1,
                                        "cause": type(cause).__name__})
            if delay > 0:
                sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
    finally:
        if group:
            experiment.group_coordinator = None


def _record_save_wait_ms(experiment: Any, cause: BaseException,
                         save_wait_ms: List[float]) -> None:
    """A preempted run's async drain time, from the experiment's
    ``save_wait_ms``."""
    if not isinstance(cause, Preempted):
        return
    wait = getattr(experiment, "save_wait_ms", None)
    if wait is not None:
        save_wait_ms.append(float(wait))


def _record_restore_ms(experiment: Any, attempt: int, t_start: float,
                       restore_ms: List[float]) -> None:
    """A resumed run's restart-to-first-step latency, from the
    experiment's ``first_step_at`` (attempt 0 is no restart)."""
    if attempt == 0:
        return
    t_first = getattr(experiment, "first_step_at", None)
    if t_first is not None and t_first >= t_start:
        restore_ms.append((t_first - t_start) * 1e3)


def measure_recovery_restore_ms(
    make_experiment: Callable[[], Any],
    *,
    kill_at_step: int = 2,
    max_restarts: int = 1,
) -> Dict[str, float]:
    """The recovery path's latency: run ``make_experiment()`` (a fresh
    experiment with a checkpoint directory) under an injected kill at
    ``kill_at_step``, resume it, and return ``{"recovery_restore_ms",
    "recovery_restarts", "recovery_save_wait_ms"}``."""
    exp = make_experiment()
    with faults.injected(faults.FaultPlan(kill_at_step=kill_at_step)):
        result = run_with_recovery(exp, max_restarts=max_restarts, backoff_s=0.0,
                                   sleep=lambda s: None)
    if result.restarts < 1 or not result.restore_ms:
        raise RuntimeError(
            "recovery measurement never restarted (kill_at_step beyond "
            "the run, or no checkpoint directory configured)"
        )
    return {
        "recovery_restore_ms": round(result.restore_ms[-1], 2),
        "recovery_restarts": float(result.restarts),
        "recovery_save_wait_ms": round(
            result.save_wait_ms[-1] if result.save_wait_ms else 0.0, 2),
    }
