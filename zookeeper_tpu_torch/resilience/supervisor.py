"""The restart supervisor: keep training alive across recoverable exits.

The port of ``zookeeper_tpu/resilience/supervisor.py``'s single-process
path. ``run_with_recovery(experiment)`` runs ``experiment.run()``, and
when it exits with a recoverable status, :class:`Preempted` (SIGTERM or
an injected kill, the state already saved) or
:class:`NonFiniteLossError` (``nan_policy="halt"``), runs it again; the
experiment's ``Checkpointer.restore_state`` picks up at the newest
restorable step (an exact mid-epoch resume). Restarts are budgeted
(``max_restarts``) with exponential backoff, and each resumed run's
restore latency (restart to its first train step) is measured.
Unrecoverable exceptions (config errors, structure mismatches, bugs)
propagate at once. The group mode (``coordinator=`` over several
processes) is not ported yet (ROADMAP.md).
"""

import logging
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple, Type

from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.resilience.faults import NonFiniteLossError, Preempted

logger = logging.getLogger(__name__)

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
    coordinator: Any = None,
) -> RecoveryResult:
    """Run ``experiment.run()`` under a restart budget: at most
    ``max_restarts`` reruns, ``backoff_s * backoff_factor**i`` (capped at
    ``max_backoff_s``) apart (``sleep`` is injectable for tests). When the
    budget is spent the last recoverable exception propagates. The same
    experiment object is rerun, so its checkpoint directory carries over.
    ``coordinator`` is the JAX package's group recovery across processes:
    one over more than one process raises ``NotImplementedError``."""
    if max_restarts < 0:
        raise ValueError(f"max_restarts={max_restarts} must be >= 0.")
    if backoff_s < 0 or backoff_factor < 1.0:
        raise ValueError(
            f"backoff_s={backoff_s} must be >= 0 and "
            f"backoff_factor={backoff_factor} >= 1."
        )
    if coordinator is not None and getattr(coordinator, "process_count", 1) > 1:
        raise NotImplementedError(
            "run_with_recovery(coordinator=...) over several processes (group "
            "recovery) is not in the PyTorch port yet; it is queued in "
            "ROADMAP.md (Queue 1 item 3)."
        )
    causes: List[BaseException] = []
    restore_ms: List[float] = []
    save_wait_ms: List[float] = []
    for attempt in range(max_restarts + 1):
        t_start = time.perf_counter()
        try:
            history = experiment.run()
        except recover_on as e:
            _record_save_wait_ms(experiment, e, save_wait_ms)
            if isinstance(e, Preempted) and e.signum == _signal.SIGINT:
                logger.warning("SIGINT preemption (operator stop) — not restarting: %s", e)
                raise
            causes.append(e)
            _record_restore_ms(experiment, attempt, t_start, restore_ms)
            if attempt >= max_restarts:
                logger.warning(
                    "restart budget exhausted (%d restart(s)); last "
                    "recoverable exit propagates: %s", max_restarts, e,
                )
                raise
            delay = min(max_backoff_s, backoff_s * (backoff_factor**attempt))
            logger.warning(
                "recoverable exit (%s); restart %d/%d after %.1fs backoff",
                e, attempt + 1, max_restarts, delay,
            )
            if delay > 0:
                sleep(delay)
            continue
        _record_restore_ms(experiment, attempt, t_start, restore_ms)
        return RecoveryResult(history=history, restarts=attempt, causes=causes,
                              restore_ms=restore_ms, save_wait_ms=save_wait_ms)
    raise AssertionError("unreachable")  # pragma: no cover


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
