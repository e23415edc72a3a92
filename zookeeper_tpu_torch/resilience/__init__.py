"""Resilience: preemption, restart and fault injection.

- :class:`PreemptionGuard` (``guard.py``): SIGTERM/SIGINT become a flag
  checked at step boundaries; the loop saves once, synchronously, and
  exits with :class:`Preempted`.
- :func:`run_with_recovery` (``supervisor.py``): budgeted restarts with
  backoff; a rerun restores from the checkpointer and replays the
  (seed, epoch)-fixed pipeline from the saved step, an exact resume.
- :class:`FaultPlan` (``faults.py``): deterministic, process-local fault
  injection (kill at a step, tear a checkpoint, fail a save, NaN a step,
  kill or fail an async write).

The retrying, crash-consistent saves and the restore walk live in
``training.checkpoint.Checkpointer``; the ``nan_policy`` in
``training.step.make_train_step``.
"""

from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
    NonFiniteLossError,
    Preempted,
    corrupt_checkpoint_dir,
)
from zookeeper_tpu_torch.resilience.guard import PreemptionGuard
from zookeeper_tpu_torch.resilience.supervisor import (
    RECOVERABLE,
    RecoveryResult,
    measure_recovery_restore_ms,
    run_with_recovery,
)

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "NonFiniteLossError",
    "Preempted",
    "PreemptionGuard",
    "RECOVERABLE",
    "RecoveryResult",
    "corrupt_checkpoint_dir",
    "faults",
    "measure_recovery_restore_ms",
    "run_with_recovery",
]
