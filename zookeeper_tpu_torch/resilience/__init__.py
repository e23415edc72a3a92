"""Resilience: preemption, restart and fault injection.

- :class:`PreemptionGuard` (``guard.py``): SIGTERM/SIGINT become a flag
  checked at step boundaries; the loop saves once, synchronously, and
  exits with :class:`Preempted`.
- :func:`run_with_recovery` (``supervisor.py``): budgeted restarts with
  backoff; a rerun restores from the checkpointer and replays the
  (seed, epoch)-fixed pipeline from the saved step, an exact resume.
- :class:`FaultPlan` (``faults.py``): deterministic, process-local fault
  injection (kill at a step, tear a checkpoint, fail a save, NaN a step,
  kill or fail an async write, kill a host of a group, drop a host's
  checkpoint finalize, lose the coordinator).
- :class:`FileCoordinator` (``coordination.py``): the shared-directory
  flags and exchanges the multi-host protocols ride: the group drain,
  the supervisor's restart verdicts and the per-host checkpoint's
  restore agreement.

The retrying, crash-consistent saves and the restore walk live in
``training.checkpoint.Checkpointer``; the ``nan_policy`` in
``training.step.make_train_step``.
"""

from zookeeper_tpu_torch.resilience import faults
from zookeeper_tpu_torch.resilience.coordination import (
    CoordinatorLostError,
    FileCoordinator,
    HostCoordinator,
    NullCoordinator,
)
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
    GroupPeerFailure,
    RecoveryResult,
    measure_recovery_restore_ms,
    run_with_recovery,
)

__all__ = [
    "CoordinatorLostError",
    "FaultPlan",
    "FileCoordinator",
    "GroupPeerFailure",
    "HostCoordinator",
    "InjectedFault",
    "NonFiniteLossError",
    "NullCoordinator",
    "Preempted",
    "PreemptionGuard",
    "RECOVERABLE",
    "RecoveryResult",
    "corrupt_checkpoint_dir",
    "faults",
    "measure_recovery_restore_ms",
    "run_with_recovery",
]
