"""Deterministic, process-local fault injection, and the errors a run
raises when it must stop.

The port of ``zookeeper_tpu/resilience/faults.py``'s training legs: a
test installs a :class:`FaultPlan` naming which fault fires where
(``kill_at_step=N``, ``corrupt_checkpoint_step=M``, ``fail_save_io=1``,
``nan_at_step=K``, ``fail_async_finalize=1``,
``kill_during_async_write=S``), runs the real system and checks the
recovery, e.g. that the recovered training state equals an
uninterrupted run's bit for bit. The hooks live in the production code
paths (the experiment's boundary check, the checkpointer's write path,
the async writer, ``make_train_step``); with no plan installed each is
one ``None`` check.

- Faults key on logical coordinates (the global step, the N-th save
  attempt), never on the clock: two runs of one plan fire the same
  faults at the same points.
- One-shot faults consume themselves (under a lock: the async writer
  thread reads the plan too), so the retry of a faulted operation
  succeeds and the recovery completes.
- ``nan_at_step`` is read once, when ``make_train_step`` builds the step:
  the step whose counter (the host ``state.step`` before it, or under the
  fused loop's CUDA graph ``state.step_counter`` on the card) equals it
  computes a NaN loss, which the ``nan_policy`` then handles.
- Under the fused loop (``TrainingExperiment.unroll > 1``) the boundaries
  are slab ends: a kill at a step inside a slab lands at the slab's end,
  as step-cadence checkpoints do.
- The multi-host legs key on the host's logical process index: a
  several-process run installs the same plan in every process and each
  host fires only its own faults.
- Every training leg that fires marks the trace with
  ``fault_injected{kind}`` (the ``FaultPlan`` field's name) and notifies
  the flight recorder, as the JAX package's legs do; ``nan_at_step`` is
  marked by the experiment when it dispatches the step
  (:meth:`FaultPlan.mark_nan_dispatch`), which the JAX package does not
  mark. The serving legs raise no such notice here.

The serving legs cover the worker and decode-scheduler crashes and the
disaggregated page handoff; the fleet's legs and ``delay_forward_ms``
are not ported yet (ROADMAP.md).
"""

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace


def _injection_event(kind: str, step: Optional[int] = None) -> None:
    """A training leg's fault fired: an instant ``fault_injected{kind}``
    on the trace, where the recovery it triggers starts its spans, and a
    flight-recorder notice (one global read when none is installed)."""
    _trace.event("fault_injected", step=step, attrs={"kind": kind})
    _recorder.notify("fault_injected", step=step, attrs={"kind": kind})


class Preempted(Exception):
    """Training exited at a safe boundary after a preemption request
    (SIGTERM/SIGINT or an injected kill). The state as of ``step`` has
    been checkpointed when a checkpoint directory was configured; a
    supervisor (``run_with_recovery``) resumes from it, except for a
    SIGINT exit (``signum``), which is the operator stopping the job."""

    def __init__(self, step: int, saved: bool, signum: Optional[int] = None):
        self.step = int(step)
        self.saved = bool(saved)
        #: The signal that caused the exit (None = injected/programmatic).
        self.signum = signum
        super().__init__(
            f"preempted at step {step} "
            f"({'checkpoint saved' if saved else 'no checkpoint configured'}"
            + (f", signal {signum}" if signum is not None else "")
            + ")"
        )


class NonFiniteLossError(RuntimeError):
    """``nan_policy="halt"``: a non-finite training loss reached a host
    readback boundary. The in-memory state skipped the bad step(s), but
    the run refuses to continue; a supervisor restores from the last
    checkpoint."""

    def __init__(self, step: int, skipped: int):
        self.step = int(step)
        self.skipped = int(skipped)
        super().__init__(
            f"non-finite training loss detected by step {step} "
            f"({skipped} step(s) skipped); halting per nan_policy='halt'"
        )


class InjectedFault(OSError):
    """The error of plan-driven IO faults: an ``OSError``, so the retry
    paths treat it as the disk failures it stands in for."""


@dataclass
class FaultPlan:
    """One deterministic schedule of faults; every field defaults to
    "never fire".

    - ``kill_at_step``: request preemption at the first safe boundary
      whose global step is ``>= kill_at_step`` (one-shot: the recovery
      run is not killed again).
    - ``corrupt_checkpoint_step``: after the save of this step lands,
      tear its files on disk so that restore finds it unreadable.
    - ``fail_save_io``: the next N checkpoint save attempts raise
      :class:`InjectedFault` (1 = once: the retry succeeds).
    - ``nan_at_step``: the train step whose counter equals this computes
      a NaN loss (read when the step is built).
    - ``fail_async_finalize``: the next N async writes fail at the
      finalize: the data is written under its temporary name and never
      renamed, leaving an unfinalized remnant, and the write reports
      failure to the writer's retries (1 = once).
    - ``kill_during_async_write``: the async write of this step dies
      mid-write (one-shot): a torn unfinalized remnant is left and the
      write is abandoned, with no retry and no error to training, as
      when the process is killed while the writer thread saves.

    The multi-host legs:

    - ``kill_process_at_step``: ``{process_index: step}``, request
      preemption on that host only, at the first boundary whose step is
      ``>= step`` (one-shot per plan, ``kill_at_step``'s twin). Under
      group recovery the flag becomes a drain and save of the whole group.
    - ``fail_host_finalize``: the first per-host sharded checkpoint
      finalize on this process index is dropped, as when the host dies
      between writing its shards and the rename: the temporary directory
      stays, the marker never appears, process 0 never writes the step's
      commit record, so no host's restore sees the step. One-shot, not
      retried (a dead host does not retry).
    - ``coordinator_loss``: the next N cross-host ``exchange`` rounds
      raise ``CoordinatorLostError``.

    The serving legs:

    - ``serving_worker_crash``: the next N ``MicroBatcher`` worker
      iterations crash the worker thread (its requests fail cleanly and
      the next submit restarts it).
    - ``decode_worker_crash``: the next N ``DecodeScheduler`` loop
      iterations crash mid-decode (every queued and in-flight stream
      fails cleanly, the next submit restarts the loop).
    - ``prefill_role_crash_at``: the N-th decode-slot admission of a
      parked prefill (1 = the first) finds the prefill role dead
      mid-handoff: the victim and every parked handoff fail cleanly, the
      prefill pool is reset (``leak_check() == 0``) and the decode role
      keeps serving its active streams.
    - ``fail_page_transfer``: the next N page transfers fail at the move
      itself: the victim fails cleanly, both pools unwind their half of
      the handoff and every other stream proceeds.
    """

    kill_at_step: Optional[int] = None
    corrupt_checkpoint_step: Optional[int] = None
    fail_save_io: int = 0
    nan_at_step: Optional[int] = None
    fail_async_finalize: int = 0
    kill_during_async_write: Optional[int] = None
    kill_process_at_step: Optional[Dict[int, int]] = None
    fail_host_finalize: Optional[int] = None
    coordinator_loss: int = 0
    serving_worker_crash: int = 0
    decode_worker_crash: int = 0
    prefill_role_crash_at: Optional[int] = None
    fail_page_transfer: int = 0

    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)
    _killed: bool = field(default=False, repr=False, compare=False)
    _corrupted: bool = field(default=False, repr=False, compare=False)
    _async_killed: bool = field(default=False, repr=False, compare=False)
    _host_finalize_failed: bool = field(default=False, repr=False, compare=False)
    _handoffs_seen: int = field(default=0, repr=False, compare=False)
    _prefill_role_crashed: bool = field(default=False, repr=False, compare=False)

    def kill_due(self, step: int, process_index: int = 0) -> bool:
        """One-shot: True at the first query with ``step >=
        kill_at_step`` (any host) or ``step >=
        kill_process_at_step[process_index]`` (that host only), whichever
        comes first (queried at step boundaries; with ``unroll > 1`` at
        slab ends, so the kill lands at the end of the slab holding the
        step)."""
        candidates = [self.kill_at_step]
        if self.kill_process_at_step is not None:
            candidates.append(self.kill_process_at_step.get(int(process_index)))
        candidates = [c for c in candidates if c is not None]
        if not candidates:
            return False
        with self._lock:
            if not self._killed and int(step) >= int(min(candidates)):
                self._killed = True
                _injection_event("kill_at_step", step=int(step))
                return True
        return False

    def mark_nan_dispatch(self, step: int, steps: int = 1) -> None:
        """A dispatch of ``steps`` train steps from the counter ``step``
        is about to run: when ``nan_at_step`` falls in them, mark the
        fault (the step computes its NaN on the card, where the host
        cannot see it). The JAX package reads the fault when it traces
        the step and never marks it."""
        if self.nan_at_step is not None and step <= self.nan_at_step < step + steps:
            _injection_event("nan_at_step", step=int(self.nan_at_step))

    def take_host_finalize_failure(self, process_index: int) -> bool:
        """Consume the injected per-host finalize death when it names
        ``process_index`` (False otherwise, or once fired)."""
        if self.fail_host_finalize is None:
            return False
        with self._lock:
            if (not self._host_finalize_failed
                    and int(process_index) == int(self.fail_host_finalize)):
                self._host_finalize_failed = True
                _injection_event("fail_host_finalize")
                return True
        return False

    def take_coordinator_loss(self) -> bool:
        """Consume one injected coordinator loss (False when exhausted)."""
        with self._lock:
            if self.coordinator_loss > 0:
                self.coordinator_loss -= 1
                _injection_event("coordinator_loss")
                return True
        return False

    def take_worker_crash(self) -> bool:
        """Consume one injected serving-worker crash."""
        with self._lock:
            if self.serving_worker_crash > 0:
                self.serving_worker_crash -= 1
                return True
        return False

    def take_decode_worker_crash(self) -> bool:
        """Consume one injected decode-scheduler crash."""
        with self._lock:
            if self.decode_worker_crash > 0:
                self.decode_worker_crash -= 1
                return True
        return False

    def take_prefill_role_crash(self) -> bool:
        """One-shot, keyed on handoffs: True when this decode-slot
        admission (the N-th page handoff, counting from 1) should find
        the prefill role dead mid-handoff."""
        if self.prefill_role_crash_at is None:
            return False
        with self._lock:
            self._handoffs_seen += 1
            if (not self._prefill_role_crashed
                    and self._handoffs_seen >= int(self.prefill_role_crash_at)):
                self._prefill_role_crashed = True
                return True
        return False

    def take_fail_page_transfer(self) -> bool:
        """Consume one injected page-transfer failure (False when
        exhausted)."""
        with self._lock:
            if self.fail_page_transfer > 0:
                self.fail_page_transfer -= 1
                return True
        return False

    def take_save_io_failure(self) -> bool:
        """Consume one injected save-IO failure (False when exhausted)."""
        with self._lock:
            if self.fail_save_io > 0:
                self.fail_save_io -= 1
                _injection_event("fail_save_io")
                return True
        return False

    def take_async_finalize_failure(self) -> bool:
        """Consume one injected async-finalize failure (False when
        exhausted)."""
        with self._lock:
            if self.fail_async_finalize > 0:
                self.fail_async_finalize -= 1
                _injection_event("fail_async_finalize")
                return True
        return False

    def async_kill_due(self, step: int) -> bool:
        """One-shot: True when the async write of ``step`` should die
        mid-write."""
        if self.kill_during_async_write is None:
            return False
        with self._lock:
            if not self._async_killed and int(step) == self.kill_during_async_write:
                self._async_killed = True
                _injection_event("kill_during_async_write", step=int(step))
                return True
        return False

    def corrupt_due(self, step: int) -> bool:
        """One-shot: True when ``step``'s just-landed save should be torn
        on disk."""
        if self.corrupt_checkpoint_step is None:
            return False
        with self._lock:
            if not self._corrupted and int(step) == self.corrupt_checkpoint_step:
                self._corrupted = True
                _injection_event("corrupt_checkpoint_step", step=int(step))
                return True
        return False


def corrupt_checkpoint_dir(path: str) -> int:
    """Tear a checkpoint on disk the same way every time: each regular
    file under ``path`` is truncated to half and its head overwritten
    with a fixed pattern, the shape a torn write leaves. Returns the
    number of files damaged (0: ``path`` held nothing to corrupt)."""
    damaged = 0
    pattern = b"\xde\xad\xbe\xef" * 16
    for root, _, files in os.walk(path):
        for name in files:
            fpath = os.path.join(root, name)
            try:
                size = os.path.getsize(fpath)
            except OSError:
                continue
            with open(fpath, "r+b" if size else "wb") as f:
                f.truncate(size // 2)
                f.seek(0)
                f.write(pattern[: max(1, min(len(pattern), size // 2 or 1))])
            damaged += 1
    return damaged


# -- process-local activation -------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process's active plan (replacing any other)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    """Deactivate fault injection."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    """The active plan, or None."""
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan) -> Iterator[FaultPlan]:
    """``with injected(FaultPlan(...)) as plan:``: scoped activation that
    restores the previous plan (scopes nest)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev
