"""The async checkpoint writer: the background half of ``Checkpointer``'s
``mode="async"``.

The port of ``zookeeper_tpu/training/async_checkpoint.py``. A sync save
stalls the training thread for the whole serialize and write; the async
mode splits it:

1. **Snapshot** (training thread): ``training.step.host_snapshot``
   enqueues the device-to-host copies of the state on the step's stream
   and records an event. The port's train step updates the state in
   place, so the snapshot must own its bytes before the next step runs:
   stream order puts the next step's writes behind the copies, and the
   training thread goes on without waiting for them. Under the fused
   loop the snapshot is taken at a slab's end, on the stream its CUDA
   graph replays on, so the next slab's replay queues behind it too.
2. **Write** (this module's thread): it waits on the snapshot's event,
   then serializes and writes it with the sync path's protocol
   (temporary name, fsync, atomic rename), so a write that dies with the
   process is an unfinalized remnant that restore never lists.

Queue (one slot behind the write in flight), ``Checkpointer.queue_policy``:

- ``"wait"``: a new snapshot while one already waits blocks the training
  thread until the slot frees.
- ``"supersede"``: the waiting snapshot is replaced by the newer one; the
  write in flight always completes.

A write that fails retries on this thread with the checkpointer's
backoff and is then logged and dropped: the training thread never sees
checkpoint IO errors. ``FaultPlan.kill_during_async_write`` models the
process dying mid-write (a torn remnant, the write abandoned).

Observability: the gauge ``zk_ckpt_queue_depth`` (the snapshot queued
plus the write in flight), the events ``ckpt_queued``,
``ckpt_superseded``, ``ckpt_killed``, ``ckpt_finalized`` and
``ckpt_dropped``, and a ``ckpt_write`` span around each write, all
keyed by the step.
"""

import logging
import threading
import time
from typing import Any, Dict, Optional

from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)


class AsyncCheckpointWriter:
    """One background writer thread with a one-slot queue for one
    ``Checkpointer``. A snapshot is ``queued``, then ``writing``, then
    ``finalized`` (or ``dropped`` after the retries, ``superseded``
    before its write began, or ``killed`` by an injected mid-write
    death)."""

    def __init__(self, checkpointer: Any, queue_policy: str = "wait"):
        if queue_policy not in ("wait", "supersede"):
            raise ValueError(
                f"queue_policy={queue_policy!r} unknown; choose wait/supersede."
            )
        self._ckpt = checkpointer
        self._policy = queue_policy
        self._cv = threading.Condition()
        #: The one pending slot: (step, host tree, metrics, ready event).
        self._pending: Optional[tuple] = None
        self._writing_step: Optional[int] = None
        self._stopping = False
        self.stats: Dict[str, float] = {
            "submitted": 0, "finalized": 0, "dropped": 0, "superseded": 0,
            "killed": 0, "last_write_ms": 0.0,
        }
        # Process-wide (one writer a process in practice): is the writer
        # keeping up with the save cadence.
        self._queue_gauge = default_registry().gauge(
            "zk_ckpt_queue_depth",
            help="async checkpoint snapshots queued + being written",
        )
        self._thread = threading.Thread(target=self._loop, name="zk-async-ckpt", daemon=True)
        self._thread.start()

    def _update_queue_gauge(self) -> None:
        """The caller holds ``_cv``."""
        self._queue_gauge.set((self._pending is not None) + (self._writing_step is not None))

    # -- training-thread API ---------------------------------------------

    def submit(self, step: int, host_tree: Any, metrics: Optional[dict] = None,
               ready: Any = None) -> bool:
        """Queue one host snapshot (``ready``: the event its copies
        complete at, or None). True when accepted, which is not yet a
        durability promise: ``drain`` or ``Checkpointer.wait`` see it
        land."""
        with self._cv:
            if self._stopping:
                return False
            self.stats["submitted"] += 1
            if self._pending is not None:
                if self._policy == "supersede":
                    self.stats["superseded"] += 1
                    _trace.event("ckpt_superseded", step=self._pending[0])
                    logger.info(
                        "async checkpoint of step %d superseded by step %d "
                        "before its write began", self._pending[0], step,
                    )
                else:
                    while self._pending is not None and not self._stopping:
                        if not self._thread.is_alive():
                            return False  # a dead writer never hangs training
                        self._cv.wait(0.005)
                    if self._stopping:
                        return False
            self._pending = (int(step), host_tree, metrics, ready)
            self._update_queue_gauge()
            _trace.event("ckpt_queued", step=step)
            self._cv.notify_all()
        return True

    @property
    def in_flight(self) -> bool:
        """Whether a snapshot is queued or being written."""
        return self._pending is not None or self._writing_step is not None

    def drain(self, supersede: bool = False) -> float:
        """Block until the writer is idle; returns the ms spent waiting
        (the preemption path's ``save_wait_ms``). ``supersede=True`` drops
        the queued, not yet started snapshot first; the write in flight
        always completes."""
        t0 = time.perf_counter()
        with self._cv:
            if supersede and self._pending is not None:
                self.stats["superseded"] += 1
                _trace.event("ckpt_superseded", step=self._pending[0])
                self._pending = None
                self._update_queue_gauge()
                self._cv.notify_all()
            while self._pending is not None or self._writing_step is not None:
                if not self._thread.is_alive():
                    break
                self._cv.wait(0.005)
        return (time.perf_counter() - t0) * 1e3

    def stop(self) -> None:
        """Write what is queued, then stop the thread (idempotent)."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=60)

    # -- writer thread ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stopping:
                    self._cv.wait(0.05)
                if self._pending is None:
                    break  # stopping with nothing queued
                step, host_tree, metrics, ready = self._pending
                self._pending = None
                self._writing_step = step
                self._update_queue_gauge()
                self._cv.notify_all()
            t0 = time.perf_counter()
            try:
                if ready is not None:
                    ready.synchronize()  # the snapshot's copies have landed
                plan = faults.active()
                if plan is not None and plan.async_kill_due(step):
                    # The process "dies" mid-write: a torn remnant stays,
                    # nothing retries; restore walks back past it.
                    self._ckpt._leave_unfinalized_remnant(step)
                    self.stats["killed"] += 1
                    _trace.event("ckpt_killed", step=step)
                    logger.warning(
                        "async write of step %d killed mid-write (injected): "
                        "unfinalized remnant left on disk; restore walks back "
                        "to the previous finalized step", step,
                    )
                else:
                    with _trace.span("ckpt_write", step=step):
                        finalized = self._ckpt._run_with_save_retries(
                            step,
                            lambda: self._ckpt._attempt_async_write(step, host_tree, metrics))
                    if finalized:
                        self.stats["finalized"] += 1
                        self.stats["last_write_ms"] = (time.perf_counter() - t0) * 1e3
                        _trace.event("ckpt_finalized", step=step)
                    else:
                        self.stats["dropped"] += 1
                        _trace.event("ckpt_dropped", step=step)
            except BaseException as e:
                # Nothing the writer hits reaches the training thread.
                self.stats["dropped"] += 1
                _trace.event("ckpt_dropped", step=step)
                logger.error(
                    "async checkpoint write of step %d failed outside the "
                    "retry loop; dropping this save", step, exc_info=e,
                )
            finally:
                del host_tree
                with self._cv:
                    self._writing_step = None
                    self._update_queue_gauge()
                    self._cv.notify_all()
