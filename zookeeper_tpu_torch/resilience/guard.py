"""Preemption safety: SIGTERM/SIGINT become a clean exit at a step
boundary.

The port of ``zookeeper_tpu/resilience/guard.py``. A preemptible pool
sends SIGTERM and gives the process a grace window. The
:class:`PreemptionGuard`'s handlers only set a flag; the training loop
checks it at each step boundary, where the state is an exact resume
point, saves once, synchronously, and raises
:class:`~zookeeper_tpu_torch.resilience.faults.Preempted`, which
``run_with_recovery`` resumes from. Nothing runs inside the handler:
the save happens on the training thread at the next boundary.
``FaultPlan(kill_at_step=N)`` trips the same flag, so an injected kill
and a real SIGTERM take one code path. The fused loop
(``TrainingExperiment.unroll > 1``) checks the flag at slab ends: the
state is an exact resume point only between slabs, so a signal during a
slab takes effect, and saves, at its end. A trip marks the trace with
``preemption_requested`` (its signal and origin host), and the boundary's
drain and save are the spans ``preemption_drain`` and
``preemption_save``.
"""

import logging
import signal
import threading
from typing import Any, Optional, Sequence, Tuple

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability import trace as _trace

logger = logging.getLogger(__name__)


@component
class PreemptionGuard:
    """A boundary-checked preemption flag with scoped signal handlers.

    ``install()``/``uninstall()`` bracket a training run (the experiment
    does this); while installed, SIGTERM/SIGINT set the flag instead of
    ending the process, and uninstall puts the previous handlers back.
    Off the main thread, where CPython refuses ``signal.signal``, install
    hooks nothing and logs a warning (``installed`` stays False);
    :meth:`request_preemption` still works there.
    """

    enabled: bool = Field(True)
    #: Catch SIGINT too (Ctrl-C becomes a clean save and exit). False keeps
    #: KeyboardInterrupt's immediate abort.
    handle_sigint: bool = Field(True)

    def _state(self) -> dict:
        st = getattr(self, "_guard_state", None)
        if st is None:
            st = {"flag": threading.Event(), "prev": {}, "installed": False,
                  "signal": None, "origin": None}
            object.__setattr__(self, "_guard_state", st)
        return st

    @property
    def preempted(self) -> bool:
        return self._state()["flag"].is_set()

    @property
    def installed(self) -> bool:
        """Whether the signal handlers are in place (False when disabled
        or when ``install`` ran off the main thread)."""
        return self._state()["installed"]

    @property
    def received_signal(self) -> Optional[int]:
        """The signal that tripped the flag (None for a programmatic or
        injected preemption)."""
        return self._state()["signal"]

    @property
    def preemption_origin(self) -> Optional[int]:
        """The process index that originated a group preemption (None for
        a single process; the port runs one)."""
        return self._state()["origin"]

    def request_preemption(self, signum: Optional[int] = None,
                           origin: Optional[int] = None) -> None:
        """Trip the flag (fault injection, tests, a watcher thread)."""
        st = self._state()
        st["signal"] = signum
        if origin is not None:
            st["origin"] = int(origin)
        st["flag"].set()
        _trace.event("preemption_requested", attrs={"signal": signum, "origin": origin})

    def _signals(self) -> Sequence[int]:
        sigs = [signal.SIGTERM]
        if self.handle_sigint:
            sigs.append(signal.SIGINT)
        return sigs

    def install(self) -> "PreemptionGuard":
        """Install the handlers (idempotent); clears a stale flag so that
        a resumed run does not exit at once."""
        st = self._state()
        st["flag"].clear()
        st["signal"] = None
        st["origin"] = None
        if not self.enabled or st["installed"]:
            return self

        def handler(signum, frame):
            self.request_preemption(signum)  # the flag only

        try:
            for sig in self._signals():
                st["prev"][sig] = signal.signal(sig, handler)
            st["installed"] = True
        except ValueError:
            # Not the main thread (the first call already refused): train on.
            st["prev"].clear()
            logger.warning(
                "PreemptionGuard could not install its signal handlers (not "
                "the main thread): SIGTERM/SIGINT keep their default effect; "
                "request_preemption() still works"
            )
        return self

    def preemption_save(self, checkpointer: Any, state: Any,
                        global_step: int) -> Tuple[bool, float]:
        """The preemption boundary's save, for both checkpoint modes:

        1. Drain the async writer: a queued or in-flight write lands
           first. Under ``queue_policy="supersede"`` the queued, not yet
           started snapshot is dropped instead (the save below writes a
           newer state); the in-flight write always completes.
        2. One synchronous save of this state, skipped when a cadence save
           already landed on this step, or under best-ranking retention
           (a save without metrics cannot be ranked; the latest ranked
           save is the resume point). It is on disk when ``save``
           returns, before the grace window closes.

        Returns ``(saved, save_wait_ms)``, the wait being step 1's."""
        saved, wait_ms = False, 0.0
        if checkpointer.enabled:
            supersede = (checkpointer.queue_policy == "supersede"
                         and checkpointer.keep_best_metric is None)
            with _trace.span("preemption_drain", step=global_step):
                wait_ms = checkpointer.wait(supersede=supersede)
            if checkpointer.keep_best_metric is not None:
                saved = checkpointer.latest_step() is not None
            elif checkpointer.latest_step() == global_step:
                saved = True  # a cadence save landed on this step
            else:
                with _trace.span("preemption_save", step=global_step):
                    saved = bool(checkpointer.save(state, sync=True))
        return saved, wait_ms

    def uninstall(self) -> "PreemptionGuard":
        """Put the handlers from before ``install`` back (idempotent)."""
        st = self._state()
        if st["installed"]:
            for sig, prev in st["prev"].items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, TypeError):
                    pass
            st["prev"].clear()
            st["installed"] = False
        return self
