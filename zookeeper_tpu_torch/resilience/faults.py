"""The port of ``zookeeper_tpu/resilience/faults.py``'s
``NonFiniteLossError``. ``FaultPlan`` (fault injection) is not ported yet
(ROADMAP.md)."""


class NonFiniteLossError(RuntimeError):
    """``nan_policy="halt"``: a non-finite training loss reached a host
    readback boundary. The in-memory state skipped the bad step(s), but
    the run refuses to continue."""

    def __init__(self, step: int, skipped: int):
        self.step = int(step)
        self.skipped = int(skipped)
        super().__init__(
            f"non-finite training loss detected by step {step} "
            f"({skipped} step(s) skipped); halting per nan_policy='halt'"
        )
