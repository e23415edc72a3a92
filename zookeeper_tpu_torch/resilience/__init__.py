"""Resilience: the errors a run raises when it must stop."""

from zookeeper_tpu_torch.resilience.faults import NonFiniteLossError

__all__ = ["NonFiniteLossError"]
