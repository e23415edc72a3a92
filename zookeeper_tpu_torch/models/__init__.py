"""Models: the abstract ``Model`` component and the QuickNet family."""

from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import QuickNet, QuickNetLarge, QuickNetSmall

__all__ = ["Model", "QuickNet", "QuickNetLarge", "QuickNetSmall"]
