"""Models: the abstract ``Model`` component, the QuickNet family and the
TransformerLM family."""

from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import QuickNet, QuickNetLarge, QuickNetSmall
from zookeeper_tpu_torch.models.transformer import TransformerLM

__all__ = ["Model", "QuickNet", "QuickNetLarge", "QuickNetSmall", "TransformerLM"]
