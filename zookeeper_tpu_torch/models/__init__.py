"""Models: the abstract ``Model`` component, the binary zoo (the QuickNet
family, BinaryNet, BinaryAlexNet) and the TransformerLM family."""

from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.binary import (
    BinaryAlexNet,
    BinaryNet,
    QuickNet,
    QuickNetLarge,
    QuickNetSmall,
)
from zookeeper_tpu_torch.models.transformer import TransformerLM

__all__ = [
    "BinaryAlexNet", "BinaryNet", "Model", "QuickNet", "QuickNetLarge", "QuickNetSmall",
    "TransformerLM",
]
