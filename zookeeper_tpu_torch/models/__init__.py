"""Models: the abstract ``Model`` component; the binary zoo (the QuickNet
family, BinaryNet, BinaryAlexNet, XNORNet, DoReFaNet; the ResNet-topology
BiRealNet, BinaryResNetE18, RealToBinaryNet and ReActNet; the dense
BinaryDenseNet28/37/37Dilated/45 and MeliusNet22); the fp
ResNet50/101/152, SimpleCnn and Mlp; and the TransformerLM family."""

from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.keras_import import (
    import_keras_weights,
    keras_transpose_kernel,
)
from zookeeper_tpu_torch.models.binary import (
    BinaryAlexNet,
    BinaryNet,
    DoReFaNet,
    QuickNet,
    QuickNetLarge,
    QuickNetSmall,
    XNORNet,
)
from zookeeper_tpu_torch.models.binary_dense import (
    BinaryDenseNet28,
    BinaryDenseNet37,
    BinaryDenseNet37Dilated,
    BinaryDenseNet45,
    MeliusNet22,
)
from zookeeper_tpu_torch.models.binary_resnet import (
    BinaryResNetE18,
    BiRealNet,
    ReActNet,
    RealToBinaryNet,
)
from zookeeper_tpu_torch.models.resnet import ResNet50, ResNet101, ResNet152
from zookeeper_tpu_torch.models.simple import Mlp, SimpleCnn
from zookeeper_tpu_torch.models.summary import ModelSummary, model_summary
from zookeeper_tpu_torch.models.transformer import (
    TransformerLM,
    TransformerLMModule,
    greedy_decode,
)

__all__ = [
    "BiRealNet", "BinaryAlexNet", "BinaryDenseNet28", "BinaryDenseNet37",
    "BinaryDenseNet37Dilated", "BinaryDenseNet45", "BinaryNet", "BinaryResNetE18",
    "DoReFaNet", "MeliusNet22", "Mlp", "Model", "ModelSummary",
    "QuickNet", "QuickNetLarge", "QuickNetSmall", "ReActNet", "RealToBinaryNet", "ResNet50",
    "ResNet101", "ResNet152", "SimpleCnn", "TransformerLM", "TransformerLMModule", "XNORNet",
    "greedy_decode", "import_keras_weights", "keras_transpose_kernel", "model_summary",
]
