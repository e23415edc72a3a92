"""Input pipeline: sources, datasets, preprocessing, batching, prefetch.

Pure numpy up to the device copy, with the same bytes as the JAX
package's pipeline for the same seed and epoch.
"""

from zookeeper_tpu_torch.data.augrng import AugRng
from zookeeper_tpu_torch.data.dataset import (
    Dataset,
    SyntheticImageClassification,
    SyntheticImageNet,
    SyntheticTokens,
)
from zookeeper_tpu_torch.data.pipeline import DataLoader, batch_iterator, prefetch_to_device
from zookeeper_tpu_torch.data.preprocessing import (
    ImageClassificationPreprocessing,
    PassThroughPreprocessing,
    Preprocessing,
    TokenPreprocessing,
)
from zookeeper_tpu_torch.data.source import ArraySource, DataSource

__all__ = [
    "ArraySource",
    "AugRng",
    "DataLoader",
    "DataSource",
    "Dataset",
    "ImageClassificationPreprocessing",
    "PassThroughPreprocessing",
    "Preprocessing",
    "SyntheticImageClassification",
    "SyntheticImageNet",
    "SyntheticTokens",
    "TokenPreprocessing",
    "batch_iterator",
    "prefetch_to_device",
]
