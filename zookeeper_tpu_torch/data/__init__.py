"""Input pipeline: sources, datasets, preprocessing, batching, prefetch.

Pure numpy up to the device copy, with the same bytes as the JAX
package's pipeline for the same seed and epoch; on-disk stores in the
JAX package's format (``data.store``).
"""

from zookeeper_tpu_torch.data.augrng import AugRng
from zookeeper_tpu_torch.data.dataset import (
    ArrayDataset,
    Dataset,
    GrainDataset,
    MemmapDataset,
    SklearnDigits,
    SyntheticCifar10,
    SyntheticImageClassification,
    SyntheticImageNet,
    SyntheticMnist,
    SyntheticTokens,
)
from zookeeper_tpu_torch.data.pipeline import (
    DataLoader,
    batch_iterator,
    prefetch_to_device,
    slab_iterator,
)
from zookeeper_tpu_torch.data.preprocessing import (
    ImageClassificationPreprocessing,
    PassThroughPreprocessing,
    Preprocessing,
    TokenPreprocessing,
)
from zookeeper_tpu_torch.data.source import (
    ArraySource,
    ConcatSource,
    DataSource,
    MappedSource,
    SliceSource,
)
from zookeeper_tpu_torch.data.store import (
    MemmapSource,
    MemmapWriter,
    WrappedSource,
    wrap_source,
    write_store,
)

__all__ = [
    "ArrayDataset",
    "ArraySource",
    "AugRng",
    "ConcatSource",
    "DataLoader",
    "DataSource",
    "Dataset",
    "GrainDataset",
    "ImageClassificationPreprocessing",
    "MappedSource",
    "MemmapDataset",
    "MemmapSource",
    "MemmapWriter",
    "PassThroughPreprocessing",
    "Preprocessing",
    "SklearnDigits",
    "SliceSource",
    "SyntheticCifar10",
    "SyntheticImageClassification",
    "SyntheticImageNet",
    "SyntheticMnist",
    "SyntheticTokens",
    "TokenPreprocessing",
    "WrappedSource",
    "batch_iterator",
    "prefetch_to_device",
    "slab_iterator",
    "wrap_source",
    "write_store",
]
