"""The language-model training task, the port of
``examples/lm_experiment.py``'s ``TrainLM``::

    python -m zookeeper_tpu_torch.training TrainLM seq_len=8192 \\
        model.d_model=512 model.num_heads=8 batch_size=4 \\
        model.compute_dtype=bfloat16 loader.dataset.vocab_size=1024

A ``TransformerLM`` on the synthetic periodic token corpus.
``seq_len``, set once here, is inherited by the dataset (window length)
and the preprocessing (the model's input shape and positional table).
With ``model.attention=flash`` (the default) every layer runs K9 with lse
forward and K10/K11 backward. It trains on the card unless
``device=cpu`` is passed.

``partitioner`` defaults to ``DataParallelPartitioner`` (one card
without a launcher). Sequence parallelism, the dp x sp ring-flash
recipe, runs N ranks::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m zookeeper_tpu_torch.training TrainLM seq_len=8192 \
        partitioner=SequenceParallelPartitioner partitioner.sp=4 \
        model.d_model=512 model.num_heads=8 batch_size=4
"""

from zookeeper_tpu_torch.core import ComponentField, Field, PartialComponent, task
from zookeeper_tpu_torch.data import DataLoader, SyntheticTokens, TokenPreprocessing
from zookeeper_tpu_torch.models import Model, TransformerLM
from zookeeper_tpu_torch.parallel import DataParallelPartitioner, Partitioner
from zookeeper_tpu_torch.training.experiment import TrainingExperiment


@task
class TrainLM(TrainingExperiment):
    loader: DataLoader = ComponentField(
        DataLoader,
        dataset=SyntheticTokens,
        preprocessing=PartialComponent(TokenPreprocessing),
    )
    model: Model = ComponentField(TransformerLM)
    partitioner: Partitioner = ComponentField(DataParallelPartitioner)
    #: Inherited by loader.dataset.seq_len and loader.preprocessing.seq_len.
    seq_len: int = Field(64)
    batch_size: int = Field(32)
    epochs: int = Field(3)
