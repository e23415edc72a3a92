"""Serving real data: the digits classifier behind the micro-batcher,
the port of ``examples/serve_classifier.py``'s ``ServeDigits``::

    python -m zookeeper_tpu_torch.training TrainDigits export_model_to=/tmp/digits
    python -m zookeeper_tpu_torch.serving ServeDigits checkpoint=/tmp/digits

The validation split of ``SklearnDigits`` (scikit-learn is needed) is cut
into variable-size requests (1 to the rows left of a batch) and served
through the ``MicroBatcher`` and the bucketed engine; the accuracy of the
answers is reported beside the serving metrics, so it doubles as a
check of the batching (served answers must score what an eval of the
same export scores).
"""

import time

import numpy as np

from zookeeper_tpu_torch.core import ComponentField, Field, pretty_print, task
from zookeeper_tpu_torch.data import DataLoader, SklearnDigits
from zookeeper_tpu_torch.models import Model, SimpleCnn
from zookeeper_tpu_torch.serving.service import ServingConfig
from zookeeper_tpu_torch.training.digits import DigitsPreprocessing


@task
class ServeDigits(ServingConfig):
    """Serve the digits validation split through the engine."""

    loader: DataLoader = ComponentField(
        DataLoader,
        dataset=SklearnDigits,
        preprocessing=DigitsPreprocessing,
        drop_remainder=False,
    )
    model: Model = ComponentField(SimpleCnn)
    #: Feeds the loader by scoped inheritance; also the largest request
    #: (the batcher splits what exceeds the engine's buckets).
    batch_size: int = Field(64)
    height: int = Field(8)
    width: int = Field(8)
    channels: int = Field(1)
    num_classes: int = Field(10)

    def run(self):
        if self.verbose:
            print(pretty_print(self), flush=True)
        engine, batcher = self.build_service()
        try:
            warm_compiles = engine.warmed_buckets
            rng = np.random.default_rng(self.seed)
            handles = []
            n_requests = 0
            t0 = time.perf_counter()
            for batch in self.loader.host_batches("validation", training=False):
                x = np.asarray(batch["input"])
                y = np.asarray(batch["target"])
                # Variable-size requests of 1..rows-left, the traffic shape
                # the batcher coalesces.
                lo = 0
                while lo < x.shape[0]:
                    take = int(rng.integers(1, max(2, x.shape[0] - lo + 1)))
                    hi = min(lo + take, x.shape[0])
                    handles.append((y[lo:hi], batcher.submit(x[lo:hi])))
                    n_requests += 1
                    lo = hi
            batcher.flush()
            dt = time.perf_counter() - t0
            correct = total = 0
            for y, handle in handles:
                logits = np.asarray(handle.result())
                correct += int((logits.argmax(-1) == y).sum())
                total += int(y.shape[0])
        except BaseException:
            batcher.close()
            raise
        accuracy = correct / max(1, total)
        return self.finish_report(
            warm_compiles=warm_compiles,
            n_requests=n_requests,
            dt=dt,
            writer_extra={"accuracy": accuracy},
            result_extra={"accuracy": round(accuracy, 4), "examples": total},
        )
