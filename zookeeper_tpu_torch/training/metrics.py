"""Metrics writers: where the training loop's scalars go.

The port of ``zookeeper_tpu/training/metrics.py``. A writer is a
configurable component, so ``TrainingExperiment`` sends scalars to any
sink without owning a file format. Writers receive host floats (the loop
reads its metrics back once per epoch, or per ``log_every`` steps), so a
writer never adds a readback from the card.

- ``MetricsWriter``: the base and the null sink.
- ``JsonlMetricsWriter``: one JSON object per line.
- ``TensorBoardMetricsWriter``: TensorBoard event files through
  ``torch.utils.tensorboard.SummaryWriter``, imported at the first write
  (``tensorboard`` is optional; with ``log_dir`` set and no
  ``tensorboard``, the first write raises).
- ``CompositeMetricsWriter``: both of the above from one config node.
"""

import json
import os
from typing import Any, Mapping, Optional

from zookeeper_tpu_torch.core import ComponentField, Field, component

__all__ = [
    "CompositeMetricsWriter",
    "JsonlMetricsWriter",
    "MetricsWriter",
    "TensorBoardMetricsWriter",
]


@component
class MetricsWriter:
    """The null sink; the base of every writer. The contract:

    - ``write_scalars(step, values)``: record a flat ``{name: float}``
      mapping at an integer global step (names may group with ``/``);
    - ``flush()``: make everything written so far durable;
    - ``close()``: flush and release; later writes are no-ops.
    """

    def write_scalars(self, step: int, values: Mapping[str, float]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


@component
class JsonlMetricsWriter(MetricsWriter):
    """Appends one ``{"step": N, **values}`` line per write; a no-op while
    ``path`` is None, so it can sit in a config tree and be switched on
    with one key (``writer.jsonl.path=metrics.jsonl``)."""

    path: Optional[str] = Field(None)

    def write_scalars(self, step: int, values: Mapping[str, float]) -> None:
        if not self.path or getattr(self, "_closed", False):
            return
        record = {"step": int(step)}
        record.update({k: float(v) for k, v in values.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        object.__setattr__(self, "_closed", True)


def _summary_writer(log_dir: str) -> Any:
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "TensorBoardMetricsWriter with a log_dir needs the 'tensorboard' "
            "package (pip install tensorboard); unset log_dir or use "
            "JsonlMetricsWriter."
        ) from e
    return SummaryWriter(log_dir=log_dir)


@component
class TensorBoardMetricsWriter(MetricsWriter):
    """TensorBoard event files under ``log_dir``; a no-op while ``log_dir``
    is None. Each scalar is one ``add_scalar(tag, value, step)``, the tags
    and steps the JAX writer's."""

    log_dir: Optional[str] = Field(None)

    def _writer(self) -> Any:
        w = getattr(self, "_writer_cache", None)
        if w is not None:
            return w
        if not self.log_dir or getattr(self, "_closed", False):
            return None
        os.makedirs(self.log_dir, exist_ok=True)
        w = _summary_writer(self.log_dir)
        object.__setattr__(self, "_writer_cache", w)
        return w

    def write_scalars(self, step: int, values: Mapping[str, float]) -> None:
        w = self._writer()
        if w is None:
            return
        for k, v in values.items():
            w.add_scalar(k, float(v), int(step))

    def flush(self) -> None:
        w = getattr(self, "_writer_cache", None)
        if w is not None:
            w.flush()

    def close(self) -> None:
        w = getattr(self, "_writer_cache", None)
        if w is not None:
            w.flush()
            w.close()
            object.__setattr__(self, "_writer_cache", None)
        object.__setattr__(self, "_closed", True)


@component
class CompositeMetricsWriter(MetricsWriter):
    """Every call to a jsonl and a TensorBoard writer. Each leg is off
    until configured (``writer.jsonl.path=...``,
    ``writer.tensorboard.log_dir=...``), so this is a free default."""

    jsonl: JsonlMetricsWriter = ComponentField(JsonlMetricsWriter)
    tensorboard: TensorBoardMetricsWriter = ComponentField(TensorBoardMetricsWriter)

    def write_scalars(self, step: int, values: Mapping[str, float]) -> None:
        self.jsonl.write_scalars(step, values)
        self.tensorboard.write_scalars(step, values)

    def flush(self) -> None:
        self.jsonl.flush()
        self.tensorboard.flush()

    def close(self) -> None:
        self.jsonl.close()
        self.tensorboard.close()
