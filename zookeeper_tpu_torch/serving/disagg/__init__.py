"""Disaggregated prefill/decode serving: the port of
``zookeeper_tpu/serving/disagg``.

Prefill (compute-bound, batched wide) and the decode step
(memory-bound, latency-critical) run on two role engines, with the KV
page as the handoff unit:

- :class:`DisaggPartitioner` — the roles' devices (disjoint when this
  process has two cards, overlapping on device 0 otherwise, flagged);
- :class:`PageTransfer` — moves a completed prefill's pool pages into
  the decode pool (export, a direct or host-bounced copy, import);
  ``PageTransferError`` on failure, never a silent fallback;
- :class:`DisaggScheduler` — the split admission over the
  ``DecodeScheduler`` machinery, with refcount custody that keeps both
  pools leak-free at every point;
- :class:`DisaggServingConfig` — the CLI task.

Greedy disaggregated output equals the single engine's token for token
(``tests/test_torch_disagg.py``).
"""

from zookeeper_tpu_torch.serving.disagg.partition import DisaggPartitioner
from zookeeper_tpu_torch.serving.disagg.scheduler import DisaggScheduler
from zookeeper_tpu_torch.serving.disagg.service import DisaggServingConfig
from zookeeper_tpu_torch.serving.disagg.transfer import PageTransfer, PageTransferError

__all__ = [
    "DisaggPartitioner",
    "DisaggScheduler",
    "DisaggServingConfig",
    "PageTransfer",
    "PageTransferError",
]
