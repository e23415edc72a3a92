"""The disaggregated LM serving config: one checkpoint, two role engines.

The port of ``zookeeper_tpu/serving/disagg/service.py``'s
``DisaggServingConfig``: ``LMServingConfig`` with the roles split. The
same weights bind into a prefill engine (few lanes, wide
``prefill_buckets``, prefix cache on: the compute-bound role) on the
partitioner's prefill device and a decode engine (the slot array, prefix
cache off: adopted pages are private to their stream; the memory-bound
role) on its decode device, joined by a :class:`~zookeeper_tpu_torch.\
serving.disagg.transfer.PageTransfer` and scheduled by the
:class:`~zookeeper_tpu_torch.serving.disagg.scheduler.DisaggScheduler`.
Both run the paged layout: the handoff unit is the page. On one card
both roles share it and the module; on two they get a module each.

Everything else is ``LMServingConfig``'s: the checkpoint and EMA
choice, speculative decoding (the draft lives with the decode role),
the seeded stream of ``run()``, and the one JSON line, which gains
``role="disagg"`` and the transfer keys. Chunked prefill is the
single-engine answer to prefill/decode interference, which the split
already removes: a role configured with ``prefill_chunk_tokens`` runs
monolithic prefill, with a warning. A group of several ranks raises: a
role spans one device of one process in the port (ROADMAP.md).

Observability adds three ``/statusz`` sections (and bundle sections) to
``LMServingConfig``'s: ``prefill`` (the prefill role's lanes, parked
handoffs, programs, recompiles, decode attention and pool), ``transfer``
(``PageTransfer.status()``) and ``topology`` (the partitioner's
``describe()``); the RequestLog is the scheduler's ``"disagg"`` one.

CLI (the counterpart of ``examples/serve_lm.py --disagg``)::

    python -m zookeeper_tpu_torch.serving.decode DisaggServingConfig \\
        model.num_layers=4 model.d_model=512 model.num_heads=8 seq_len=8192 \\
        engine.slots=8 prefill_engine.slots=4 transfer.host_bounce=False
"""

import copy
import logging
from typing import Any, Dict

from zookeeper_tpu_torch.core import ComponentField, task
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.parallel.partitioner import Partitioner
from zookeeper_tpu_torch.serving.decode.engine import DecodeEngine
from zookeeper_tpu_torch.serving.decode.scheduler import DecodeScheduler
from zookeeper_tpu_torch.serving.decode.service import LMServingConfig
from zookeeper_tpu_torch.serving.disagg.partition import DisaggPartitioner
from zookeeper_tpu_torch.serving.disagg.scheduler import DisaggScheduler
from zookeeper_tpu_torch.serving.disagg.transfer import PageTransfer

logger = logging.getLogger(__name__)

__all__ = ["DisaggServingConfig"]


@task
class DisaggServingConfig(LMServingConfig):
    """Disaggregated prefill/decode serving (see the module docstring)."""

    #: The role placement: disjoint devices when there are enough,
    #: overlapping on device 0 otherwise.
    partitioner: Partitioner = ComponentField(DisaggPartitioner)
    #: The decode role (the inherited ``engine``, so every report key
    #: keeps meaning "the serving engine"): paged, prefix cache off.
    engine: DecodeEngine = ComponentField(DecodeEngine, kv_layout="paged", prefix_cache=False)
    #: The prefill role: few lanes batched wide, prefix cache on (warm
    #: prompts skip prefill before the transfer).
    prefill_engine: DecodeEngine = ComponentField(
        DecodeEngine, kv_layout="paged", slots=4, prefill_buckets=(1, 2, 4))
    #: The page mover (``transfer.host_bounce=True``: through host memory).
    transfer: PageTransfer = ComponentField(PageTransfer)
    scheduler: DecodeScheduler = ComponentField(DisaggScheduler)

    def _roles(self):
        """``(prefill partitioner, decode partitioner, prefill device,
        decode device)``: the DisaggPartitioner's roles, or the one
        configured partitioner and ``device`` for both."""
        p = self.partitioner
        if isinstance(p, DisaggPartitioner):
            return p.prefill, p.decode, p.prefill_device, p.decode_device
        return p, p, self.device, self.device

    def build_service(self):
        """Load the weights once, bind and warm both role engines, bind
        the transfer and the scheduler. Returns ``(engine, scheduler)``,
        the decode role as ``LMServingConfig`` returns its engine."""
        if self.weights not in ("auto", "ema", "raw"):
            raise ValueError(f"weights={self.weights!r} unknown; choose auto/ema/raw.")
        if self.requests < 0 or self.max_prompt < 1 or self.new_tokens < 1:
            raise ValueError(
                f"requests={self.requests} must be >= 0, max_prompt="
                f"{self.max_prompt} and new_tokens={self.new_tokens} >= 1."
            )
        for role, eng in (("prefill", self.prefill_engine), ("decode", self.engine)):
            if int(eng.prefill_chunk_tokens) > 0:
                logger.warning(
                    "prefill_chunk_tokens=%d ignored on the disagg %s role: "
                    "disaggregation already isolates prefill from decode — running "
                    "monolithic prefill.", int(eng.prefill_chunk_tokens), role)
                # Configured components are immutable: the degrade writes the
                # instance's value store, before bind() reads the field.
                object.__getattribute__(eng, "__component_values__")["prefill_chunk_tokens"] = 0
        module = self._build_module()
        self.runtime.initialize(self.device)
        if distributed.world_size() > 1:
            raise ValueError(
                f"DisaggServingConfig at world size {distributed.world_size()}: the port "
                "serves each role on one device of one process; roles across ranks are "
                "queued in ROADMAP.md (Queue 1 item 4)."
            )
        self.partitioner.setup()
        prefill_part, decode_part, prefill_dev, decode_dev = self._roles()
        shared = str(prefill_dev) == str(decode_dev)
        self.prefill_engine.bind(module if shared else copy.deepcopy(module),
                                 partitioner=prefill_part, device=prefill_dev)
        self.engine.bind(module, partitioner=decode_part, device=decode_dev)
        if self.warmup:
            # Each role warms what it runs: K9 on the prefill role only,
            # the decode step (K13) on the decode role only.
            self.prefill_engine.warmup(decode=False)
            self.engine.warmup(prefill=False)
            self.prefill_engine.warmup_transfer()
            self.engine.warmup_transfer()
        self.transfer.bind(self.prefill_engine, self.engine, metrics=self.metrics)
        self.scheduler.bind(self.prefill_engine, self.engine, self.transfer,
                            metrics=self.metrics, speculative=self._resolve_speculative())
        self._start_observability()
        return self.engine, self.scheduler

    def _prefill_status(self) -> Dict[str, Any]:
        """The ``/statusz`` ``prefill`` section: the prefill role."""
        pe = self.prefill_engine
        sched = self.scheduler
        return {
            "lanes": int(pe.slots),
            "parked_handoffs": sched.parked if hasattr(sched, "parked") else 0,
            "compiles": pe.compile_count,
            "recompiles_detected": pe.recompiles_detected,
            "decode_attention": pe.decode_attention_flavor,
            "kv_pool": pe.pool_status(),
        }

    def _topology_status(self) -> Dict[str, Any]:
        """The ``/statusz`` ``topology`` section: the roles' devices."""
        p = self.partitioner
        return p.describe() if hasattr(p, "describe") else {}

    def _status_providers(self):
        """``LMServingConfig``'s sections plus ``prefill``, ``transfer``
        and ``topology``."""
        out = super()._status_providers()
        out["prefill"] = self._prefill_status
        out["transfer"] = self.transfer.status
        out["topology"] = self._topology_status
        return out

    def finish_report(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """``LMServingConfig``'s line with ``role="disagg"``, the prefill
        lanes, whether the roles are disjoint and the transfer totals."""
        ts = self.transfer.status()
        result.update({
            "role": "disagg",
            "prefill_lanes": int(self.prefill_engine.slots),
            "disjoint_roles": bool(getattr(self.partitioner, "disjoint", False)),
            "transfer_handoffs": int(ts["handoffs_total"]),
            "transfer_pages": int(ts["pages_total"]),
            "transfer_bytes": int(ts["bytes_total"]),
            "transfer_host_bounces": int(ts["host_bounces"]),
            "transfer_ms_p50": float(ts["transfer_ms_p50"]),
        })
        return super().finish_report(result)
