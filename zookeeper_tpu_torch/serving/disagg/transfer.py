"""KV page handoff between the two role engines.

The port of ``zookeeper_tpu/serving/disagg/transfer.py``. The unit of
disaggregated serving is the pool pages a completed prefill wrote.
:class:`PageTransfer` moves exactly those pages from the prefill
engine's pool into freshly adopted pages of the decode engine's pool:

1. **Export** (source, read only): ``DecodeEngine.export_pages`` gathers
   the pages' k/v rows (and int8 scales), every layer's, into a block.
2. **Move**: ``Tensor.to(dst_device, non_blocking=True)``, a copy within
   one card, or a peer copy when the roles sit on two cards.
   ``host_bounce=True`` routes the block through pinned host memory
   instead. There is no silent fallback: a failed copy raises
   :class:`PageTransferError`, and ``bounces`` counts only the bounces
   asked for.
3. **Import** (destination): ``DecodeEngine.import_pages`` writes the
   block at the adopted page ids.

Refcount custody is the caller's (``DisaggScheduler``): destination
pages are adopted before ``move`` and the source lane is released only
after it returns, so both pools hold ``leak_check() == 0`` at every
point, across an injected ``FaultPlan.fail_page_transfer`` too (this
module raises :class:`PageTransferError`; the scheduler unwinds the
adopted pages and fails only the victim stream). ``move`` returns its
host wall time; it does not wait for the card.
"""

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.observability import trace as _trace

__all__ = ["PageTransfer", "PageTransferError"]


class PageTransferError(RuntimeError):
    """A page handoff failed (injected or real): the victim stream fails
    cleanly, the destination pages are unwound, and both pools stay
    leak-free."""


@component
class PageTransfer:
    """Mover of KV page blocks between two paged engines' pools.
    ``bind(src_engine, dst_engine)`` checks the geometry; ``move`` is the
    per-handoff call."""

    #: Route every block through pinned host memory instead of the direct
    #: device copy (the A/B lever of the transfer's cost).
    host_bounce: bool = Field(False)

    def bind(self, src_engine, dst_engine, metrics=None) -> "PageTransfer":
        """Attach the two engines. Both must run the paged layout with the
        same page size and transfer width."""
        src_engine._require_bound()
        dst_engine._require_bound()
        if not src_engine.paged or not dst_engine.paged:
            raise ValueError(
                "page transfer needs kv_layout='paged' on BOTH roles; got "
                f"src={src_engine.kv_layout!r} dst={dst_engine.kv_layout!r}."
            )
        if int(src_engine.page_size) != int(dst_engine.page_size):
            raise ValueError(
                f"page_size mismatch across roles: src={src_engine.page_size} "
                f"dst={dst_engine.page_size} — a transferred page would land "
                "misaligned."
            )
        if int(src_engine.transfer_width) != int(dst_engine.transfer_width):
            raise ValueError(
                f"transfer_width mismatch: src={src_engine.transfer_width} "
                f"dst={dst_engine.transfer_width} pages — align the roles' seq_buckets "
                "so one block shape serves both."
            )
        object.__setattr__(self, "_src", src_engine)
        object.__setattr__(self, "_dst", dst_engine)
        object.__setattr__(self, "_metrics", metrics)
        object.__setattr__(self, "_stats", {"handoffs": 0, "pages": 0, "bytes": 0,
                                            "bounces": 0})
        object.__setattr__(self, "_ms_window", deque(maxlen=512))
        return self

    def _require_bound(self) -> None:
        if getattr(self, "_src", None) is None:
            raise RuntimeError(
                "PageTransfer is not bound: call transfer.bind(prefill_engine, "
                "decode_engine) first."
            )

    # -- the handoff -----------------------------------------------------

    def move(self, src_page_ids: Sequence[int], dst_page_ids: Sequence[int],
             rid: Optional[int] = None) -> float:
        """Move ``src_page_ids``'s pages into ``dst_page_ids`` (equal
        lengths; the destination ids come from ``PagePool.adopt_slot``)
        inside a ``page_transfer`` span tagged with the stream's ``rid``.
        Returns the host wall milliseconds. Raises
        :class:`PageTransferError` on an injected
        ``FaultPlan.fail_page_transfer`` before touching either pool, and
        on a failed copy."""
        from zookeeper_tpu_torch.resilience import faults

        self._require_bound()
        if len(src_page_ids) != len(dst_page_ids):
            raise ValueError(
                f"page id lists must pair up: {len(src_page_ids)} src vs "
                f"{len(dst_page_ids)} dst."
            )
        plan = faults.active()
        if plan is not None and plan.take_fail_page_transfer():
            raise PageTransferError(
                "injected page-transfer failure (FaultPlan.fail_page_transfer): the "
                "handoff block never reached the decode pool."
            )
        n = len(src_page_ids)
        t0 = time.perf_counter()
        with _trace.span("page_transfer", rid=rid,
                         attrs={"pages": n} if _trace.enabled() else None):
            block = self._src.export_pages(src_page_ids)
            moved = self._place(block)
            self._dst.import_pages(moved, dst_page_ids)
        dt_ms = (time.perf_counter() - t0) * 1e3
        nbytes = self._block_bytes(block)
        stats = self._stats
        stats["handoffs"] += 1
        stats["pages"] += n
        stats["bytes"] += nbytes
        self._ms_window.append(dt_ms)
        if self._metrics is not None:
            self._metrics.record_transfer(n, nbytes, dt_ms)
        return dt_ms

    def _place(self, block: list) -> list:
        """The block on the destination engine's device: a direct copy,
        or through pinned host memory under ``host_bounce``."""
        dst = self._dst.device
        try:
            if not self.host_bounce:
                return [{k: t.to(dst, non_blocking=True) for k, t in layer.items()}
                        for layer in block]
            self._stats["bounces"] += 1
            return [{k: self._bounce(t).to(dst, non_blocking=True) for k, t in layer.items()}
                    for layer in block]
        except RuntimeError as e:
            raise PageTransferError(
                f"page copy to {dst} failed ({e}); no fallback is taken — set "
                "transfer.host_bounce=True to route blocks through host memory."
            ) from e

    @staticmethod
    def _bounce(t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into host memory (pinned when it comes from a
        card, so the copy on to the destination can run async)."""
        if t.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    @staticmethod
    def _block_bytes(block: list) -> int:
        """Payload bytes of a block (every buffer of every layer; the
        block holds the real pages only)."""
        return int(sum(t.numel() * t.element_size() for layer in block for t in layer.values()))

    # -- accounting ------------------------------------------------------

    @property
    def handoffs(self) -> int:
        return self._stats["handoffs"] if hasattr(self, "_stats") else 0

    def transfer_ms_p50(self) -> float:
        """Median handoff wall time over the recent window (-1 before
        any handoff)."""
        window = getattr(self, "_ms_window", None)
        if not window:
            return -1.0
        return float(np.percentile(np.asarray(window), 50))

    def status(self) -> dict:
        """The transfer section of a status report."""
        self._require_bound()
        stats = self._stats
        return {
            "handoffs_total": int(stats["handoffs"]),
            "pages_total": int(stats["pages"]),
            "bytes_total": int(stats["bytes"]),
            "host_bounces": int(stats["bounces"]),
            "host_bounce_forced": bool(self.host_bounce),
            "transfer_width": int(self._src.transfer_width),
            "transfer_ms_p50": round(self.transfer_ms_p50(), 4),
        }
