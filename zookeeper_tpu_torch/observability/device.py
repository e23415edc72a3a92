"""Device memory probe: live per-card memory gauges.

PyTorch's caching allocator keeps per-card counters (bytes allocated,
their high-water mark) and CUDA reports each card's capacity;
the probe publishes them as registry gauges a live ``/metrics`` scrape
reads, under the JAX package's names:

- ``zk_hbm_bytes_in_use{device=N}`` — bytes the allocator has handed
  out (``torch.cuda.memory_stats``' ``allocated_bytes.all.current``).
- ``zk_hbm_peak_bytes_in_use{device=N}`` — their high-water mark
  (``allocated_bytes.all.peak``; ``torch.cuda.reset_peak_memory_stats``
  resets it), what bounds batch and bucket sizing.
- ``zk_hbm_bytes_limit{device=N}`` — the card's capacity
  (``torch.cuda.mem_get_info``'s total).

Only cards this process has touched are read (the current card once
CUDA is initialized, and any card the allocator holds memory on): a
probe must never create a CUDA context on a card it does not use. With
no card, ``device_memory_stats()`` is ``[]`` and the gauges that were
registered keep their documented ``-1`` sentinel.

``poll_once()`` is the deterministic unit (tests); ``start()`` runs it
on a ``zk-device-probe`` daemon thread every ``interval_s``. Polling
reads allocator counters and one CUDA memory query — no kernel launch and
no device synchronisation — so its cost on the dispatch path is zero
by construction.
"""

import logging
import threading
from typing import Any, Dict, List, Optional

from zookeeper_tpu_torch.observability.registry import (
    MetricsRegistry,
    default_registry,
)

__all__ = ["DeviceProbe", "device_memory_stats"]

logger = logging.getLogger(__name__)

#: The stats keys published as gauges, in (stats key, gauge name) pairs.
_STAT_GAUGES = (
    ("bytes_in_use", "zk_hbm_bytes_in_use"),
    ("peak_bytes_in_use", "zk_hbm_peak_bytes_in_use"),
    ("bytes_limit", "zk_hbm_bytes_limit"),
)


def _touched_devices(torch) -> List[int]:
    """The cards this process holds a CUDA context on (see the module
    docstring)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    current = torch.cuda.current_device()
    return [
        i for i in range(torch.cuda.device_count())
        if i == current or torch.cuda.memory_reserved(i) > 0
    ]


def device_memory_stats() -> List[Dict[str, Any]]:
    """Best-effort memory stats of every card this process uses: one
    dict per card (``{"device": i, "kind": name, "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}``). ``[]`` with no card. Never
    raises — a metrics poller must not be able to kill its process."""
    try:
        import torch

        devices = _touched_devices(torch)
    except Exception:
        return []
    out = []
    for i in devices:
        row: Dict[str, Any] = {"device": i}
        try:
            row["kind"] = torch.cuda.get_device_name(i)
            stats = torch.cuda.memory_stats(i)
            row["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
            row["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
            row["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        except Exception as e:  # a half-read row still names the card
            logger.debug("device %d memory stats unreadable: %s", i, e)
        out.append(row)
    return out


class DeviceProbe:
    """Poll per-card memory stats into the ``zk_hbm_*`` gauges.

    ``registry`` defaults to the process-global one (memory is a process
    asset with no per-component owner). Construction registers the
    card-0 gauges at ``-1``, so the series render before the first poll
    and stay ``-1`` with no card. Start/stop are idempotent;
    ``poll_once()`` works without a thread."""

    def __init__(
        self,
        interval_s: float = 10.0,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0.")
        self._interval_s = float(interval_s)
        self._registry = registry if registry is not None else default_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for stat_key, gauge_name in _STAT_GAUGES:
            self._gauge(gauge_name, stat_key, "0")

    def _gauge(self, gauge_name: str, stat_key: str, device: str):
        return self._registry.gauge(
            gauge_name,
            help=f"per-card allocator {stat_key} (-1 = no memory stats)",
            labels={"device": device},
            initial=-1,
        )

    def poll_once(self) -> List[Dict[str, Any]]:
        """One poll: publish every card's gauges (``-1`` where a stat is
        unreadable) and return the raw stats."""
        stats = device_memory_stats()
        for row in stats:
            for stat_key, gauge_name in _STAT_GAUGES:
                value = row.get(stat_key)
                self._gauge(gauge_name, stat_key, str(row["device"])).set(
                    float(value) if isinstance(value, (int, float)) else -1
                )
        return stats

    @property
    def alive(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def start(self) -> "DeviceProbe":
        if self.alive:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:  # pragma: no cover - defensive
                    logger.warning("device probe poll failed: %s", e)
                self._stop.wait(self._interval_s)

        self._thread = threading.Thread(target=loop, name="zk-device-probe", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5)
