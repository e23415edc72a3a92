"""Role-aware placement: the prefill role and the decode role on the
devices of one process.

The port of ``zookeeper_tpu/serving/disagg/partition.py``'s
``DisaggPartitioner``. Disaggregated serving runs prefill (compute-bound,
batched wide) and the decode step (memory-bound, latency-critical) on
different devices. The devices are this process's: every card
(``torch.cuda.device_count()``) when ``device`` is "cuda", the one
"cpu" device otherwise. Counts resolve at ``setup()`` as JAX resolves
them: explicit ``prefill_devices``/``decode_devices``, or half the
devices (at least one) for prefill and the rest (at least one) for
decode. When there are too few devices for disjoint roles (one card, or
the CPU) both roles take device 0: every step of the handoff still runs,
and ``describe()`` flags the overlap so it is never mistaken for real
disaggregation.

In the port a role holds one device: one process drives one card per
role, and a role spanning several cards (JAX's role meshes) would need
ranks, so it raises ``ValueError`` (ROADMAP.md). The class is itself a
meshless :class:`~zookeeper_tpu_torch.parallel.partitioner.Partitioner`
(it answers as the decode role does); the roles' own partitioners are
``prefill`` and ``decode`` and their devices ``prefill_device`` and
``decode_device``.
"""

from typing import List

import torch

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.parallel.partitioner import Partitioner, SingleDevicePartitioner

__all__ = ["DisaggPartitioner"]


@component
class DisaggPartitioner(Partitioner):
    """Two-role device placement over one process's devices (see the
    module docstring)."""

    #: Devices of the prefill role (-1: half the devices, at least 1).
    prefill_devices: int = Field(-1)
    #: Devices of the decode role (-1: the rest, at least 1).
    decode_devices: int = Field(-1)
    #: The device type the roles run on: "cuda" (every card of this
    #: process) or "cpu".
    device: str = Field("cuda")

    def _devices(self) -> List[torch.device]:
        if torch.device(self.device).type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    def setup(self) -> None:
        """Resolve the split. Idempotent."""
        if getattr(self, "_roles_ready", False):
            return
        devices = self._devices()
        n = len(devices)
        pn, dn = int(self.prefill_devices), int(self.decode_devices)
        if pn == 0 or dn == 0 or pn < -1 or dn < -1:
            raise ValueError(
                f"prefill_devices={pn} / decode_devices={dn} must be >= 1 per role "
                "(-1 = auto split)."
            )
        if pn < 0:
            pn = max(1, n // 2)
        if dn < 0:
            dn = max(1, n - pn)
        if pn > n or dn > n:
            raise ValueError(
                f"role sizes prefill={pn} / decode={dn} exceed the host's {n} devices."
            )
        if pn > 1 or dn > 1:
            raise ValueError(
                f"role sizes prefill={pn} / decode={dn}: a role of more than one device "
                "needs ranks (one process per card); the port serves each role on one "
                "device (queued in ROADMAP.md). Set prefill_devices=1 decode_devices=1."
            )
        disjoint = pn + dn <= n
        prefill = devices[0]
        decode = devices[pn] if disjoint else devices[0]
        roles = (SingleDevicePartitioner(), SingleDevicePartitioner())
        for role in roles:
            role.setup()
        object.__setattr__(self, "_role_devices", (prefill, decode))
        object.__setattr__(self, "_roles", roles)
        object.__setattr__(self, "_disjoint", disjoint)
        object.__setattr__(self, "_roles_ready", True)

    @property
    def prefill(self) -> Partitioner:
        """The prefill role's partitioner."""
        self.setup()
        return self._roles[0]

    @property
    def decode(self) -> Partitioner:
        """The decode role's partitioner."""
        self.setup()
        return self._roles[1]

    @property
    def prefill_device(self) -> torch.device:
        self.setup()
        return self._role_devices[0]

    @property
    def decode_device(self) -> torch.device:
        self.setup()
        return self._role_devices[1]

    @property
    def disjoint(self) -> bool:
        """Whether the roles landed on different devices (False: the
        overlapping fallback)."""
        self.setup()
        return bool(self._disjoint)

    def describe(self) -> dict:
        """The topology section of a status report: each role's devices
        and whether they are disjoint."""
        self.setup()
        return {
            "disjoint": bool(self._disjoint),
            "prefill_devices": [str(self._role_devices[0])],
            "decode_devices": [str(self._role_devices[1])],
        }

    @property
    def mesh(self):
        return self.decode.mesh
