"""Forming the process group: one process per card.

The port of ``zookeeper_tpu/parallel/distributed.py`` over
``torch.distributed``. A run of N ranks is N processes, each driving one
card (``cuda:LOCAL_RANK``) over NCCL, or, when the run was asked for the
CPU (``device=cpu``), one CPU rank each over gloo. A group forms in one
of two ways:

- from the ``env://`` variables ``python -m torch.distributed.run``
  sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``)::

      python -m torch.distributed.run --nproc-per-node 4 \\
          -m zookeeper_tpu_torch.training TrainLM \\
          partitioner=SequenceParallelPartitioner partitioner.sp=4

- from an explicit cluster: ``coordinator_address`` (``host:port``, the
  rendezvous every rank dials), ``num_processes`` and ``process_id``.

With neither, no group is formed and the world size is 1: the port's
single-card path, on which no collective is ever called. A run asked
for the card that finds none raises; nothing falls back to gloo.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from zookeeper_tpu_torch.core import Field, component

#: The variables ``torch.distributed.run`` sets for every rank.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_distributed_initialized() -> bool:
    """Whether this process belongs to a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the group; 1 without one."""
    return dist.get_world_size() if is_distributed_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_distributed_initialized() else 0


def local_rank() -> int:
    """This rank's index among the ranks of its host: ``LOCAL_RANK`` when
    a launcher set it, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(1, torch.cuda.device_count())


def local_device(device: str) -> torch.device:
    """The device this rank runs on for a run asked for ``device``: in a
    group, a CUDA run takes ``cuda:LOCAL_RANK``; without one, ``device``
    as it is. A CUDA device with no card raises."""
    from zookeeper_tpu_torch.ops.device import resolve_device

    resolved = resolve_device(device)
    if resolved.type == "cuda" and is_distributed_initialized() and resolved.index is None:
        return torch.device("cuda", local_rank())
    return resolved


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> None:
    """Form the process group (idempotent; see the module docstring).

    ``num_processes``/``process_id`` describe a manually specified
    cluster and mean nothing without the coordinator every process
    rendezvouses at, so passing them alone is an error, as in the JAX
    package. ``device`` picks the backend: NCCL with this rank's card for
    "cuda" (raises without one), gloo for "cpu"."""
    if (num_processes is not None or process_id is not None) and coordinator_address is None:
        raise ValueError(
            "num_processes/process_id were given without a "
            "coordinator_address: an explicit cluster topology needs "
            "the coordinator every process rendezvouses at (e.g. "
            "runtime.coordinator_address=10.0.0.1:8476). Under "
            "torch.distributed.run, pass NONE of the three and let its "
            "environment describe the group."
        )
    if is_distributed_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id "
                "(the world size and this process's rank)."
            )
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    elif all(name in os.environ for name in _LAUNCHER_ENV):
        kwargs = dict(init_method="env://")
    else:
        return  # No launcher and no coordinator: world size 1, no group.
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but no CUDA card is available "
                "to form the NCCL group; pass device=cpu to run the ranks "
                "on the CPU over gloo."
            )
        if coordinator_address is not None and "LOCAL_RANK" not in os.environ:
            card = int(process_id) % torch.cuda.device_count()
        else:
            card = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=torch.device("cuda", card), **kwargs)
    elif kind == "cpu":
        dist.init_process_group("gloo", **kwargs)
    else:
        raise ValueError(f"device={device!r}: expected cuda or cpu.")


def check_same_dispatch(values, what: str) -> None:
    """The collective dispatch guard of the serving engines under a
    partitioner that spans several ranks: every rank runs its own
    scheduler, and a collective forward needs every rank to make the same
    dispatch. The ranks all-gather ``values`` (small ints: kind, bucket,
    rows, a checksum of the slots) and raise on any difference, so a
    divergence is an error, not a hang in the next collective."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
    seen = torch.empty((world_size(), mine.numel()), dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(seen.view(-1), mine)
    rows = seen.cpu().tolist()
    if any(r != rows[0] for r in rows):
        raise RuntimeError(
            f"{what}: the ranks' dispatches differ ({rows}): every rank must make the "
            "same dispatches (run the same synchronous scheduler on the same request "
            "stream)."
        )


def dispatch_checksum(*arrays) -> int:
    """A checksum of small int arrays (slot ids, lengths) for
    :func:`check_same_dispatch`."""
    total = 0
    for i, a in enumerate(arrays):
        for j, v in enumerate(a):
            total = (total * 1000003 + (i + 1) * (j + 7) * (int(v) + 11)) % (1 << 61)
    return total


def refuse_clock_driven(engine, what: str) -> None:
    """Raise for a clock-driven serving mode in front of a collective
    ``engine`` (one whose partitioner spans several ranks): a threaded
    scheduler or batcher, or a request deadline, decides by each rank's
    own clock, so the ranks' dispatches would diverge."""
    if getattr(engine, "collective", False):
        raise ValueError(
            f"{what} decides by each rank's own clock, so at world size "
            f"{world_size()} the ranks' dispatches would diverge; serve with "
            "synchronous=True and no deadlines (a chief-led dispatch is queued in "
            "ROADMAP.md)."
        )


def shutdown_distributed() -> None:
    """Leave the process group, when there is one."""
    if is_distributed_initialized():
        dist.destroy_process_group()


@component
class DistributedRuntime:
    """Component wrapper so the group is configurable from the CLI::

        python -m zookeeper_tpu_torch.training TrainLM \\
            runtime.coordinator_address=10.0.0.2:1234 \\
            runtime.num_processes=8 runtime.process_id=0
    """

    coordinator_address: Optional[str] = Field(None)
    num_processes: int = Field(-1)
    process_id: int = Field(-1)
    enabled: bool = Field(True)

    def initialize(self, device: str = "cuda") -> None:
        if not self.enabled:
            return
        initialize_distributed(
            coordinator_address=self.coordinator_address,
            num_processes=None if self.num_processes < 0 else self.num_processes,
            process_id=None if self.process_id < 0 else self.process_id,
            device=device,
        )
