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

**Chief-led dispatch.** A serving engine whose partitioner spans several
ranks is collective: every rank must make the same dispatches. The
synchronous batcher and scheduler on the same request stream make them
by construction. A clock-driven mode (a worker thread, deadlines, a
checkpoint watcher) would decide by each rank's clock, so there rank 0
decides and the others follow: :class:`ChiefLink` carries the chief's
decisions as small int64 records over a gloo group made beside the
card's group (never the NCCL group, which the engine's own collectives
use from the same thread), and :meth:`ChiefLink.agree` lets a follower
that lacks a request the record names fail that dispatch on every rank,
after a bounded wait (:data:`FOLLOWER_WAIT_S`), instead of hanging.
Requests are named by their submission ordinal on the batcher or
scheduler, so every rank must submit the same requests in the same
order, as the synchronous mode already asks.
"""

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

import torch
import torch.distributed as dist

from zookeeper_tpu_torch.core import Field, component

logger = logging.getLogger(__name__)

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


#: How long a follower waits for a request (or a staged swap) that the
#: chief's record names before the dispatch fails on every rank.
FOLLOWER_WAIT_S = 30.0

#: Record kinds (the first int of every record).
RECORD_STOP, RECORD_STEP, RECORD_CRASH, RECORD_END = 0, 1, 2, 3

#: The seam that engages chief-led dispatch in front of an engine that
#: spans one rank (tests, and the card's one-rank check); no
#: configuration sets it.
_FORCED = False


@contextlib.contextmanager
def forced_chief_led():
    """Engage chief-led dispatch for the batchers and schedulers bound
    inside the block, whatever their engine spans."""
    global _FORCED
    saved, _FORCED = _FORCED, True
    try:
        yield
    finally:
        _FORCED = saved


def chief_led(engine) -> bool:
    """Whether a clock-driven mode in front of ``engine`` must be led by
    rank 0: the engine is collective (or the seam is engaged)."""
    return _FORCED or bool(getattr(engine, "collective", False))


class ChiefLedError(RuntimeError):
    """A follower rank lacked a request the chief's dispatch named (the
    ranks did not submit the same requests in the same order): the
    dispatch failed on every rank."""


class ChiefLink:
    """The control channel of chief-led dispatch: rank 0's records, one
    int64 list each, broadcast over a gloo group of every rank, and a
    one-int agreement. A link is made by every rank at the same point
    (the group's creation is collective) and used by one thread on each
    rank, the thread that then issues the engine's collectives, so every
    rank posts the same collectives in the same order. Without a process
    group (the seam at world size 1) records pass through unsent."""

    #: Ints a record's first broadcast carries (its length first); a
    #: longer record takes a second broadcast.
    _HEAD = 32

    def __init__(self) -> None:
        self.rank = rank()
        self.world = world_size()
        self._group = dist.new_group(backend="gloo") if is_distributed_initialized() else None

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def exchange(self, record: Optional[Sequence[int]] = None) -> List[int]:
        """The chief sends ``record``; a follower passes nothing and gets
        the chief's. Blocks a follower until the chief sends."""
        if self._group is None:
            return [int(v) for v in record]
        head = torch.zeros(self._HEAD, dtype=torch.int64)
        if self.is_chief:
            values = [int(v) for v in record]
            head[0] = len(values)
            first = values[:self._HEAD - 1]
            head[1:1 + len(first)] = torch.tensor(first, dtype=torch.int64)
        dist.broadcast(head, src=0, group=self._group)
        n = int(head[0])
        if n <= self._HEAD - 1:
            return head[1:1 + n].tolist()
        rest = torch.zeros(n - (self._HEAD - 1), dtype=torch.int64)
        if self.is_chief:
            rest[:] = torch.tensor(values[self._HEAD - 1:], dtype=torch.int64)
        dist.broadcast(rest, src=0, group=self._group)
        return head[1:].tolist() + rest.tolist()

    def agree(self, ok: bool) -> bool:
        """True when every rank says ``ok``."""
        if self._group is None:
            return bool(ok)
        flag = torch.tensor([1 if ok else 0], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._group)
        return bool(flag.item())


class ChiefLed:
    """The follower machinery one batcher or scheduler keeps for chief-led
    dispatch, from its bind on: the submission ordinals that name its
    requests (counted before the protocol engages, so the ranks agree on
    them whenever it does), the chief's decisions about requests a
    follower has not received yet, and the :class:`ChiefLink` once
    engaged. The owner supplies its records' encoding and how it applies
    one; ``unit`` ("request", "stream") names its requests in errors and
    ``crash_error(ordinals)`` is what the chief's crash record raises on
    a follower."""

    def __init__(self, unit: str, crash_error: Callable[[List[int]], BaseException]) -> None:
        self.unit = unit
        self._crash_error = crash_error
        self.link: Optional[ChiefLink] = None
        self.next_ordinal = 0
        self._decided: Dict[int, BaseException] = {}

    def engage(self, refused: Sequence[str] = ()) -> bool:
        """Make the link (every rank at the same point) unless it is made;
        returns whether this call made it. ``refused`` names the
        submit-time policies in force (shedding, the overload guard):
        they decide by one rank's queue, so they raise instead."""
        if self.link is not None:
            return False
        if refused:
            raise ValueError(
                f"{' and '.join(refused)} decide at submit by one rank's queue, so under "
                "chief-led dispatch (a collective engine with a clock-driven mode) the "
                f"ranks' {self.unit}s would diverge; serve without them.")
        self.link = ChiefLink()
        return True

    def mint(self, item) -> Optional[BaseException]:
        """Give ``item`` the next ordinal (``item.ordinal``); returns the
        chief's decision about it when that came first (a follower fails
        it on arrival), else None."""
        item.ordinal = self.next_ordinal
        self.next_ordinal += 1
        return self._decided.pop(item.ordinal, None)

    def decide(self, ordinal: int, error: BaseException) -> None:
        """Fail request ``ordinal`` with ``error`` when it arrives (the
        first decision holds)."""
        self._decided.setdefault(ordinal, error)

    def lost_error(self, what: str, when: str) -> "ChiefLedError":
        """The error of a dispatch a follower could not follow: it had not
        received ``what`` by the bounded wait after the chief's ``when``."""
        return ChiefLedError(
            f"chief-led dispatch: rank {self.link.rank} had not received {what} within "
            f"{FOLLOWER_WAIT_S:.0f} s of the chief's {when}; every rank must submit the "
            f"same {self.unit}s in the same order.")

    @staticmethod
    def wait(cv, ready: Callable[[], bool], t_end: float) -> bool:
        """Wait on ``cv`` (held by the caller) until ``ready()`` or the
        clock passes ``t_end`` (see :data:`FOLLOWER_WAIT_S`); returns
        ``ready()``."""
        while not ready():
            remaining = t_end - time.perf_counter()
            if remaining <= 0:
                return False
            cv.wait(min(remaining, 0.05))
        return True

    def follow(self, apply: Callable[[List[int]], None], end: int) -> None:
        """A follower: ``apply`` the chief's records as they come, until
        its ``end`` record (:data:`RECORD_STOP` for a worker thread,
        :data:`RECORD_END` for a synchronous entry point). The chief's
        crash record raises ``crash_error`` with the ordinals it failed."""
        while True:
            record = self.link.exchange()
            if record[0] == end:
                return
            if record[0] == RECORD_CRASH:
                raise self._crash_error(record[1:])
            apply(record)

    def send_crash(self, ordinals: Iterable[int]) -> None:
        """The chief's side of a crash: the followers fail ``ordinals``."""
        try:
            self.link.exchange([RECORD_CRASH, *ordinals])
        except Exception:
            logger.warning("chief-led crash record not sent", exc_info=True)

    def crashed(self, error, present: Iterable[int]) -> Set[int]:
        """A follower's side of the chief's crash ``error``: the ordinals it
        names; of those, the ones not ``present`` fail with it on
        arrival."""
        named = set(error.ordinals)
        for ordinal in named - set(present):
            self.decide(ordinal, error)
        return named


def broadcast_from_chief(value: Optional[int]) -> Optional[int]:
    """Rank 0's ``value`` (an int or None) on every rank of the group, as
    it is without one; a collective of the default group."""
    if not is_distributed_initialized():
        return value
    box = [value]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else None)
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


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
