"""Cross-host coordination for the multi-process resilience stack.

The port of ``zookeeper_tpu/resilience/coordination.py``, the same
on-disk protocol. The group recovery and the per-host checkpoint
protocol need two small primitives that work between the processes of
one job without relying on the collective runtime (the thing that may
be failing):

- **flag publish/poll**: a non-blocking "host i wants to stop" signal
  every host sees at its next step or slab boundary (the group drain);
- **exchange**: a small-value allgather with a deadline (the restore
  step agreement, the supervisor's restart verdicts).

:class:`FileCoordinator` implements both over a shared directory (the
storage the checkpoint root already lives on): every write is temp
file, fsync, atomic rename; every read tolerates a missing peer; every
round is namespaced by ``(generation, key, sequence)``, so a restarted
group attempt never reads an earlier attempt's files. No collective, no
socket: a host that died never writes its file, and its peers time out
with :class:`CoordinatorLostError` instead of hanging in a collective.
A port coordinator and a JAX one over the same directory complete the
same rounds.

:class:`NullCoordinator` is the single-process no-op, so wiring a
coordinator costs nothing at ``process_count == 1``.

The payloads are small JSON values keyed by logical coordinates (steps,
attempts, process indices), never by the clock, so two runs of one
``FaultPlan`` walk the same rounds. The plan's ``coordinator_loss``
makes the next ``exchange`` raise :class:`CoordinatorLostError`.
"""

import json
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "CoordinatorLostError",
    "FileCoordinator",
    "HostCoordinator",
    "NullCoordinator",
]


class CoordinatorLostError(RuntimeError):
    """A cross-host round did not complete: a peer never wrote its half
    before the deadline (host death, shared storage partitioned away) or
    the loss was injected (``FaultPlan.coordinator_loss``). The restore
    agreement falls back to a local decision; the supervisor's verdict
    propagates it (restarting half a group would wedge the survivors)."""


def _safe_key(key: str) -> str:
    """A filesystem-safe round key (keys carry steps and tiers)."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(key))


def _atomic_write_json(path: str, payload: Any) -> None:
    """Temp file, fsync, atomic rename: a reader sees the whole document
    or no file."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # vanished: absent


class HostCoordinator:
    """The interface the resilience stack programs against.
    ``process_index``/``process_count`` name this host in the group;
    ``generation`` namespaces every round (the group supervisor sets it
    to the restart attempt)."""

    process_index: int = 0
    process_count: int = 1
    generation: int = 0

    def exchange(self, key: str, payload: Any, timeout_s: Optional[float] = None) -> List[Any]:
        """Allgather one small JSON payload per host for round ``key``;
        the payloads by process index. Raises :class:`CoordinatorLostError`
        at the deadline."""
        raise NotImplementedError

    def publish_flag(self, kind: str, payload: Any) -> None:
        """Make ``payload`` visible to every host under ``kind`` (a
        republish overwrites this host's)."""
        raise NotImplementedError

    def poll_flags(self, kind: str) -> List[Any]:
        """Every host's published ``kind`` flag, by process index, without
        blocking (hosts that published none are absent)."""
        raise NotImplementedError


class NullCoordinator(HostCoordinator):
    """One process: an exchange returns the caller's payload, flags are a
    process-local dict."""

    def __init__(self) -> None:
        self.process_index = 0
        self.process_count = 1
        self.generation = 0
        self._flags: Dict[str, Any] = {}

    def exchange(self, key, payload, timeout_s=None):
        return [payload]

    def publish_flag(self, kind, payload):
        self._flags[str(kind)] = payload

    def poll_flags(self, kind):
        flag = self._flags.get(str(kind))
        return [] if flag is None else [flag]


class FileCoordinator(HostCoordinator):
    """The shared-directory coordinator (module docstring). Layout under
    ``root``::

        xchg/g<generation>/<key>/r<sequence>/host_<pid>.json
        flags/g<generation>/<kind>/host_<pid>.json

    Each file holds ``{"v": payload}``, so a null payload differs from a
    missing file. The per-key sequence is process-local and advances
    once an ``exchange``: every host walks the same rounds in the same
    order, so the counters agree; the generation covers an in-process
    group restart.

    A restart of the whole job over the same root starts the generation
    and the counters again, so construction purges this host's own files
    from the root: once every host of the new incarnation has built its
    coordinator (before any poll or exchange, behind the process group's
    rendezvous), no stale flag can drain the resumed group and no stale
    file can complete a new round. A dead incarnation's hosts never write
    again, so purging one's own files is safe.
    """

    def __init__(self, root: str, process_index: int, process_count: int, *,
                 timeout_s: float = 120.0, poll_interval_s: float = 0.01) -> None:
        if not 0 <= int(process_index) < int(process_count):
            raise ValueError(
                f"process_index={process_index} outside [0, {process_count})."
            )
        self.root = os.path.abspath(os.path.expanduser(root))
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.generation = 0
        self.timeout_s = float(timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self._seq: Dict[str, int] = {}
        self._purge_own_files()

    def _own_name(self) -> str:
        return f"host_{self.process_index:05d}.json"

    def _purge_own_files(self) -> None:
        """Remove every file this host wrote in an earlier incarnation
        (its own only: a live peer's are never touched)."""
        mine = self._own_name()
        if not os.path.isdir(self.root):
            return
        for dirpath, _, filenames in os.walk(self.root):
            if mine in filenames:
                try:
                    os.unlink(os.path.join(dirpath, mine))
                except OSError:
                    pass  # already gone

    # -- exchange ---------------------------------------------------------

    def _round_dir(self, key: str, seq: int) -> str:
        return os.path.join(self.root, "xchg", f"g{int(self.generation)}", _safe_key(key),
                            f"r{seq:06d}")

    def exchange(self, key, payload, timeout_s=None):
        from zookeeper_tpu_torch.resilience import faults

        plan = faults.active()
        if plan is not None and plan.take_coordinator_loss():
            raise CoordinatorLostError(f"injected coordinator loss during exchange {key!r}")
        seq = self._seq[key] = self._seq.get(key, 0) + 1
        d = self._round_dir(key, seq)
        _atomic_write_json(os.path.join(d, self._own_name()), {"v": payload})
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None else float(timeout_s))
        paths = [os.path.join(d, f"host_{pid:05d}.json") for pid in range(self.process_count)]
        while True:
            docs = [_read_json(p) if os.path.exists(p) else None for p in paths]
            if all(isinstance(doc, dict) and "v" in doc for doc in docs):
                return [doc["v"] for doc in docs]
            if time.monotonic() >= deadline:
                missing = [pid for pid, doc in enumerate(docs) if doc is None]
                raise CoordinatorLostError(
                    f"exchange {key!r} (round {seq}, generation {self.generation}) timed "
                    f"out waiting for host(s) {missing} of {self.process_count}"
                )
            time.sleep(self.poll_interval_s)

    # -- flags ------------------------------------------------------------

    def _flag_dir(self, kind: str) -> str:
        return os.path.join(self.root, "flags", f"g{int(self.generation)}", _safe_key(kind))

    def publish_flag(self, kind, payload):
        _atomic_write_json(os.path.join(self._flag_dir(kind), self._own_name()), {"v": payload})

    def poll_flags(self, kind):
        d = self._flag_dir(kind)
        try:
            names = sorted(n for n in os.listdir(d)
                           if n.startswith("host_") and n.endswith(".json"))
        except OSError:
            return []
        docs = [_read_json(os.path.join(d, n)) for n in names]
        return [doc["v"] for doc in docs if isinstance(doc, dict) and "v" in doc]
