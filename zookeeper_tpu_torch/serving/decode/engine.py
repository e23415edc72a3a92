"""The autoregressive decode engine: prefill and decode steps over
device-resident KV-cache state.

The port of ``zookeeper_tpu/serving/decode/engine.py``'s
``DecodeEngine``. Two dispatch families serve all traffic:

- **prefill**, bucketed (``prefill_buckets`` x ``seq_buckets``): the
  full-context forward over a right-padded prompt group (K9 in every
  layer), its K/V written into the group's slots (or pages), and each
  request's first token;
- **decode**: one token for every slot of the slot array (K12 over the
  slot caches, or K13 through the page tables), inactive slots riding
  along with their output ignored.

The serving features add windows of several positions, the module's
``decode_verify`` / ``decode_verify_paged`` (plain fp32 attention):

- **verify** (``w`` tokens for every slot, the speculative teacher's
  ``k + 1`` and the draft's width-2 catch-up);
- **prefill_warm** (the radix prefix cache, paged: a prompt whose prefix
  is resident in shared pages runs only its suffix, over the
  ``prefill_buckets`` x ``seq_buckets`` width grid) and **prefill_chunk**
  (chunked prefill, paged: one chunk of each of a group of prompts,
  appended at its cursor), both with the first token from each row's
  last real position;
- **copy_page**: the copy-on-write of one pool page, every layer's k/v
  (and scale) rows, before a warm suffix writes into it.

PyTorch runs eagerly, so there is nothing to compile: ``warmup()`` runs
each bucket and one decode step once (and, paged with the prefix cache
or chunking, each extend width), which builds the kernels and warms the
allocator before the first request; ``warmup_verify(w)`` runs a verify
window. The cache is written in place. ``dispatches`` counts each kind.

Under a partitioner (``bind(module, partitioner=...)``) the module serves
in the layout it trained with (``Partitioner.plan_variables``: the
tensor-parallel blocks on their heads, FSDP's shards gathered for each
dispatch and freed after) and each rank holds its block of the KV state
(``parallel.shards.DecodeShard``): slots over the data axes, heads over
the model axis (``decode_cache_axes``; a page pool splits its heads
only). Geometry that does not divide logs JAX's warning and keeps a
replicated cache. A slot id stays global. ``prefill`` runs the whole
group on every rank and each writes the rows it holds; ``decode`` runs
each data rank on its slots and gathers the next tokens, so both return
the same tokens on every rank. The engine is collective: every rank
must make the same dispatches (the synchronous ``DecodeScheduler`` on
the same stream does), and when the partitioner spans several ranks
each dispatch checks that they agree (``parallel.distributed.check_same_dispatch``).

A window over a group (warm extend, chunk) runs like a prefill: every
rank runs the whole group and writes its heads of every row; a verify
window runs like a decode step (each data rank its slots, the pool
taking every slot's rows). The host state (table, refcounts, trie) is
the same on every rank.

**Page transfer** (disaggregated prefill/decode, paged): ``export_pages``
gathers the k/v rows (and int8 scales) of a list of pool pages, every
layer's, into a block of exactly those pages; ``import_pages`` writes a
block into this pool at the pages ``PagePool.adopt_slot`` gave. The
JAX engine pads every block to ``transfer_width`` pages so one compiled
program serves every handoff, its padding lanes writing nowhere; eager
PyTorch moves the live pages only, and ``transfer_width`` stays the
bound both roles must agree on.

**Hot weight swap**: ``check_swap`` validates a candidate weight set (the
export trees, ``{flax path: tensor}``) against the bound structure, leaf
shapes and dtypes; ``swap_weights`` then copies it into the module in
place, each rank's block through the plan ``bind`` cut it with
(``serving.weights``). Per dispatch that is atomic only when no dispatch
runs meanwhile: a bound ``DecodeScheduler`` swaps through
``request_swap``, at a boundary with no stream in flight.

**Programs and the ledger** (``observability.ledger``). Each program's
first run (a ``(prefill bucket, seq bucket)`` prefill, the warm-extend
``(bucket, width)`` grid shared by warm and chunked prefill, the decode
step, a verify window ``verify_step/w{N}``, ``copy_page``, the transfer
gather and scatter) ends in a device synchronisation and lands one ledger
row, its key carrying ``ledger_prefix`` ("draft_" for a speculative
draft): its wall time, and its FLOPs and bytes counted from the shapes
(``2*M*N*K`` for each dense layer and the head, ``4 * head_dim`` per
(query, key) pair and head; the weights once plus the K/V rows it reads
or writes). ``warmup()`` runs the grid (and ``copy_page`` when paged);
``warmup_verify`` and ``warmup_transfer`` extend it. A first run after
``warmup()`` outside them is a stall: ``zk_serving_recompiles_total``,
``recompile_detected`` and a flight-recorder trigger. Binding sets
``zk_decode_kv_bytes``; each decode step and verify window publishes
``zk_decode_mbu``: the bytes that dispatch must read (:meth:`_step_bytes`:
the weights, the live K/V rows and their scales, the positional rows)
over its readback-bounded wall time over the card's HBM bandwidth. With
tracing on, each dispatch is a span (``prefill_dispatch``,
``prefill_warm_dispatch``, ``prefill_chunk_dispatch``,
``decode_dispatch``, ``verify_dispatch``, ``copy_page_dispatch``,
``export_pages_dispatch``, ``import_pages_dispatch``, ``weight_swap``).
None of it adds a synchronisation or a launch to a warmed dispatch.
"""

import collections
import contextlib
import dataclasses
import logging
import statistics
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.models.transformer import _Linear, _pool_write_rows, pool_window_write
from zookeeper_tpu_torch.observability import ledger as _ledger
from zookeeper_tpu_torch.observability import peaks as _peaks
from zookeeper_tpu_torch.observability import recorder as _recorder
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.observability.registry import default_registry
from zookeeper_tpu_torch.parallel import distributed
from zookeeper_tpu_torch.parallel.shards import DecodeShard
from zookeeper_tpu_torch.serving import weights as _weights
from zookeeper_tpu_torch.serving.decode.cache import (
    allocate_kv_cache,
    kv_cache_bytes,
    pages_in_use,
)
from zookeeper_tpu_torch.serving.decode.pages import (
    PagePool,
    allocate_page_pool,
    page_pool_bytes,
)

__all__ = ["DecodeEngine"]

logger = logging.getLogger(__name__)

#: The dispatch kinds :func:`check_same_dispatch` compares.
_PREFILL, _DECODE, _WARM, _CHUNK, _VERIFY, _COPY = 1, 2, 3, 4, 5, 6


class _Dispatch:
    """A warm program's run: counts its dispatch when the body returns
    (a plain object, not a generator: the decode loop enters one a step)."""

    __slots__ = ("record",)

    def __init__(self, record) -> None:
        self.record = record

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.record.dispatches += 1
        return False


@component
class DecodeEngine:
    """KV-cache decode engine over a ``TransformerLMModule`` (``prefill``
    / ``decode_step`` / ``decode_step_paged``). Configure the slot array
    and buckets as Fields, then :meth:`bind` the module."""

    #: Concurrent sequence slots: the decode step's fixed batch.
    slots: int = Field(8)
    #: Prompt-length buckets of the prefill (ascending); a prompt rides
    #: the smallest that holds it, right-padded.
    seq_buckets: Sequence[int] = Field((16, 64))
    #: How many queued requests one prefill dispatch admits together.
    prefill_buckets: Sequence[int] = Field((1,))
    #: Per-slot KV capacity in tokens; -1 sizes it to the module's
    #: positional table. Rounded up to a ``page_size`` multiple.
    kv_capacity: int = Field(-1)
    #: KV page granularity (tokens).
    page_size: int = Field(16)
    #: Decode attention: "auto" or "kernel" (alias "pallas"). Either way
    #: a step calls the K12/K13 wrappers, which launch the kernel on a
    #: CUDA device (or raise) and run the plain oracle on the CPU; the
    #: resolved flavor reports "reference" for "auto" on the CPU.
    decode_attention: str = Field("auto")
    #: KV storage layout: "slots" (per-slot contiguous buffers) or "paged"
    #: (a shared page pool with per-slot page tables).
    kv_layout: str = Field("slots")
    #: Pool pages per layer (paged only); -1 = slots x capacity/page_size.
    pool_pages: int = Field(-1)
    #: Paged-pool rows: "none" (the compute dtype) or "int8" (with fp32
    #: per-(row, head) scales).
    kv_quant: str = Field("none")
    #: Radix prefix cache over prompt prefixes (paged only): a warm
    #: admission references the cached pages of its longest cached prefix
    #: and runs only its suffix (copy-on-write at a mid-page divergence,
    #: LRU eviction under pool pressure). Off: every admission is cold.
    prefix_cache: bool = Field(True)
    #: Chunked prefill (paged only): > 0 splits every admitted prompt into
    #: chunks of at most this many tokens, which the scheduler interleaves
    #: with decode steps under its token budget. 0: one prefill dispatch
    #: a prompt. At most the largest seq bucket.
    prefill_chunk_tokens: int = Field(0)
    #: Prefixes the engine's program keys in the program ledger (a
    #: speculative draft engine takes "draft_": ``draft_decode_step``).
    ledger_prefix: str = Field("")

    # -- binding ---------------------------------------------------------

    def bind(self, module: Any, partitioner: Any = None, device: Any = "cuda") -> "DecodeEngine":
        """Attach the LM module (moved to ``device``, eval mode) and
        allocate the cache there. ``partitioner`` (default: one card)
        serves under a training layout: every rank binds the same weights
        and holds its block of them and of the cache (see the module
        docstring)."""
        for method in ("prefill", "decode_step", "decode_step_paged", "decode_verify",
                       "decode_verify_paged"):
            if not hasattr(module, method):
                raise ValueError(
                    f"DecodeEngine needs a module with a {method!r} method "
                    f"(see TransformerLMModule); got {type(module).__name__}."
                )
        seq_buckets = tuple(int(s) for s in self.seq_buckets)
        if not seq_buckets or any(s < 1 for s in seq_buckets) or list(
            seq_buckets
        ) != sorted(set(seq_buckets)):
            raise ValueError(
                f"seq_buckets={self.seq_buckets!r} must be a non-empty, "
                "strictly-ascending tuple of positive lengths."
            )
        prefill_buckets = tuple(int(b) for b in self.prefill_buckets)
        if not prefill_buckets or any(b < 1 for b in prefill_buckets) or list(
            prefill_buckets
        ) != sorted(set(prefill_buckets)):
            raise ValueError(
                f"prefill_buckets={self.prefill_buckets!r} must be a "
                "non-empty, strictly-ascending tuple of positive sizes."
            )
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1.")
        if max(prefill_buckets) > self.slots:
            raise ValueError(
                f"largest prefill bucket {max(prefill_buckets)} exceeds "
                f"slots={self.slots}."
            )
        if self.page_size < 1:
            raise ValueError(f"page_size={self.page_size} must be >= 1.")
        position_cap = int(module.max_seq_len)
        if self.kv_capacity == -1:
            capacity = position_cap
        elif self.kv_capacity > 0:
            capacity = int(self.kv_capacity)
        else:
            raise ValueError(
                f"kv_capacity={self.kv_capacity}: expected a positive token "
                "capacity or -1 (size to the positional table)."
            )
        capacity = -(-capacity // self.page_size) * self.page_size
        if max(seq_buckets) > capacity:
            raise ValueError(
                f"largest seq bucket {max(seq_buckets)} exceeds the KV "
                f"capacity {capacity}; shrink the buckets or raise kv_capacity."
            )
        if max(seq_buckets) > position_cap:
            raise ValueError(
                f"largest seq bucket {max(seq_buckets)} exceeds the module's "
                f"positional table ({position_cap})."
            )
        if str(self.decode_attention) not in ("auto", "kernel", "pallas"):
            raise ValueError(
                f"decode_attention={self.decode_attention!r}: expected 'auto' "
                "or 'kernel' ('pallas')."
            )
        if str(self.kv_layout) not in ("slots", "paged"):
            raise ValueError(f"kv_layout={self.kv_layout!r}: expected 'slots' or 'paged'.")
        if str(self.kv_quant) not in ("none", "int8"):
            raise ValueError(f"kv_quant={self.kv_quant!r}: expected 'none' or 'int8'.")
        paged = str(self.kv_layout) == "paged"
        if not paged and str(self.kv_quant) != "none":
            raise ValueError(
                "kv_quant='int8' requires kv_layout='paged' (quantization "
                "lives with the page pool)."
            )
        chunk = int(self.prefill_chunk_tokens)
        if chunk < 0:
            raise ValueError(
                f"prefill_chunk_tokens={chunk}: expected 0 (monolithic prefill) or a "
                "positive chunk size in tokens."
            )
        if chunk > 0 and not paged:
            raise ValueError(
                "prefill_chunk_tokens requires kv_layout='paged' (chunks append "
                "through the page table; the slot layout always prefills "
                "monolithically). Set engine.kv_layout='paged' or prefill_chunk_tokens=0."
            )
        if chunk > max(seq_buckets):
            raise ValueError(
                f"prefill_chunk_tokens={chunk} exceeds the largest seq bucket "
                f"{max(seq_buckets)}: chunks ride the extend width grid; shrink the "
                "chunk or widen seq_buckets."
            )
        max_pages = capacity // int(self.page_size)
        if paged:
            if self.pool_pages == -1:
                num_pages = int(self.slots) * max_pages
            elif self.pool_pages > 0:
                num_pages = int(self.pool_pages)
            else:
                raise ValueError(
                    f"pool_pages={self.pool_pages}: expected a positive page "
                    "count or -1."
                )
            if num_pages < max_pages:
                raise ValueError(
                    f"pool_pages={num_pages} below capacity/page_size={max_pages}: "
                    "one full-capacity sequence could never be served."
                )
        else:
            num_pages = 0
        if partitioner is None:
            from zookeeper_tpu_torch.parallel.partitioner import SingleDevicePartitioner

            partitioner = SingleDevicePartitioner()
        partitioner.setup()
        device = distributed.local_device(device)
        module = module.to(device).eval()
        set_ = lambda name, value: object.__setattr__(self, name, value)  # noqa: E731
        set_("_module", module)
        set_("_device", device)
        set_("_partitioner", partitioner)
        set_("_plan", partitioner.plan_variables(module))
        set_("_shard", self._decode_shard(partitioner, module))
        set_("_cache_replicated", self._shard is not None and self._shard.replicated)
        set_("_seq_buckets", seq_buckets)
        set_("_prefill_buckets", prefill_buckets)
        set_("_capacity", capacity)
        set_("_position_cap", position_cap)
        set_("_paged", paged)
        set_("_num_pages", num_pages)
        set_("_max_pages", max_pages)
        set_("_pool", PagePool(num_pages=num_pages, page_size=int(self.page_size),
                               slots=int(self.slots), max_pages_per_slot=max_pages,
                               prefix_cache=bool(self.prefix_cache))
             if paged else None)
        set_("_cache", self._allocate_cache())
        itemsize = torch.empty((), dtype=module.dtype).element_size()
        if paged:
            nbytes = page_pool_bytes(int(module.num_layers), num_pages, int(self.page_size),
                                     int(module.num_heads), module.head_dim, itemsize,
                                     quant=str(self.kv_quant), shard=self._shard)
        else:
            nbytes = kv_cache_bytes(int(module.num_layers), int(self.slots), capacity,
                                    int(module.num_heads), module.head_dim, itemsize,
                                    shard=self._shard)
        set_("_cache_nbytes", nbytes)
        # Parameters a decode step reads once (the positional table only
        # at the slots' rows, counted with the K/V rows in _step_bytes):
        # the rank's blocks, or whole where FSDP gathers them.
        gathered = set() if self._plan is None else set(self._plan.gathered)
        set_("_weight_bytes", sum(
            (self._plan.numel(name, p) if name in gathered else p.numel()) * p.element_size()
            for name, p in module.named_parameters() if name != "pos"))
        set_("_swap_layout", None)  # the bound weights' trees, taken at the first swap
        set_("_decode_records", [])
        set_("_dispatches", collections.Counter())
        set_("_warmed", False)
        set_("_decode_attention_flavor",
             "reference" if str(self.decode_attention) == "auto" and device.type != "cuda"
             else "kernel")
        # The program ledger: rows by key, the warm-up scopes' depth, the
        # counted FLOPs per token (dense layers + the head) and per (query,
        # key) pair (every layer's heads on this rank).
        set_("_programs", {})
        set_("_key_prefix", str(self.ledger_prefix))
        set_("_kv_row_nbytes", self._kv_row_bytes())
        set_("_warming", 0)
        set_("_recompiles_detected", 0)
        linear = sum(
            (self._plan.numel(f"{name}.weight", m.weight) if f"{name}.weight" in gathered
             else m.weight.numel())
            for name, m in module.named_modules() if isinstance(m, _Linear))
        set_("_token_flops", 2 * linear + 2 * int(module.d_model) * int(module.vocab_size))
        heads = int(module.num_heads) if self._shard is None else \
            self._shard.local_heads(int(module.num_heads))
        set_("_pair_flops", 4 * module.head_dim * heads * int(module.num_layers))
        set_("_hbm_bandwidth", _peaks.reference_hbm_bandwidth(
            torch.cuda.get_device_name(device) if device.type == "cuda" else None)[0])
        _ledger.recompile_counter()
        reg = default_registry()
        reg.gauge("zk_decode_kv_bytes",
                  help="bytes provisioned for the decode KV cache (k+v, all layers, full "
                  "slot capacity or pool)").set(float(nbytes))
        # A handle: the gauge is set once per decode-path dispatch.
        set_("_mbu_gauge", reg.gauge(
            "zk_decode_mbu",
            help="last decode dispatch: the bytes it must read (weights, live K/V rows "
            "and scales) / wall time / HBM bandwidth (-1 = unknown)",
            initial=-1))
        return self

    def _require_bound(self) -> None:
        if getattr(self, "_module", None) is None:
            raise RuntimeError(
                "DecodeEngine is not bound: call engine.bind(module) before "
                "warmup()/prefill()/decode()."
            )

    def _decode_shard(self, partitioner, module) -> Optional[DecodeShard]:
        """This rank's block of the KV state (None without a mesh): slots
        over the data axes and heads over the model axis of
        ``decode_cache_axes``, the one derivation the sharded attention
        reads too. When slots do not divide the data-axis product (the
        slots of q, the lengths and the table split the same way in the
        paged layout) or heads the model axis, the cache replicates, with
        the JAX engine's warning."""
        mesh = partitioner.mesh
        if mesh is None:
            return None
        data_axes, model_axis = partitioner.decode_cache_axes()
        sizes = partitioner.mesh_sizes
        data_axes = tuple(a for a in data_axes if a in sizes)
        if model_axis is not None and model_axis not in sizes:
            model_axis = None
        data_size = int(np.prod([sizes[a] for a in data_axes])) if data_axes else 1
        model_size = sizes[model_axis] if model_axis is not None else 1
        slots, heads = int(self.slots), int(module.num_heads)
        if slots % data_size or heads % model_size:
            logger.warning(
                "KV cache [slots=%d, heads=%d] does not divide over the %s mesh (%s); "
                "decoding with a REPLICATED cache — size slots/heads in multiples of the "
                "mesh axes to shard", slots, heads, sizes,
                f"slots % {data_size} = {slots % data_size}, heads % {model_size} = "
                f"{heads % model_size}")
            return DecodeShard(mesh, data_axes, model_axis, replicated=True)
        return DecodeShard(
            mesh, data_axes, model_axis,
            data=partitioner.group_of(data_axes) if data_axes else None,
            heads=partitioner.group_of((model_axis,)) if model_axis is not None else None)

    def _allocate_cache(self):
        module = self._module
        if self._paged:
            return allocate_page_pool(int(module.num_layers), self._num_pages,
                                      int(self.page_size), int(module.num_heads),
                                      module.head_dim, module.dtype,
                                      quant=str(self.kv_quant), device=self._device,
                                      shard=self._shard)
        return allocate_kv_cache(int(module.num_layers), int(self.slots), self._capacity,
                                 int(module.num_heads), module.head_dim, module.dtype,
                                 device=self._device, shard=self._shard)

    # -- geometry and accounting ----------------------------------------

    @property
    def device(self) -> torch.device:
        self._require_bound()
        return self._device

    @property
    def cache(self):
        """The per-layer KV cache (slot buffers or pool dicts)."""
        self._require_bound()
        return self._cache

    @property
    def capacity(self) -> int:
        """Per-slot KV capacity in tokens (page-aligned)."""
        self._require_bound()
        return self._capacity

    @property
    def position_cap(self) -> int:
        self._require_bound()
        return self._position_cap

    @property
    def token_limit(self) -> int:
        """Hard per-sequence total-token bound (prompt + generated)."""
        return min(self.capacity, self.position_cap)

    @property
    def max_prompt(self) -> int:
        """Longest admissible prompt (the largest seq bucket)."""
        self._require_bound()
        return max(self._seq_buckets)

    @property
    def kv_cache_nbytes(self) -> int:
        """This rank's KV bytes (the whole cache on one card)."""
        self._require_bound()
        return self._cache_nbytes

    @property
    def decode_shard(self) -> Optional[DecodeShard]:
        """This rank's block of the KV state (None without a mesh)."""
        self._require_bound()
        return self._shard

    @property
    def cache_replicated(self) -> bool:
        """Whether the cache took the replicated fallback."""
        self._require_bound()
        return bool(self._cache_replicated)

    @property
    def paged(self) -> bool:
        self._require_bound()
        return bool(self._paged)

    @property
    def page_pool(self) -> Optional[PagePool]:
        """The host-side :class:`PagePool` (None in the slot layout)."""
        self._require_bound()
        return self._pool

    @property
    def decode_attention_flavor(self) -> str:
        """The resolved decode-attention flavor: "kernel", or "reference"
        for "auto" on the CPU."""
        self._require_bound()
        return self._decode_attention_flavor

    @property
    def decode_mbu(self) -> float:
        """Memory-bandwidth utilization of the decode steps so far: the
        median bytes a step must read (the weights once, plus every
        slot's live K/V rows, scales and positional row) over the median
        step wall time, over the card's HBM bandwidth
        (``observability.peaks``). The JAX engine takes its bytes from
        XLA's cost analysis, which the port has no counterpart of, so
        this counts them from the shapes. -1 when nothing was decoded or
        the engine runs on the CPU. ``zk_decode_mbu`` is the same ratio
        for the last dispatch alone (:meth:`decode_mbu_for`)."""
        records = getattr(self, "_decode_records", [])
        if not records or self._device.type != "cuda":
            return -1.0
        seconds = statistics.median(r[0] for r in records)
        nbytes = statistics.median(r[1] for r in records)
        return self.decode_mbu_for(seconds, nbytes=nbytes)

    def decode_mbu_for(self, seconds: float, program: str = "decode_step",
                       nbytes: Optional[float] = None) -> float:
        """MBU of a decode-path program at a given wall time: ``nbytes``
        (default: the bytes the ledger row of ``program`` — the
        ``ledger_prefix`` applied — counted at its first run) over
        ``seconds`` over the card's HBM bandwidth; -1 when an input is
        unknown (``ledger.mbu``'s totality contract: never raises). The
        bytes are those the dispatch must read (:meth:`_step_bytes`), so
        on a card that meets its data-sheet bandwidth the ratio stays at
        or below 1, where the JAX gauge's full-buffer bytes are an upper
        bound."""
        if nbytes is None:
            nbytes = _ledger.cost_bytes(
                getattr(self, "_programs", {}).get(getattr(self, "_key_prefix", "") + program))
        value = _ledger.mbu(nbytes, seconds, getattr(self, "_hbm_bandwidth", None))
        return float(value) if value is not None else -1.0

    def _observe_decode(self, seconds: float, nbytes: float) -> None:
        """Publish ``zk_decode_mbu`` for one completed, readback-bounded
        decode step or verify window (under speculation the verify window
        is the hot program). Host arithmetic only."""
        if seconds > 0:
            self._mbu_gauge.set(self.decode_mbu_for(seconds, nbytes=nbytes))

    @property
    def recompiles_detected(self) -> int:
        """Programs first run after ``warmup()`` outside a warm-up call
        (each one stalled every active stream)."""
        return getattr(self, "_recompiles_detected", 0)

    @property
    def compile_count(self) -> int:
        """Programs run at least once (the port's counterpart of the JAX
        engine's compiled executables)."""
        return len(getattr(self, "_programs", {}))

    @property
    def programs(self) -> dict:
        """This engine's ledger rows by key (``ledger_prefix`` applied)."""
        return dict(getattr(self, "_programs", {}))

    def _kv_row_bytes(self) -> int:
        """Bytes of one K (or V) row of one layer on this rank: the heads
        it holds, int8 rows with their fp32 scale per head. Taken once at
        bind (``_kv_row_nbytes``): the byte counts run every step."""
        module = self._module
        heads = int(module.num_heads)
        if self._shard is not None:
            heads = self._shard.local_heads(heads)
        if self._paged and str(self.kv_quant) == "int8":
            return heads * (module.head_dim + 4)
        return heads * module.head_dim * torch.empty((), dtype=module.dtype).element_size()

    def _rank_lengths(self, lengths: np.ndarray) -> np.ndarray:
        if self._shard is None:
            return lengths
        lo, hi = self._shard.slot_range(len(lengths))
        return lengths[lo:hi]

    def _step_bytes(self, lengths: np.ndarray, width: int = 1) -> int:
        """Bytes one decode step (``width`` 1) or verify window must read
        on this rank: weights, and per slot it runs its ``clamp(length) +
        width`` live K/V rows of the heads it holds (int8 rows with their
        fp32 scales), and its ``width`` positional rows."""
        module = self._module
        lengths = self._rank_lengths(lengths)
        rows = int(np.sum(np.minimum(np.clip(lengths, 0, self._capacity - 1) + width,
                                     self._capacity)))
        kv = 2 * int(module.num_layers) * rows * self._kv_row_nbytes
        return self._weight_bytes + kv + len(lengths) * width * int(module.d_model) * 4

    def _window_bytes(self, kv_rows: int, tokens: int) -> int:
        """Bytes a prefill or window dispatch must move: the weights once,
        ``kv_rows`` K/V rows of every layer read or written, and the
        positional rows of its ``tokens``."""
        module = self._module
        return (self._weight_bytes + 2 * int(module.num_layers) * kv_rows * self._kv_row_nbytes
                + tokens * int(module.d_model) * 4)

    def _page_bytes(self) -> int:
        """Bytes of one pool page over every layer's buffers (k, v and the
        int8 rows' scales) on this rank."""
        return sum(buf[0].numel() * buf.element_size()
                   for layer in self._cache for buf in layer.values())

    def _flops(self, tokens: int, pairs: int) -> int:
        """``2*M*N*K`` over the dense layers and the head for ``tokens``
        rows, plus ``4 * head_dim`` per (query, key) pair and head."""
        return tokens * self._token_flops + pairs * self._pair_flops

    @contextlib.contextmanager
    def _warmup_scope(self):
        """First runs inside are the warmed grid, not stalls."""
        object.__setattr__(self, "_warming", self._warming + 1)
        try:
            yield
        finally:
            object.__setattr__(self, "_warming", self._warming - 1)

    def _note_dispatch_compile(self, key: str) -> None:
        """A program's first run after ``warmup()``, on the dispatch path:
        counted (the classifier engine's series too), traced, logged and
        handed to the flight recorder — with continuous batching it stalls
        every active stream."""
        object.__setattr__(self, "_recompiles_detected", self._recompiles_detected + 1)
        _ledger.recompile_counter().inc()
        _trace.event("recompile_detected", attrs={"program": key})
        _recorder.notify("recompile_detected", attrs={"program": key})
        logger.warning(
            "post-warmup decode-engine first run on the dispatch path (%s): every "
            "active stream is stalling on it — warm the full bucket grid", key)

    def _program(self, key: str, flops, nbytes):
        """Run the body as program ``key`` (``ledger_prefix`` applied).
        Its first run is synchronised, timed and ledgered, ``flops()`` and
        ``nbytes()`` counted then (and only then); a first run after
        ``warmup()`` outside a warm-up scope is noted as a stall. A warm
        run only counts its dispatch, when the body returns."""
        key = self._key_prefix + key
        record = self._programs.get(key)
        if record is not None:
            return _Dispatch(record)
        return self._first_run(key, flops, nbytes)

    @contextlib.contextmanager
    def _first_run(self, key: str, flops, nbytes):
        if self._warmed and not self._warming:
            self._note_dispatch_compile(key)
        t0 = time.perf_counter()
        yield
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        compile_ms = (time.perf_counter() - t0) * 1e3
        mesh = "x".join(f"{k}:{v}" for k, v in self._partitioner.mesh_sizes.items()) or "1"
        record = _ledger.default_ledger().record(
            key.split("/")[0], f"{type(self._partitioner).__name__}/mesh={mesh}/{key}",
            flops=flops(), bytes_accessed=nbytes(), compile_ms=compile_ms,
            attrs={"slots": int(self.slots)})
        record.dispatches += 1
        self._programs[key] = record

    def kv_pages_in_use(self, lengths) -> int:
        """Occupancy: the allocator's count (paged), or ``sum(ceil(len /
        page_size))`` over the active slots' lengths (slots)."""
        if self._paged:
            return int(self._pool.used_pages)
        return pages_in_use(lengths, int(self.page_size))

    def seq_bucket_for(self, length: int) -> int:
        for s in self._seq_buckets:
            if s >= length:
                return s
        raise ValueError(
            f"prompt of {length} tokens exceeds the largest seq bucket "
            f"{max(self._seq_buckets)}; widen seq_buckets."
        )

    def prefill_bucket_for(self, n: int) -> int:
        for b in self._prefill_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"prefill group of {n} exceeds the largest prefill bucket "
            f"{max(self._prefill_buckets)}."
        )

    # -- page lifecycle (every method answers in both layouts) -----------

    def admit_slot(self, slot: int, prompt, *, copy: bool = True) -> Optional[dict]:
        """Allocate ``slot``'s pages for ``prompt``: the prefix-cache
        lookup, the table row and (``copy=True``) the copy-on-write of a
        mid-page divergence. Returns the plan ``{"shared_tokens": t,
        "cow": None}``, with the pending ``"cow": (src, dst)`` when
        ``copy=False`` (the scheduler runs :meth:`copy_page` itself), or
        None when the pool is exhausted (nothing allocated). The slot
        layout's plan is always cold."""
        if not self._paged:
            return {"shared_tokens": 0, "cow": None}
        plan = self._pool.assign_prompt(int(slot), prompt)
        if plan is None:
            return None
        if copy:
            cow = plan.pop("cow")
            if cow is not None:
                self.copy_page(*cow)
            plan["cow"] = None
        return plan

    def ensure_rows(self, slot: int, rows: int) -> bool:
        """Guarantee ``slot``'s pages cover ``rows`` KV rows before a
        step writes them; False when the pool is exhausted."""
        if not self._paged:
            return True
        return self._pool.ensure_rows(int(slot), int(rows))

    def release_slot(self, slot: int) -> None:
        """Stream finished or failed: drop the slot's page references
        (pages the prefix cache shares stay resident)."""
        if self._paged:
            self._pool.release_slot(int(slot))

    def insert_prefix(self, slot: int, prompt) -> int:
        """Cache the admitted prompt's pages for later warm hits (after
        the dispatch that wrote them). Returns the nodes created."""
        if not self._paged:
            return 0
        return self._pool.insert_prefix(int(slot), prompt)

    def invalidate_prefix_cache(self) -> int:
        """Drop every cached prefix page (a weight swap: the cached K/V
        is the old weights'). Returns the nodes dropped."""
        if not self._paged:
            return 0
        return self._pool.invalidate_prefix()

    def pool_status(self) -> Optional[dict]:
        return self._pool.status() if self._paged else None

    @property
    def dispatches(self) -> dict:
        """Dispatches so far by kind ("prefill", "prefill_warm",
        "prefill_chunk", "decode", "verify", "copy_page", "export_pages",
        "import_pages"), the warm-ups included: a prefill dispatch
        launches K9 once a layer, a decode step K12 (slots) or K13 (paged)
        once a layer; the other kinds launch no kernel."""
        return dict(self._dispatches)

    def _reset_cache(self) -> None:
        """Back to a freshly bound pool: every cache buffer zeroed in place
        and the host allocator reset (no page held, the trie dropped). The
        disaggregated scheduler's answer to a prefill role that died: its
        device state is gone wholesale, with nothing leaked."""
        with torch.inference_mode():
            for layer in self._cache:
                for buf in layer.values():
                    buf.zero_()
        if self._paged:
            self._pool.reset()

    # -- page transfer ---------------------------------------------------

    @property
    def transfer_width(self) -> int:
        """Pages of the largest transfer block: the pages a prompt of the
        largest seq bucket writes. Both roles of a transfer must agree
        on it."""
        self._require_bound()
        if not self._paged:
            raise RuntimeError(
                "page transfer is a paged-layout program; kv_layout='slots' has no "
                "page pool to export."
            )
        return self._pool.pages_for(max(self._seq_buckets))

    def warmup_transfer(self) -> None:
        """Run the export and import once before handoff traffic: page 0
        gathered and written back onto itself (the same bytes)."""
        with self._warmup_scope():
            self.import_pages(self.export_pages([0]), [0])

    def _transfer_ids(self, what: str, page_ids: Sequence[int]) -> torch.Tensor:
        w = self.transfer_width
        n = len(page_ids)
        if not 0 < n <= w:
            raise ValueError(f"{what} 1..{w} pages per block, got {n}.")
        return torch.as_tensor([int(p) for p in page_ids], dtype=torch.long,
                               device=self._device)

    def export_pages(self, page_ids: Sequence[int]) -> list:
        """Gather ``page_ids``'s pool pages into a transfer block: per
        layer ``{name: [n, page_size, ...]}`` over the pool's buffers (k,
        v, and the int8 rows' scales), on this engine's device. The pool
        is only read (pages the prefix cache shares may be read by
        another lane meanwhile)."""
        self._require_bound()
        ids = self._transfer_ids("export_pages moves", page_ids)
        n = len(page_ids)
        with self._program("gather_pages", lambda: 0, lambda: 2 * n * self._page_bytes()), \
                _trace.span("export_pages_dispatch",
                            attrs={"pages": n} if _trace.enabled() else None), \
                torch.inference_mode():
            block = [{name: buf.index_select(0, ids) for name, buf in layer.items()}
                     for layer in self._cache]
        self._dispatches["export_pages"] += 1
        return block

    def import_pages(self, block: list, page_ids: Sequence[int]) -> None:
        """Write a transferred ``block`` into this pool at ``page_ids``
        (from ``PagePool.adopt_slot``): the destination half of a
        handoff. ``block`` must already be on this engine's device (the
        caller, ``PageTransfer``, owns the move)."""
        self._require_bound()
        ids = self._transfer_ids("import_pages lands", page_ids)
        if len(block) != len(self._cache):
            raise ValueError(
                f"import_pages: a block of {len(block)} layers for a pool of "
                f"{len(self._cache)}."
            )
        n = len(page_ids)
        with self._program("scatter_pages", lambda: 0, lambda: 2 * n * self._page_bytes()), \
                _trace.span("import_pages_dispatch",
                            attrs={"pages": n} if _trace.enabled() else None), \
                torch.inference_mode():
            for layer, pages in zip(self._cache, block):
                for name, buf in layer.items():
                    buf.index_copy_(0, ids, pages[name])
        self._dispatches["import_pages"] += 1

    # -- hot swap --------------------------------------------------------

    def check_swap(self, params: Any, model_state: Any = None) -> None:
        """Validate a candidate weight set (export trees, ``{flax path:
        tensor}``) against the bound one, structure and leaf shapes and
        dtypes, without applying it. Raises ``ValueError`` on a
        mismatch."""
        self._require_bound()
        if self._swap_layout is None:
            object.__setattr__(self, "_swap_layout",
                               _weights.weight_layout(self._module, self._plan))
        _weights.check_swap(self._swap_layout, params, model_state,
                            "prefill/decode programs")

    def swap_weights(self, params: Any, model_state: Any = None) -> None:
        """Replace the decoded weights in place, with no rebind: the kernels
        keep their shapes and the cache its contents (see the module
        docstring for what a swap under in-flight streams means;
        ``DecodeScheduler.request_swap`` is the safe seam)."""
        self.check_swap(params, model_state)
        with _trace.span("weight_swap"):
            _weights.load_weights(self._module, self._plan, params, model_state)

    # -- dispatch --------------------------------------------------------

    def _weights(self):
        """The block one dispatch runs in: FSDP's gathered weights, freed
        after it (nothing to do without a plan)."""
        if self._plan is None:
            return contextlib.nullcontext()
        return self._plan.gathered_weights(self._module)

    @property
    def collective(self) -> bool:
        """Whether the engine's partitioner spans several ranks: every
        rank must then make the same dispatches."""
        return getattr(self, "_partitioner", None) is not None and \
            self._partitioner.process_span() > 1

    def _check_dispatch(self, kind: int, bucket: int, rows: int, *arrays) -> None:
        if self.collective:
            distributed.check_same_dispatch(
                (kind, bucket, rows, distributed.dispatch_checksum(*arrays)), "DecodeEngine")

    def warmup(self, prefill: bool = True, decode: bool = True) -> int:
        """Run every prefill bucket and one decode step once, and in the
        paged layout with the prefix cache or chunking every extend
        (bucket, width) pair, writing no live cache row: prefill outputs
        are discarded, the decode step writes only rows no stream owns,
        the extend rows are all masked. ``prefill=False`` or
        ``decode=False`` leaves out the dispatches a disaggregated role
        never makes (the decode role prefills nothing, the prefill role
        decodes nothing). Returns the number of dispatches run."""
        self._require_bound()
        runs = 0
        dev = self._device
        extend = self._paged and (bool(self.prefix_cache) or int(self.prefill_chunk_tokens) > 0)
        with torch.inference_mode(), self._warmup_scope():
            for pb in self._prefill_buckets if prefill else ():
                for sb in self._seq_buckets:
                    self._check_dispatch(_PREFILL, pb, sb)
                    tokens = torch.zeros((pb, sb), dtype=torch.int32, device=dev)
                    lengths = torch.ones((pb,), dtype=torch.int32, device=dev)
                    with self._prefill_program(pb, sb), self._weights():
                        last, _ = self._module.prefill(tokens, lengths)
                        torch.argmax(last, dim=-1).cpu()
                    self._dispatches["prefill"] += 1
                    runs += 1
                    if extend:
                        zeros = np.zeros((pb,), np.int32)
                        self._check_dispatch(_WARM, pb, sb)
                        self._extend_dispatch("prefill_warm", np.zeros((pb, sb), np.int32),
                                              zeros, np.full((pb, self._max_pages), -1, np.int32),
                                              zeros, zeros)
                        runs += 1
            if decode:
                n = int(self.slots)
                self._check_dispatch(_DECODE, n, 0)
                self._slots_dispatch("decode", np.zeros(n, np.int32), np.zeros(n, np.int32))
                runs += 1
            if self._paged:
                # Page 0 onto itself: the same bytes.
                self.copy_page(0, 0)
                runs += 1
        object.__setattr__(self, "_warmed", True)
        return runs

    def warmup_verify(self, width: int) -> None:
        """Run one verify window of ``width`` before traffic (a
        speculative bind warms the teacher's ``k + 1`` and the draft's
        catch-up width). Writes rows that no stream owns yet: call it
        before serving."""
        self._require_bound()
        n = int(self.slots)
        with self._warmup_scope():
            self.verify(np.zeros((n, int(width)), np.int32), np.zeros(n, np.int32))

    def _prefill_program(self, pb: int, sb: int):
        """The ``(pb, sb)`` prefill's program: K9 over the causal bucket,
        its K/V rows written."""
        return self._program(f"prefill/b{pb}s{sb}",
                             lambda: self._flops(pb * sb, pb * sb * (sb + 1) // 2),
                             lambda: self._window_bytes(pb * sb, pb * sb))

    def prefill(self, prompts: Sequence[np.ndarray], slot_ids: Sequence[int]) -> np.ndarray:
        """Admit a group: write each prompt's K/V into its slot (or its
        pages) and return each sequence's first token as a host ``[n]``
        int32 array. Under a partitioner every rank runs the whole group
        and writes the rows it holds."""
        self._require_bound()
        n = len(prompts)
        if n == 0:
            return np.zeros((0,), np.int32)
        if n != len(set(int(s) for s in slot_ids)) or n != len(slot_ids):
            raise ValueError(
                f"slot_ids {list(slot_ids)!r} must be unique and match the {n} prompts."
            )
        lens = [int(np.shape(p)[0]) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt is not servable.")
        pb = self.prefill_bucket_for(n)
        sb = self.seq_bucket_for(max(lens))
        tokens = np.zeros((pb, sb), np.int32)
        lengths = np.ones((pb,), np.int32)  # padding rows: length 1, dropped
        for i, p in enumerate(prompts):
            tokens[i, : lens[i]] = np.asarray(p, np.int32)
            lengths[i] = lens[i]
        self._check_dispatch(_PREFILL, pb, sb, [int(s) for s in slot_ids], lens)
        dev = self._device
        with self._prefill_program(pb, sb), _trace.span(
                "prefill_dispatch", attrs={"requests": n, "bucket": pb, "seq_bucket": sb}
                if _trace.enabled() else None), torch.inference_mode():
            with self._weights():
                last, kv = self._module.prefill(torch.from_numpy(tokens).to(dev),
                                                torch.from_numpy(lengths).to(dev))
            kv = self._cache_heads(kv)
            if self._paged:
                self._write_prefill_pages(kv, lengths, slot_ids, pb, sb)
            else:
                # Slots: rows [0, sb) of each real row's slot, padding
                # included; padding rows of a partial group write nowhere;
                # under a data split a rank writes the slots it holds.
                lo, hi = (0, int(self.slots)) if self._shard is None else \
                    self._shard.slot_range(int(self.slots))
                own = [(i, int(s) - lo) for i, s in enumerate(slot_ids) if lo <= int(s) < hi]
                if own:
                    rows = torch.as_tensor([i for i, _ in own], device=dev)
                    ids = torch.as_tensor([s for _, s in own], device=dev)
                    for layer, (k, v) in zip(self._cache, kv):
                        layer["k"][ids, :sb] = k[rows]
                        layer["v"][ids, :sb] = v[rows]
            first = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        self._dispatches["prefill"] += 1
        return first[:n].astype(np.int32)

    def _cache_heads(self, kv):
        """Each layer's prefill K/V in the cache's head layout (a slice or
        a gather of heads, see ``models.transformer.relay_heads``)."""
        if self._shard is None:
            return kv
        from zookeeper_tpu_torch.models.transformer import relay_heads

        return tuple((relay_heads(k, block._tp_attn, self._shard.heads),
                      relay_heads(v, block._tp_attn, self._shard.heads))
                     for block, (k, v) in zip(self._module.blocks, kv))

    def _write_prefill_pages(self, kv, lengths: np.ndarray, slot_ids, pb: int, sb: int) -> None:
        """Scatter each prompt row through its slot's table row: position
        ``j`` lands at ``(table[slot, j // page_size], j % page_size)``.
        Rows past the true length, unallocated entries and padding rows
        take the out-of-range page and write nowhere."""
        ps = int(self.page_size)
        table = np.full((pb, self._max_pages), -1, np.int32)
        for i, s in enumerate(slot_ids):
            table[i] = self._pool.table[int(s)]
        j = np.arange(sb)
        pages = table[:, np.clip(j // ps, 0, self._max_pages - 1)]  # [pb, sb]
        dead = (j[None, :] >= lengths[:, None]) | (pages < 0)
        pages = np.where(dead, self._num_pages, pages)
        offsets = np.broadcast_to(j % ps, pages.shape)
        pages_t = torch.from_numpy(pages.astype(np.int64)).to(self._device)
        offsets_t = torch.from_numpy(np.array(offsets, np.int64)).to(self._device)
        for layer, (k, v) in zip(self._cache, kv):
            _pool_write_rows(layer, {"k": k, "v": v}, pages_t, offsets_t)

    def _require_paged(self, what: str) -> None:
        self._require_bound()
        if not self._paged:
            raise RuntimeError(
                f"{what} is a paged-layout dispatch; the slot layout always runs the "
                "cold, monolithic prefill."
            )

    def prefill_warm(self, prompts: Sequence[np.ndarray], slot_ids: Sequence[int],
                     shared_lens: Sequence[int]) -> np.ndarray:
        """Warm-prefix admission (paged): each prompt's first
        ``shared_lens[i]`` tokens are resident in its slot's (shared)
        pages, so only the suffix runs, in one window dispatch at the
        smallest seq bucket holding the longest suffix. Returns each
        request's first token, as :meth:`prefill` does."""
        self._require_paged("prefill_warm")
        n = len(prompts)
        if n == 0:
            return np.zeros((0,), np.int32)
        suffixes = [int(np.shape(p)[0]) - int(sh) for p, sh in zip(prompts, shared_lens)]
        if min(suffixes) < 1:
            raise ValueError(
                "warm prefill needs >= 1 suffix token per prompt (the prefix match is "
                "capped at len - 1 so the first emission's logits exist)."
            )
        windows = [np.asarray(p, np.int32)[int(sh):] for p, sh in zip(prompts, shared_lens)]
        return self._extend(_WARM, "prefill_warm", windows, slot_ids, shared_lens)

    def prefill_chunk(self, chunks: Sequence[np.ndarray], slot_ids: Sequence[int],
                      offsets: Sequence[int]) -> np.ndarray:
        """Chunked-prefill append (paged): write lane ``i``'s ``chunks[i]``
        rows at positions ``offsets[i]..`` of its slot through its table
        row, each attending the committed rows below its offset (earlier
        chunks or prefix-cache pages). Returns the argmax at each chunk's
        last position: the first emission on a prompt's final chunk,
        discarded otherwise. Every row is written once with its full
        causal context, so the tokens are the monolithic prefill's."""
        self._require_paged("prefill_chunk")
        n = len(chunks)
        if n == 0:
            return np.zeros((0,), np.int32)
        if min(int(np.shape(c)[0]) for c in chunks) < 1:
            raise ValueError(
                "prefill_chunk needs >= 1 token per lane (the planner skips empty chunks)."
            )
        return self._extend(_CHUNK, "prefill_chunk", [np.asarray(c, np.int32) for c in chunks],
                            slot_ids, offsets)

    def _extend(self, kind: int, name: str, windows, slot_ids, starts) -> np.ndarray:
        """One window dispatch over a group: lane ``i``'s ``windows[i]``
        at positions ``starts[i]..`` of slot ``slot_ids[i]``, padded to the
        (prefill bucket, seq bucket) grid; padding rows and lanes write
        nowhere."""
        n = len(windows)
        lens = [int(w.shape[0]) for w in windows]
        pb = self.prefill_bucket_for(n)
        w = self.seq_bucket_for(max(lens))
        tokens = np.zeros((pb, w), np.int32)
        lengths = np.zeros((pb,), np.int32)
        valid = np.zeros((pb,), np.int32)  # padding lanes: no valid row
        rows = np.full((pb, self._max_pages), -1, np.int32)
        for i, (win, s, start) in enumerate(zip(windows, slot_ids, starts)):
            tokens[i, : lens[i]] = win
            lengths[i] = int(start)
            valid[i] = lens[i]
            rows[i] = self._pool.table[int(s)]
        out_idx = np.maximum(valid - 1, 0)
        self._check_dispatch(kind, pb, w, [int(s) for s in slot_ids], list(starts), lens)
        with torch.inference_mode():
            first = self._extend_dispatch(name, tokens, lengths, rows, valid, out_idx)
        return first[:n].astype(np.int32)

    def _extend_dispatch(self, name: str, tokens, lengths, rows, valid, out_idx) -> np.ndarray:
        """Run a padded window group through ``decode_verify_paged`` and
        return the argmax at each lane's ``out_idx``. Every rank runs the
        whole group (no data split) and writes its heads of every row.
        Warm and chunked prefill share the ``prefill_extend/b{pb}w{w}``
        programs."""
        dev = self._device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        shard = None if self._shard is None else dataclasses.replace(self._shard, data=None)
        pb, w = tokens.shape
        span = None
        if _trace.enabled():
            lanes = int(np.count_nonzero(valid))
            span = ({"requests": lanes, "bucket": pb, "width": w} if name == "prefill_warm"
                    else {"lanes": lanes, "bucket": pb, "width": w, "tokens": int(valid.sum())})
        v, st = valid.astype(np.int64), lengths.astype(np.int64)

        def flops():
            # Lane i's row j (of v[i]) attends st[i] + j + 1 keys.
            return self._flops(pb * w, int(np.sum(v * (st + 1) + v * (v - 1) // 2)))

        with self._program(f"prefill_extend/b{pb}w{w}", flops,
                           lambda: self._window_bytes(int(np.sum(st + v)), pb * w)), \
                _trace.span(f"{name}_dispatch", attrs=span):
            with self._weights():
                logits, _ = self._module.decode_verify_paged(t(tokens), t(lengths), self._cache,
                                                             t(rows), valid=t(valid), shard=shard)
            last = logits[torch.arange(tokens.shape[0], device=dev), t(out_idx).long()]
            first = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        self._dispatches[name] += 1
        return first

    def copy_page(self, src: int, dst: int) -> None:
        """The copy-on-write of one pool page, before the dispatch that
        writes into ``dst``: every layer's k/v rows (and int8 scales) of
        page ``src`` into page ``dst`` (a rank copies the heads it
        holds)."""
        self._require_paged("copy_page")
        self._check_dispatch(_COPY, int(src), int(dst))
        with self._program("copy_page", lambda: 0, lambda: 2 * self._page_bytes()), \
                _trace.span("copy_page_dispatch", attrs={"src": int(src), "dst": int(dst)}
                            if _trace.enabled() else None), torch.inference_mode():
            for layer in self._cache:
                for buf in layer.values():
                    buf[int(dst)] = buf[int(src)]
        self._dispatches["copy_page"] += 1

    def decode(self, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """One token for every slot: feed each slot's current token (at
        position ``lengths[slot]``), write its K/V, and return the argmax
        next token per slot as a host ``[slots]`` int32 array."""
        self._require_bound()
        tokens = np.asarray(tokens, np.int32)
        lengths = np.asarray(lengths, np.int32)
        n = int(self.slots)
        if tokens.shape != (n,) or lengths.shape != (n,):
            raise ValueError(
                f"decode expects [slots]={n} token and length arrays, got "
                f"{tokens.shape} / {lengths.shape}."
            )
        self._check_dispatch(_DECODE, n, 0, tokens, lengths)
        t0 = time.perf_counter()
        with torch.inference_mode():
            nxt = self._slots_dispatch("decode", tokens, lengths)
        # Readback-bounded wall time: the dispatch ends in a copy to the
        # host, which waits for the card.
        seconds, nbytes = time.perf_counter() - t0, self._step_bytes(lengths)
        self._decode_records.append((seconds, nbytes))
        self._observe_decode(seconds, nbytes)
        return nxt

    def verify(self, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """``w`` tokens for every slot in one dispatch: token ``j`` of a
        slot's window sits at position ``lengths[slot] + j``; all ``w``
        K/V rows are appended. Returns the argmax next token at each
        position as a host ``[slots, w]`` int32 array (``out[s, j]``:
        after consuming input ``j``). The caller owns the rollback: only
        the lengths it advances count. Active slots must satisfy
        ``lengths + w <= capacity`` (the scheduler's check); inactive
        ones ride along and are ignored."""
        self._require_bound()
        tokens = np.asarray(tokens, np.int32)
        lengths = np.asarray(lengths, np.int32)
        n = int(self.slots)
        if tokens.ndim != 2 or tokens.shape[0] != n or lengths.shape != (n,):
            raise ValueError(
                f"verify expects [slots={n}, w] tokens and [slots] lengths, got "
                f"{tokens.shape} / {lengths.shape}."
            )
        w = int(tokens.shape[1])
        if not 1 <= w <= self._capacity:
            raise ValueError(
                f"verify width {w} must be in [1, {self._capacity}] (the KV capacity); "
                "shrink speculative.k or raise kv_capacity."
            )
        self._check_dispatch(_VERIFY, n, w, tokens.reshape(-1), lengths)
        t0 = time.perf_counter()
        with torch.inference_mode():
            nxt = self._slots_dispatch("verify", tokens, lengths)
        self._observe_decode(time.perf_counter() - t0, self._step_bytes(lengths, width=w))
        return nxt

    def _slots_dispatch(self, name: str, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """A decode step (``tokens [slots]``) or a verify window
        (``tokens [slots, w]``) over the slot array; under a data split
        each rank runs its slots and the next tokens are gathered."""
        dev = self._device
        shard = self._shard
        window = tokens.ndim == 2
        w = tokens.shape[1] if window else 1
        lo, hi = (0, len(tokens)) if shard is None else shard.slot_range(len(tokens))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        tok_t, len_t = t(tokens[lo:hi]), t(lengths[lo:hi])
        module = self._module

        def flops():
            live = np.clip(lengths[lo:hi].astype(np.int64), 0, self._capacity - 1) + 1
            return self._flops((hi - lo) * w, int(np.sum(w * live)) + (hi - lo) * w * (w - 1) // 2)

        program = self._program(f"verify_step/w{w}" if window else "decode_step", flops,
                                lambda: self._step_bytes(lengths, width=w))
        span = _trace.span(f"{name}_dispatch", attrs=(
            {"slots": int(self.slots), "width": w} if window else {"slots": int(self.slots)})
            if _trace.enabled() else None)
        with program, span, self._weights():
            if self._paged:
                table = np.ascontiguousarray(self._pool.table)
                table_t = t(table[lo:hi])
                # Under a data split every data rank's pool copy takes every
                # slot's rows: their write comes from the whole table.
                write = None if shard is None or shard.data is None else pool_window_write(
                    t(table), t(lengths), tokens.shape[1] if window else 1, int(self.page_size))
                if window:
                    logits, _ = module.decode_verify_paged(tok_t, len_t, self._cache, table_t,
                                                           shard=shard, write=write)
                else:
                    logits, _ = module.decode_step_paged(tok_t, len_t, self._cache, table_t,
                                                         shard, write)
            elif window:
                logits, _ = module.decode_verify(tok_t, len_t, self._cache, shard)
            else:
                logits, _ = module.decode_step(tok_t, len_t, self._cache, shard)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if shard is not None:
                nxt = shard.gather_slots(nxt)
            nxt = nxt.cpu().numpy()
        self._dispatches[name] += 1
        return nxt
