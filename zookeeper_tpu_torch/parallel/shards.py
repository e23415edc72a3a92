"""Sharded parameters over ``torch.distributed``: FSDP and tensor parallelism.

In the JAX package a partition rule gives each leaf of the state a
``NamedSharding`` and GSPMD inserts every collective. The port has no
compiler to do that, so this module does it explicitly, one process per
card. :func:`plan_state` matches the rules against the flax path of each
tensor of a module (``models.convert.flax_state_layouts``), maps each
spec from flax dimensions onto the port's, and returns a
:class:`ShardPlan`; :meth:`ShardPlan.apply` keeps only this rank's
block of every sharded tensor: the parameter, its optimizer state (Adam
``mu``/``nu``, Bop's memory, the trace, the accumulated gradients) and
its EMA copy, which therefore co-shard with it.

A sharded tensor is used in one of two ways:

- **local**: its layer computes on the shard (tensor parallelism). A
  layer declares the layouts it can compute on
  (``tensor_parallel_forms``): the transformer block's column-parallel
  ``qkv``/``up`` and row-parallel ``proj``/``down`` over a model axis,
  the conv zoo's convs, denses and BatchNorms on their output features.
  The plan hands such a layer a :class:`TensorParallel` (its model group)
  when every tensor of the form has exactly that layout and the heads,
  hidden units or channels divide the axis. The local ``qkv`` shard is
  head-aligned: rank r holds the q, k and v rows of its own heads, where
  JAX's ``P(None, "model")`` is a contiguous split of the 3d columns;
  whatever is gathered comes back in the global order.
- **gathered** (ZeRO-3): every other sharded parameter (each
  ``auto_fsdp_rules`` shard, any rule a layer has no local form for) is
  all-gathered before the forward and its gradient reduce-scattered back
  (or averaged and cut, when its axes are not the replica axes). That
  gives the values GSPMD gives for any spec.

A dimension that does not divide its axes replicates (GSPMD would pad
it; the values are the same), and so does a buffer whose layer does not
compute locally (in an inference plan, :func:`plan_inference`, a buffer
under ``params/``, a packed kernel, is gathered on use like a
parameter). Whole-tensor reductions over a sharded tensor (norms,
counts) are completed over its group (:meth:`ShardPlan.whole_sums`).
Every collective is posted in the same order on every rank: parameters
in module order, groups in mesh-axis order.

Serving: :func:`plan_inference` is the plan of a module with no
optimizer state and no EMA (``ShardPlan.apply_module``), and
:class:`DecodeShard` is how a decode engine's KV cache or page pool lies
over the mesh for one rank: slots over the data axes, heads over the
model axis (``parallel.rules.decode_cache_rules``/``page_pool_rules``),
with the local shapes a rank allocates.
"""

import contextlib
import itertools
from dataclasses import dataclass
from math import prod
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from zookeeper_tpu_torch.parallel.rules import PartitionRule, spec_for

#: Per-parameter optimizer-state keys (their ``{name: tensor}`` dicts
#: co-shard with the parameters); ``models.convert``'s list.
_PER_PARAM = ("mu", "nu", "trace", "gradient_memory", "acc_grads")


# -- the mesh's groups ------------------------------------------------------


class MeshGroups:
    """The ranks of a row-major mesh ``{axis: size}`` and the process group
    of every subset of its axes: the ranks that share this rank's
    coordinates on the other axes. A group is made the first time it is
    asked for, as ``dist.new_group`` of every such class in row-major order,
    which every rank must do at the same point (it does: the same program
    asks for the same groups); a class that spans every rank is the world
    group."""

    def __init__(self, sizes: Dict[str, int], rank: int):
        self.sizes = dict(sizes)
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], Any] = {}

    def coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for axis in reversed(list(self.sizes)):
            out[axis] = rank % self.sizes[axis]
            rank //= self.sizes[axis]
        return {a: out[a] for a in self.sizes}

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for axis, size in self.sizes.items():
            r = r * size + coords[axis]
        return r

    def key(self, axes: Iterable[str]) -> Tuple[str, ...]:
        axes = set(axes)
        unknown = axes - set(self.sizes)
        if unknown:
            raise ValueError(f"Axes {sorted(unknown)} are not mesh axes {tuple(self.sizes)}.")
        return tuple(a for a in self.sizes if a in axes)

    def _classes(self, key: Tuple[str, ...]) -> List[List[int]]:
        others = [a for a in self.sizes if a not in key]
        classes = []
        for fixed in itertools.product(*(range(self.sizes[a]) for a in others)):
            base = dict(zip(others, fixed))
            ranks = [self._rank_of({**base, **dict(zip(key, inner))})
                     for inner in itertools.product(*(range(self.sizes[a]) for a in key))]
            classes.append(sorted(ranks))
        return classes

    def members(self, axes: Iterable[str]) -> List[int]:
        """The global ranks of this rank's group over ``axes``, in group
        rank order."""
        for ranks in self._classes(self.key(axes)):
            if self.rank in ranks:
                return ranks
        raise AssertionError("rank outside the mesh")

    def group(self, axes: Iterable[str]) -> Any:
        key = self.key(axes)
        if key not in self._groups:
            classes = self._classes(key)
            if len(classes) == 1:
                mine = dist.group.WORLD
            else:
                mine = None
                for ranks in classes:
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
            self._groups[key] = mine
        return self._groups[key]

    def size(self, axes: Iterable[str]) -> int:
        return prod(self.sizes[a] for a in self.key(axes))


# -- the model group's collectives (autograd-aware) --------------------------


@dataclass(frozen=True)
class TensorParallel:
    """A layer's model group: the ranks that hold the other shards of its
    tensors (``group``, ``size`` of them), and this rank's shard
    ``index``."""

    group: Any
    index: int
    size: int


def all_gather_stack(x: torch.Tensor, group: Any, size: int) -> torch.Tensor:
    """``[size, *x.shape]``: every member's ``x``, in group rank order. The
    bytes are gathered (every backend gathers uint8; gloo has no
    bfloat16)."""
    x = x.contiguous()
    out = torch.empty((size * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out.view(torch.uint8), x.reshape(-1).view(torch.uint8),
                                group=group)
    return out.view(size, *x.shape)


def _gather_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    stacked = all_gather_stack(x, tp.group, tp.size)
    return stacked.movedim(0, -2).reshape(*x.shape[:-1], tp.size * x.shape[-1])


def _own_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    c = x.shape[-1] // tp.size
    return x.narrow(-1, tp.index * c, c)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the members' partial input
    gradients in float32 (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.float().contiguous().clone()
        dist.all_reduce(out, group=ctx.tp.group)
        return out.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Sums the members' partial outputs in float32 (Megatron's ``g``);
    identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        out = x.float().contiguous().clone()
        dist.all_reduce(out, group=tp.group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gathers the last dimension's shards; the backward keeps this
    rank's channels (the cotangent is the same on every member)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_last(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _own_last(grad, ctx.tp), None


class _SplitChannels(torch.autograd.Function):
    """This rank's channels of a whole tensor; the backward all-gathers
    the members' channel gradients."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_last(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.tp), None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_channels(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _GatherChannels.apply(x, tp)


def split_channels(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _SplitChannels.apply(x, tp)


# -- layouts ------------------------------------------------------------------


@dataclass(frozen=True)
class Layout:
    """How one tensor of the state lies over the mesh: its global shape;
    per port dimension the axes it is split over (major first) and its
    interleave ``k`` (the dimension read as ``[k, members, rest]``, each
    member holding ``[k, rest]``: 3 for the head-aligned ``qkv``, else 1);
    and whether its layer computes on the shard (``local``)."""

    shape: Tuple[int, ...]
    dims: Tuple[Tuple[Tuple[str, ...], int], ...]
    local: bool = False

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for axes, _ in self.dims for a in axes)

    def box(self, coords: Dict[str, int],
            sizes: Dict[str, int]) -> Tuple[List[int], List[List[int]]]:
        """The block ``coords`` holds, as a box: ``(view, index)``, the
        view of the global shape in which the block is one box (a dimension
        of interleave k > 1 read as ``[k, members, rest]``) and the box's
        ``[start, stop]`` in each view dimension."""
        view: List[int] = []
        index: List[List[int]] = []
        for n, (axes, k) in zip(self.shape, self.dims):
            if not axes:
                view.append(n)
                index.append([0, n])
                continue
            count = prod(sizes[a] for a in axes)
            i = _block_index(axes, coords, sizes)
            if k == 1:
                m = n // count
                view.append(n)
                index.append([i * m, (i + 1) * m])
            else:
                rest = n // (k * count)
                view += [k, count, rest]
                index += [[0, k], [i, i + 1], [0, rest]]
        return view, index


def _block_index(axes: Sequence[str], coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    index = 0
    for a in axes:
        index = index * sizes[a] + coords[a]
    return index


def _block(t: torch.Tensor, layout: Layout, coords: Dict[str, int],
           sizes: Dict[str, int]) -> torch.Tensor:
    """A view of the block ``coords`` holds of the global tensor ``t``
    (:meth:`Layout.box`), each sharded dimension of interleave k > 1 left
    as ``[k, rest]``."""
    view, index = layout.box(coords, sizes)
    t = t.reshape(view)[tuple(slice(a, b) for a, b in index)]
    dim = 0
    for axes, k in layout.dims:
        if axes and k > 1:
            t = t.squeeze(dim + 1)  # the member dimension, one wide
            dim += 2
        else:
            dim += 1
    return t


def _unfold(local: torch.Tensor, layout: Layout) -> torch.Tensor:
    """A shard in :func:`_block`'s view shape."""
    for dim in reversed(range(len(layout.dims))):
        axes, k = layout.dims[dim]
        if axes and k > 1:
            local = local.unflatten(dim, (k, -1))
    return local


def _port_dims(spec, axes_map: Tuple[int, ...], ndim: int) -> List[Tuple[str, ...]]:
    """A spec over flax dimensions as axes per port dimension."""
    out: List[Tuple[str, ...]] = [()] * ndim
    if len(spec) > ndim:
        raise ValueError(f"PartitionSpec {spec} has more entries than the tensor's {ndim} dims.")
    for flax_dim, entry in enumerate(spec):
        if entry is None:
            continue
        out[axes_map[flax_dim]] = (entry,) if isinstance(entry, str) else tuple(entry)
    return out


class ShardPlan:
    """Which tensors of a module's state are sharded and how
    (:class:`Layout` by ``state_dict`` name), and the collectives that
    move them. Built by :func:`plan_state`; see the module docstring."""

    def __init__(self, layouts: Dict[str, Layout], params: Sequence[str], mesh: MeshGroups,
                 replica_axes: Sequence[str]):
        self.layouts = layouts
        self.mesh = mesh
        self.replica_axes = mesh.key(replica_axes)
        self.coords = mesh.coords(mesh.rank)
        #: The parameters gathered on use, in module order.
        self.gathered = [n for n in params if n in layouts and not layouts[n].local]

    # -- one tensor --

    def local_shape(self, name: str) -> Tuple[int, ...]:
        layout = self.layouts[name]
        return tuple(n // prod(self.mesh.sizes[a] for a in axes) if axes else n
                     for n, (axes, _) in zip(layout.shape, layout.dims))

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``full`` of ``name`` (a
        contiguous copy; ``full`` itself when ``name`` is not sharded)."""
        layout = self.layouts.get(name)
        if layout is None:
            return full
        if tuple(full.shape) != layout.shape:
            raise ValueError(f"{name}: expected the global shape {layout.shape}, "
                             f"got {tuple(full.shape)}.")
        block = _block(full, layout, self.coords, self.mesh.sizes)
        return block.reshape(self.local_shape(name)).clone(memory_format=torch.contiguous_format)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The global tensor of ``name`` from every member's block (one
        all-gather over its axes); ``local`` itself when not sharded."""
        layout = self.layouts.get(name)
        if layout is None:
            return local
        members = self.mesh.members(layout.axes)
        stacked = all_gather_stack(local, self.mesh.group(layout.axes), len(members))
        full = torch.empty(layout.shape, dtype=local.dtype, device=local.device)
        for rank, chunk in zip(members, stacked):
            _block(full, layout, self.mesh.coords(rank), self.mesh.sizes).copy_(
                _unfold(chunk, layout))
        return full

    def _reduce_scatter(self, name: str, full: torch.Tensor) -> torch.Tensor:
        layout = self.layouts[name]
        members = self.mesh.members(layout.axes)
        stacked = torch.stack([
            _block(full, layout, self.mesh.coords(r), self.mesh.sizes).reshape(
                self.local_shape(name)) for r in members])
        out = torch.empty(self.local_shape(name), dtype=full.dtype, device=full.device,
                          memory_format=torch.contiguous_format)
        dist.reduce_scatter_tensor(out.view(-1), stacked.contiguous().view(-1),
                                   group=self.mesh.group(layout.axes))
        return out

    # -- the train step --

    def gather_params(self, tensors: Dict[str, torch.Tensor],
                      requires_grad: bool = False) -> Dict[str, torch.Tensor]:
        """``{name: global tensor}`` of the gathered parameters among
        ``tensors`` (parameters or their EMA), as leaves that require grad
        when asked."""
        out = {}
        with torch.no_grad():
            for name in self.gathered:
                if name in tensors:
                    out[name] = self.gather(name, tensors[name].detach())
        if requires_grad:
            for t in out.values():
                t.requires_grad_(True)
        return out

    @contextlib.contextmanager
    def swapped(self, module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
        """Inside the block the module's parameters (or buffers)
        ``tensors`` (by name) are the given tensors; the shards are put
        back after it."""
        saved = []
        try:
            for name, t in tensors.items():
                prefix, _, leaf = name.rpartition(".")
                owner = module.get_submodule(prefix)
                slot = owner._parameters if leaf in owner._parameters else owner._buffers
                saved.append((slot, leaf, slot[leaf]))
                slot[leaf] = t
            yield
        finally:
            for slot, leaf, p in reversed(saved):
                slot[leaf] = p

    @contextlib.contextmanager
    def gathered_weights(self, module: torch.nn.Module):
        """An inference dispatch under this plan: every gathered tensor is
        all-gathered for the block and freed after it, so between
        dispatches the rank holds only its blocks (no-op when nothing is
        gathered)."""
        if not self.gathered:
            yield
            return
        tensors = dict(module.state_dict(keep_vars=True))
        with self.swapped(module, self.gather_params(tensors)):
            yield

    def reduce_gradients(self, grads: Dict[str, torch.Tensor], extra: Sequence[torch.Tensor],
                         replicas: Any) -> None:
        """Turn each rank's gradients into this rank's block of their mean
        over the replica ranks, in place: the gradients of replicated and
        local parameters (and ``extra``, the loss) are averaged by
        ``replicas`` (None: one rank); a gathered parameter's global
        gradient is reduce-scattered over its axes and divided by their
        size when they are the replica axes, else averaged with the rest
        and cut to this rank's block."""
        scatter = [n for n in self.gathered if self.mesh.key(self.layouts[n].axes)
                   == self.replica_axes]
        averaged = [g for n, g in grads.items() if n not in scatter] + list(extra)
        if replicas is not None:
            replicas.mean_(averaged)
        for name in self.gathered:
            if name in scatter:
                out = self._reduce_scatter(name, grads[name])
                size = float(self.mesh.size(self.layouts[name].axes))
                grads[name] = out.div_(size)
            else:
                grads[name] = self.shard(name, grads[name])

    def whole_sums(self, values: Sequence[torch.Tensor], names: Sequence[str]) -> List[torch.Tensor]:
        """``values[i]``, a sum over this rank's block of ``names[i]``, as
        the sum over the whole tensor: one all-reduce per group of axes
        over the stacked values of its tensors."""
        out = list(values)
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, name in enumerate(names):
            layout = self.layouts.get(name)
            if layout is not None:
                by_axes.setdefault(self.mesh.key(layout.axes), []).append(i)
        for key in sorted(by_axes):
            idx = by_axes[key]
            flat = torch.stack([values[i] for i in idx])
            dist.all_reduce(flat, group=self.mesh.group(key))
            for j, i in enumerate(idx):
                out[i] = flat[j]
        return out

    def whole_norms(self, norms: Sequence[torch.Tensor], names: Sequence[str]) -> List[torch.Tensor]:
        """Per-tensor L2 norms over this rank's blocks -> over the whole
        tensors (a replicated tensor's norm unchanged)."""
        sharded = [i for i, n in enumerate(names) if n in self.layouts]
        if not sharded:
            return list(norms)
        sums = self.whole_sums([norms[i] * norms[i] for i in sharded], [names[i] for i in sharded])
        out = list(norms)
        for i, s in zip(sharded, sums):
            out[i] = torch.sqrt(s)
        return out

    def numel(self, name: str, local: torch.Tensor) -> int:
        layout = self.layouts.get(name)
        return prod(layout.shape) if layout is not None else local.numel()

    # -- the state --

    def _map_opt(self, opt: Dict[str, Any], fn: Callable[[str, torch.Tensor], torch.Tensor]
                 ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in opt.items():
            if key in _PER_PARAM:
                out[key] = {n: fn(n, t) for n, t in value.items()}
            elif isinstance(value, dict):
                out[key] = self._map_opt(value, fn)
            else:
                out[key] = value
        return out

    def map_tree(self, tree: Dict[str, Any], fn: Callable[[str, torch.Tensor], Any]
                 ) -> Dict[str, Any]:
        """A checkpoint tree (``module``, ``opt_state``, ``ema_params``
        and host values) with ``fn(name, tensor)`` applied to each tensor
        of a named state tensor, in a fixed order (module, optimizer, EMA)."""
        out = dict(tree)
        if "module" in tree:
            out["module"] = {n: fn(n, t) for n, t in tree["module"].items()}
        if "opt_state" in tree:
            out["opt_state"] = self._map_opt(tree["opt_state"], fn)
        if tree.get("ema_params") is not None:
            out["ema_params"] = {n: fn(n, t) for n, t in tree["ema_params"].items()}
        return out

    def gather_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Every sharded tensor of a checkpoint tree gathered (collectives:
        every rank calls it)."""
        with torch.no_grad():
            return self.map_tree(tree, lambda n, t: self.gather(n, t.detach()))

    def shard_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's blocks of a global checkpoint tree (no collective)."""
        return self.map_tree(tree, lambda n, t: self.shard(n, torch.as_tensor(t)))

    def global_like(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """A tree of ``meta`` tensors of the global shapes (for structure
        checks)."""
        def like(name, t):
            layout = self.layouts.get(name)
            if layout is None or not isinstance(t, torch.Tensor):
                return t
            return torch.empty(layout.shape, dtype=t.dtype, device="meta")
        return self.map_tree(tree, like)

    def apply(self, state: Any) -> Any:
        """Keep this rank's block of every sharded tensor of ``state`` (the
        global tensors it holds now): parameters and buffers in place of
        the module's, their optimizer state and EMA in their dicts."""
        module = state.module
        with torch.no_grad():
            for name, t in list(module.state_dict(keep_vars=True).items()):
                if name not in self.layouts:
                    continue
                prefix, _, leaf = name.rpartition(".")
                owner = module.get_submodule(prefix)
                if leaf in owner._parameters:
                    owner._parameters[leaf].data = self.shard(name, t.data)
                else:
                    owner._buffers[leaf] = self.shard(name, t)
            state.opt_state = self._map_opt(state.opt_state, self.shard)
            if state.ema_params is not None:
                state.ema_params = {n: self.shard(n, t) for n, t in state.ema_params.items()}
        state.shards = self
        return state

    def apply_module(self, module: torch.nn.Module) -> torch.nn.Module:
        """:meth:`apply` for a module served alone (no optimizer state, no
        EMA): it keeps this rank's block of every sharded tensor."""
        import types

        self.apply(types.SimpleNamespace(module=module, opt_state={}, ema_params=None))
        return module


def _exact_axis(dims: List[Tuple[str, ...]], want_dim: int) -> Optional[str]:
    """The one axis a tensor is split over when that is ``want_dim`` on a
    single axis and nothing else; None otherwise."""
    split = [(d, axes) for d, axes in enumerate(dims) if axes]
    if len(split) == 1 and split[0][0] == want_dim and len(split[0][1]) == 1:
        return split[0][1][0]
    return None


def plan_state(module: torch.nn.Module, rules: Sequence[PartitionRule], mesh: MeshGroups,
               model_axes: Sequence[str], replica_axes: Sequence[str],
               gather_buffers: bool = False) -> Optional[ShardPlan]:
    """The :class:`ShardPlan` of ``module`` under ``rules`` on ``mesh``
    (None when no tensor shards). Hands each layer whose tensors have one
    of its ``tensor_parallel_forms`` on a model axis that divides it its
    :class:`TensorParallel` (and clears it elsewhere). ``gather_buffers``:
    a buffer under ``params/`` (a packed kernel) that its layer does not
    compute on is sharded and gathered on use, as a parameter is (the
    inference plan; a training state keeps such buffers whole)."""
    from zookeeper_tpu_torch.models.convert import flax_state_layouts

    tensors = module.state_dict(keep_vars=True)
    layouts_of = flax_state_layouts(module)
    dims: Dict[str, List[Tuple[str, ...]]] = {}
    for name, (path, axes_map) in layouts_of.items():
        t = tensors[name]
        port = _port_dims(spec_for(rules, path), axes_map, t.dim())
        if not any(port):
            continue
        mesh.key(a for axes in port for a in axes)  # unknown axes raise
        if any(axes and t.shape[d] % mesh.size(axes) for d, axes in enumerate(port)):
            continue  # indivisible: replicated (GSPMD would pad)
        dims[name] = port
    interleave: Dict[str, Tuple[int, int]] = {}
    for prefix, sub in module.named_modules():
        forms = getattr(sub, "tensor_parallel_forms", None)
        if forms is None:
            continue
        for attr, leaves, divides in forms():
            names = {(f"{prefix}.{leaf}" if prefix else leaf): dk for leaf, dk in leaves.items()}
            axis = {_exact_axis(dims.get(n, []), d) for n, (d, _) in names.items()}
            tp = None
            if len(axis) == 1:
                (axis,) = axis
                if axis is not None and axis in model_axes and divides(mesh.sizes[axis]):
                    members = mesh.members((axis,))
                    tp = TensorParallel(mesh.group((axis,)), members.index(mesh.rank),
                                        len(members))
                    interleave.update(names)
            object.__setattr__(sub, attr, tp)
    params = [n for n, _ in module.named_parameters()]
    if gather_buffers:
        params += [n for n, _ in module.named_buffers()
                   if layouts_of.get(n, ("",))[0].startswith("params/")]
    layouts = {}
    for name, port in dims.items():
        local = name in interleave
        if not local and name not in params:
            continue  # a buffer its layer does not compute on: replicated
        layouts[name] = Layout(
            shape=tuple(tensors[name].shape),
            dims=tuple((axes, interleave[name][1] if local and axes else 1) for axes in port),
            local=local)
    if not layouts:
        return None
    return ShardPlan(layouts, params, mesh, replica_axes)


def plan_inference(module: torch.nn.Module, rules: Sequence[PartitionRule], mesh: MeshGroups,
                   model_axes: Sequence[str]) -> Optional[ShardPlan]:
    """The plan of an inference module (no optimizer state, no EMA), by
    :func:`plan_state`'s rules: the tensor-parallel layers get their model
    groups (the head-aligned ``qkv`` block: a rank's K/V rows are its own
    heads) and every other sharded tensor, packed kernels included, is
    gathered for each dispatch (:meth:`ShardPlan.gathered_weights`). Call
    :meth:`ShardPlan.apply_module` to keep this rank's blocks."""
    return plan_state(module, rules, mesh, model_axes, (), gather_buffers=True)


# -- the decode engine's KV state ---------------------------------------------


@dataclass(frozen=True)
class DecodeShard:
    """How a decode engine's KV state lies over the mesh for this rank:
    ``data`` the group its slots are split over (the data axes; None: every
    rank holds every slot) and ``heads`` the group its heads are split over
    (the model axis; None: whole heads); ``replicated`` marks the
    indivisible-geometry fallback (both None). ``mesh``, ``data_axes`` and
    ``model_axis`` are what the sharded decode attention is called with
    (``ops.attention.sharded_paged_decode_attention``). A page pool never
    splits its pages (any slot may read any page): only its heads split,
    while the slots of q, the lengths and the page table split over
    ``data``."""

    mesh: Any
    data_axes: Tuple[str, ...]
    model_axis: Optional[str]
    data: Optional[TensorParallel] = None
    heads: Optional[TensorParallel] = None
    replicated: bool = False

    def slot_range(self, slots: int) -> Tuple[int, int]:
        """``[lo, hi)``: the global slots this rank holds."""
        if self.data is None:
            return 0, slots
        n = slots // self.data.size
        return self.data.index * n, (self.data.index + 1) * n

    def local_heads(self, heads: int) -> int:
        return heads if self.heads is None else heads // self.heads.size

    def cache_shape(self, slots: int, capacity: int, heads: int,
                    head_dim: int) -> Tuple[int, int, int, int]:
        """This rank's ``[slots, capacity, heads, head_dim]`` block of a
        slot cache."""
        lo, hi = self.slot_range(slots)
        return hi - lo, capacity, self.local_heads(heads), head_dim

    def pool_shape(self, num_pages: int, page_size: int, heads: int,
                   head_dim: int) -> Tuple[int, int, int, int]:
        """This rank's ``[pages, page_size, heads, head_dim]`` block of a
        page pool (every page, its heads)."""
        return num_pages, page_size, self.local_heads(heads), head_dim

    def attention_kwargs(self) -> Dict[str, Any]:
        return {"mesh": self.mesh, "data_axes": self.data_axes,
                "model_axis": self.model_axis, "replicated": self.replicated}

    def gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        """``x [local slots, ...]`` of every data rank, in slot order
        (``x`` itself without a data split)."""
        if self.data is None:
            return x
        stacked = all_gather_stack(x, self.data.group, self.data.size)
        return stacked.reshape(self.data.size * x.shape[0], *x.shape[1:])
