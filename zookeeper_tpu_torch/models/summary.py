"""Model summary with quantization-aware size accounting.

The port of ``zookeeper_tpu/models/summary.py``: one row per parameter,
under its flax path (``QuantConv_3/kernel``, ``_MeliusDenseBlock_0/
BatchNorm_0/scale``) with its stored dtype and its bit width in the
packed deployment (a latent sign-read kernel ships at 1 bit per weight; a
``kernel_packed`` holds 32 binary weights in each int32), the train and
deployment bytes, and, on request, the forward's FLOPs at batch 1 from
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and convolutions;
XLA's cost analysis in the JAX package also counts the elementwise work).

Build the module on the ``meta`` device (:func:`meta_module`) and nothing
is allocated, whatever its size: the rows read shapes only, and the FLOP
count traces a meta forward.
"""

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from zookeeper_tpu_torch.models.convert import flax_param_tree
from zookeeper_tpu_torch.ops.layers import BINARY_KERNEL_PATTERN

__all__ = ["ModelSummary", "ParamRow", "meta_module", "model_summary"]

#: Latent kernels read through a sign quantizer: deployable at 1 bit.
_BINARY_KERNEL_PATTERN = re.compile(BINARY_KERNEL_PATTERN)
#: Already-packed deployment kernels (int32 lanes of 32 binary weights).
_PACKED_KERNEL_PATTERN = re.compile(r"kernel_packed$")
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
          torch.int32: np.int32, torch.int64: np.int64, torch.int8: np.int8}


@dataclass
class ParamRow:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    #: STORED elements (int32 lanes for pre-packed kernels).
    count: int
    #: Bits per weight in the packed deployment form.
    deploy_bits: int
    binary: bool
    #: True for kernel_packed rows: each stored int32 lane carries 32
    #: binary weights, so weight_count = 32 * count.
    packed: bool = False

    @property
    def weight_count(self) -> int:
        """Logical weights represented (what "params" means to a user)."""
        return self.count * 32 if self.packed else self.count

    @property
    def train_bytes(self) -> int:
        return self.count * np.dtype(self.dtype).itemsize

    @property
    def deploy_bytes(self) -> float:
        return self.weight_count * self.deploy_bits / 8


@dataclass
class ModelSummary:
    rows: List[ParamRow]
    flops: Optional[float] = None  # Forward FLOPs at batch 1 (FlopCounterMode).
    input_shape: Optional[Tuple[int, ...]] = None
    extra_collections: List[str] = field(default_factory=list)

    @property
    def total_params(self) -> int:
        return sum(r.weight_count for r in self.rows)

    @property
    def binary_params(self) -> int:
        return sum(r.weight_count for r in self.rows if r.binary)

    @property
    def fp_params(self) -> int:
        return self.total_params - self.binary_params

    @property
    def train_bytes(self) -> int:
        return sum(r.train_bytes for r in self.rows)

    @property
    def deploy_bytes(self) -> float:
        return sum(r.deploy_bytes for r in self.rows)

    def __str__(self) -> str:
        header = f"{'param':<58}{'shape':<20}{'dtype':<10}{'count':>12}{'bits':>6}"
        lines = [header, "-" * len(header)]
        for r in self.rows:
            shape = "x".join(str(s) for s in r.shape) or "scalar"
            lines.append(
                f"{r.path:<58}{shape:<20}{r.dtype:<10}{r.weight_count:>12,}"
                f"{r.deploy_bits:>6}"
            )
        lines.append("-" * len(header))
        lines.append(
            f"params: {self.total_params:,} "
            f"({self.binary_params:,} binary / {self.fp_params:,} fp)"
        )
        lines.append(
            f"memory: train {self.train_bytes / 2**20:.2f} MiB -> "
            f"deploy {self.deploy_bytes / 2**20:.2f} MiB "
            f"(binary kernels packed to 1 bit)"
        )
        if self.flops is not None:
            lines.append(f"forward FLOPs (FlopCounterMode, batch 1): {self.flops:,.0f}")
        return "\n".join(lines)


def _classify(path: str, dtype_bits: int) -> Tuple[int, bool, bool]:
    """(deploy_bits, is_binary, is_packed) for one param path."""
    if _PACKED_KERNEL_PATTERN.search(path):
        return 1, True, True
    if _BINARY_KERNEL_PATTERN.search(path):
        return 1, True, False
    return dtype_bits, False, False


def meta_module(model: Any, input_shape: Sequence[int], num_classes: int) -> nn.Module:
    """``model.build(input_shape, num_classes)`` on the ``meta`` device:
    shapes and dtypes, no storage."""
    with torch.device("meta"):
        return model.build(tuple(input_shape), num_classes)


def _shape_leaf(t: torch.Tensor) -> np.ndarray:
    """A zero-stride numpy stand-in of ``t``'s shape and dtype (no
    storage), which the converters transpose as they would the values."""
    return np.broadcast_to(np.zeros((), _NUMPY[t.dtype]), tuple(t.shape))


def _flatten(tree: Any, prefix: str = ""):
    for key, child in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(child, dict):
            yield from _flatten(child, path)
        else:
            yield path, child


def model_summary(
    module: nn.Module,
    input_shape: Sequence[int],
    *,
    compute_flops: bool = False,
    input_dtype: Optional[torch.dtype] = None,
) -> ModelSummary:
    """Summarize a port module's parameters and (optionally) FLOPs.

    The rows are the module's parameters (its packed kernels included)
    under their flax paths, sorted by path as the JAX summary sorts them;
    BatchNorm statistics are no parameters and are listed as the extra
    collection ``batch_stats``. ``compute_flops=True`` runs one batch-1
    forward under ``FlopCounterMode`` on the module's device (on ``meta``:
    nothing is computed); a forward the device cannot trace (the packed
    kernels take CPU or CUDA tensors only) gives ``None``, since the count
    is diagnostic output.

    ``input_dtype``: the dummy input's dtype; by default int32 for a
    module with a ``vocab_size`` (a token model) and float32 otherwise.
    """
    tree = flax_param_tree(module, _shape_leaf)
    rows = []
    for path, leaf in sorted(_flatten(tree)):
        dtype = np.dtype(leaf.dtype)
        deploy_bits, binary, packed = _classify(path, dtype.itemsize * 8)
        rows.append(ParamRow(path=path, shape=tuple(leaf.shape), dtype=dtype.name,
                             count=int(leaf.size), deploy_bits=deploy_bits, binary=binary,
                             packed=packed))
    extra = ["batch_stats"] if any(n.endswith("running_mean") for n in module.state_dict()) else []

    flops = None
    if compute_flops:
        if input_dtype is None:
            input_dtype = (torch.int32 if isinstance(getattr(module, "vocab_size", None), int)
                           else torch.float32)
        device = next(iter(module.state_dict().values())).device
        x = torch.zeros((1, *input_shape), dtype=input_dtype, device=device)
        was_training = module.training
        module.eval()
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as counter:
                module(x)
            flops = float(counter.get_total_flops())
        except ValueError:  # a kernel wrapper refused the device
            flops = None
        finally:
            module.train(was_training)
    return ModelSummary(rows=rows, flops=flops, input_shape=tuple(input_shape),
                        extra_collections=extra)
