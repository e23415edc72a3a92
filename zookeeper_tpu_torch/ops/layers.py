"""The binary models' layers, as ``nn.Module``s, for training and serving.

Counterparts of the flax layers the JAX zoo builds: ``Conv``
(``flax.linen.Conv``, with or without a bias), ``BatchNorm``
(``ops/layers.py`` ``BatchNorm``, i.e. ``flax.linen.BatchNorm``), ``Dense``,
and ``QuantConv`` and ``QuantDense`` on all four binary paths with every
quantizer of the registry, validated as the JAX layers validate them; and
the rest of the JAX Quant layers: ``QuantConvND``/``1D``/``3D``,
``QuantLocallyConnectedND``/``1D``/``2D``, ``QuantConvTranspose``,
``QuantDepthwiseConv``, ``QuantSeparableConvND``/``1D`` and
``QuantSeparableConv``.
Every layer takes and returns channels-last tensors (NHWC in 2-D), as in
the JAX package. The fp convs run ``F.conv*d`` on the channels-first view
of the channels-last storage (a ``torch.channels_last`` tensor in 2-D),
so no layout copy is made; the packed kernels read the same storage
directly. Parameter names and layouts follow the flax ones (see
``models/convert.py``), except that fp conv weights are OIHW and the
dense weight is [out, in], as PyTorch holds them; a layer that wraps
others holds them under their flax scope names (``QuantConv_0``).
``module.train()`` is flax's ``training=True``. Unlike flax, a layer takes
its input width (``in_features``) at construction.

Tensor parallelism (``parallel.shards``): ``Conv``, ``Dense``,
``QuantConv``, ``QuantDense`` (latent or packed: ``kernel_packed`` and
``kernel_scale`` split on ``co``/``N``, run through K3/K4 or K2/K5 on the
block, with the block of a bias the rules leave whole) and ``BatchNorm`` name the layouts they can
compute on (``tensor_parallel_forms``: every tensor of the layer split
on its output features over one model axis). A layer the partitioner
handed its model group (``_tp``) holds only its output-feature shard;
a conv or dense then computes that shard of the output from the whole
input (whose gradient it sums over the group), a BatchNorm normalises
its own channels of the whole input, and each all-gathers the channels
before it returns, so the next layer reads every channel.
"""

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from zookeeper_tpu_torch.ops.binary_compute import (
    _spatial_pad,
    conv_pads,
    float_conv,
    float_conv_transpose,
    int8_conv,
    int8_conv_transpose,
    int8_dense,
    packed_conv_infer,
    packed_dense_infer,
    resolve_binary_flavor,
    xnor_conv,
    xnor_dense,
)
from zookeeper_tpu_torch.ops.quantizers import get_quantizer, ste_sign_packed

#: A quantizer: a registry name, a callable, or None (no quantization).
Quantizer = Union[str, Callable, None]

#: Binary compute modes of the JAX package; the port runs all four.
BINARY_COMPUTE_MODES = ("mxu", "int8", "xnor", "xnor_popcount")

#: Flat param-path regex (flax names: "QuantDense_1/kernel") matching the
#: latent sign-read kernels of the Quant* layers: the JAX package's
#: ``BINARY_KERNEL_PATTERN``, kept here so the port reads no JAX module.
BINARY_KERNEL_PATTERN = r"Quant[A-Za-z0-9]*_\d+/kernel$"

#: The tag on every Quant* layer's quantized input (:func:`tag_quant_act`):
#: the JAX package's ``QUANT_ACT_CHECKPOINT_NAME``, the one name the
#: "quant" rematerialization policy saves.
QUANT_ACT_CHECKPOINT_NAME = "quant_act"


@torch.library.custom_op(f"zookeeper_tpu_torch::{QUANT_ACT_CHECKPOINT_NAME}", mutates_args=())
def _quant_act(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


_quant_act.register_fake(lambda x: torch.empty_like(x))
_quant_act.register_autograd(lambda ctx, grad: grad)


class _RematFlags(threading.local):
    """What a rematerialized train step asks of the layers: ``tag`` the
    quantized inputs (the "quant" policy), and whether the forward is a
    ``recompute`` for the backward (BatchNorm then leaves its running
    statistics as the first forward left them)."""

    tag = False
    recompute = False


_REMAT = _RematFlags()


@contextlib.contextmanager
def remat_scope(tag: bool = False, recompute: bool = False):
    """Set the layers' rematerialization flags inside the block."""
    saved = (_REMAT.tag, _REMAT.recompute)
    _REMAT.tag, _REMAT.recompute = tag, recompute
    try:
        yield
    finally:
        _REMAT.tag, _REMAT.recompute = saved


class _BatchStatsGroup(threading.local):
    """The process group whose global batch the train-mode BatchNorms
    take their moments over (None: this rank's batch alone)."""

    group = None


_BATCH_STATS = _BatchStatsGroup()


@contextlib.contextmanager
def global_batch_stats(group):
    """Inside the block, train-mode BatchNorms normalise with the moments
    of the global batch of ``group`` (the data-parallel ranks): the sums
    of x, x^2 and the count are all-reduced, as the JAX package's GSPMD
    step reduces them over the batch sharding. The sums' all-reduce is
    autograd-aware, so the backward (and a remat recompute inside the
    block) reduces the same way."""
    saved = _BATCH_STATS.group
    _BATCH_STATS.group = group
    try:
        yield
    finally:
        _BATCH_STATS.group = saved


def _global_moments(xf: torch.Tensor, axes, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and flax's fast variance ``E[x^2] - E[x]^2`` (clipped at
    0) of ``xf`` over ``axes`` and every rank of ``group``."""
    from torch.distributed.nn.functional import all_reduce

    c = xf.shape[-1]
    count = torch.full((1,), float(xf.numel() // c), dtype=torch.float32, device=xf.device)
    sums = all_reduce(torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes), count]),
                      group=group)
    mean = sums[:c] / sums[2 * c]
    var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    return mean, var


def tag_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Tag a quantized activation for the "quant" remat policy: inside a
    tagging scope, the ``zookeeper_tpu_torch::quant_act`` op (a copy, its
    gradient the identity) that the policy saves; elsewhere ``x`` itself
    (JAX's ``checkpoint_name`` is the identity outside a checkpoint)."""
    if _REMAT.tag:
        return torch.ops.zookeeper_tpu_torch.quant_act(x)
    return x


#: Kernel quantizers whose output is sign x per-output-channel scale: the
#: contract of the packed binary kernels.
_SIGN_KERNEL_QUANTIZERS = frozenset(
    {"ste_sign", "approx_sign", "swish_sign", "magnitude_aware_sign"}
)
#: Input quantizers that emit exact small integers ({-1, 0, +1}), which
#: the int8 and packed-weight paths cast to int8 (dorefa's fractions would
#: truncate).
_INT_INPUT_QUANTIZERS = frozenset(
    {"ste_sign", "ste_sign_packed", "approx_sign", "swish_sign", "ste_tern",
     "ste_heaviside"}
)
#: Kernel quantizers the int8 path runs exactly: the sign family (the
#: scale re-applies after the integer sum) and the small-integer ones.
_INT_KERNEL_QUANTIZERS = _SIGN_KERNEL_QUANTIZERS | {"ste_tern", "ste_heaviside"}
#: Input quantizers that emit strictly ±1: what the popcount path and
#: 1-bit residual packing need (a 0 would come back as +1).
_PM1_INPUT_QUANTIZERS = frozenset(
    {"ste_sign", "ste_sign_packed", "approx_sign", "swish_sign"}
)


def _channelwise(kernel_quantizer: Quantizer) -> bool:
    """Whether a kernel quantizer treats each output channel on its own
    (elementwise, or a per-channel scale), so an output-feature shard of
    the kernel quantizes as its slice of the whole."""
    return kernel_quantizer is None or kernel_quantizer in _SIGN_KERNEL_QUANTIZERS


def _tp_input(x: torch.Tensor, tp) -> torch.Tensor:
    """A tensor-parallel layer's input: itself, its gradient summed over
    the model group (each rank's shard contributes a part)."""
    if tp is None:
        return x
    from zookeeper_tpu_torch.parallel.shards import copy_to_model

    return copy_to_model(x, tp)


def _tp_output(y: torch.Tensor, tp) -> torch.Tensor:
    """A tensor-parallel layer's output shard with every channel
    gathered."""
    if tp is None:
        return y
    from zookeeper_tpu_torch.parallel.shards import gather_channels

    return gather_channels(y, tp)


def _output_forms(layer: nn.Module, weight: str, dim: int, ok: bool):
    """The one form of a layer that computes an output-feature shard:
    ``weight`` split on ``dim``, the bias (when held) on its only dim."""
    leaves = {weight: (dim, 1)}
    if getattr(layer, "bias", None) is not None:
        leaves["bias"] = (0, 1)
    return [("_tp", leaves, lambda size: ok)]


def _packed_forms(layer: nn.Module, dim: int):
    """The output-feature form of a packed layer: ``kernel_packed`` split
    on ``dim`` and ``kernel_scale`` on its only dim. A packed kernel's
    output features are independent integer sums, so a block computes its
    slice of the whole layer's output exactly. The bias (a folded BN's
    shift) is not part of the form: the rules may leave it whole (JAX's
    ``conv_model_tp_rules`` name no conv bias), and the layer adds its
    block of it (:func:`_block_bias`)."""
    return [("_tp", {"kernel_packed": (dim, 1), "kernel_scale": (0, 1)}, lambda size: True)]


def _block_bias(bias: torch.Tensor, tp, features: int) -> torch.Tensor:
    """The bias of a block of ``features`` output channels: this rank's
    block of a whole bias (itself when it is the block's already)."""
    if tp is None or bias.shape[-1] == features:
        return bias
    return bias.narrow(-1, tp.index * features, features)


def kernel_param_name(kernel_quantizer: Quantizer) -> str:
    """The latent kernel's parameter name, as the flax layers name it:
    "kernel" for a sign-family or callable quantizer (what
    ``BINARY_KERNEL_PATTERN`` treats as binary), "kernel_fp" for None and
    the multi-level quantizers (ste_tern, ste_heaviside, dorefa)."""
    if kernel_quantizer is None:
        return "kernel_fp"
    if callable(kernel_quantizer) or kernel_quantizer in _SIGN_KERNEL_QUANTIZERS:
        return "kernel"
    return "kernel_fp"


def check_binary_compute(mode: str, layer: str, input_quantizer: Quantizer = None,
                         kernel_quantizer: Quantizer = None, padding="SAME") -> None:
    """Raise where the JAX layers raise: an unknown mode, or a binary path
    that its quantizers or its padding cannot run exactly (a typo or a
    mismatch must not quietly run another path; explicit pads run on "mxu"
    only). Callables are trusted to honour the value contracts."""
    if mode not in BINARY_COMPUTE_MODES:
        raise ValueError(
            f"{layer}: unknown binary_compute {mode!r}; choose from "
            f"{BINARY_COMPUTE_MODES}."
        )
    if mode == "mxu":
        return
    problems = []
    missing = [n for n, q in (("input", input_quantizer), ("kernel", kernel_quantizer))
               if q is None]
    if missing:
        problems.append(
            f"it needs both an input and a kernel quantizer (the {' and '.join(missing)} "
            "quantizer is None: not binarized)"
        )
    if not isinstance(padding, str):
        problems.append(f"padding {padding!r} is not a named mode (SAME/VALID)")
    if isinstance(kernel_quantizer, str):
        if mode in ("xnor", "xnor_popcount") and kernel_quantizer not in _SIGN_KERNEL_QUANTIZERS:
            problems.append(
                f"kernel_quantizer {kernel_quantizer!r} does not produce sign x "
                "per-channel scale (packed kernels require one of "
                f"{sorted(_SIGN_KERNEL_QUANTIZERS)})"
            )
        if mode == "int8" and kernel_quantizer not in _INT_KERNEL_QUANTIZERS:
            problems.append(
                f"kernel_quantizer {kernel_quantizer!r} does not produce sign x "
                "per-channel scale or exact small integers (int8 requires one of "
                f"{sorted(_INT_KERNEL_QUANTIZERS)})"
            )
    if isinstance(input_quantizer, str):
        if mode in ("int8", "xnor") and input_quantizer not in _INT_INPUT_QUANTIZERS:
            problems.append(
                f"input_quantizer {input_quantizer!r} can emit non-integer values, "
                f"which the int8 activation cast would truncate ({mode} requires "
                f"one of {sorted(_INT_INPUT_QUANTIZERS)})"
            )
        if mode == "xnor_popcount" and input_quantizer not in _PM1_INPUT_QUANTIZERS:
            problems.append(
                f"input_quantizer {input_quantizer!r} can emit values other than "
                "+-1, which bit-packing would miscount (xnor_popcount requires "
                f"one of {sorted(_PM1_INPUT_QUANTIZERS)})"
            )
    if problems:
        raise ValueError(
            f"{layer}: binary_compute={mode!r} requested but unusable: "
            + "; ".join(problems)
            + ". Fix the configuration or set binary_compute='mxu' explicitly "
            "— this layer never falls back silently."
        )


def check_pack_residuals(
    mode: str, input_quantizer, packed_weights: bool, layer: str
) -> None:
    """Loud validation of ``pack_residuals=True`` (1-bit fwd->bwd
    residuals): it needs the int8 path, which owns its backward
    residuals, and a strictly ±1 input quantizer; packed weights are
    inference-only. Callables are trusted to honour the ±1 contract."""
    problems = []
    if packed_weights:
        problems.append(
            "packed_weights=True is inference-only (no training residuals "
            "to pack)"
        )
    if mode != "int8":
        problems.append(
            f"binary_compute={mode!r} does not own its backward residuals "
            "(supported: 'int8')"
        )
    if input_quantizer is None:
        problems.append("input_quantizer is None (unquantized inputs are not +-1)")
    elif isinstance(input_quantizer, str) and input_quantizer not in _PM1_INPUT_QUANTIZERS:
        problems.append(
            f"input_quantizer {input_quantizer!r} can emit values other than "
            "+-1, which 1-bit packing would corrupt (requires one of "
            f"{sorted(_PM1_INPUT_QUANTIZERS)})"
        )
    if problems:
        raise ValueError(
            f"{layer}: pack_residuals=True requested but unusable: "
            + "; ".join(problems)
            + ". Fix the configuration or drop pack_residuals — this layer "
            "never falls back silently."
        )


def _int8_kernel_is_unscaled(kernel_quantizer) -> bool:
    """True when the kernel is statically known to be pure {-1, 0, +1}
    (skips the int8 path's runtime scale extraction). Callables are
    assumed scaled, which stays exact either way."""
    return isinstance(kernel_quantizer, str) and kernel_quantizer != "magnitude_aware_sign"


def _apply_clip(kernel: torch.Tensor, clip: bool) -> torch.Tensor:
    """Read-time weight clip as a straight-through projection: the forward
    sees ``clamp(kernel, -1, 1)``, the gradient passes to the latent
    weight unclipped (larq's weight_clip semantics, as in the JAX
    layer)."""
    if not clip:
        return kernel
    return kernel + (kernel.clamp(-1.0, 1.0) - kernel).detach()


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class Conv(nn.Module):
    """Float conv over NHWC with XLA SAME/VALID padding
    (``flax.linen.Conv``); the weight is OIHW. Computes in ``dtype``, the
    bias (``use_bias``) added in it. Tensor-parallel on its output
    features when ungrouped."""

    _tp = None

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int],
        strides: Tuple[int, int] = (1, 1),
        padding: str = "SAME",
        feature_group_count: int = 1,
        dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = feature_group_count
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(features, in_features // feature_group_count, kh, kw)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()  # lecun_normal, as flax's default
        _normal_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def tensor_parallel_forms(self):
        return _output_forms(self, "weight", 0, self.groups == 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        x, _, _ = _spatial_pad(
            _tp_input(x, self._tp).to(self.dtype), kh, kw, self.strides, self.padding, 0.0
        )
        y = F.conv2d(
            x.permute(0, 3, 1, 2), self.weight.to(self.dtype),
            stride=self.strides, groups=self.groups,
        ).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return _tp_output(y, self._tp)


class BatchNorm(nn.Module):
    """Batch norm over the trailing (channel) axis with flax
    ``nn.BatchNorm`` semantics (``momentum`` 0.9 and eps 1e-5 as the zoo
    builds it; flax's own default momentum is 0.99, which ``SimpleCnn``
    takes). Statistics and the normalisation run in float32:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast to ``dtype``.

    In train mode (``module.train()``) it normalises with the batch mean
    and flax's fast biased variance ``mean(x^2) - mean(x)^2`` clipped at
    0 (of the global batch of the data-parallel ranks inside
    :func:`global_batch_stats`), and updates ``ra = m * ra + (1 - m) * batch`` for both statistics
    (the biased variance, unlike ``nn.BatchNorm2d``), ``m`` the share of
    the running statistic kept (flax's convention). In eval mode it uses
    the running statistics. The recompute of a rematerialized step leaves
    the statistics as the step's first forward left them. Tensor-parallel
    over its channels: it normalises its own channels of the whole input
    and gathers the rest."""

    _tp = None

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def tensor_parallel_forms(self):
        leaves = {n: (0, 1) for n in ("weight", "bias", "running_mean", "running_var")}
        return [("_tp", leaves, lambda size: True)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._tp is not None:
            from zookeeper_tpu_torch.parallel.shards import split_channels

            x = split_channels(x, self._tp)
        xf = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if _BATCH_STATS.group is not None:
                mean, var = _global_moments(xf, axes, _BATCH_STATS.group)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            if not _REMAT.recompute:
                with torch.no_grad():
                    keep, take = self.momentum, 1.0 - self.momentum
                    self.running_mean.copy_(keep * self.running_mean + take * mean)
                    self.running_var.copy_(keep * self.running_var + take * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return _tp_output(((xf - mean) * mul + self.bias).to(self.dtype), self._tp)


class Dense(nn.Module):
    """``flax.linen.Dense`` over the last axis, computed in ``dtype``;
    the weight is [out, in]. Tensor-parallel on its output features."""

    _tp = None

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), generator)
        with torch.no_grad():
            self.bias.zero_()

    def tensor_parallel_forms(self):
        return _output_forms(self, "weight", 0, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = F.linear(_tp_input(x, self._tp).to(d), self.weight.to(d), self.bias.to(d))
        return _tp_output(y, self._tp)


def _check_quant_layer(layer: str, binary_compute: str, binary_flavor: str,
                       input_quantizer, kernel_quantizer, packed_weights: bool,
                       padding="SAME") -> None:
    """The validation both Quant layers share: a known flavor, a binary path
    its quantizers run exactly (``check_binary_compute``), packed weights
    only on the packed paths."""
    resolve_binary_flavor(binary_flavor)  # loud typo check
    check_binary_compute(binary_compute, layer, input_quantizer, kernel_quantizer, padding)
    if packed_weights and binary_compute not in ("xnor", "xnor_popcount"):
        raise ValueError(
            "packed_weights=True requires binary_compute='xnor' or "
            f"'xnor_popcount', got {binary_compute!r}."
        )


class _QuantLayer(nn.Module):
    _tp = None

    @property
    def latent(self) -> nn.Parameter:
        """The latent float kernel, under flax's name for it
        (:func:`kernel_param_name`: ``kernel`` or ``kernel_fp``)."""
        return getattr(self, self.latent_name)


class QuantDense(_QuantLayer):
    """Binary dense layer over the last axis: the JAX ``QuantDense`` on its
    four paths.

    - "mxu": the float matmul of the quantized operands in ``dtype``.
    - "int8": :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_dense`,
      exact integer sums with the float matmul's gradients.
    - "xnor_popcount": both operands packed; K1 + K2 under the default
      flavor, ``pack_bits`` + K5 + the scale under "reference".
    - "xnor": int8 activations times packed weights, K4.

    The two packed paths train through
    :func:`~zookeeper_tpu_torch.ops.binary_compute.xnor_dense` (the float
    matmul's gradients). ``packed_weights=True`` holds only the
    deployed form (inference only): ``kernel_packed`` [ceil(K/32), N] int32 and
    ``kernel_scale`` [N] float32 (plus ``bias`` when ``use_bias``, which
    carries a folded BN's shift). Otherwise the latent float kernel
    [K, N] (the flax layout, named as flax names it: ``kernel``, or
    ``kernel_fp`` for a multi-level or no quantizer) is held, clipped straight-through and
    quantized at each call. Output is cast to ``dtype`` and the bias added
    in ``dtype``. ``in_features`` (K) is given at construction.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        _check_quant_layer(type(self).__name__, binary_compute, binary_flavor,
                           input_quantizer, kernel_quantizer, packed_weights)
        self.in_features = in_features
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.binary_compute = binary_compute
        self.packed_weights = packed_weights
        self.binary_flavor = binary_flavor
        self.scaled = not _int8_kernel_is_unscaled(kernel_quantizer)
        self.channelwise = _channelwise(kernel_quantizer)
        if packed_weights:
            self.register_buffer(
                "kernel_packed",
                torch.zeros(-(-in_features // 32), features, dtype=torch.int32),
            )
            self.kernel_scale = nn.Parameter(torch.ones(features))
        else:
            self.latent_name = kernel_param_name(kernel_quantizer)
            self.register_parameter(
                self.latent_name, nn.Parameter(torch.zeros(in_features, features))
            )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.packed_weights:
                self.kernel_packed.zero_()
                self.kernel_scale.fill_(1.0)
            else:
                k, n = self.latent.shape
                _normal_(self.latent, math.sqrt(2.0 / (k + n)), generator)  # glorot_normal
            if self.bias is not None:
                self.bias.zero_()

    def tensor_parallel_forms(self):
        if self.packed_weights:
            # ``kernel_packed`` [ceil(K/32), N] and ``kernel_scale`` [N]
            # on N: K2 (or K5) computes the block's columns.
            return _packed_forms(self, 1)
        return _output_forms(self, self.latent_name, 1, self.channelwise)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.binary_compute
        if x.shape[-1] != self.in_features:
            raise ValueError(
                f"{type(self).__name__}: input has {x.shape[-1]} features, the "
                f"layer was built for {self.in_features}."
            )
        x = _tp_input(x, self._tp)
        if self.in_q is not None:
            x = tag_quant_act(self.in_q(x))
        if self.packed_weights:
            y = packed_dense_infer(
                x, self.kernel_packed, self.kernel_scale, self.in_features,
                use_popcount=mode == "xnor_popcount", flavor=self.binary_flavor,
            )
        else:
            kernel = _apply_clip(self.latent, self.kernel_clip)
            if self.k_q is not None:
                kernel = self.k_q(kernel)
            if mode == "int8":
                y = int8_dense(x, kernel, self.scaled)
            elif mode == "mxu":
                d = self.dtype
                y = torch.matmul(x.to(d), kernel.to(d))
            else:
                y = xnor_dense(x, kernel, mode == "xnor_popcount", self.binary_flavor)
        y = y.to(self.dtype)
        if self.bias is not None:
            y = y + _block_bias(self.bias, self._tp, y.shape[-1]).to(self.dtype)
        return _tp_output(y, self._tp)


def _glorot_(t: torch.Tensor, generator: torch.Generator) -> None:
    """glorot_normal over a channels-last kernel ``[*receptive, in, out]``."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = receptive * t.shape[-2], receptive * t.shape[-1]
    _normal_(t, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def _resolve_groups(layer: str, groups: int, ci: int, features: int,
                    depthwise_ok: bool = True) -> int:
    """``feature_group_count`` as a group count (-1: depthwise, where
    allowed), validated as the JAX layers validate it."""
    if groups == -1 and depthwise_ok:
        groups = ci
    elif groups < 1:
        raise ValueError(
            f"{layer}: feature_group_count={groups} invalid (>= 1"
            + (", or -1 for depthwise)." if depthwise_ok else ").")
        )
    if ci % groups != 0 or features % groups != 0:
        raise ValueError(
            f"{layer}: feature_group_count={groups} must divide both input "
            f"channels ({ci}) and features ({features})."
        )
    return groups


def _check_named_padding(layer: str, padding) -> None:
    if isinstance(padding, str) and padding not in ("SAME", "VALID"):
        raise ValueError(f"{layer}: padding {padding!r} is not SAME/VALID.")


class QuantConv(_QuantLayer):
    """Binary 2-D conv (NHWC): the JAX ``QuantConv`` on its four paths.

    - "mxu": the float conv of the quantized operands in ``dtype`` (the
      JAX package's default training path); the only path that takes
      ``kernel_dilation`` and explicit pads (a sequence of (lo, hi)).
    - "int8": :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_conv`,
      exact integer sums with the float conv's gradients.
      ``pack_residuals=True`` stores its forward->backward residuals at 1
      bit per value: the ±1 conv input (K6 in the forward, K7 in the
      backward) and, when the input quantizer is "ste_sign", the STE mask
      (the quantizer becomes "ste_sign_packed": K6, then K8). Numerics
      are bit-identical either way.
    - "xnor_popcount": both operands packed, K1 + K3 under the default
      flavor (SAME pads with ones, the documented popcount deviation).
    - "xnor": int8 activations times packed weights, K4 (zero padding,
      exact against the float conv).

    ``feature_group_count`` groups the conv on "mxu" and "int8" (-1:
    depthwise, one group per input channel); the packed paths compress
    the K = ci contraction, which grouping removes, and refuse it. The two
    packed paths train through
    :func:`~zookeeper_tpu_torch.ops.binary_compute.xnor_conv` (the float
    conv's gradients). ``packed_weights=True`` holds only the deployed
    form (inference only): ``kernel_packed`` [kh, kw, ceil(ci/32), co]
    int32 and ``kernel_scale`` [co] float32 (plus ``bias`` when
    ``use_bias``, which carries a folded BN's shift). Otherwise the latent
    HWIO float kernel [kh, kw, ci / groups, co] (``kernel``, or
    ``kernel_fp`` as flax names it) is held, clipped straight-through and
    quantized at each call. Output is cast to ``dtype`` and the bias added
    in ``dtype``.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Sequence[int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        input_quantizer: Quantizer = "ste_sign",
        kernel_quantizer: Quantizer = "ste_sign",
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
        packed_weights: bool = False,
        pack_residuals: bool = False,
        binary_flavor: str = "auto",
        kernel_dilation: Tuple[int, int] = (1, 1),
        feature_group_count: int = 1,
    ):
        super().__init__()
        name = type(self).__name__
        _check_named_padding(name, padding)
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        _check_quant_layer(name, binary_compute, binary_flavor, input_quantizer,
                           kernel_quantizer, packed_weights, padding)
        if pack_residuals:
            check_pack_residuals(binary_compute, input_quantizer, packed_weights, name)
            if input_quantizer == "ste_sign":
                # Same values and gradients; the STE mask packs to 1 bit
                # alongside the conv input.
                self.in_q = ste_sign_packed
        if tuple(kernel_dilation) != (1, 1) and binary_compute != "mxu":
            raise ValueError(
                f"{name}: kernel_dilation={tuple(kernel_dilation)} is only supported "
                f"with binary_compute='mxu' (got {binary_compute!r}) — no silent fallback."
            )
        groups = _resolve_groups(name, feature_group_count, in_features, features)
        if groups != 1 and binary_compute not in ("mxu", "int8"):
            raise ValueError(
                f"{name}: grouped conv (feature_group_count={groups}) supports "
                f"binary_compute 'mxu'/'int8' only (got {binary_compute!r}) — the "
                "packed kernels compress the K=ci contraction, which grouping removes."
            )
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.kernel_dilation = tuple(kernel_dilation)
        self.groups = groups
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.binary_compute = binary_compute
        self.packed_weights = packed_weights
        self.pack_residuals = pack_residuals
        self.binary_flavor = binary_flavor
        self.scaled = not _int8_kernel_is_unscaled(kernel_quantizer)
        self.channelwise = _channelwise(kernel_quantizer)
        if packed_weights:
            ciw = -(-in_features // 32)
            self.register_buffer(
                "kernel_packed",
                torch.zeros(kh, kw, ciw, features, dtype=torch.int32),
            )
            self.kernel_scale = nn.Parameter(torch.ones(features))
        else:
            self.latent_name = kernel_param_name(kernel_quantizer)
            self.register_parameter(self.latent_name, nn.Parameter(
                torch.zeros(kh, kw, in_features // groups, features)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.packed_weights:
                self.kernel_packed.zero_()
                self.kernel_scale.fill_(1.0)
            else:
                _glorot_(self.latent, generator)
            if self.bias is not None:
                self.bias.zero_()

    def tensor_parallel_forms(self):
        if self.packed_weights:
            # ``kernel_packed`` [kh, kw, ci_words, co] and ``kernel_scale``
            # [co] on co: K3 (or K4) computes the block's channels.
            return _packed_forms(self, 3)
        return _output_forms(self, self.latent_name, 3, self.channelwise and self.groups == 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.binary_compute
        x = _tp_input(x, self._tp)
        if self.in_q is not None:
            x = tag_quant_act(self.in_q(x))
        if self.packed_weights:
            y = packed_conv_infer(
                x, self.kernel_packed, self.kernel_scale, self.strides,
                self.padding, use_popcount=mode == "xnor_popcount",
                flavor=self.binary_flavor,
            )
        else:
            kernel = _apply_clip(self.latent, self.kernel_clip)
            if self.k_q is not None:
                kernel = self.k_q(kernel)
            if mode == "int8":
                y = int8_conv(
                    x, kernel, self.strides, self.padding, self.groups,
                    self.scaled, self.pack_residuals,
                )
            elif mode == "mxu":
                y = float_conv(x.to(self.dtype), kernel, self.strides, self.padding,
                               self.groups, self.kernel_dilation)
            else:
                y = xnor_conv(x, kernel, self.strides, self.padding,
                              mode == "xnor_popcount", self.binary_flavor)
        y = y.to(self.dtype)
        if self.bias is not None:
            y = y + _block_bias(self.bias, self._tp, y.shape[-1]).to(self.dtype)
        return _tp_output(y, self._tp)


class _LatentLayer(_QuantLayer):
    """What the rank-generic Quant layers share: the quantizers, the latent
    kernel under flax's name (glorot_normal), the optional float32 bias,
    and the quantize-then-compute forward (``_compute(x, kernel)`` in the
    subclass; output cast to ``dtype``, bias added in it)."""

    def _setup(self, kernel_shape, bias_shape, input_quantizer, kernel_quantizer,
               kernel_clip: bool, use_bias: bool, dtype: torch.dtype) -> None:
        self.in_q = get_quantizer(input_quantizer)
        self.k_q = get_quantizer(kernel_quantizer)
        self.kernel_clip = kernel_clip
        self.dtype = dtype
        self.scaled = not _int8_kernel_is_unscaled(kernel_quantizer)
        self.latent_name = kernel_param_name(kernel_quantizer)
        self.register_parameter(self.latent_name, nn.Parameter(torch.zeros(*kernel_shape)))
        self.bias = nn.Parameter(torch.zeros(*bias_shape)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _glorot_(self.latent, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _check_input(self, x: torch.Tensor) -> None:
        rank = len(self.kernel_size)
        if x.dim() != rank + 2:
            raise ValueError(
                f"{type(self).__name__}: input rank {x.dim()} does not match a "
                f"{rank}-D layer (expect [batch, *spatial, channels])."
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input(x)
        if self.in_q is not None:
            x = tag_quant_act(self.in_q(x))
        kernel = _apply_clip(self.latent, self.kernel_clip)
        if self.k_q is not None:
            kernel = self.k_q(kernel)
        y = self._compute(x, kernel).to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _rank_of(layer: str, kernel_size, rank: Optional[int]) -> int:
    if rank is not None and len(kernel_size) != rank:
        raise ValueError(
            f"{layer}: kernel_size {tuple(kernel_size)} must have {rank} spatial dim(s)."
        )
    return len(kernel_size)


def _per_dim(layer: str, what: str, value, rank: int) -> Tuple[int, ...]:
    value = tuple(value) if value else (1,) * rank
    if len(value) != rank:
        raise ValueError(f"{layer}: {what} {value} must match kernel_size rank {rank}.")
    return value


class QuantConvND(_LatentLayer):
    """Channels-last N-D conv with optional input/kernel quantization (the
    JAX ``QuantConvND``; the spatial rank is ``len(kernel_size)``).
    ``binary_compute`` is "mxu" (the float conv, with ``kernel_dilation``
    and explicit pads) or "int8" (rank-generic
    :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_conv`); the packed
    kernels are 2-D only and raise here (use :class:`QuantConv`)."""

    _SPATIAL_RANK: Optional[int] = None

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int] = (3,),
        strides: Optional[Sequence[int]] = None,
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        kernel_dilation: Optional[Sequence[int]] = None,
        feature_group_count: int = 1,
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
    ):
        super().__init__()
        name = type(self).__name__
        rank = _rank_of(name, kernel_size, self._SPATIAL_RANK)
        strides = _per_dim(name, "strides", strides, rank)
        dilation = _per_dim(name, "kernel_dilation", kernel_dilation, rank)
        if binary_compute not in ("mxu", "int8"):
            raise ValueError(
                f"{name}: binary_compute={binary_compute!r} unsupported — the packed "
                "kernels are 2-D-specific; use QuantConv for packed deployment, or "
                "'mxu'/'int8' here."
            )
        _check_named_padding(name, padding)
        check_binary_compute(binary_compute, name, input_quantizer, kernel_quantizer, padding)
        if dilation != (1,) * rank and binary_compute != "mxu":
            raise ValueError(
                f"{name}: kernel_dilation={dilation} is only supported with "
                "binary_compute='mxu' — no silent fallback."
            )
        groups = _resolve_groups(name, feature_group_count, in_features, features,
                                 depthwise_ok=False)
        self.kernel_size = tuple(kernel_size)
        self.strides, self.padding, self.kernel_dilation = strides, padding, dilation
        self.groups = groups
        self.binary_compute = binary_compute
        self._setup((*kernel_size, in_features // groups, features), (features,),
                    input_quantizer, kernel_quantizer, kernel_clip, use_bias, dtype)

    def _compute(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        if self.binary_compute == "int8":
            return int8_conv(x, kernel, self.strides, self.padding, self.groups, self.scaled)
        return float_conv(x.to(self.dtype), kernel, self.strides, self.padding,
                          self.groups, self.kernel_dilation)


class QuantConv1D(QuantConvND):
    """1-D quantized conv over [batch, width, channels] (larq
    ``QuantConv1D``)."""

    _SPATIAL_RANK = 1


class QuantConv3D(QuantConvND):
    """3-D quantized conv over [batch, depth, height, width, channels]
    (larq ``QuantConv3D``)."""

    _SPATIAL_RANK = 3

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3, 3), **kwargs):
        super().__init__(in_features, features, kernel_size, **kwargs)


class QuantLocallyConnectedND(_LatentLayer):
    """Channels-last N-D locally connected layer with optional input/kernel
    quantization (the JAX ``QuantLocallyConnectedND``): a conv whose kernel
    is not shared across positions. Every output position owns a
    ``[prod(kernel_size) * in_features, features]`` block, held as one
    ``[*out_spatial, prod(kernel_size) * in_features, features]`` kernel
    whose rows run channel-major, then the window row-major (XLA's
    ``conv_general_dilated_local`` order); the bias, when used, is per
    position and channel. The output size depends on the input's, so
    ``input_spatial`` is given at construction. "mxu" only: unshared
    weights leave the packed and int8 paths nothing to amortize."""

    def __init__(
        self,
        in_features: int,
        features: int,
        input_spatial: Sequence[int],
        kernel_size: Sequence[int] = (3, 3),
        strides: Optional[Sequence[int]] = None,
        padding: Union[str, Sequence[Tuple[int, int]]] = "VALID",
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
    ):
        super().__init__()
        name = type(self).__name__
        rank = len(kernel_size)
        if len(input_spatial) != rank:
            raise ValueError(
                f"{name} with kernel_size={tuple(kernel_size)} expects a rank-{rank + 2} "
                f"channels-last input, got spatial size {tuple(input_spatial)}."
            )
        if binary_compute != "mxu":
            raise ValueError(
                f"{name}: binary_compute={binary_compute!r} is not supported — unshared "
                "weights defeat the packed kernels' one-unpack-many-positions "
                "amortization and the int8 path's per-channel scale contract; only "
                "'mxu' runs (no silent fallback)."
            )
        _check_named_padding(name, padding)
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides or (1,) * rank)
        self.pads = conv_pads(input_spatial, kernel_size, self.strides, padding)
        self.out_spatial = tuple(
            (n + lo + hi - k) // s + 1
            for n, k, s, (lo, hi) in zip(input_spatial, kernel_size, self.strides, self.pads))
        k = math.prod(kernel_size) * in_features
        self._setup((*self.out_spatial, k, features), (*self.out_spatial, features),
                    input_quantizer, kernel_quantizer, kernel_clip, use_bias, dtype)

    def _compute(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        flat = [0, 0]
        for lo, hi in reversed(self.pads):
            flat += [lo, hi]
        patches = F.pad(x.to(self.dtype), flat)
        for i, (k, s) in enumerate(zip(self.kernel_size, self.strides)):
            patches = patches.unfold(1 + i, k, s)  # [B, *out, C, *window]
        b = x.shape[0]
        p = math.prod(self.out_spatial)
        patches = patches.reshape(b, p, -1)
        w = kernel.to(self.dtype).reshape(p, *kernel.shape[-2:])
        y = torch.einsum("bpk,pkf->bpf", patches, w)
        return y.reshape(b, *self.out_spatial, -1)


class QuantLocallyConnected1D(QuantLocallyConnectedND):
    """1-D locally connected layer over [batch, width, channels] (larq
    ``QuantLocallyConnected1D``)."""

    def __init__(self, in_features: int, features: int, input_spatial: Sequence[int],
                 kernel_size: Sequence[int] = (3,), **kwargs):
        super().__init__(in_features, features, input_spatial, kernel_size, **kwargs)


class QuantLocallyConnected2D(QuantLocallyConnectedND):
    """2-D locally connected layer over NHWC (larq
    ``QuantLocallyConnected2D``)."""


class QuantConvTranspose(_LatentLayer):
    """Channels-last N-D transposed conv with optional input/kernel
    quantization (the JAX ``QuantConvTranspose``): JAX's
    ``lax.conv_transpose`` with ``transpose_kernel=False``, the kernel
    ``[*kernel_size, in_features, features]`` neither flipped nor IO-swapped
    (``models.keras_import.keras_transpose_kernel`` converts a Keras
    ``Conv2DTranspose`` kernel). "mxu" or "int8" (exact integer sums,
    :func:`~zookeeper_tpu_torch.ops.binary_compute.int8_conv_transpose`)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int] = (3, 3),
        strides: Optional[Sequence[int]] = None,
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
    ):
        super().__init__()
        name = type(self).__name__
        rank = len(kernel_size)
        self.strides = _per_dim(name, "strides", strides, rank)
        if binary_compute not in ("mxu", "int8"):
            raise ValueError(
                f"{name}: binary_compute={binary_compute!r} unsupported (packed kernels "
                "cover the 2-D forward conv only); use 'mxu' or 'int8'."
            )
        _check_named_padding(name, padding)
        check_binary_compute(binary_compute, name, input_quantizer, kernel_quantizer, padding)
        self.kernel_size = tuple(kernel_size)
        self.padding = padding
        self.binary_compute = binary_compute
        self._setup((*kernel_size, in_features, features), (features,), input_quantizer,
                    kernel_quantizer, kernel_clip, use_bias, dtype)

    def _compute(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        if self.binary_compute == "int8":
            return int8_conv_transpose(x, kernel, self.strides, self.padding, self.scaled)
        return float_conv_transpose(x.to(self.dtype), kernel, self.strides, self.padding)


class QuantDepthwiseConv(nn.Module):
    """Depthwise 2-D conv with optional input/kernel quantization (NHWC; the
    JAX ``QuantDepthwiseConv``): a :class:`QuantConv` with one group per
    input channel, held under flax's scope name ``QuantConv_0``, its kernel
    ``[kh, kw, 1, in_features * channel_multiplier]``. "mxu" and "int8"
    only: a depthwise contraction is kh*kw long, nothing for the packed
    kernels to compress."""

    def __init__(
        self,
        in_features: int,
        channel_multiplier: int = 1,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Sequence[int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        input_quantizer: Quantizer = None,
        kernel_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        binary_compute: str = "mxu",
    ):
        super().__init__()
        if binary_compute not in ("mxu", "int8"):
            raise ValueError(
                f"{type(self).__name__}: binary_compute={binary_compute!r} unsupported "
                "(depthwise K is kh*kw — nothing for the packed kernels to compress); "
                "use 'mxu' or 'int8'."
            )
        self.QuantConv_0 = QuantConv(
            in_features, in_features * channel_multiplier, kernel_size, strides, padding,
            input_quantizer=input_quantizer, kernel_quantizer=kernel_quantizer,
            kernel_clip=kernel_clip, use_bias=use_bias, dtype=dtype,
            binary_compute=binary_compute, feature_group_count=-1,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.QuantConv_0(x)


class QuantSeparableConvND(nn.Module):
    """N-D separable conv (depthwise, then pointwise), both stages
    optionally quantized (the JAX ``QuantSeparableConvND``):
    ``QuantConvND_0`` with one group per input channel, then the 1x..x1
    ``QuantConvND_1``. ``input_quantizer`` applies to the layer input only;
    ``intermediate_quantizer`` re-binarizes between the stages. Each stage
    runs "mxu" or "int8"."""

    _SPATIAL_RANK: Optional[int] = None

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int] = (3,),
        strides: Optional[Sequence[int]] = None,
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        channel_multiplier: int = 1,
        input_quantizer: Quantizer = None,
        depthwise_quantizer: Quantizer = None,
        pointwise_quantizer: Quantizer = None,
        intermediate_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        depthwise_compute: str = "mxu",
        pointwise_compute: str = "mxu",
    ):
        super().__init__()
        rank = _rank_of(type(self).__name__, kernel_size, self._SPATIAL_RANK)
        mid = in_features * channel_multiplier
        self.QuantConvND_0 = QuantConvND(
            in_features, mid, tuple(kernel_size), strides, padding,
            feature_group_count=in_features, input_quantizer=input_quantizer,
            kernel_quantizer=depthwise_quantizer, kernel_clip=kernel_clip, dtype=dtype,
            binary_compute=depthwise_compute,
        )
        self.QuantConvND_1 = QuantConvND(
            mid, features, (1,) * rank, input_quantizer=intermediate_quantizer,
            kernel_quantizer=pointwise_quantizer, kernel_clip=kernel_clip,
            use_bias=use_bias, dtype=dtype, binary_compute=pointwise_compute,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.QuantConvND_1(self.QuantConvND_0(x))


class QuantSeparableConv1D(QuantSeparableConvND):
    """1-D separable quant conv over [batch, width, channels] (larq
    ``QuantSeparableConv1D``)."""

    _SPATIAL_RANK = 1


class QuantSeparableConv(nn.Module):
    """Separable 2-D conv (depthwise, then pointwise), both stages
    optionally quantized (the JAX ``QuantSeparableConv``):
    ``QuantDepthwiseConv_0`` ("mxu"/"int8", ``depthwise_compute``), then a
    full 1x1 ``QuantConv_0`` (``pointwise_compute``, the packed paths and
    ``packed_weights`` included: on "xnor_popcount" it is a 1x1 K1 + K3).
    ``input_quantizer`` applies to the layer input only; the depthwise
    output reaches the pointwise stage unquantized unless
    ``intermediate_quantizer`` is set, which a binary pointwise path needs."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Sequence[int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        channel_multiplier: int = 1,
        input_quantizer: Quantizer = None,
        depthwise_quantizer: Quantizer = None,
        pointwise_quantizer: Quantizer = None,
        intermediate_quantizer: Quantizer = None,
        kernel_clip: bool = True,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        depthwise_compute: str = "mxu",
        pointwise_compute: str = "mxu",
        packed_weights: bool = False,
        binary_flavor: str = "auto",
    ):
        super().__init__()
        self.QuantDepthwiseConv_0 = QuantDepthwiseConv(
            in_features, channel_multiplier, kernel_size, strides, padding,
            input_quantizer=input_quantizer, kernel_quantizer=depthwise_quantizer,
            kernel_clip=kernel_clip, dtype=dtype, binary_compute=depthwise_compute,
        )
        self.QuantConv_0 = QuantConv(
            in_features * channel_multiplier, features, (1, 1),
            input_quantizer=intermediate_quantizer, kernel_quantizer=pointwise_quantizer,
            kernel_clip=kernel_clip, use_bias=use_bias, dtype=dtype,
            binary_compute=pointwise_compute, packed_weights=packed_weights,
            binary_flavor=binary_flavor,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.QuantConv_0(self.QuantDepthwiseConv_0(x))
