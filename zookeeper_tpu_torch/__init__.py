"""zookeeper_tpu_torch: the PyTorch/CUDA port of zookeeper_tpu.

A second package beside the JAX one, with the same layout (``core``,
``ops``, ``models``, ``serving``) and hand-written CUDA kernels for an
NVIDIA Hopper card under ``csrc/``. It imports ``torch`` and numpy and
nothing of JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs the plain
PyTorch version that sits beside its kernel.
"""

from zookeeper_tpu_torch.core import (
    ComponentField,
    ConfigurationError,
    Field,
    PartialComponent,
    component,
    configure,
    factory,
    pretty_print,
    task,
)

__all__ = [
    "ComponentField",
    "ConfigurationError",
    "Field",
    "PartialComponent",
    "component",
    "configure",
    "factory",
    "pretty_print",
    "task",
]
