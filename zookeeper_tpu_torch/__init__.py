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


def _resolve_version() -> str:
    """The version in the ``pyproject.toml`` beside the package (this
    checkout's), else the installed distribution's, else a sentinel that
    no release carries."""
    try:
        import os
        import tomllib

        pyproject = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                 "pyproject.toml")
        with open(pyproject, "rb") as f:
            project = tomllib.load(f)["project"]
        if project["name"] == "zookeeper-tpu":
            return project["version"]
    except (OSError, KeyError, ImportError, ValueError):
        pass
    try:
        from importlib.metadata import version

        return version("zookeeper-tpu")
    except Exception:
        return "0.0.0+unknown"


__version__ = _resolve_version()


def __getattr__(name):
    # ``cli`` needs click: loaded on first use, as ``core`` loads it.
    if name == "cli":
        from zookeeper_tpu_torch import core

        return core.cli
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ComponentField",
    "ConfigurationError",
    "Field",
    "PartialComponent",
    "cli",
    "component",
    "configure",
    "factory",
    "pretty_print",
    "task",
    "__version__",
]
