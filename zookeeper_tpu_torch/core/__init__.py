"""Core component/config system — pure Python, framework-agnostic.

The port's own copy of the config system (``@component``, ``Field``,
``ComponentField``, ``configure``, ``@task`` and the ``key=value`` CLI),
so the PyTorch package stands without the JAX package. ``cli`` and
``ConfigParam`` load on first use: they need ``click``, and a program
that only configures components does not.
"""

from .component import (
    component,
    component_path,
    configure,
    configured_field_names,
    is_component_class,
    is_component_instance,
    pretty_print,
)
from .factory import FACTORY_REGISTRY, factory
from .field import ComponentField, Field
from .partial_component import PartialComponent
from .task import TASK_REGISTRY, get_task, task
from .utils import ConfigurationError, missing


def __getattr__(name):
    if name in ("cli", "ConfigParam"):
        import importlib

        module = importlib.import_module(".cli", __name__)
        # Importing the submodule binds the package attribute ``cli`` to
        # the module; rebind both names to what the package exports.
        globals().update(cli=module.cli, ConfigParam=module.ConfigParam)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ConfigParam",
    "cli",
    "component",
    "component_path",
    "configure",
    "configured_field_names",
    "is_component_class",
    "is_component_instance",
    "pretty_print",
    "FACTORY_REGISTRY",
    "factory",
    "ComponentField",
    "Field",
    "PartialComponent",
    "TASK_REGISTRY",
    "get_task",
    "task",
    "ConfigurationError",
    "missing",
]
