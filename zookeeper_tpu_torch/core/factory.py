"""Factories: components whose ``build()`` produces a value for a field.

Capability parity with the reference's ``zookeeper/core/factory.py`` +
``factory_registry.py`` (SURVEY.md §2.1): a ``@factory`` class implements
``build(self) -> T``; a plain ``Field`` annotated ``T`` can then be
satisfied by naming the factory in the configuration — the factory is
instantiated as a node of the component tree (so it has its own
configurable fields, participates in scope inheritance, etc.), configured,
and its ``build()`` result is type-checked against ``T`` and assigned::

    @factory
    class WarmupCosine:
        steps: int = Field()
        def build(self) -> Schedule: ...

    @component
    class Experiment:
        schedule: Schedule = Field()   # configure with schedule=WarmupCosine
"""

from __future__ import annotations

import inspect
import typing
from typing import Any, Dict, Mapping

from . import utils
from .component import component, is_component_class
from .utils import ConfigurationError, missing

#: All registered factory classes, keyed by class name.
FACTORY_REGISTRY: Dict[str, type] = {}


def factory(cls: type) -> type:
    """Class decorator registering a component as a factory."""
    build = getattr(cls, "build", None)
    if build is None or not callable(build):
        raise TypeError(
            f"@factory class {cls.__name__} must define a build(self) method."
        )
    try:
        return_type = typing.get_type_hints(build).get("return", missing)
    except Exception:
        # PEP 563 string annotations naming TYPE_CHECKING-only (or otherwise
        # unresolvable) types must not crash registration; the return-type
        # precheck is simply skipped and build() output is still checked
        # against the field annotation at configure time.
        return_type = missing
    if not is_component_class(cls):
        cls = component(cls)
    cls.__component_factory_return_type__ = return_type
    FACTORY_REGISTRY[cls.__name__] = cls
    return cls


def try_build_factory_value(
    host: Any,
    field: Any,
    name_value: str,
    conf: Mapping[str, Any],
    child_path: str,
    interactive: bool,
    used_keys: set,
) -> Any:
    """Attempt to satisfy ``field`` with a factory named ``name_value``.

    Called from configure() when a string conf value does not directly
    type-check against the field annotation. Returns the built value, or
    ``missing`` if no factory by that name exists.
    """
    from .component import _NAME, _PARENT, _configure_component  # noqa: PLC0415

    fcls = utils.registry_lookup(FACTORY_REGISTRY, name_value, "Factory")
    if fcls is None:
        return missing
    ret = fcls.__component_factory_return_type__
    if (
        ret is not missing
        and field.type is not None
        and inspect.isclass(ret)
        and inspect.isclass(field.type)
        and not issubclass(ret, field.type)
    ):
        raise ConfigurationError(
            f"Factory '{fcls.__name__}' builds "
            f"'{utils.type_name(ret)}', which does not satisfy field "
            f"'{child_path}' of type '{utils.type_name(field.type)}'."
        )
    instance = fcls()
    object.__setattr__(instance, _PARENT, host)
    object.__setattr__(instance, _NAME, field.name)
    _configure_component(instance, conf, child_path, interactive, used_keys)
    value = instance.build()
    if not field.check_type(value):
        raise TypeError(
            f"Factory '{fcls.__name__}'.build() returned {value!r}, which "
            f"does not satisfy field '{child_path}' of type "
            f"'{utils.type_name(field.type)}'."
        )
    return value
