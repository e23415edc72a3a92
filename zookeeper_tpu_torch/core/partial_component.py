"""``PartialComponent``: a component class with some fields pre-bound.

Capability parity with the reference's
``zookeeper/core/partial_component.py`` (SURVEY.md §2.1): a configurable
``functools.partial`` for components. Used chiefly as a ``ComponentField``
default::

    @component
    class Experiment:
        optimizer: Optimizer = ComponentField(
            PartialComponent(Adam, learning_rate=1e-2)
        )

Pre-bound values are set on the fresh instance *before* configure(), so
explicit configuration keys still override them.
"""

from __future__ import annotations

import inspect
from typing import Any


class PartialComponent:
    def __init__(self, component_class: type, **field_values: Any):
        if not inspect.isclass(component_class):
            # Allow nesting: PartialComponent(PartialComponent(C, a=1), b=2)
            if isinstance(component_class, PartialComponent):
                merged = {**component_class.field_values, **field_values}
                component_class, field_values = (
                    component_class.component_class,
                    merged,
                )
            else:
                raise TypeError(
                    "PartialComponent expects a component class, got "
                    f"{component_class!r}."
                )
        if not getattr(component_class, "__component__", False):
            raise TypeError(
                f"{component_class.__name__} is not a @component class."
            )
        unknown = set(field_values) - set(component_class.__component_fields__)
        if unknown:
            raise TypeError(
                f"PartialComponent({component_class.__name__}): unknown "
                f"fields {sorted(unknown)}."
            )
        self.component_class = component_class
        self.field_values = dict(field_values)

    def with_overrides(self, **field_values: Any) -> "PartialComponent":
        return PartialComponent(
            self.component_class, **{**self.field_values, **field_values}
        )

    def __call__(self, **extra: Any) -> Any:
        return self.component_class(**{**self.field_values, **extra})

    def __repr__(self) -> str:
        bound = ", ".join(f"{k}={v!r}" for k, v in self.field_values.items())
        return f"PartialComponent({self.component_class.__name__}, {bound})"
