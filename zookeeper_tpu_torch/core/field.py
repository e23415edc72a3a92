"""Field descriptors for the component/config system.

Capability parity with the reference's ``zookeeper/core/field.py``
(SURVEY.md §2.1): ``Field`` declares a typed config leaf with an optional
(possibly lazy) default; ``ComponentField`` declares a nested sub-component
slot that is overridable by subclass *name* from config/CLI.

Value-resolution precedence for ``instance.field`` (SURVEY.md §3.2/§3.4):

1. value set on this instance (by ``configure()`` or by direct assignment
   before configuration);
2. value *set* on the nearest ancestor component that declares a
   same-named field — this is scoped field inheritance, the signature
   config-reuse mechanism (set ``batch_size`` once on the experiment; the
   dataset inherits it);
3. this field's own default (lazily evaluated and cached if callable);
4. the default of the nearest ancestor's same-named field;
5. error (or AttributeError if ``allow_missing``).

Explicit beats implicit: an ancestor's *configured* value overrides a
child's default, but an ancestor's mere default does not.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, TypeVar, Union

from . import utils
from .utils import ConfigurationError, missing

T = TypeVar("T")


class Field:
    """A typed configurable value declared in a component class body::

        @component
        class Hyper:
            batch_size: int = Field(32)
            lr: float = Field(lambda self: 0.1 * self.batch_size / 256)

        @component
        class Net:
            @Field
            def hidden_sizes(self) -> list:
                return [64, 64]

    The default may be:

    - a concrete value (type-checked at configure time);
    - a zero-argument callable, evaluated lazily on first access;
    - a one-argument callable receiving the component instance, enabling
      derived defaults (``@Field`` on a method is the idiomatic spelling).
    """

    def __init__(self, default: Any = missing, *, allow_missing: bool = False):
        self._default = default
        self.allow_missing = allow_missing
        self.name: Optional[str] = None
        self.host_component_class: Optional[type] = None
        self._type: Any = missing
        # ``@Field`` decorator form: infer the type from the function's
        # return annotation.
        if callable(default) and not inspect.isclass(default):
            ret = getattr(default, "__annotations__", {}).get("return", missing)
            if ret is not missing:
                self._type = ret

    # -- declaration-time wiring ------------------------------------------

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name
        self.host_component_class = owner
        if self._type is missing:
            self._type = owner.__dict__.get("__annotations__", {}).get(name, missing)

    def attach(self, owner: type, name: str, annotation: Any = missing) -> None:
        """Explicit wiring used by the @component decorator for inherited
        fields and annotation resolution."""
        if self.name is None:
            self.name = name
        if self.host_component_class is None:
            self.host_component_class = owner
        if annotation is not missing and (
            self._type is missing or isinstance(self._type, str)
        ):
            self._type = annotation

    @property
    def type(self) -> Any:
        return None if self._type is missing else self._type

    @property
    def has_default(self) -> bool:
        return self._default is not missing

    def get_default(self, instance: Any) -> Any:
        """Evaluate this field's default in the context of ``instance``."""
        if not self.has_default:
            raise AttributeError(
                f"Field '{self.name}' has no default and no configured value."
            )
        default = self._default
        if callable(default) and not inspect.isclass(default):
            try:
                n_params = len(inspect.signature(default).parameters)
            except (TypeError, ValueError):
                n_params = 0
            return default(instance) if n_params >= 1 else default()
        # Concrete defaults are deep-copied per instance so mutating one
        # instance's value never poisons the class-level default or siblings.
        import copy

        return copy.deepcopy(default)

    def check_type(self, value: Any) -> bool:
        return utils.type_check(value, self.type) if self.type is not None else True

    # -- descriptor protocol ----------------------------------------------
    # The actual resolution logic lives on the component instance side
    # (component._resolve_field) because it needs the parent chain; the
    # descriptor just delegates.

    def __get__(self, instance: Any, owner: Optional[type] = None) -> Any:
        if instance is None:
            return self
        from .component import resolve_field_value

        return resolve_field_value(instance, self)

    def __set__(self, instance: Any, value: Any) -> None:
        from .component import set_field_value

        set_field_value(instance, self, value)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(name={self.name!r}, "
            f"type={utils.type_name(self.type)}, "
            f"default={'<lazy>' if callable(self._default) else self._default!r})"
        )


class ComponentField(Field):
    """A nested sub-component slot::

        @component
        class Experiment:
            dataset: Dataset = ComponentField(Mnist)

    The declared annotation (``Dataset``) is the lookup base: a config/CLI
    value ``dataset=Cifar10`` resolves ``Cifar10`` among ``Dataset``'s
    subclasses and instantiates it (SURVEY.md §3.2). ``**field_overrides``
    pre-bind field values on the default class, i.e.
    ``ComponentField(Adam, learning_rate=1e-2)`` behaves like a
    ``PartialComponent``.
    """

    def __init__(
        self,
        default_class: Union[type, "Any", None] = None,
        *,
        allow_missing: bool = False,
        **field_overrides: Any,
    ):
        super().__init__(
            missing if default_class is None else default_class,
            allow_missing=allow_missing,
        )
        self.field_overrides = dict(field_overrides)
        if default_class is not None and not self._is_acceptable_default(default_class):
            raise TypeError(
                "ComponentField default must be a class or PartialComponent, "
                f"got {default_class!r}."
            )
        # Catch override typos at declaration time (consistent with
        # PartialComponent): overrides must name fields the default class
        # declares. For conf-selected sibling subclasses they still act as
        # soft defaults, filtered to the fields that class declares.
        dc = self.default_class
        declared = getattr(dc, "__component_fields__", None)
        if self.field_overrides and declared is not None:
            unknown = sorted(k for k in self.field_overrides if k not in declared)
            if unknown:
                raise TypeError(
                    f"ComponentField override(s) {unknown} are not declared "
                    f"Fields of default class '{dc.__name__}'."
                )

    @staticmethod
    def _is_acceptable_default(value: Any) -> bool:
        from .partial_component import PartialComponent

        return inspect.isclass(value) or isinstance(value, PartialComponent)

    @property
    def default_class(self) -> Optional[type]:
        from .partial_component import PartialComponent

        if not self.has_default:
            return None
        if isinstance(self._default, PartialComponent):
            return self._default.component_class
        return self._default

    def instantiate_default(self) -> Any:
        """Instantiate the default class with any pre-bound overrides."""
        from .partial_component import PartialComponent

        if not self.has_default:
            raise AttributeError(f"ComponentField '{self.name}' has no default.")
        default = self._default
        if isinstance(default, PartialComponent):
            if self.field_overrides:
                default = default.with_overrides(**self.field_overrides)
            return default()
        return default(**self.field_overrides)

    @property
    def base_type(self) -> type:
        """The lookup base for subclass-by-name resolution: the declared
        annotation if it is a class, else the default class."""
        if inspect.isclass(self.type):
            return self.type
        dc = self.default_class
        if dc is not None:
            return dc
        raise ConfigurationError(
            f"ComponentField '{self.name}' has neither a class annotation nor "
            "a default class; cannot resolve subcomponents by name."
        )

    def get_default(self, instance: Any) -> Any:
        # Never reached through normal resolution (configure() instantiates
        # sub-components), but direct access on an unconfigured component
        # should still work for interactive exploration.
        return self.instantiate_default()
