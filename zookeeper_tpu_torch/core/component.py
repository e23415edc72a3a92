"""The ``@component`` decorator and ``configure()`` — the heart of the
config system.

Capability parity with the reference's ``zookeeper/core/component.py``
(SURVEY.md §2.1, §3.2 — the behavior contract):

- ``@component`` turns a plain class into a configurable component: collects
  ``Field`` declarations from the class body and all bases, routes attribute
  access through scoped resolution, enforces post-``configure`` immutability,
  and pretty-prints the resolved tree.
- ``configure(instance, conf, name=..., interactive=False)`` walks the
  component tree, applies dotted-key overrides (``"dataset.batch_size": 32``),
  instantiates nested components (subclass-by-name for ``ComponentField``),
  runtime-type-checks every value, and optionally prompts interactively.

Value precedence (SURVEY.md §3.2)::

    conf["<scoped>.<name>"] > conf["<name>"]
      > ancestor component's *set* same-named field   (scope inheritance)
      > own Field default (lazily evaluated)
      > ancestor's same-named field default
      > interactive prompt (if enabled) > error / allow_missing

Pure Python, zero ML-framework dependencies (SURVEY.md §5: the core stays
framework-agnostic).
"""

from __future__ import annotations

import inspect
import sys
from typing import Any, Dict, Mapping, Optional

from . import utils
from .field import ComponentField, Field
from .utils import ConfigurationError, missing

# Instance-state attribute names (set via object.__setattr__ to bypass
# the immutability guard and the Field descriptors).
_VALUES = "__component_values__"
_CACHED = "__component_cached_defaults__"
_PARENT = "__component_parent__"
_NAME = "__component_instance_name__"
_CONFIGURED = "__component_configured__"


def is_component_class(cls: Any) -> bool:
    return inspect.isclass(cls) and getattr(cls, "__component__", False)


def is_component_instance(obj: Any) -> bool:
    return getattr(type(obj), "__component__", False)


# ---------------------------------------------------------------------------
# Field value resolution (called from Field.__get__ / Field.__set__)
# ---------------------------------------------------------------------------


def _state(instance: Any, attr: str) -> Any:
    try:
        return object.__getattribute__(instance, attr)
    except AttributeError:
        raise TypeError(
            f"{type(instance).__name__} is not an initialized component "
            "instance — is the class decorated with @component (or "
            "@task/@factory) and instantiated normally?"
        ) from None


def resolve_field_value(instance: Any, field: Field) -> Any:
    """Resolve ``instance.<field.name>`` per the precedence contract."""
    name = field.name
    values = _state(instance, _VALUES)
    # 1. Value set on this instance (configured or pre-assigned).
    if name in values:
        return values[name]
    # 2. Nearest ancestor with a *set* same-named field.
    parent = _state(instance, _PARENT)
    while parent is not None:
        if name in type(parent).__component_fields__:
            pvalues = _state(parent, _VALUES)
            if name in pvalues:
                return pvalues[name]
        parent = _state(parent, _PARENT)
    # 3. Own default, lazily evaluated and cached.
    cached = _state(instance, _CACHED)
    if name in cached:
        return cached[name]
    if field.has_default:
        value = field.get_default(instance)
        cached[name] = value
        return value
    # 4. Nearest ancestor's same-named field default.
    parent = _state(instance, _PARENT)
    while parent is not None:
        pfield = type(parent).__component_fields__.get(name)
        if pfield is not None and pfield.has_default:
            pcached = _state(parent, _CACHED)
            if name in pcached:
                return pcached[name]
            value = pfield.get_default(parent)
            pcached[name] = value
            return value
        parent = _state(parent, _PARENT)
    # 5. Missing.
    raise AttributeError(
        f"Field '{name}' of component '{component_path(instance)}' has no "
        "configured value, no default, and none is inherited from a parent "
        "component."
    )


def set_field_value(instance: Any, field: Field, value: Any) -> None:
    if _state(instance, _CONFIGURED):
        raise AttributeError(
            f"Cannot set field '{field.name}' on component "
            f"'{component_path(instance)}': components are immutable after "
            "configure()."
        )
    if not isinstance(field, ComponentField) and not field.check_type(value):
        raise TypeError(
            f"Field '{field.name}' of component '{type(instance).__name__}' "
            f"expects type '{utils.type_name(field.type)}', got "
            f"{value!r} of type '{type(value).__name__}'."
        )
    _state(instance, _VALUES)[field.name] = value


def component_path(instance: Any) -> str:
    """Dotted path of this component instance from the configuration root."""
    parts = []
    node = instance
    while node is not None:
        parts.append(_state(node, _NAME) or type(node).__name__)
        node = _state(node, _PARENT)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# The @component decorator
# ---------------------------------------------------------------------------


def _collect_fields(cls: type) -> Dict[str, Field]:
    fields: Dict[str, Field] = {}
    for klass in reversed(cls.__mro__):
        annotations = klass.__dict__.get("__annotations__", {})
        # PEP 563 (`from __future__ import annotations`) leaves annotations
        # as strings; resolve them against the defining module so
        # ComponentField base types are real classes. Resolution is
        # per-annotation: one unresolvable name (e.g. TYPE_CHECKING-only)
        # degrades only its own field, not the whole class.
        if any(isinstance(v, str) for v in annotations.values()):
            module = sys.modules.get(klass.__module__)
            globalns = getattr(module, "__dict__", {})
            localns = dict(vars(klass))
            resolved = {}
            for k, v in annotations.items():
                if isinstance(v, str):
                    try:
                        v = eval(v, globalns, localns)  # noqa: S307
                    except Exception:
                        pass
                resolved[k] = v
            annotations = resolved
        for attr_name, attr_value in vars(klass).items():
            if isinstance(attr_value, Field):
                attr_value.attach(
                    klass, attr_name, annotations.get(attr_name, missing)
                )
                # Validate concrete defaults against the annotation at
                # declaration time (lazy/callable defaults check at access).
                if (
                    not isinstance(attr_value, ComponentField)
                    and attr_value.has_default
                    and not callable(attr_value._default)
                    and not attr_value.check_type(attr_value._default)
                ):
                    raise TypeError(
                        f"Default for field '{attr_name}' of "
                        f"'{cls.__name__}' must have type "
                        f"'{utils.type_name(attr_value.type)}', got "
                        f"{attr_value._default!r}."
                    )
                fields[attr_name] = attr_value
    return fields


def _component_init_subclass(cls: type, **kwargs: Any) -> None:
    # Cooperative chaining: invoke the next __init_subclass__ in the MRO
    # that is not this hook (mixins doing their own subclass registration,
    # and ultimately object's, which rejects stray class kwargs).
    for base in cls.__mro__[1:]:
        hook = base.__dict__.get("__init_subclass__")
        if hook is None:
            continue
        func = getattr(hook, "__func__", hook)
        if func is _component_init_subclass:
            continue
        func(cls, **kwargs)
        break
    cls.__component_fields__ = _collect_fields(cls)


def _component_init(self: Any, **kwargs: Any) -> None:
    object.__setattr__(self, _VALUES, {})
    object.__setattr__(self, _CACHED, {})
    object.__setattr__(self, _PARENT, None)
    object.__setattr__(self, _NAME, None)
    object.__setattr__(self, _CONFIGURED, False)
    fields = type(self).__component_fields__
    for key, value in kwargs.items():
        if key not in fields:
            raise TypeError(
                f"{type(self).__name__}() got an unexpected keyword argument "
                f"'{key}' (not a declared Field)."
            )
        setattr(self, key, value)


def _component_setattr(self: Any, name: str, value: Any) -> None:
    fields = type(self).__component_fields__
    if name in fields:
        set_field_value(self, fields[name], value)
        return
    # Immutability applies to declared Fields only: run() methods are free
    # to stash ordinary instance state (models, metrics, ...) on self.
    object.__setattr__(self, name, value)


def _render_value(value: Any, indent: int, color: bool) -> str:
    if is_component_instance(value):
        return _render_component(value, indent, color)
    return repr(value)


def _style(text: str, color: bool, **kwargs: Any) -> str:
    if not color:
        return text
    import click

    return click.style(text, **kwargs)


def _render_component(instance: Any, indent: int = 0, color: bool = False) -> str:
    pad = "    " * (indent + 1)
    lines = [_style(type(instance).__name__, color, fg="blue", bold=True) + "("]
    for name, field in type(instance).__component_fields__.items():
        try:
            value = getattr(instance, name)
            rendered = _render_value(value, indent + 1, color)
        except AttributeError:
            rendered = _style("<missing>", color, fg="red")
        lines.append(f"{pad}{_style(name, color, fg='cyan')}={rendered},")
    lines.append("    " * indent + ")")
    return "\n".join(lines)


def _component_str(self: Any) -> str:
    return _render_component(self, 0, color=False)


def _component_repr(self: Any) -> str:
    status = "configured" if _state(self, _CONFIGURED) else "unconfigured"
    return f"<{type(self).__name__} component ({status})>"


def component(cls: type) -> type:
    """Class decorator that turns a plain class into a component."""
    if not inspect.isclass(cls):
        raise TypeError("@component can only be applied to classes.")
    if "__component_decorated__" in vars(cls):
        raise TypeError(f"{cls.__name__} is already a component.")
    cls.__component_decorated__ = True
    if "__init__" in vars(cls):
        raise TypeError(
            f"Component {cls.__name__} must not define __init__: field "
            "values are provided via configure() or keyword arguments to "
            "the generated constructor."
        )
    cls.__component__ = True
    cls.__component_fields__ = _collect_fields(cls)
    cls.__init__ = _component_init
    cls.__setattr__ = _component_setattr
    # Subclasses declare new/overriding Fields without re-decorating (e.g.
    # an @task subclass of a component base): re-collect on subclassing.
    cls.__init_subclass__ = classmethod(_component_init_subclass)
    if "__str__" not in vars(cls):
        cls.__str__ = _component_str
    if "__repr__" not in vars(cls):
        cls.__repr__ = _component_repr
    return cls


def pretty_print(instance: Any, color: bool = True) -> str:
    """Render the resolved component tree (click-styled when ``color``)."""
    return _render_component(instance, 0, color=color)


def configured_field_names(instance: Any) -> frozenset:
    """Names of fields EXPLICITLY set on this component — by configure()
    keys, pre-bound PartialComponent overrides, or direct assignment —
    as opposed to defaults or scope inheritance.

    Lets a component distinguish "the user asked for this" from "this is
    just the default" (e.g. to reject configuration that it would
    otherwise silently ignore).
    """
    return frozenset(_state(instance, _VALUES))


# ---------------------------------------------------------------------------
# configure()
# ---------------------------------------------------------------------------


def _scoped_lookup(conf: Mapping[str, Any], path: str, name: str):
    """Find the most specific conf key for field ``name`` at dotted ``path``.

    For path ``dataset.preprocessing`` and field ``size``, tries
    ``dataset.preprocessing.size``, ``preprocessing.size``, ``size`` in that
    order (longest scoped match wins; unscoped keys propagate to the whole
    subtree — SURVEY.md §3.2).
    Returns (key, value) or (None, missing).
    """
    segments = path.split(".") if path else []
    for start in range(len(segments) + 1):
        key = ".".join(segments[start:] + [name])
        if key in conf:
            return key, conf[key]
    return None, missing


def _applicable_overrides(field: ComponentField, target_cls: type) -> dict:
    """The ComponentField's pre-bound overrides, restricted to fields the
    (possibly user-selected, non-default) target class actually declares.
    They act as soft defaults: scoped conf keys still beat them."""
    declared = getattr(target_cls, "__component_fields__", {})
    return {k: v for k, v in field.field_overrides.items() if k in declared}


def _resolve_component_target(
    field: ComponentField, conf_value: Any, interactive: bool
) -> Any:
    """Turn a conf value / default into a component *instance* (or missing)."""
    from .partial_component import PartialComponent

    if conf_value is not missing:
        if isinstance(conf_value, str):
            target_cls = utils.find_subclass_by_name(field.base_type, conf_value)
            return target_cls(**_applicable_overrides(field, target_cls))
        if isinstance(conf_value, PartialComponent):
            merged = _applicable_overrides(field, conf_value.component_class)
            merged.update(conf_value.field_values)
            return conf_value.component_class(**merged)
        if inspect.isclass(conf_value):
            return conf_value(**_applicable_overrides(field, conf_value))
        return conf_value  # Already an instance.
    return missing


def _configure_component(
    instance: Any,
    conf: Mapping[str, Any],
    path: str,
    interactive: bool,
    used_keys: set,
) -> None:
    from .factory import try_build_factory_value

    cls = type(instance)
    values = _state(instance, _VALUES)
    cached = _state(instance, _CACHED)

    # Three phases: (A) plain Fields, (B) ComponentField instantiation +
    # parent attachment, (C) recursion into children. All of THIS
    # component's fields (including later-declared sibling components) are
    # set before any descendant configures, so scope inheritance is
    # independent of field declaration order.
    ordered = sorted(
        cls.__component_fields__.items(),
        key=lambda kv: isinstance(kv[1], ComponentField),
    )
    recurse: list = []
    for name, field in ordered:
        key, conf_value = _scoped_lookup(conf, path, name)
        if key is not None:
            used_keys.add(key)
        child_path = f"{path}.{name}" if path else name

        if isinstance(field, ComponentField):
            child = _resolve_component_target(field, conf_value, interactive)
            defaulted = False
            if child is missing:
                if name in values:
                    # Pre-assigned values resolve exactly like conf values
                    # (class / PartialComponent / instance all behave the
                    # same through either entry point).
                    child = _resolve_component_target(
                        field, values[name], interactive
                    )
                elif _inherited_from_ancestor(instance, name):
                    # An ancestor's *explicitly-set* same-named component is
                    # shared by scope inheritance (beats our own default —
                    # explicit beats implicit). Type-check it now.
                    inherited = _inherited_value(instance, name)
                    if (
                        field.type is not None
                        and inspect.isclass(field.type)
                        and not isinstance(inherited, field.type)
                    ):
                        raise TypeError(
                            f"Component field '{child_path}' expects an "
                            f"instance of '{utils.type_name(field.type)}', "
                            "but inherits "
                            f"'{type(inherited).__name__}' from an ancestor."
                        )
                    continue
                elif field.has_default:
                    child = field.instantiate_default()
                    defaulted = True
                elif _ancestor_has_default(instance, name):
                    continue  # Ancestor's default resolves at access time.
                elif interactive:
                    candidates = [
                        c
                        for c in utils.generate_subclasses(field.base_type)
                        if not inspect.isabstract(c) and is_component_class(c)
                    ]
                    target_cls = utils.prompt_for_component_subclass(
                        child_path, candidates
                    )
                    child = target_cls(**field.field_overrides)
                elif field.allow_missing:
                    continue
                else:
                    raise ConfigurationError(
                        f"No value provided for component field '{child_path}' "
                        f"(base type '{utils.type_name(field.base_type)}') and "
                        "it declares no default."
                    )
            if not is_component_instance(child):
                raise ConfigurationError(
                    f"Component field '{child_path}' resolved to {child!r}, "
                    "which is not a component instance."
                )
            if field.type is not None and inspect.isclass(field.type):
                if not isinstance(child, field.type):
                    raise TypeError(
                        f"Component field '{child_path}' expects an instance "
                        f"of '{utils.type_name(field.type)}', got "
                        f"'{type(child).__name__}'."
                    )
            # A default-instantiated child lives in the lazy-default cache,
            # not in values: a *descendant's* own default must not be
            # overridden by this mere default (explicit beats implicit),
            # mirroring how plain-Field defaults stay out of _VALUES.
            if defaulted:
                cached[name] = child
            else:
                values[name] = child
            object.__setattr__(child, _PARENT, instance)
            object.__setattr__(child, _NAME, name)
            recurse.append((child, child_path))
            continue

        # Plain Field.
        if conf_value is not missing:
            if isinstance(conf_value, str) and not field.check_type(conf_value):
                built = try_build_factory_value(
                    instance, field, conf_value, conf, child_path, interactive,
                    used_keys,
                )
                if built is not missing:
                    values[name] = built
                    continue
            if not field.check_type(conf_value):
                raise TypeError(
                    f"Configured value for field '{child_path}' must have "
                    f"type '{utils.type_name(field.type)}', got "
                    f"{conf_value!r} of type '{type(conf_value).__name__}'."
                )
            values[name] = conf_value
        elif name in values:
            pass  # Pre-assigned before configure; already type-checked.
        elif _inherited_from_ancestor(instance, name):
            # Explicitly-set ancestor value: resolved lazily at access, but
            # type-checked against THIS field's annotation now so bad
            # inherited types fail at configure time, not deep in training.
            inherited = _inherited_value(instance, name)
            if not field.check_type(inherited):
                raise TypeError(
                    f"Field '{child_path}' expects type "
                    f"'{utils.type_name(field.type)}', but inherits "
                    f"{inherited!r} of type '{type(inherited).__name__}' "
                    "from an ancestor component."
                )
        elif field.has_default or _ancestor_has_default(instance, name):
            pass  # Resolved lazily at access time.
        elif interactive:
            value = utils.prompt_for_value(child_path, field.type)
            if not field.check_type(value):
                raise TypeError(
                    f"Value entered for field '{child_path}' must have type "
                    f"'{utils.type_name(field.type)}', got {value!r}."
                )
            values[name] = value
        elif field.allow_missing:
            pass
        else:
            raise ConfigurationError(
                f"No value provided for field '{child_path}' of type "
                f"'{utils.type_name(field.type)}': not in the configuration, "
                "no default, and nothing to inherit from a parent component. "
                "Pass a value (e.g. on the CLI as "
                f"'{child_path}=<value>') or run with --interactive."
            )

    # Phase C: recurse into children only after every field of this
    # component is resolved, so descendants can inherit later-declared
    # sibling values.
    for child, child_path in recurse:
        _configure_component(child, conf, child_path, interactive, used_keys)

    object.__setattr__(instance, _CONFIGURED, True)


def _inherited_value(instance: Any, name: str) -> Any:
    """The nearest ancestor's explicitly-set value for ``name`` (or missing)."""
    parent = _state(instance, _PARENT)
    while parent is not None:
        if name in type(parent).__component_fields__:
            pvalues = _state(parent, _VALUES)
            if name in pvalues:
                return pvalues[name]
        parent = _state(parent, _PARENT)
    return missing


def _inherited_from_ancestor(instance: Any, name: str) -> bool:
    return _inherited_value(instance, name) is not missing


def _ancestor_has_default(instance: Any, name: str) -> bool:
    parent = _state(instance, _PARENT)
    while parent is not None:
        pfield = type(parent).__component_fields__.get(name)
        if pfield is not None and pfield.has_default:
            return True
        parent = _state(parent, _PARENT)
    return False


def configure(
    instance: Any,
    conf: Optional[Mapping[str, Any]] = None,
    name: Optional[str] = None,
    interactive: bool = False,
) -> Any:
    """Configure a component tree in place and freeze it.

    Args:
        instance: the root component instance (e.g. an ``@task``).
        conf: mapping of (optionally dotted) field names to values, e.g.
            ``{"epochs": 10, "dataset": "Mnist", "dataset.batch_size": 32}``.
        name: root instance name (defaults to the snake-cased class name);
            used in error messages and the printed tree.
        interactive: prompt on stdin for missing values instead of raising.

    Returns:
        ``instance`` (configured and immutable), for chaining.
    """
    if not is_component_instance(instance):
        raise TypeError(
            f"configure() expects a component instance, got {instance!r}."
        )
    if _state(instance, _CONFIGURED):
        raise ConfigurationError(
            f"Component '{type(instance).__name__}' is already configured."
        )
    conf = dict(conf or {})
    object.__setattr__(
        instance,
        _NAME,
        name or utils.convert_to_snake_case(type(instance).__name__),
    )
    used_keys: set = set()
    _configure_component(instance, conf, "", interactive, used_keys)
    unused = set(conf) - used_keys
    if unused:
        raise ConfigurationError(
            f"Configuration keys {sorted(unused)} did not match any field of "
            f"the component tree rooted at '{type(instance).__name__}'. "
            "Check for typos (keys may be scoped, e.g. "
            "'dataset.batch_size')."
        )
    return instance
