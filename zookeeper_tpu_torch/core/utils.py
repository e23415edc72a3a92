"""Shared helpers for the core component/config system.

Capability parity with the reference's ``zookeeper/core/utils.py`` (see
SURVEY.md §2.1 — reference mount was empty; parity is to the surveyed
contract, not to literal code): runtime type checking against ``typing``
annotations, the missing-value sentinel, camel/snake name munging, subclass
enumeration for subclass-by-name lookup, and interactive prompting.

This module (like the whole ``core`` package) is pure Python with zero
JAX/TF dependencies so the config system stays framework-agnostic.
"""

from __future__ import annotations

import ast
import re
import typing
from typing import Any, Iterator, Optional, Type


class _Missing:
    """Sentinel for "no value provided" (``None`` is a legitimate value)."""

    _instance: Optional["_Missing"] = None

    def __new__(cls) -> "_Missing":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "<missing>"

    def __bool__(self) -> bool:
        return False


#: The singleton missing-value sentinel.
missing = _Missing()


class ConfigurationError(Exception):
    """Raised when a component tree cannot be configured as requested."""


def type_check(value: Any, annotation: Any) -> bool:
    """Return True iff ``value`` conforms to the ``typing`` annotation."""
    if annotation is Any or annotation is None:
        return True
    try:
        import typeguard

        mismatch_error: tuple = (TypeError,)
        if hasattr(typeguard, "TypeCheckError"):  # typeguard >= 3
            mismatch_error = (typeguard.TypeCheckError,)
            check = lambda: typeguard.check_type(value, annotation)  # noqa: E731
        else:  # typeguard 2.x: check_type(argname, value, expected_type)
            check = lambda: typeguard.check_type("value", value, annotation)  # noqa: E731
        try:
            check()
            return True
        except mismatch_error:
            return False
    except Exception:
        # Exotic annotations typeguard cannot handle fall back to a
        # best-effort isinstance check below.
        pass
    origin = typing.get_origin(annotation)
    if origin is None:
        try:
            return isinstance(value, annotation)
        except TypeError:
            return True  # Unevaluable annotation: do not block configuration.
    try:
        return isinstance(value, origin)
    except TypeError:
        return True


def type_name(annotation: Any) -> str:
    """Human-readable name of a type annotation for error messages."""
    if annotation is None:
        return "None"
    if hasattr(annotation, "__name__"):
        return annotation.__name__
    return str(annotation).replace("typing.", "")


_CAMEL_BOUNDARY_1 = re.compile(r"(.)([A-Z][a-z]+)")
_CAMEL_BOUNDARY_2 = re.compile(r"([a-z0-9])([A-Z])")


def convert_to_snake_case(name: str) -> str:
    """``QuickNetLarge`` -> ``quick_net_large``."""
    s = _CAMEL_BOUNDARY_1.sub(r"\1_\2", name)
    return _CAMEL_BOUNDARY_2.sub(r"\1_\2", s).lower()


def is_pep_8_module_name(name: str) -> bool:
    return re.fullmatch(r"[a-z_][a-z0-9_]*", name) is not None


def generate_subclasses(cls: type) -> Iterator[type]:
    """Yield ``cls`` and all its (transitive) subclasses, depth-first.

    This drives subclass-by-name lookup for ``ComponentField``s
    (SURVEY.md §3.2): config value ``dataset=Mnist`` searches the subclass
    tree of the field's declared base for a class named ``Mnist``.
    """
    seen = set()
    stack = [cls]
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        yield c
        stack.extend(c.__subclasses__())


def find_subclass_by_name(base: type, name: str) -> Type:
    """Resolve a class by name among ``base`` and its subclasses.

    Accepts both the exact class name (``Mnist``) and its snake-case form
    (``mnist``). Raises ConfigurationError on no match or ambiguity.
    """
    matches = [
        c
        for c in generate_subclasses(base)
        if c.__name__ == name or convert_to_snake_case(c.__name__) == name
    ]
    if not matches:
        raise ConfigurationError(
            f"No class named '{name}' found among subclasses of "
            f"'{base.__name__}'. Known: "
            f"{sorted(c.__name__ for c in generate_subclasses(base))}."
        )
    # Identical class objects reachable twice are already deduplicated by
    # generate_subclasses; distinct classes sharing a name are ambiguous.
    if len(matches) > 1:
        raise ConfigurationError(
            f"Class name '{name}' is ambiguous among subclasses of "
            f"'{base.__name__}': "
            f"{[c.__module__ + '.' + c.__name__ for c in matches]}. "
        )
    return matches[0]


def registry_lookup(registry: dict, name: str, kind: str) -> Optional[type]:
    """Resolve ``name`` in a class registry, accepting the exact class name
    or its snake-case form, with an ambiguity check (shared by the task and
    factory registries so the matching rules cannot drift)."""
    if name in registry:
        return registry[name]
    matches = [
        c for c in registry.values() if convert_to_snake_case(c.__name__) == name
    ]
    if len(matches) > 1:
        raise ConfigurationError(
            f"{kind} name '{name}' is ambiguous: "
            f"{sorted(c.__module__ + '.' + c.__name__ for c in matches)}."
        )
    return matches[0] if matches else None


def parse_value(string: str) -> Any:
    """Parse a CLI/prompt value: ``ast.literal_eval`` with string fallback.

    ``epochs=10`` -> int 10; ``lr=1e-3`` -> float; ``name=mnist`` -> 'mnist';
    ``shape=(1,2)`` -> tuple. Mirrors the reference CLI's ConfigParam
    behavior (SURVEY.md §2.1 'CLI').
    """
    try:
        return ast.literal_eval(string)
    except (ValueError, SyntaxError):
        return string


def prompt_for_value(field_name: str, annotation: Any) -> Any:
    """Interactively prompt the user for a missing field value."""
    import click

    raw = click.prompt(
        click.style(
            f"No value found for field '{field_name}' "
            f"of type '{type_name(annotation)}'. Please enter a value",
            fg="yellow",
        ),
        type=str,
    )
    return parse_value(raw)


def prompt_for_component_subclass(field_name: str, classes: list) -> type:
    """Interactively choose a component subclass for a ComponentField."""
    import click

    names = sorted(c.__name__ for c in classes)
    by_name = {c.__name__: c for c in classes}
    click.echo(
        click.style(
            f"No component instance found for field '{field_name}'. "
            f"Choose one of: {', '.join(names)}",
            fg="yellow",
        )
    )
    choice = click.prompt("Component class", type=click.Choice(names))
    return by_name[choice]
