"""``@task``: CLI-invokable root components.

Capability parity with the reference's ``zookeeper/core/task.py``
(SURVEY.md §2.1): ``@task`` marks a component with a ``run()`` method as an
entry point and registers it by class name; the CLI (``cli.py``) exposes
every registered task as a sub-command.
"""

from __future__ import annotations

from typing import Dict

from .component import component, is_component_class

#: All registered task classes, keyed by class name.
TASK_REGISTRY: Dict[str, type] = {}


def task(cls: type) -> type:
    """Class decorator registering a component with run() as a CLI task."""
    run = getattr(cls, "run", None)
    if run is None or not callable(run):
        raise TypeError(
            f"@task class {cls.__name__} must define a run(self) method."
        )
    if not is_component_class(cls):
        cls = component(cls)
    if cls.__name__ in TASK_REGISTRY and TASK_REGISTRY[cls.__name__] is not cls:
        raise ValueError(
            f"A different task named '{cls.__name__}' is already registered."
        )
    TASK_REGISTRY[cls.__name__] = cls
    return cls


def get_task(name: str) -> type:
    from . import utils

    cls = utils.registry_lookup(TASK_REGISTRY, name, "Task")
    if cls is not None:
        return cls
    raise KeyError(
        f"No task named '{name}'. Registered tasks: "
        f"{sorted(TASK_REGISTRY)}."
    )
