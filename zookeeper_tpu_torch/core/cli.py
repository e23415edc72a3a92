"""The ``key=value`` task CLI.

Capability parity with the reference's ``zookeeper/core/cli.py``
(SURVEY.md §2.1, §3.1): every registered ``@task`` becomes a click
sub-command taking variadic ``key=value`` arguments (values parsed with
``ast.literal_eval``, falling back to string) plus ``-i/--interactive``.
The command body instantiates the task, runs ``configure()``, prints the
resolved component tree, and calls ``task.run()``::

    python my_experiment.py MyExperiment dataset=Mnist epochs=10 -i
"""

from __future__ import annotations

from typing import Any, Tuple

import click

from . import utils
from .component import configure, pretty_print
from .task import TASK_REGISTRY, get_task


class ConfigParam(click.ParamType):
    """A single ``key=value`` CLI token -> (key, parsed value)."""

    name = "config"

    def convert(self, value: str, param: Any, ctx: Any) -> Tuple[str, Any]:
        if "=" not in value:
            self.fail(
                f"'{value}' is not a key=value configuration argument "
                "(e.g. 'dataset.batch_size=32').",
                param,
                ctx,
            )
        key, _, raw = value.partition("=")
        key = key.strip()
        if not key:
            self.fail(f"Empty key in configuration argument '{value}'.")
        return key, utils.parse_value(raw)


CONFIG_PARAM = ConfigParam()


class _TaskGroup(click.Group):
    """Resolves sub-commands lazily against the task registry, so tasks
    registered after import (the normal case) are found."""

    def list_commands(self, ctx):
        return sorted(TASK_REGISTRY)

    def get_command(self, ctx, name):
        try:
            task_cls = get_task(name)
        except KeyError:
            return None
        return _make_task_command(task_cls)


def _make_task_command(task_cls: type) -> click.Command:
    @click.command(
        name=task_cls.__name__,
        help=(task_cls.__doc__ or f"Run the {task_cls.__name__} task."),
        context_settings={"ignore_unknown_options": True},
    )
    @click.argument("config", type=CONFIG_PARAM, nargs=-1)
    @click.option(
        "-i",
        "--interactive",
        is_flag=True,
        default=False,
        help="Prompt for missing field values instead of failing.",
    )
    def run_task(config, interactive):
        instance = task_cls()
        try:
            configure(instance, dict(config), interactive=interactive)
        except (utils.ConfigurationError, TypeError) as e:
            raise click.ClickException(str(e)) from e
        click.echo(pretty_print(instance, color=True))
        instance.run()

    return run_task


@click.group(cls=_TaskGroup)
def cli() -> None:
    """Run a registered task: ``cli <TaskName> key=value ... [-i]``."""
