"""The activation-sharding scope: where a layer names its layout.

The port of ``zookeeper_tpu/parallel/sharding.py``. In the JAX package
the mesh partitioners open :func:`activation_sharding_scope` around the
traced step, and the model's layers call :func:`constrain_batch_sharded`
to pin activations to ``P(data_axes, None, ..., model_axes)``: batch on
the data axes, channels on the tensor-parallel axes.

The port has no compiler to pin a layout for, so the same calls are
where it checks the layout it keeps. Each rank holds its own rows of
every batch (the batch is split over the data axes on the host), and
every layer returns whole channels: a tensor-parallel layer computes its
channel shard and all-gathers the channels over the model group before
it returns (``ops.layers``, ``parallel.shards``), because the next
layer, the packed kernels above all, reads every input channel. So the
data half of the pin holds by construction and the channel half is
whole on every model rank, on purpose. Outside a scope the helpers are
exact no-ops.
"""

from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional, Sequence, Tuple


class ActivationScope(NamedTuple):
    """The ambient layout: the mesh, its data and model axes, and the
    rows this rank holds of the batch in flight (None: not checked)."""

    mesh: object
    data_axes: Tuple[str, ...]
    model_axes: Tuple[str, ...]
    rows: Optional[int] = None


_SCOPE: ContextVar[Optional[ActivationScope]] = ContextVar(
    "zk_torch_activation_sharding_scope", default=None)


@contextmanager
def activation_sharding_scope(mesh, data_axes: Sequence[str], model_axes: Sequence[str] = (),
                              rows: Optional[int] = None):
    """Make ``(mesh, data_axes, model_axes)`` ambient for
    :func:`constrain_batch_sharded`; ``rows`` (the train and eval steps
    pass it) is this rank's share of the batch, which the check holds
    every batched activation to. Re-entrant; the innermost scope wins."""
    token = _SCOPE.set(ActivationScope(mesh, tuple(data_axes), tuple(model_axes), rows))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_activation_scope() -> Optional[ActivationScope]:
    """The active :class:`ActivationScope` or None."""
    return _SCOPE.get()


def constrain_batch_sharded(x):
    """``x`` itself, at the points where the JAX model pins an activation
    to ``P(data_axes, ..., model_axes)``. Outside a scope, or for a tensor
    of fewer than two dimensions (a per-channel vector), an exact no-op.
    Inside a scope that knows this rank's ``rows`` it checks the layout
    the port keeps in place of the pin: the leading (batch) dimension
    holds exactly the rank's rows, so no layer has gathered or dropped
    rows of another rank; the channels are whole on every rank (see the
    module docstring) and are not checked."""
    scope = _SCOPE.get()
    if scope is None or getattr(x, "ndim", 0) < 2 or scope.rows is None:
        return x
    if x.shape[0] != scope.rows:
        raise ValueError(
            f"An activation of shape {tuple(x.shape)} holds {x.shape[0]} rows where "
            f"this rank holds {scope.rows} of the batch (split over the data axes "
            f"{scope.data_axes}): a layer gathered or dropped rows."
        )
    return x
