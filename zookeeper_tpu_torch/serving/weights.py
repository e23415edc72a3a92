"""Hot weight swaps into a bound serving module.

The one path both serving engines (``InferenceEngine``,
``DecodeEngine``) take for ``swap_weights``: a candidate weight set, the
export trees ``(params, model_state)`` as ``{flax path: tensor}`` (what
``training.checkpoint.load_inference_model`` returns), is checked
against the bound module's own trees (taken at the first swap), path by
path, leaf shape and dtype (JAX's ``check_swap`` messages), then copied into the module's tensors
in place. Under a partitioner each tensor goes through the same
``ShardPlan.shard`` that bind's ``apply_module`` cut it with, so a rank
keeps exactly its block (the head-aligned ``qkv`` of a tensor-parallel
layer included) and nothing is rebuilt: the kernels see the same
storage and shapes as before.
"""

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["check_swap", "load_weights", "weight_layout"]

#: ``{"params/<path>" or "<state path>": (global shape, dtype)}``.
Layout = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _leaves(params: Mapping[str, Any], model_state: Optional[Mapping[str, Any]]):
    out = {f"params/{k}": v for k, v in dict(params).items()}
    out.update(dict(model_state or {}))
    return out


def weight_layout(module: torch.nn.Module, plan: Any = None) -> Layout:
    """The bound weights' structure: every export-tree leaf's global shape
    and dtype (under ``plan``, a ``ShardPlan``, its blocks gathered first:
    a collective, every rank calls it)."""
    from zookeeper_tpu_torch.training.checkpoint import export_trees

    params, model_state = export_trees(module, shards=plan)
    return {k: (tuple(v.shape), v.dtype) for k, v in _leaves(params, model_state).items()}


def check_swap(layout: Layout, params: Mapping[str, Any], model_state: Any,
               programs: str) -> None:
    """Raise ``ValueError`` unless ``(params, model_state)`` has the bound
    structure, leaf shapes and dtypes (``programs`` names what was built
    for them in the message)."""
    new = _leaves(params, model_state)
    if set(new) != set(layout):
        missing, extra = sorted(set(layout) - set(new)), sorted(set(new) - set(layout))
        raise ValueError(
            "swap_weights: new variables tree does not match the bound structure "
            f"(bound paths missing {missing[:4]}, unexpected {extra[:4]}); the "
            f"{programs} serve ONE architecture."
        )
    bad = []
    for path, (shape, dtype) in layout.items():
        got = new[path]
        got_shape = tuple(getattr(got, "shape", ()))
        got_dtype = getattr(got, "dtype", None)
        if got_shape != shape or got_dtype != dtype:
            bad.append(f"{got_shape}/{got_dtype} where the engine serves {shape}/{dtype}")
    if bad:
        raise ValueError(
            "swap_weights: leaf shape/dtype mismatch — " + "; ".join(bad[:4])
            + (" ..." if len(bad) > 4 else "")
            + f". The {programs} were built for the bound shapes; a differently-sized "
            "checkpoint needs a fresh bind()."
        )


def load_weights(module: torch.nn.Module, plan: Any, params: Mapping[str, Any],
                 model_state: Any) -> None:
    """Copy checked export trees into ``module`` in place: each tensor's
    global value, cut to this rank's block by ``plan`` (a ``ShardPlan``,
    None for none), cast to the module tensor's dtype."""
    from zookeeper_tpu_torch.training.checkpoint import module_state_from_trees

    named = module_state_from_trees(module, params, dict(model_state or {}))
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            src = named[name].to(t.device)
            if plan is not None and name in plan.layouts:
                src = plan.shard(name, src)
            t.data.copy_(src)
