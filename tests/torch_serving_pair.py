"""Shared set-up of the guard, loadgen and fleet tests against the JAX
package: one tiny paged LM service in each package on the same weights.

The JAX ``LMServingConfig`` initializes its weights from its seed; the
port's loads them from a model-only export written with the port's
converter (``from_flax_lm_variables``), so both services hold the same
fp32 weights. The JAX model runs its dense attention (as the JAX fleet
tests do), the port's the plain K9 on the CPU.
"""

import os

import numpy as np
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.serving import LMServingConfig as JaxLMServingConfig
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.models.convert import from_flax_lm_variables
from zookeeper_tpu_torch.models.transformer import TransformerLM
from zookeeper_tpu_torch.serving import LMServingConfig
from zookeeper_tpu_torch.training.checkpoint import export_trees, save_model

#: Both packages' service, before the package's own keys: the JAX fleet
#: tests' geometry (vocab 61, paged at page 8, the prefix cache on).
LM_CONF = {
    "model.num_layers": 1,
    "model.d_model": 32,
    "model.num_heads": 4,
    "model.max_seq_len": 64,
    "seq_len": 64,
    "vocab_size": 61,
    "seed": 0,
    "engine.kv_layout": "paged",
    "engine.page_size": 8,
    "engine.slots": 2,
    "engine.seq_buckets": (16, 64),
    "engine.prefill_buckets": (1,),
    "requests": 0,
    "verbose": False,
}


def jax_service(extra=None):
    """A built JAX ``LMServingConfig``: ``(service, scheduler)``."""
    svc = JaxLMServingConfig()
    jax_configure(svc, {**LM_CONF, "model.attention": "dense", **(extra or {})},
                  name="jax_lm")
    _, scheduler = svc.build_service()
    return svc, scheduler


def export_jax_weights(jax_svc, directory):
    """Write ``jax_svc``'s weights as a port model export in
    ``directory``; returns the directory."""
    params = jax_svc.engine._variables["params"]
    lm = TransformerLM()
    configure(lm, {k[len("model."):]: v for k, v in LM_CONF.items()
                   if k.startswith("model.")}, name="lm")
    module = lm.build((LM_CONF["seq_len"],), LM_CONF["vocab_size"])
    module.load_state_dict(from_flax_lm_variables(params))
    save_model(str(directory), *export_trees(module))
    return str(directory)


def port_service(checkpoint, extra=None):
    """A built port ``LMServingConfig`` on ``checkpoint``'s weights, on
    the CPU: ``(service, scheduler)``."""
    svc = LMServingConfig()
    configure(svc, {**LM_CONF, "device": "cpu", "checkpoint": os.fspath(checkpoint),
                    **(extra or {})}, name="port_lm")
    _, scheduler = svc.build_service()
    return svc, scheduler


def prompt(seed, n):
    """``n`` seeded tokens in [1, vocab)."""
    return np.random.default_rng(seed).integers(1, LM_CONF["vocab_size"], size=n).astype(
        np.int32)


def as_list(tokens):
    return [int(t) for t in np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens)]
