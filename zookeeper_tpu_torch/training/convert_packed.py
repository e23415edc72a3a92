"""The packed-deployment converter, the port of
``examples/convert_packed.py``'s ``ConvertPacked``: a trained float export
(``export_model_to=...``) becomes the bit-packed deployment export, the
binary conv and dense kernels stored as int32 lanes (32x smaller) plus
per-channel scales, loadable into the same model built with
``packed_weights=True``::

    python -m zookeeper_tpu_torch.training TrainCifar epochs=10 \\
        export_model_to=/tmp/cifar_float
    python -m zookeeper_tpu_torch.training ConvertPacked model=BinaryNet \\
        "model.features=(128,128,256,256)" "model.dense_units=(512,)" \\
        height=32 width=32 channels=3 checkpoint=/tmp/cifar_float \\
        output=/tmp/cifar_packed
    python -m zookeeper_tpu_torch.serving LatencyBench model=BinaryNet ... \\
        model.binary_compute=xnor model.packed_weights=True checkpoint=/tmp/cifar_packed

The packed twin's forward is checked against the float model's on a
seeded probe batch, on ``device`` (through the packed kernels on the
card), before anything is written; the task prints the quantization-aware
summaries' sizes before and after.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from zookeeper_tpu_torch.core import (
    ComponentField,
    Field,
    configure,
    configured_field_names,
    task,
)
from zookeeper_tpu_torch.models import Model
from zookeeper_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from zookeeper_tpu_torch.models.summary import model_summary
from zookeeper_tpu_torch.ops.device import resolve_device
from zookeeper_tpu_torch.ops.packed import pack_quantconv_params
from zookeeper_tpu_torch.training.checkpoint import export_trees, load_exported_model, save_model
from zookeeper_tpu_torch.training.experiment import Experiment


def resolve_deploy_conf(model, fold_bn: bool, deploy_overrides) -> Tuple[Dict[str, Any], bool]:
    """The deployment twin's configuration from the trained model's
    explicitly set fields and the task's settings (a pure function).

    Precedence: the model's explicitly set fields < the task's
    ``fold_bn`` < ``deploy_overrides`` (twin-only, wins over everything).
    Then the packing defaults apply to the conv-level pair only:
    ``packed_weights`` is True unless something set it, and when it is
    truthy ``binary_compute`` becomes "xnor" unless an override pinned it
    or it is a per-section tuple (a trained "int8"/"mxu" cannot run
    packed). Stage knobs like ``dense_binary_compute`` are never second-
    guessed: pin them in ``deploy_overrides``. The port's models have no
    ``pallas_interpret`` field, so the conf never carries one.

    Returns ``(conf, fold_bn_resolved)``.
    """
    conf = {name: getattr(model, name) for name in configured_field_names(model)}
    conf["fold_bn"] = fold_bn
    conf.update(dict(deploy_overrides))  # Twin-only knobs win.
    fold_resolved = bool(conf.get("fold_bn", False))
    if fold_resolved and not hasattr(type(model), "fold_bn"):
        raise ValueError(f"{type(model).__name__} has no fold_bn deployment mode.")
    if not fold_resolved:
        del conf["fold_bn"]  # Some families lack the field.
    if "packed_weights" not in conf:
        conf["packed_weights"] = True
    pw = conf["packed_weights"]
    twin_packed = any(pw) if isinstance(pw, (tuple, list)) else bool(pw)
    bc = conf.get("binary_compute")
    if (
        twin_packed
        and "binary_compute" not in deploy_overrides
        and not isinstance(bc, (tuple, list))
        and bc not in ("xnor", "xnor_popcount")
    ):
        conf["binary_compute"] = "xnor"
    return conf, fold_resolved


@task
class ConvertPacked(Experiment):
    """Float export -> packed deployment export."""

    model: Model = ComponentField()
    #: The trained float model's export (``save_model`` form).
    checkpoint: str = Field()
    #: Where the packed export is written.
    output: str = Field()
    #: The input shape the model was trained at.
    height: int = Field(28)
    width: int = Field(28)
    channels: int = Field(1)
    num_classes: int = Field(10)
    #: The kernel quantizer the model trained with (per zoo family).
    kernel_quantizer: str = Field("ste_sign")
    #: Largest |logit difference| the probe batch tolerates. Binary sums
    #: are integers: 0.0 holds for sign models without the fold.
    verify_atol: float = Field(0.0)
    #: Fold each packed layer's eval-mode BatchNorm into its epilogue.
    #: The re-association is equal to float rounding, not bitwise: set
    #: ``verify_atol`` (~1e-4 covers typical stacks).
    fold_bn: bool = Field(False)
    #: Overrides of the deployment twin only (a dict literal on the CLI),
    #: e.g. "deploy_overrides={'binary_compute': 'xnor_popcount'}".
    deploy_overrides: dict = Field({})
    #: Where the probe batch runs: "cuda" (raises without a card) or "cpu".
    device: str = Field("cuda")
    verbose: bool = Field(True)

    def run(self) -> Optional[str]:
        input_shape = (self.height, self.width, self.channels)
        module_f = self.model.build(input_shape, self.num_classes)
        self.model.initialize(module_f, seed=0)
        load_exported_model(self.checkpoint, module_f)

        for field_name in ("packed_weights", "binary_compute"):
            if not hasattr(type(self.model), field_name):
                raise ValueError(
                    f"{type(self.model).__name__} has no {field_name} field: not a "
                    "packable model family."
                )
        deploy_model = type(self.model)()
        conf, fold_bn = resolve_deploy_conf(self.model, self.fold_bn, self.deploy_overrides)
        configure(deploy_model, conf, name="deploy_model")
        module_p = deploy_model.build(input_shape, self.num_classes)

        # The float tree in module creation order (the fold pairs each
        # packed layer with the BatchNorm created after it).
        params_f, state_f = to_flax_variables(module_f)
        template, _ = to_flax_variables(module_p)
        if fold_bn:
            packed, folded = pack_quantconv_params(
                params_f, kernel_quantizer=self.kernel_quantizer, template=template,
                fold_bn=True, batch_stats=state_f["batch_stats"],
            )
            deploy_state = {"batch_stats": folded}
        else:
            packed = pack_quantconv_params(
                params_f, kernel_quantizer=self.kernel_quantizer, template=template
            )
            deploy_state = state_f
        module_p.load_state_dict(from_flax_variables(packed, deploy_state))

        # The probe batch, before anything is written.
        device = resolve_device(self.device)
        module_f.to(device).eval()
        module_p.to(device).eval()
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.normal(size=(4, *input_shape)).astype(np.float32)).to(device)
        with torch.inference_mode():
            y_f = module_f(x)
            y_p = module_p(x)
        max_diff = float((y_f.double() - y_p.double()).abs().max())
        if not max_diff <= self.verify_atol:
            raise RuntimeError(
                f"Packed model diverges from float model: max |diff| {max_diff} > "
                f"verify_atol={self.verify_atol}. Wrong kernel_quantizer for this family?"
            )

        save_model(self.output, *export_trees(module_p))

        s_f = model_summary(module_f, input_shape)
        s_p = model_summary(module_p, input_shape)
        # The binary kernels (conv + dense) on both sides: their float
        # bytes against the packed rows, any binary kernel left unpacked
        # and the per-channel scales.
        binary_f = sum(r.train_bytes for r in s_f.rows if r.binary)
        binary_p = sum(r.train_bytes for r in s_p.rows if r.binary or "kernel_scale" in r.path)
        self.result = {
            "output": self.output,
            "max_abs_diff": max_diff,
            "whole_mib": (s_f.train_bytes / 2**20, s_p.train_bytes / 2**20),
            "binary_kib": (binary_f / 2**10, binary_p / 2**10),
        }
        if self.verbose:
            print(
                f"converted {self.checkpoint} -> {self.output}\n"
                f"  whole model: {s_f.train_bytes / 2**20:.2f} MiB -> "
                f"{s_p.train_bytes / 2**20:.2f} MiB\n"
                f"  binary kernels (conv + dense): {binary_f / 2**10:.1f} KiB -> "
                f"{binary_p / 2**10:.1f} KiB ({binary_f / max(binary_p, 1):.1f}x)\n"
                f"  verified max |forward diff| = {max_diff}",
                flush=True,
            )
        return self.output
