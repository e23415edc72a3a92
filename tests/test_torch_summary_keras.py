"""The port's model summary and Keras import against the JAX package's.

``model_summary`` of a port module built on the ``meta`` device must give
JAX's rows exactly (flax paths, shapes, dtypes, counts, deployment bits,
binary and packed flags) and the same train and deployment byte totals,
for a packed model and a float one. Its FLOP count is
``FlopCounterMode``'s (convolutions and matmuls, 2 per multiply-add of
every window position) where JAX's is XLA's cost analysis, which also
counts the elementwise work (BatchNorm, activations, pooling) and leaves
out the taps that fall on SAME padding: on the float DenseNet below the
two are held within 10% of XLA's count (the port's is 9% above it).

``import_keras_weights`` is held to the JAX package's on the same seeded
Keras model: the port module's logits equal the flax module's within
2e-5 (as the JAX test holds flax's to Keras's), and both to Keras's.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from zookeeper_tpu import models as jax_models
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models.keras_import import import_keras_weights as jax_import
from zookeeper_tpu.models.summary import model_summary as jax_summary
from zookeeper_tpu.ops import QuantConvTranspose as JaxQuantConvTranspose
from zookeeper_tpu_torch import models as port_models
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models.keras_import import import_keras_weights, keras_transpose_kernel
from zookeeper_tpu_torch.models.summary import meta_module, model_summary
from zookeeper_tpu_torch.ops.layers import QuantConvTranspose

tf = pytest.importorskip("tensorflow")

CLASSES = 10


def _models(family, conf):
    jm, pm = getattr(jax_models, family)(), getattr(port_models, family)()
    jax_configure(jm, conf, name="model")
    port_configure(pm, conf, name="model")
    return jm, pm


SUMMARIES = [
    ("QuickNet", {"blocks_per_section": (1, 1), "section_features": (32, 64),
                  "binary_compute": "xnor_popcount", "packed_weights": True, "fold_bn": True},
     (32, 32, 3)),
    ("BinaryDenseNet28", {"layers_per_block": (2, 2), "reduction": (2.0,), "dilation": (1, 1),
                          "growth_rate": 16, "initial_features": 24}, (32, 32, 3)),
    ("MeliusNet22", {"blocks_per_section": (1, 1), "transition_features": (48,),
                     "growth": 16, "stem_features": 24, "binary_compute": "xnor"}, (32, 32, 3)),
]


@pytest.mark.parametrize("family,conf,shape", SUMMARIES, ids=[s[0] for s in SUMMARIES])
def test_summary_rows_and_bytes_match_jax(family, conf, shape):
    jm, pm = _models(family, conf)
    want = jax_summary(jm.build(shape, CLASSES), shape, compute_flops=family == "BinaryDenseNet28")
    module = meta_module(pm, shape, CLASSES)
    assert all(t.device.type == "meta" for t in module.state_dict().values())
    got = model_summary(module, shape, compute_flops=family == "BinaryDenseNet28")
    assert [vars(r) for r in got.rows] == [vars(r) for r in want.rows]
    assert (got.total_params, got.binary_params, got.fp_params) == \
        (want.total_params, want.binary_params, want.fp_params)
    assert got.train_bytes == want.train_bytes and got.deploy_bytes == want.deploy_bytes
    assert got.extra_collections == want.extra_collections
    if family == "QuickNet":  # already deployed: the packed lanes hold the 1-bit weights
        assert any(r.packed for r in got.rows) and got.deploy_bytes == got.train_bytes
    else:
        assert got.binary_params and got.deploy_bytes < got.train_bytes
    if family == "BinaryDenseNet28":
        assert want.flops and got.flops
        assert 0.9 * want.flops <= got.flops <= 1.1 * want.flops
        assert "forward FLOPs" in str(got)
    assert "binary" in str(got)


def test_summary_of_a_packed_model_has_no_meta_flops():
    """The packed kernels take CPU or CUDA tensors: the meta forward
    cannot run them, and the diagnostic count is None."""
    _, pm = _models("QuickNet", SUMMARIES[0][1])
    got = model_summary(meta_module(pm, (32, 32, 3), CLASSES), (32, 32, 3), compute_flops=True)
    assert got.flops is None and got.rows


def _keras_simple_cnn(input_shape, features, dense_units, num_classes):
    """Keras twin of SimpleCnn (conv/BN/relu stacks, a maxpool after every
    second conv, the dense head); BN epsilon pinned to flax's 1e-5."""
    layers = [tf.keras.layers.Input(input_shape)]
    for i, f in enumerate(features):
        layers.append(tf.keras.layers.Conv2D(f, 3, padding="same"))
        layers.append(tf.keras.layers.BatchNormalization(epsilon=1e-5, momentum=0.9))
        layers.append(tf.keras.layers.ReLU())
        if i % 2 == 1:
            layers.append(tf.keras.layers.MaxPool2D(2, 2))
    layers.append(tf.keras.layers.Flatten())
    for units in dense_units:
        layers.append(tf.keras.layers.Dense(units))
        layers.append(tf.keras.layers.ReLU())
    layers.append(tf.keras.layers.Dense(num_classes))
    return tf.keras.Sequential(layers)


def _randomize(keras_model, seed=0):
    """Non-default weights everywhere, the BN running statistics too."""
    rng = np.random.default_rng(seed)
    for layer in keras_model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            gamma, beta, mean, var = ws
            layer.set_weights([
                rng.normal(1.0, 0.2, gamma.shape).astype(np.float32),
                rng.normal(0.0, 0.2, beta.shape).astype(np.float32),
                rng.normal(0.0, 0.5, mean.shape).astype(np.float32),
                rng.uniform(0.5, 2.0, var.shape).astype(np.float32),
            ])
        else:
            layer.set_weights([rng.normal(0, 0.1, w.shape).astype(np.float32) for w in ws])


SIMPLE = {"features": (4, 8), "dense_units": (16,)}


def test_simple_cnn_import_matches_flax_and_keras():
    shape = (8, 8, 1)
    keras_model = _keras_simple_cnn(shape, SIMPLE["features"], SIMPLE["dense_units"], CLASSES)
    _randomize(keras_model)
    jm, pm = _models("SimpleCnn", SIMPLE)
    jmod = jm.build(shape, num_classes=CLASSES)
    params, model_state = jax_import(keras_model, *jm.initialize(jmod, shape))
    module = import_keras_weights(keras_model, pm.build(shape, CLASSES))
    x = np.random.default_rng(1).normal(size=(4, *shape)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params, **model_state}, jnp.asarray(x),
                                 training=False))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, keras_model(x, training=False).numpy(), rtol=0, atol=2e-5)


def test_transpose_kernel_convention_and_automatic_import():
    """keras_transpose_kernel makes QuantConvTranspose reproduce Keras's
    Conv2DTranspose, by hand and through the import; the port's
    conversion equals the JAX package's."""
    from zookeeper_tpu.models.keras_import import keras_transpose_kernel as jax_transpose

    x = np.random.default_rng(2).normal(size=(2, 5, 5, 3)).astype(np.float32)
    keras_model = tf.keras.Sequential([
        tf.keras.layers.Input((5, 5, 3)),
        tf.keras.layers.Conv2DTranspose(4, 3, strides=2, padding="same", use_bias=False),
    ])
    _randomize(keras_model)
    want = keras_model(x, training=False).numpy()
    (kernel,) = keras_model.layers[0].get_weights()
    np.testing.assert_array_equal(keras_transpose_kernel(kernel), jax_transpose(kernel))
    holder = nn.Module()
    holder.QuantConvTranspose_0 = QuantConvTranspose(3, 4, (3, 3), (2, 2), "SAME")
    import_keras_weights(keras_model, holder)
    with torch.no_grad():
        got = holder.QuantConvTranspose_0(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jlayer = JaxQuantConvTranspose(4, (3, 3), (2, 2), "SAME")
    variables = {"params": {"kernel_fp": jnp.asarray(keras_transpose_kernel(kernel))}}
    np.testing.assert_allclose(got, np.asarray(jlayer.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def test_mismatches_are_loud():
    shape = (8, 8, 1)
    keras_model = _keras_simple_cnn(shape, SIMPLE["features"], SIMPLE["dense_units"], CLASSES)
    _, pm = _models("SimpleCnn", {"features": (4, 4), "dense_units": (16,)})
    module = pm.build(shape, CLASSES)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    with pytest.raises(ValueError, match="does not match template"):
        import_keras_weights(keras_model, module)
    assert all(torch.equal(before[k], v) for k, v in module.state_dict().items())
    tiny = tf.keras.Sequential([tf.keras.layers.Input(shape),
                                tf.keras.layers.Conv2D(4, 3, padding="same")])
    tiny(np.zeros((1, *shape), np.float32))
    _, pm = _models("SimpleCnn", SIMPLE)
    with pytest.raises(ValueError, match="flax slots remain"):
        import_keras_weights(tiny, pm.build(shape, CLASSES))
    _, pm = _models("ReActNet", {"features": (8, 16), "strides": (1,)})
    with pytest.raises(ValueError, match="custom learnables"):
        import_keras_weights(tiny, pm.build((16, 16, 3), CLASSES))
    _, pm = _models("QuickNet", SUMMARIES[0][1])
    with pytest.raises(ValueError, match="packed"):
        import_keras_weights(tiny, pm.build((32, 32, 3), CLASSES))
    big = tf.keras.Sequential([tf.keras.layers.Input(shape),
                               tf.keras.layers.Conv2D(4, 3, padding="same"),
                               tf.keras.layers.Conv2D(4, 3, padding="same")])
    big(np.zeros((1, *shape), np.float32))
    holder = nn.Module()
    holder.QuantConvTranspose_0 = QuantConvTranspose(1, 4, (3, 3))
    with pytest.raises(ValueError, match="use_bias mismatch"):
        import_keras_weights(big, holder)
