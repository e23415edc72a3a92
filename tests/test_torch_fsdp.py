"""The port's partition rules and FSDP against the JAX package's.

- Every rule function gives JAX's spec, as a tuple, on every leaf of
  QuickNet, TransformerLM and Mlp states (the port's own flax paths of
  its tensors, through ``FsdpPartitioner``/``MeshPartitioner.
  state_sharding`` too), on random trees with suffix-shadowing and
  same-segment names (25 seeds, moments co-sharded), and in the nested,
  segment-boundary, ``replicate_patterns`` and explicit-empty cases.
- One ``FsdpPartitioner(min_weight_size=1)`` step of an Mlp on 2 gloo
  ranks against JAX's on 2 CPU devices from the same state: the loss
  within 1e-5 relative, the parameters within rtol 1e-4 / atol 1e-6 (JAX's
  ``test_fsdp_matches_single_device``); each rank holds half of each
  sharded tensor and of its Adam moments.
- Under FSDP, three LAMB steps with a global clip norm, the flip ratio
  and ``nan_policy="skip"`` (step 1 poisoned) give the DP run's metrics
  and parameters: the sharded norms, trust ratios and counts are the
  whole tensors'.
- A FaultPlan kill and ``run_with_recovery``'s resume under FSDP end on
  the uninterrupted run's bits, and the checkpoint file equals, tensor
  for tensor, the file a single-device run writes at the same state.
- ``activation_sharding_scope``: a no-op outside a scope, values kept
  inside one, the rows checked.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JaxSpec

import torch_parallel_workers as workers
import torch_shard_workers as shard_workers
from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models import Mlp as JaxMlp
from zookeeper_tpu.models import QuickNet as JaxQuickNet
from zookeeper_tpu.models import TransformerLM as JaxTransformerLM
from zookeeper_tpu.parallel import FsdpPartitioner as JaxFsdpPartitioner
from zookeeper_tpu.parallel import rules as jax_rules
from zookeeper_tpu.training.state import TrainState as JaxTrainState
from zookeeper_tpu.training.step import make_train_step as jax_make_train_step
from zookeeper_tpu_torch.core import configure as port_configure
from zookeeper_tpu_torch.models import Mlp, QuickNet, TransformerLM
from zookeeper_tpu_torch.models.convert import flatten_tree, flax_state_layouts
from zookeeper_tpu_torch.parallel import FsdpPartitioner, MeshPartitioner
from zookeeper_tpu_torch.parallel import rules as port_rules
from zookeeper_tpu_torch.parallel.sharding import (
    activation_sharding_scope,
    constrain_batch_sharded,
    current_activation_scope,
)
from zookeeper_tpu_torch.training import TrainState

MLP = {"hidden_units": (16,)}
MLP_SHAPE, MLP_CLASSES, MLP_LR = (4, 4, 1), 4, 1e-2
QUICKNET = {"blocks_per_section": (1, 1), "section_features": (8, 16), "binary_compute": "int8"}
QN_SHAPE, QN_CLASSES = (16, 16, 3), 4
LM = {"num_layers": 2, "d_model": 32, "num_heads": 4}
LM_SHAPE, LM_VOCAB = (16,), 31
MODELS = {"QuickNet": (JaxQuickNet, QuickNet, QUICKNET, QN_SHAPE, QN_CLASSES),
          "TransformerLM": (JaxTransformerLM, TransformerLM, LM, LM_SHAPE, LM_VOCAB),
          "Mlp": (JaxMlp, Mlp, MLP, MLP_SHAPE, MLP_CLASSES)}

LM_RUN = {
    "device": "cpu", "verbose": False, "epochs": 3, "seed": 3,
    "loader.dataset": "SyntheticTokens", "loader.dataset.vocab_size": 31,
    "loader.dataset.num_train_examples": 8, "loader.dataset.num_validation_examples": 8,
    "loader.preprocessing": "TokenPreprocessing", "seq_len": 16,
    "model": "TransformerLM", "model.num_layers": 2, "model.d_model": 32,
    "model.num_heads": 4, "batch_size": 8,
    "optimizer.schedule": "ConstantSchedule", "optimizer.schedule.base_lr": 1e-3,
    "partitioner": "FsdpPartitioner", "partitioner.min_weight_size": 1,
}


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_numpy_state(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {"step": np.array(state.step), "params": _numpy_tree(state.params),
            "model_state": _numpy_tree(state.model_state),
            "adam": {"count": np.array(adam.count), "mu": _numpy_tree(adam.mu),
                     "nu": _numpy_tree(adam.nu)}}


def _flat(tree, prefix=""):
    """A nested tree (mappings, lists, plain tuples) as ``{"a/0/b": leaf}``;
    a PartitionSpec of either package is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) or type(tree) is tuple:
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


# -- the rules --------------------------------------------------------------------


def _jax_variables(name):
    jax_cls, _, conf, shape, classes = MODELS[name]
    model = jax_cls()
    jax_configure(model, dict(conf), name="model")
    module = model.build(shape, num_classes=classes)
    # Jitted: the eager init's values from one compile, not an op-by-op forward.
    params, model_state = jax.jit(lambda: model.initialize(module, shape, seed=0))()
    return {"params": _numpy_tree(params), "model_state": _numpy_tree(model_state)}


def _port_module(name):
    _, port_cls, conf, shape, classes = MODELS[name]
    model = port_cls()
    port_configure(model, dict(conf), name="model")
    return model.build(shape, classes)


RULE_TABLES = {
    "transformer_tp": lambda tree: ("transformer_tp_rules", ()),
    "conv_model_tp": lambda tree: ("conv_model_tp_rules", ()),
    "conv_model_tp_axis": lambda tree: ("conv_model_tp_rules", ("tp",)),
    "auto_fsdp_2": lambda tree: ("auto_fsdp_rules", (tree["params"], 2)),
    "auto_fsdp_4_min64": lambda tree: ("auto_fsdp_rules", (tree["params"], 4, "fsdp", 64)),
    "auto_fsdp_replicate": lambda tree: ("auto_fsdp_rules",
                                         (tree["params"], 2, "fsdp", 1, (r"^Dense_0/",))),
}


@pytest.mark.parametrize("table", sorted(RULE_TABLES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_rule_functions_give_jax_specs_on_every_state_leaf(model, table):
    """The same rule table (built by each package from the same params)
    gives each leaf of the JAX state and the port's tensor of that flax
    path the same spec; the port's paths are JAX's."""
    variables = _jax_variables(model)
    fn, args = RULE_TABLES[table](variables)
    want = _flat(jax_rules.match_partition_rules(getattr(jax_rules, fn)(*args), variables))
    rules = getattr(port_rules, fn)(*args)
    assert _flat(port_rules.match_partition_rules(rules, variables)) == {
        k: tuple(v) for k, v in want.items()}
    layouts = flax_state_layouts(_port_module(model))
    got = {path: port_rules.spec_for(rules, path) for path, _ in layouts.values()}
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path


@pytest.mark.parametrize("model", sorted(MODELS))
def test_partitioners_state_sharding_match_jax(model):
    """``FsdpPartitioner`` derives ``auto_fsdp_rules`` from the port
    state's parameters in flax layout (one rank: axis size 1), and
    ``MeshPartitioner.with_rules`` matches its rules, as JAX's do."""
    variables = _jax_variables(model)
    state = TrainState.create(_port_module(model), _adam().build(10))
    fsdp = FsdpPartitioner()
    port_configure(fsdp, {"min_weight_size": 64}, name="partitioner")
    want = _flat(jax_rules.match_partition_rules(
        jax_rules.auto_fsdp_rules(variables["params"], 1, "fsdp", 64), variables))
    assert _flat(fsdp.state_sharding(state)) == {k: tuple(v) for k, v in want.items()}
    mesh = MeshPartitioner()
    port_configure(mesh, {"mesh_shape": (1, 1), "mesh_axes": ("data", "model")},
                   name="partitioner")
    mesh.with_rules(port_rules.conv_model_tp_rules() + port_rules.transformer_tp_rules())
    want = _flat(jax_rules.match_partition_rules(
        jax_rules.conv_model_tp_rules() + jax_rules.transformer_tp_rules(), variables))
    assert _flat(mesh.state_sharding(state)) == {k: tuple(v) for k, v in want.items()}


def _adam(lr=1e-3):
    from zookeeper_tpu_torch.training import Adam

    adam = Adam()
    port_configure(adam, {"schedule": "ConstantSchedule", "schedule.base_lr": lr},
                   name="optimizer")
    return adam


@pytest.mark.parametrize("fn,args", [
    ("decode_cache_rules", ()), ("decode_cache_rules", (("data", "fsdp"), "model")),
    ("page_pool_rules", ()), ("page_pool_rules", (("data",), "model")),
], ids=["cache", "cache_model", "pool", "pool_model"])
def test_decode_rules_match_jax(fn, args):
    layer = {"k": np.zeros((4, 8, 2, 4)), "v": np.zeros((4, 8, 2, 4)),
             "k_scale": np.zeros((4, 8, 2)), "v_scale": np.zeros((4, 8, 2)),
             "lengths": np.zeros((4,))}
    tree = {"cache": [dict(layer), dict(layer)]}
    want = _flat(jax_rules.match_partition_rules(getattr(jax_rules, fn)(*args), tree))
    got = _flat(port_rules.match_partition_rules(getattr(port_rules, fn)(*args), tree))
    assert got == {k: tuple(v) for k, v in want.items()}


MODULE_NAMES = ("Dense_0", "QuantDense_0", "Head_0", "Conv_1", "BatchNorm_0")
LEAVES = ("kernel", "bias", "kernel_scale", "scale")


def _random_tree(rng, depth=0):
    tree = {}
    for leaf in rng.sample(LEAVES, rng.randrange(1, len(LEAVES) + 1)):
        shape = tuple(rng.choice((1, 2, 3, 8, 16, 64, 96, 128)) for _ in range(rng.randrange(5)))
        tree[leaf] = np.zeros(shape, np.float32)
    if depth < 2:
        for mod in rng.sample(MODULE_NAMES, rng.randrange(0, 3)):
            tree[mod] = _random_tree(rng, depth + 1)
    return tree


@pytest.mark.parametrize("seed", range(25))
def test_auto_fsdp_rules_match_jax_on_random_trees(seed):
    """Random nested trees with suffix-shadowing ("Dense_0/kernel" under
    "Head_0") and same-segment prefixes ("Dense_0" in "QuantDense_0"),
    as ``tests/parallel/test_rules_property.py`` draws them: the same
    spec on every leaf, and on the same paths under a moment prefix."""
    rng = random.Random(seed)
    tree = _random_tree(rng)
    tree.setdefault("Dense_0", {})["kernel"] = np.zeros((64, 128), np.float32)
    tree.setdefault("Head_0", {}).setdefault("Dense_0", {})["kernel"] = np.zeros(
        (96, 2), np.float32)
    tree.setdefault("QuantDense_0", {})["kernel"] = np.zeros((3, 3), np.float32)
    axis_size, min_size = rng.choice((2, 4, 8)), rng.choice((1, 64, 2**15))
    jr = jax_rules.auto_fsdp_rules(tree, axis_size, min_weight_size=min_size)
    pr = port_rules.auto_fsdp_rules(tree, axis_size, min_weight_size=min_size)
    assert [(p, tuple(s)) for p, s in pr] == [(p, tuple(s)) for p, s in jr]
    for t in (tree, {"opt": {"mu": tree}}):
        want = _flat(jax_rules.match_partition_rules(jr, t))
        assert _flat(port_rules.match_partition_rules(pr, t)) == {
            k: tuple(v) for k, v in want.items()}


def test_rule_edge_cases_match_jax():
    """The nested, segment-boundary and replicate_patterns cases of the
    JAX package's partitioner tests, and a rule on a dimension the tensor
    lacks raising."""
    cases = [
        ({"Dense_0": {"kernel": np.zeros((256, 512))},
          "Head_0": {"Dense_0": {"kernel": np.zeros((8, 3))}}}, 8, 1024, ()),
        ({"Dense_0": {"kernel": np.zeros((256, 512))},
          "QuantDense_0": {"kernel": np.zeros((8, 3))}}, 8, 1024, ()),
        ({"Stem_0": {"kernel": np.zeros((128, 128))},
          "Body_0": {"kernel": np.zeros((128, 128))}}, 2, 1, (r"^Stem_0/",)),
    ]
    for params, axis, min_size, replicate in cases:
        jr = jax_rules.auto_fsdp_rules(params, axis, "fsdp", min_size, replicate)
        pr = port_rules.auto_fsdp_rules(params, axis, "fsdp", min_size, replicate)
        for tree in ({"params": params}, {"opt_state": {"0": {"mu": params}}}):
            want = _flat(jax_rules.match_partition_rules(jr, tree))
            assert _flat(port_rules.match_partition_rules(pr, tree)) == {
                k: tuple(v) for k, v in want.items()}
    assert port_rules.PartitionSpec(None, "model") == (None, "model")
    assert tuple(JaxSpec(None, "model")) == port_rules.PartitionSpec(None, "model")


def test_fsdp_explicit_empty_rules_and_no_stale_rules():
    """``with_rules([])`` replicates everything; without it the rules
    derive from each state passed in, not the first one seen."""
    fsdp = FsdpPartitioner()
    port_configure(fsdp, {"min_weight_size": 1}, name="partitioner")
    small = TrainState.create(_port_module("Mlp"), _adam().build(10))
    model = Mlp()
    port_configure(model, {"hidden_units": (24, 24)}, name="model")
    wide = TrainState.create(model.build(MLP_SHAPE, MLP_CLASSES), _adam().build(10))
    for state in (small, wide):
        specs = _flat(fsdp.state_sharding(state))
        assert set(specs) == {path for path, _ in flax_state_layouts(state.module).values()}
        kernels = {p: s for p, s in specs.items() if p.endswith("kernel")}
        assert kernels and all(s in (("fsdp", None), (None, "fsdp")) for s in kernels.values())
        assert all(s == () for p, s in specs.items() if p.endswith("bias"))
    fsdp.with_rules([])
    assert all(s == () for s in _flat(fsdp.state_sharding(wide)).values())


# -- the activation scope -----------------------------------------------------------


def test_activation_sharding_scope_is_a_checked_no_op():
    x = torch.randn(4, 3, 5)
    vec = torch.randn(5)
    assert current_activation_scope() is None
    assert constrain_batch_sharded(x) is x and constrain_batch_sharded(vec) is vec
    with activation_sharding_scope(None, ("data",), ("model",)):
        assert current_activation_scope().model_axes == ("model",)
        assert constrain_batch_sharded(x) is x
        with activation_sharding_scope(None, ("data",), rows=4):
            assert current_activation_scope().rows == 4
            assert constrain_batch_sharded(x) is x and constrain_batch_sharded(vec) is vec
            with pytest.raises(ValueError, match="holds 2 rows where this rank holds 4"):
                constrain_batch_sharded(x[:2])
        assert current_activation_scope().rows is None
    assert current_activation_scope() is None
    # The port's QuickNet calls it at the JAX model's points: the logits
    # inside a scope of the batch's rows equal those outside it.
    module = _port_module("QuickNet").eval()
    inp = torch.randn(2, *QN_SHAPE)
    with torch.no_grad():
        want = module(inp)
        with activation_sharding_scope(None, ("data",), ("model",), rows=2):
            assert torch.equal(module(inp), want)
        with activation_sharding_scope(None, ("data",), ("model",), rows=3):
            with pytest.raises(ValueError, match="rows"):
                module(inp)


# -- 2 gloo ranks ---------------------------------------------------------------------


def _jax_fsdp_mlp_step():
    model = JaxMlp()
    jax_configure(model, dict(MLP), name="model")
    module = model.build(MLP_SHAPE, num_classes=MLP_CLASSES)
    params, model_state = model.initialize(module, MLP_SHAPE, seed=0)
    state = JaxTrainState.create(apply_fn=module.apply, params=params,
                                 model_state=model_state, tx=optax.adam(MLP_LR))
    rng = np.random.default_rng(0)
    labels = rng.integers(0, MLP_CLASSES, 32)
    x = rng.normal(size=(32, *MLP_SHAPE)).astype(np.float32)
    x += labels[:, None, None, None] * 0.5
    batch = {"input": x, "target": labels.astype(np.int32)}
    start = _jax_numpy_state(state)
    fp = JaxFsdpPartitioner()
    jax_configure(fp, {"min_weight_size": 1, "num_devices": 2}, name="partitioner")
    fp.setup()
    state = fp.shard_state(state)
    step = fp.compile_step(jax_make_train_step(), state, donate_state=False)
    new_state, metrics = step(state, jax.device_put(
        {k: jnp.asarray(v) for k, v in batch.items()}, fp.batch_sharding()))
    specs = _flat(jax.tree.map(lambda sh: sh.spec, fp.state_sharding(state).params))
    return start, batch, _numpy_tree(new_state.params), float(metrics["loss"]), specs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank cluster's legs: the Mlp FSDP step, the step features
    under FSDP and DP, and the FSDP TrainLM kill-and-resume."""
    start, batch, want_params, want_loss, specs = _jax_fsdp_mlp_step()
    rng = np.random.default_rng(5)
    qn_batch = {"input": rng.normal(size=(8, *QN_SHAPE)).astype(np.float32),
                "target": rng.integers(0, QN_CLASSES, size=8).astype(np.int32)}
    out_dir = str(tmp_path_factory.mktemp("fsdp"))
    ckpt, single = (str(tmp_path_factory.mktemp(n)) for n in ("ckpt", "single"))
    workers.spawn(shard_workers.fsdp_legs, 2, out_dir,
                  (MLP, MLP_SHAPE, MLP_CLASSES, MLP_LR, start, batch),
                  (QUICKNET, QN_SHAPE, QN_CLASSES, qn_batch),
                  (LM_RUN, ckpt, single, 2), timeout=240)
    return {"mlp": workers.load(out_dir, "fsdp_mlp", 2),
            "features": workers.load(out_dir, "features", 2),
            "resume": workers.load(out_dir, "resume", 2),
            "want_params": want_params, "want_loss": want_loss, "specs": specs}


def test_fsdp_step_matches_jax(two_ranks):
    got = two_ranks["mlp"]
    np.testing.assert_allclose(got[0]["loss"], two_ranks["want_loss"], rtol=1e-5)
    for path, w in _flat(two_ranks["want_params"]).items():
        for r in got:
            np.testing.assert_allclose(_flat(r["state"]["params"])[path], w, rtol=1e-4,
                                       atol=1e-6, err_msg=path)
    for path, w in _flat(got[0]["state"]["params"]).items():
        assert np.array_equal(_flat(got[1]["state"]["params"])[path], w), path


def test_fsdp_holds_half_of_each_sharded_tensor_and_its_moments(two_ranks):
    """Each rank's block of a sharded parameter and of its Adam moments is
    half of the tensor along the dim JAX's spec shards; 1-D tensors and
    nothing else stay whole."""
    layouts = flax_state_layouts(_port_module("Mlp"))
    full = {n: tuple(t.shape) for n, t in _port_module("Mlp").state_dict().items()}
    sharded = 0
    for name, (path, axes) in layouts.items():
        spec = tuple(two_ranks["specs"][path[len("params/"):]])
        want = list(full[name])
        for flax_dim, axis in enumerate(spec):
            if axis is not None:
                want[axes[flax_dim]] //= 2
                sharded += 1
        for r in two_ranks["mlp"]:
            for key in ("module", "mu", "nu"):
                assert r["held"][key][name] == tuple(want), (key, name)
    assert sharded >= 2


def test_fsdp_whole_tensor_reductions_match_dp(two_ranks):
    """LAMB's trust ratios, the global clip norm, the gradient norm, the
    flip ratio and the non-finite guard's skip under FSDP are the DP
    run's."""
    for r in two_ranks["features"]:
        fsdp, dp = r["fsdp"], r["dp"]
        assert [m["skipped_steps"] for m in dp["history"]] == [0.0, 1.0, 0.0]
        for a, b in zip(fsdp["history"], dp["history"]):
            assert a.keys() == b.keys()
            for key in a:
                if np.isfinite(b[key]):
                    np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-7, err_msg=key)
                else:
                    assert not np.isfinite(a[key]), key
        assert dp["history"][2]["flip_ratio"] > 0
        for path, w in _flat(dp["state"]["params"]).items():
            np.testing.assert_allclose(_flat(fsdp["state"]["params"])[path], w, rtol=1e-5,
                                       atol=1e-6, err_msg=path)


def test_fsdp_kill_and_resume_is_bit_identical_and_saves_the_single_device_file(two_ranks):
    for r in two_ranks["resume"]:
        assert r["restarts"] == 1
        a, b = r["state"], r["resumed_state"]
        assert int(a["step"]) == int(b["step"]) == 3
        for key in ("params", "adam"):
            for path, w in _flat(a[key]).items():
                assert np.array_equal(_flat(b[key])[path], w), (key, path)
        # Memory: the rank holds blocks of the sharded weights.
        assert r["held"]["module"]["block0.qkv.weight"] == (48, 32)
    r0 = two_ranks["resume"][0]
    got, want = flatten_tree(r0["file"]), flatten_tree(r0["single_file"])
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[key].shape == w.shape and torch.equal(got[key], w), key
        else:
            assert got[key] == w, key
