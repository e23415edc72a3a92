"""Sequence buckets in the port's ``InferenceEngine`` against the JAX
package's (``tests/serving/test_engine.py``'s sequence cases).

One tiny causal ``TransformerLM`` on the same weights in both packages
(the JAX init carried across with the port's converter), bound with
int32 tokens, batch buckets (2, 4) and sequence buckets (8, 16):

- the warm-up runs every (batch, sequence) pair and ``compile_count`` is
  ``len(batch_buckets) * len(seq_buckets)`` in both packages; served
  pairs never add a program or a detected recompile;
- the logits on the real positions equal the JAX engine's and the JAX
  module's exact-length forward within the JAX test's tolerance, and the
  port's own exact-length forward bit for bit;
- the ledger rows, the trace and the dispatch key carry the pair;
- a pooled ``[batch, classes]`` head whose class count equals the
  sequence bucket keeps every class, with the JAX engine's values;
- ``MicroBatcher`` concatenates token requests as the JAX batcher does.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import numpy as np
import pytest
import torch

from zookeeper_tpu.core import configure as jax_configure
from zookeeper_tpu.models.transformer import TransformerLM as JaxLM
from zookeeper_tpu.serving import InferenceEngine as JaxEngine
from zookeeper_tpu.serving import MicroBatcher as JaxBatcher
from zookeeper_tpu_torch.core import configure
from zookeeper_tpu_torch.models.convert import from_flax_lm_variables
from zookeeper_tpu_torch.models.transformer import TransformerLM
from zookeeper_tpu_torch.observability import trace as _trace
from zookeeper_tpu_torch.serving import InferenceEngine, MicroBatcher

VOCAB, SEQ = 11, 16
GEOMETRY = {"num_layers": 1, "d_model": 16, "num_heads": 2, "max_seq_len": SEQ}
BUCKETS = {"batch_buckets": (2, 4), "seq_buckets": (8, 16)}
CASES = ((1, 5), (2, 8), (3, 11), (4, 16))


@functools.lru_cache(maxsize=1)
def _lm():
    """(JAX module, JAX params, port module) on the same fp32 weights."""
    jm = JaxLM()
    jax_configure(jm, {**GEOMETRY, "attention": "dense"}, name="model")
    jmod = jm.build((SEQ,), VOCAB)
    params, _ = jax.jit(lambda: jm.initialize(jmod, (SEQ,), seed=0))()
    pm = TransformerLM()
    configure(pm, dict(GEOMETRY), name="model")
    mod = pm.build((SEQ,), VOCAB)
    mod.load_state_dict(from_flax_lm_variables(params))
    return jmod, params, mod


@pytest.fixture(scope="module")
def engines():
    """Both engines bound and warmed, with their warm-up counts."""
    jmod, params, mod = _lm()
    jax_engine = JaxEngine()
    jax_configure(jax_engine, dict(BUCKETS), name="engine")
    jax_engine.bind(jmod.apply, params, {}, (SEQ,), dtype=np.int32)
    port_engine = InferenceEngine()
    configure(port_engine, dict(BUCKETS), name="engine")
    port_engine.bind(mod, (SEQ,), dtype=torch.int32, device="cpu")
    return {"jax": (jax_engine, jax_engine.warmup()),
            "port": (port_engine, port_engine.warmup())}


def _tokens(n, seq, seed=4):
    return np.random.default_rng(seed + 10 * n + seq).integers(0, VOCAB, size=(n, seq)) \
        .astype(np.int32)


def test_warmup_runs_every_pair_as_the_jax_engine_compiles_it(engines):
    (jax_engine, jax_warm), (port_engine, port_warm) = engines["jax"], engines["port"]
    assert port_warm == jax_warm == 4  # 2 batch x 2 sequence buckets
    assert port_engine.compile_count == jax_engine.compile_count == 4
    assert port_engine.warmed_buckets == 4
    assert sorted(k[:3] for k in port_engine.programs) == [
        (b, s, "int32") for b in (2, 4) for s in (8, 16)]
    for (b, s, _, _), row in port_engine.programs.items():
        assert row.attrs == {"bucket": b, "seq_bucket": s, "during_dispatch": False}
        assert f"/b{b}s{s}/int32" in row.key and row.flops > 0


@pytest.mark.parametrize("n,seq", CASES)
def test_real_positions_equal_jax_and_the_exact_length_forward(engines, n, seq):
    jmod, params, mod = _lm()
    tokens = _tokens(n, seq)
    got = engines["port"][0].infer(tokens).numpy()
    assert got.shape == (n, seq, VOCAB)
    want = np.asarray(engines["jax"][0].infer(tokens))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    exact = np.asarray(jmod.apply({"params": params}, tokens, training=False))
    np.testing.assert_allclose(got, exact, rtol=2e-5, atol=2e-5)
    with torch.inference_mode():
        own = mod(torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(got, own)


def test_served_pairs_never_recompile_and_oversize_raises_alike(engines):
    (jax_engine, _), (port_engine, _) = engines["jax"], engines["port"]
    for n, seq in CASES:
        port_engine.infer(_tokens(n, seq))
        jax_engine.infer(_tokens(n, seq))
    assert port_engine.compile_count == jax_engine.compile_count == 4
    assert port_engine.recompiles_detected == jax_engine.recompiles_detected == 0
    too_long = _tokens(1, SEQ + 1)
    for engine in (port_engine, jax_engine):
        with pytest.raises(ValueError, match="seq bucket"):
            engine.infer(too_long)
    with pytest.raises(ValueError, match="no sequence axis"):
        port_engine.buckets_of(np.zeros((2,), np.int32))


def test_pair_keys_the_dispatch_trace_and_mfu_row(engines):
    port_engine = engines["port"][0]
    tracer = _trace.Tracer()
    previous = _trace.install(tracer)
    try:
        port_engine.infer(_tokens(3, 11))
    finally:
        _trace.install(previous)
    spans = [r for r in tracer.snapshot() if r["name"] == "engine_infer"]
    assert spans and spans[-1]["attrs"] == {"rows": 3, "bucket": 4, "seq_bucket": 16}
    assert port_engine._last_program is port_engine.programs[port_engine._key(4, 16)]
    assert port_engine.buckets_of(_tokens(3, 11)) == (4, 16)


def test_seq_buckets_must_ascend_in_both_packages():
    jmod, params, mod = _lm()
    for bad in ((16, 8), (8, 8)):
        port_engine = InferenceEngine()
        configure(port_engine, {"batch_buckets": (2,), "seq_buckets": bad}, name="engine")
        with pytest.raises(ValueError, match="seq_buckets"):
            port_engine.bind(mod, (SEQ,), dtype=torch.int32, device="cpu")
        jax_engine = JaxEngine()
        jax_configure(jax_engine, {"batch_buckets": (2,), "seq_buckets": bad}, name="engine")
        with pytest.raises(ValueError, match="seq_buckets"):
            jax_engine.bind(jmod.apply, params, {}, (SEQ,), dtype=np.int32)


class _PooledHead(torch.nn.Module):
    """JAX's test module: the mean over the sequence, then a dense
    layer (flax ``Dense``: ``x @ kernel + bias``)."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.from_numpy(np.array(kernel)))
        self.bias = torch.nn.Parameter(torch.from_numpy(np.array(bias)))

    def forward(self, x):
        return x.mean(dim=1) @ self.kernel + self.bias


def test_pooled_head_whose_classes_equal_the_seq_bucket_keeps_them_all():
    import flax.linen as nn

    class PooledHead(nn.Module):
        classes: int

        @nn.compact
        def __call__(self, x, training: bool = False):
            return nn.Dense(self.classes)(x.mean(axis=1))

    seq_bucket = 8
    jmod = PooledHead(classes=seq_bucket)  # the collision on purpose
    variables = jmod.init(jax.random.PRNGKey(0), np.zeros((1, seq_bucket, 3), np.float32))
    conf = {"batch_buckets": (4,), "seq_buckets": (seq_bucket,)}
    jax_engine = JaxEngine()
    jax_configure(jax_engine, dict(conf), name="engine")
    jax_engine.bind(jmod.apply, variables["params"], {}, (seq_bucket, 3))
    jax_engine.warmup()
    dense = variables["params"]["Dense_0"]
    port_engine = InferenceEngine()
    configure(port_engine, dict(conf), name="engine")
    port_engine.bind(_PooledHead(dense["kernel"], dense["bias"]), (seq_bucket, 3), device="cpu")
    assert port_engine.warmup() == 1
    x = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    got = port_engine.infer(x).detach().numpy()
    assert got.shape == (2, seq_bucket)  # nothing taken for sequence padding
    np.testing.assert_allclose(got, np.asarray(jax_engine.infer(x)), rtol=1e-6, atol=1e-6)
    assert port_engine._out_tracks_seq == {seq_bucket: False}


def test_batcher_concatenates_token_requests_as_the_jax_batcher(engines):
    (jax_engine, _), (port_engine, _) = engines["jax"], engines["port"]
    same = [_tokens(n, 11, seed=20) for n in (1, 2, 1)]
    mixed = [_tokens(1, 11, seed=30), _tokens(1, 7, seed=31)]
    results = {}
    for side, engine, cls, conf in (("port", port_engine, MicroBatcher, configure),
                                    ("jax", jax_engine, JaxBatcher, jax_configure)):
        batcher = cls()
        conf(batcher, {}, name="batcher")
        batcher.bind(engine)
        handles = [batcher.submit(x) for x in same]
        batcher.flush()
        results[side] = [np.asarray(h.result()) for h in handles]
        # Requests of two lengths cannot share a dispatch in either package.
        for x in mixed:
            batcher.submit(x)
        with pytest.raises(ValueError):
            batcher.flush()
        batcher.close()
    for got, want in zip(results["port"], results["jax"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
