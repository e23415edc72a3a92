"""The port's sequence-parallel attention across gloo ranks against the
JAX package's.

The same seeded numpy q/k/v ``[2, 16, 4, 8]`` and upstream gradient w go
through JAX's ``ring_attention``, ``ring_flash_attention`` and
``all_to_all_attention`` (dense and flash local) on conftest's CPU mesh
of n devices (flash in interpret mode, as ``tests/ops/test_ring_attention
.py`` runs it) and through the port's on n gloo ranks, each holding its
sequence shard (``torch_parallel_workers.ring_legs``; one cluster of 2
and one of 4 answer every leg). Outputs are held to 2e-5 and the q/k/v
gradients of ``sum(out * w)`` to 5e-5 (atol and rtol), the JAX ring
tests' tolerances; the ring flavors' overlap schedule equals the
sequential one bit for bit. The lse cotangent of
``flash_attention_lse`` is held to ``jax.vjp`` of JAX's
``_flash_attention_lse`` in one process.
"""

import torch_threads  # noqa: F401,I001  (one intra-op thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from zookeeper_tpu.ops import all_to_all_attention as jax_all_to_all_attention
from zookeeper_tpu.ops import ring_attention as jax_ring_attention
from zookeeper_tpu.ops import ring_flash_attention as jax_ring_flash_attention
from zookeeper_tpu.ops.attention import _default_flash_blocks as jax_default_blocks
from zookeeper_tpu.ops.attention import _flash_attention_lse as jax_flash_attention_lse
from zookeeper_tpu_torch.ops import attention as port

SHAPE = (2, 16, 4, 8)
OUT_TOL = 2e-5
GRAD_TOL = 5e-5


def _inputs(world):
    rng = np.random.default_rng(100 + world)
    return {name: rng.normal(size=SHAPE).astype(np.float32) for name in "qkvw"}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Every leg of a 2-rank and a 4-rank cluster: ``{world: (inputs,
    per-rank results)}``."""
    runs = {}
    for world in (2, 4):
        out_dir = str(tmp_path_factory.mktemp(f"ring{world}"))
        inputs = _inputs(world)
        workers.spawn(workers.ring_legs, world, out_dir, inputs)
        runs[world] = (inputs, workers.load(out_dir, "ring", world))
    return runs


def _jax_flavor(flavor):
    if flavor == "ring":
        return jax_ring_attention
    if flavor == "ring_flash":
        return jax_ring_flash_attention
    return functools.partial(jax_all_to_all_attention, local_attention=flavor.split("_")[1])


def _jax_leg(flavor, causal, world, inputs):
    """JAX's output and q/k/v gradients of ``sum(out * w)`` on a CPU mesh
    of ``world`` devices, under one jit."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    fn = _jax_flavor(flavor)
    w = jnp.asarray(inputs["w"])

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, seq_axis="sp", causal=causal)
        return (out * w).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(inputs[n]) for n in "qkv"))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gathered(results, key, name):
    return torch.cat([r[key][name] for r in results], dim=1).numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("flavor", workers.RING_FLAVORS)
def test_sequence_parallel_attention_matches_jax(clusters, flavor, causal, world):
    inputs, results = clusters[world]
    want_out, want_grads = _jax_leg(flavor, causal, world, inputs)
    key = (flavor, causal, True)
    np.testing.assert_allclose(_gathered(results, key, "out"), want_out,
                               atol=OUT_TOL, rtol=OUT_TOL)
    for name, want in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(_gathered(results, key, name), want,
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
    # CPU tensors: the kernel wrappers ran their plain versions.
    assert all(n == 0 for r in results for n in r[key]["launches"].values())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("flavor", ["ring", "ring_flash"])
def test_overlap_schedule_equals_sequential_bitwise(clusters, flavor, causal, world):
    _, results = clusters[world]
    for r in results:
        overlapped, sequential = r[(flavor, causal, True)], r[(flavor, causal, False)]
        for name in ("out", "dq", "dk", "dv"):
            assert torch.equal(overlapped[name], sequential[name]), name


@pytest.mark.parametrize("world", [2, 4])
def test_rejections_match_jax(clusters, world):
    """Indivisible heads (Ulysses), mismatched q/k/v shapes and an
    unknown local attention raise the JAX package's errors."""
    _, results = clusters[world]
    errors = results[0]["errors"]
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    q = jnp.zeros((2, 16, 3, 8))
    with pytest.raises(ValueError) as heads:
        jax_all_to_all_attention(q, q, q, mesh=mesh, seq_axis="sp")
    assert errors["heads"] == str(heads.value)
    with pytest.raises(ValueError) as local:
        jax_all_to_all_attention(q, q, q, mesh=mesh, seq_axis="sp", local_attention="sparse")
    assert errors["local"] == str(local.value)
    # The shapes check names the shards each side holds.
    assert errors["shapes"].startswith(
        "Sequence-parallel attention requires q, k, v of identical shape")
    with pytest.raises(ValueError, match="identical shape"):
        jax_ring_attention(q, q[:, :-1], q, mesh=mesh, seq_axis="sp")


def test_indivisible_sequence_is_refused_where_the_batch_is_cut():
    """Each rank holds its shard, so the global sequence is checked where
    the global batch is cut into shards, with JAX's message."""
    from zookeeper_tpu_torch.data.pipeline import batch_iterator
    from zookeeper_tpu_torch.data.source import ArraySource

    tokens = np.arange(4 * 10, dtype=np.int32).reshape(4, 10)
    source = ArraySource({"input": tokens, "target": tokens})
    it = batch_iterator(source, None, 2, training=True, shuffle=False, seq_index=0, seq_count=4)
    with pytest.raises(ValueError, match="Sequence length 10 does not divide the 'sp' axis size 4"):
        next(it)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_lse_cotangent_matches_jax_vjp(causal):
    """``flash_attention_lse``'s gradients with both cotangents nonzero
    (dO and dlse) against ``jax.vjp`` of ``_flash_attention_lse``:
    ``D' = D - dlse`` folded into K10/K11's plain versions."""
    b, s, h, d = 2, 40, 2, 16
    rng = np.random.default_rng(7 + causal)
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    dlse = rng.normal(size=(b * h, s)).astype(np.float32)
    scale = d ** -0.5
    block_q, block_k = jax_default_blocks(s, None, None, head_dim=d, itemsize=4)
    (j_out, j_lse), vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention_lse(q_, k_, v_, causal, scale, block_q,
                                                   block_k, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    s_pad = j_lse.shape[1]
    dlse_pad = np.zeros((b * h, s_pad, 1), np.float32)
    dlse_pad[:, :s, 0] = dlse
    j_grads = vjp((jnp.asarray(do), jnp.asarray(dlse_pad)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = port.flash_attention_lse(tq, tk, tv, causal=causal)
    torch.autograd.backward((out, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(j_lse)[:, :s, 0],
                               atol=2e-5, rtol=2e-5)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")
    # The lse cotangent moves dq and dk (dv does not depend on lse).
    tq2, tk2, tv2 = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out2, _ = port.flash_attention_lse(tq2, tk2, tv2, causal=causal)
    out2.backward(torch.from_numpy(do))
    assert not torch.allclose(tq.grad, tq2.grad)
    assert torch.allclose(tv.grad, tv2.grad)


def test_ring_flash_step_composes_the_ring_in_one_process():
    """The step function the ring runs between rotations, composed over
    4 shards without a group (as the chip check composes it), equals
    flash attention over the whole sequence, causal: diagonal blocks
    causal, past blocks full, future blocks skipped."""
    rng = np.random.default_rng(11)
    n, b, s, h, d = 4, 1, 32, 2, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
               for _ in range(3))
    sl = s // n
    shards = [(q[:, i * sl:(i + 1) * sl], k[:, i * sl:(i + 1) * sl], v[:, i * sl:(i + 1) * sl])
              for i in range(n)]
    outs = []
    for my in range(n):
        o = lse = None
        for t in range(n):
            src = (my + t) % n
            o, lse = port.ring_flash_step(shards[my][0], shards[src][1], shards[src][2], o, lse,
                                          src=src, my=my, causal=True)
        outs.append(o)
    want = port.attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(), atol=OUT_TOL,
                               rtol=OUT_TOL)
