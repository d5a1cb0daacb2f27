"""The port's vocab-parallel head against the JAX package's, on the CPU.

The port runs on four gloo ranks (``paddle_tpu_torch.testing.dist``), mesh
dp1 x mp4, each rank holding its quarter of the ``[V, H]`` classifier; the
reference runs ``vocab_parallel_softmax_cross_entropy`` on the same mesh
of its virtual CPU devices. Same inputs from a numpy seed; the labels hit
every shard, and the first and last row of each.

Tolerances (fp32, summation orders differ): the loss at 1e-6 relative,
the per-token losses and the gradients of hidden and weight at 1e-5
relative and absolute. As the reference's own test does, the port's
gradients are also held against the dense head's (full logits) at its
limits, rtol 1e-4 with atol 1e-6 (hidden) and 1e-7 (weight).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_ranks as ranks
from paddle_tpu.distributed.fleet.mp_ops import \
    vocab_parallel_softmax_cross_entropy as ref_vp
from paddle_tpu_torch.testing.dist import World

VOCAB, H, B, S, MP = 1024, 32, 2, 16, 4
SHAPE, NAMES = (1, MP), ("dp", "mp")


@pytest.fixture(scope="module")
def world():
    with World(MP) as w:
        yield w


def _inputs():
    r = np.random.RandomState(0)
    hidden = r.randn(B, S, H).astype(np.float32)
    weight = (r.randn(VOCAB, H) * 0.05).astype(np.float32)
    labels = r.randint(0, VOCAB, (B, S)).astype(np.int64)
    shard = VOCAB // MP
    edges = [e for k in range(MP) for e in (k * shard, (k + 1) * shard - 1)]
    labels.reshape(-1)[:len(edges)] = edges
    return hidden, weight, labels


def _reference(hidden, weight, labels, dense=False):
    mesh = Mesh(np.asarray(jax.devices()[:MP]).reshape(SHAPE), NAMES)
    y = jnp.asarray(labels.astype(np.int32))

    def tokens(h, w):
        if dense:
            logp = jax.nn.log_softmax(jnp.einsum("bsh,vh->bsv", h, w), -1)
            return -jnp.take_along_axis(logp, y[..., None], -1)[..., 0]
        return ref_vp(h, w, y, mesh, axis="mp")

    w = jax.device_put(jnp.asarray(weight), NamedSharding(mesh, P("mp", None)))
    loss, (gh, gw) = jax.jit(jax.value_and_grad(
        lambda h, w: tokens(h, w).mean(), argnums=(0, 1)))(
        jnp.asarray(hidden), w)
    return (float(loss), np.asarray(jax.jit(tokens)(jnp.asarray(hidden), w)),
            np.asarray(gh), np.asarray(gw))


@pytest.fixture(scope="module")
def results(world):
    hidden, weight, labels = _inputs()
    port = world.run(ranks.vocab_parallel, SHAPE, NAMES, hidden, weight,
                     labels)
    return port, _reference(hidden, weight, labels), \
        _reference(hidden, weight, labels, dense=True)


def test_labels_hit_every_shard_and_both_edges():
    _, _, labels = _inputs()
    shard = VOCAB // MP
    for k in range(MP):
        assert k * shard in labels and (k + 1) * shard - 1 in labels


def test_loss_matches_reference(results):
    port, (loss, tok, _, _), _ = results
    for r in range(MP):  # every rank holds the whole loss
        assert abs(port[r][0] - loss) <= 1e-6 * abs(loss)
        np.testing.assert_allclose(port[r][1], tok, rtol=1e-5, atol=1e-5)


def test_gradients_match_reference(results):
    port, (_, _, gh, gw), _ = results
    for r in range(MP):  # d hidden is whole on every rank
        np.testing.assert_allclose(port[r][2], gh, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([p[3] for p in port]), gw,
                               rtol=1e-5, atol=1e-5)


def test_gradients_match_dense_head(results):
    port, _, (loss, _, gh, gw) = results
    assert abs(port[0][0] - loss) <= 1e-6 * abs(loss)
    np.testing.assert_allclose(port[0][2], gh, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([p[3] for p in port]), gw,
                               rtol=1e-4, atol=1e-7)


def test_vocab_parallel_lookup_matches_dense(world):
    """The embedding lookup over the split vocabulary: the rows and the
    weight's gradient, exactly those of the whole table (one rank holds
    each row; the sum over mp adds zeros)."""
    _, weight, labels = _inputs()
    cot = np.random.RandomState(1).randn(B, S, H).astype(np.float32)
    port = world.run(ranks.vocab_lookup, SHAPE, NAMES, weight, labels, cot)
    want_grad = np.zeros_like(weight)
    np.add.at(want_grad, labels.reshape(-1), cot.reshape(-1, H))
    for r in range(MP):
        np.testing.assert_array_equal(port[r][0], weight[labels])
    np.testing.assert_allclose(np.concatenate([p[1] for p in port]),
                               want_grad, rtol=1e-6, atol=1e-7)
