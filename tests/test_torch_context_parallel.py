"""The port's context parallelism against the JAX package's, on the CPU.

The cases of ``tests/test_context_parallel.py``: ``ring_attention_global``
and ``ulysses_attention_global`` on 2 and 4 gloo ranks (one spawned
process a rank, ``paddle_tpu_torch.testing.dist``), causal and not,
against the reference's ``_global`` forms on its CPU mesh of as many
devices; the ring's (and Ulysses's) gradients against the reference's
plain attention's, the oracle of its own gradient test; dp × sep on a [2, 2] mesh; Ulysses's
``num_heads % sep`` error; and the ``_global`` forms' return, a
DistTensor of this rank's piece (``Shard(1)`` on sep, ``Shard(0)`` on the
batch axis) whose ``unshard_dtensor`` is the reference's value. Ulysses
over the port's flash entry (``attn_fn``) is held against the entry alone.
Inputs come from a numpy seed; fp32 at 2e-5 (the reference's own
tolerance), gradients at 2e-4 as the reference's grad test.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed import context_parallel as ref_cp
from paddle_tpu_torch.testing.dist import World

import torch_dist_ranks as ranks

TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture(scope="module")
def world():
    w = World(4, timeout=120)
    yield w
    w.close()


def _inputs(seed, b, s, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def _ref_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


_REF = {}


def _ref(kind, q, k, v, shape, names, causal, batch_axis=None):
    """The reference's ``_global`` form (each case built once: a build
    takes seconds on the CPU)."""
    key = (kind, q.tobytes(), k.tobytes(), v.tobytes(), shape, causal,
           batch_axis)
    if key not in _REF:
        fn = {"ring": ref_cp.ring_attention_global,
              "ulysses": ref_cp.ulysses_attention_global}[kind]
        _REF[key] = np.asarray(fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            _ref_mesh(shape, names), causal=causal, batch_axis=batch_axis))
    return _REF[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_global_forms_match_reference(world, kind, causal, n):
    h = 4 if kind == "ring" else 8       # ulysses: h % sep == 0
    q, k, v = _inputs(0 if kind == "ring" else 1, 2, 32, h, 16)
    want = _ref(kind, q, k, v, (n,), ("sep",), causal)
    got = world.run(ranks.context_parallel, kind, (n,), ("sep",), q, k, v,
                    causal)
    step = 32 // n
    for r, res in enumerate(got[:n]):
        _close(res["piece"], want[:, r * step:(r + 1) * step])
        _close(res["full"], want)
    assert got[n:] == [None] * (4 - n)


def _full_grads(q, k, v):
    """The gradients of sum(out ** 2) through the reference's plain
    attention, the oracle of its own ring-gradient test (its ring's
    gradients, through ``scan`` and ``ppermute``, take ~25 s a mesh to
    build on the CPU)."""
    def loss(q, k, v):
        return jnp.sum(ref_cp._full_attention(q, k, v, True, None) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_gradients_match_reference(world, kind, n):
    q, k, v = _inputs(2, 1, 16, 4, 8)
    want = _full_grads(q, k, v)
    got = world.run(ranks.context_parallel, kind, (n,), ("sep",), q, k, v,
                    True, None, True)
    for res in got[:n]:
        for g, w in zip(res["grads"], want):
            _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_dp_sep_mesh_matches_reference(world, kind):
    """Batch over dp, sequence over sep on a [2, 2] mesh; the piece of rank
    (d, s) is the reference's block (d, s), and the DistTensor says so."""
    q, _, _ = _inputs(4, 4, 32, 4, 8)
    want = _ref(kind, q, q, q, (2, 2), ("dp", "sep"), True, "dp")
    got = world.run(ranks.context_parallel, kind, (2, 2), ("dp", "sep"), q,
                    q, q, True, "dp")
    for r, res in enumerate(got):
        d, s = divmod(r, 2)
        _close(res["piece"], want[d * 2:(d + 1) * 2, s * 16:(s + 1) * 16])
        _close(res["full"], want)
        assert res["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert res["global_shape"] == [4, 32, 4, 8]


def test_global_forms_return_a_dist_tensor_of_the_rank_piece(world):
    """The decision pinned: a ``_global`` form returns this rank's piece
    as a DistTensor (``Shard(1)`` on the sep axis, the global shape), not
    the reference's global array; ``unshard_dtensor`` is that array."""
    q, k, v = _inputs(0, 2, 32, 4, 16)
    want = _ref("ring", q, k, v, (4,), ("sep",), False)
    got = world.run(ranks.context_parallel, "ring", (4,), ("sep",), q, k, v,
                    False)
    for r, res in enumerate(got):
        assert res["placements"] == ["Shard(dim=1)"]
        assert res["global_shape"] == list(want.shape)
        assert res["piece"].shape == (2, 8, 4, 16)
        _close(res["piece"], want[:, r * 8:(r + 1) * 8])
        _close(res["full"], want)


def test_ulysses_needs_heads_divisible_by_sep(world):
    """3 heads over sep 2: the port's ranks raise the reference's
    ValueError, with its message."""
    q = np.zeros((1, 8, 3, 4), np.float32)
    spec = jax.sharding.PartitionSpec(None, "sep")
    with pytest.raises(ValueError) as ref_err:
        ref_cp.shard_map(
            lambda x: ref_cp.ulysses_attention(x, x, x, "sep"),
            _ref_mesh((2,), ("sep",)), in_specs=(spec,), out_specs=spec,
            unchecked=True)(jnp.asarray(q))
    got = world.run(ranks.ulysses_heads_error, (2,), ("sep",), q)
    assert got[:2] == [str(ref_err.value)] * 2
    assert got[2:] == [None, None]


def test_ulysses_over_the_flash_entry_matches_the_entry(world):
    """``attn_fn`` takes the port's flash entry ([B, S, H, D]); on 2 ranks
    Ulysses over it gives the entry's own output and gradients (on the CPU
    the entry runs its kernels' plain versions)."""
    rng = np.random.RandomState(7)
    q, k, v, cot = (rng.randn(1, 256, 4, 16).astype(np.float32)
                    for _ in range(4))
    got = world.run(ranks.ulysses_flash, (2,), ("sep",), q, k, v, cot)
    for res in got[:2]:
        for a, b in zip(*res):
            _close(a, b, 1e-6)


def test_ring_shift_sends_on_and_its_gradient_comes_back(world):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = world.run(ranks.ring_shift_pair, 4, x)
    for r, (recv, grad) in enumerate(got):
        np.testing.assert_array_equal(recv, x + (r - 1) % 4)
        # this rank's x went to rank r + 1, whose cotangent is r + 2
        np.testing.assert_array_equal(grad, np.full_like(x, (r + 1) % 4 + 1))

