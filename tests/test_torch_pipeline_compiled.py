"""The port's pipeline (``distributed.pipelined_trunk``) against the JAX
package's, on the CPU.

The port runs on gloo ranks (``paddle_tpu_torch.testing.dist``), one
stage a rank, streaming micro-batches with ``send``/``recv``; the
reference runs its compiled pipeline on the same pp mesh of its virtual
CPU devices. Eight affine-tanh layers (the reference's own test block),
pp 2 and 4, 2 and 4 micro-batches, with and without remat. Held: the
trunk's output on every stage, and the gradients of ``sum(out * r)`` in
the input (the same on every stage) and in each stage's layers, fp32 at
1e-5 relative and absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_ranks as ranks
from paddle_tpu.distributed import pipeline_compiled as ref_pc
from paddle_tpu_torch.distributed import pipeline_compiled as pt_pc
from paddle_tpu_torch.testing.dist import World

L, MB, H = 8, 2, 16
CASES = [(2, 2, True), (2, 4, False), (4, 2, False), (4, 4, True)]


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


def _inputs(num_micro):
    r = np.random.RandomState(num_micro)
    w = (r.randn(L, H, H) * 0.3).astype(np.float32)
    b = (r.randn(L, H) * 0.1).astype(np.float32)
    x = r.randn(num_micro * MB, H).astype(np.float32)
    cot = r.randn(num_micro * MB, H).astype(np.float32)
    return w, b, x, cot


def _reference(pp, num_micro, remat, w, b, x, cot):
    mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))

    def block(a, blk):
        wi, bi = blk
        return jnp.tanh(a @ wi + bi)

    trunk = ref_pc.pipelined_trunk(block, mesh, num_microbatches=num_micro,
                                   axis_name="pp", remat=remat)
    out = trunk((jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x))
    gx, (gw, gb) = jax.grad(
        lambda x_, p: jnp.sum(trunk(p, x_) * cot), argnums=(0, 1))(
        jnp.asarray(x), (jnp.asarray(w), jnp.asarray(b)))
    return [np.asarray(a) for a in (out, gx, gw, gb)]


@pytest.mark.parametrize("pp,num_micro,remat", CASES,
                         ids=[f"pp{p}-m{m}-remat{r}" for p, m, r in CASES])
def test_pipelined_trunk_matches_reference(world, pp, num_micro, remat):
    w, b, x, cot = _inputs(num_micro)
    port = world.run(ranks.pipeline, pp, num_micro, remat, w, b, x, cot)
    out, gx, gw, gb = _reference(pp, num_micro, remat, w, b, x, cot)
    for r in range(pp):  # output and input gradient whole on every stage
        np.testing.assert_allclose(port[r][0], out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port[r][1], gx, rtol=1e-5, atol=1e-5)
    assert all(p is None for p in port[pp:])
    np.testing.assert_allclose(np.concatenate([p[2] for p in port[:pp]]),
                               gw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([p[3] for p in port[:pp]]),
                               gb, rtol=1e-5, atol=1e-5)


def test_schedule_tables_match_reference():
    for n in (1, 2, 4, 8):
        assert pt_pc.stream_permutation(n) == ref_pc.stream_permutation(n)
        for m in (1, 2, 4, 7):
            assert pt_pc.stream_tick_count(m, n) == \
                ref_pc.stream_tick_count(m, n)


def test_indivisible_batch_raises():
    trunk = pt_pc.pipelined_trunk(ranks._affine_block, None, 4)
    with pytest.raises(ValueError, match="batch 6 not divisible by "
                                         "micro-batches 4"):
        trunk({}, np.zeros((6, H), np.float32))
