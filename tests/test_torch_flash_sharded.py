"""The port's sharded flash attention (``mha_spmd``, ``mha_manual``)
against the JAX package's, on the CPU.

The port runs on eight gloo ranks (``paddle_tpu_torch.testing.dist``),
mesh dp2 x mp4; each rank runs the kernels' plain versions (its tensors lie
on the CPU) on its block. The reference runs its Pallas kernels in
interpret mode (``PT_FLASH_INTERPRET=1``) under the same mesh of its
virtual CPU devices. Same inputs from a numpy seed, causal,
``[4, 8, 128, 32]`` fp32; out, dq, dk and dv at 1e-5 relative and
absolute (the reference's online softmax against the plain version's
one-pass softmax: summation order only).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_ranks as ranks
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models.convert import gather_shards
from paddle_tpu_torch.ops.cuda.flash_attention import manual_axes
from paddle_tpu_torch.testing.dist import World

# the package re-exports a function of the module's name
ref_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
SHAPE, NAMES = (2, 4), ("dp", "mp")
B, H, S, D = 4, 8, 128, 32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def world():
    with World(8) as w:
        yield w


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")


def _inputs(b=B, h=H, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(b, h, S, D).astype(np.float32) for _ in range(4)]


def _ref_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(SHAPE), NAMES)


def _grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(a) for a in (out,) + vjp(jnp.asarray(do))]


def test_mha_spmd_matches_reference(world):
    q, k, v, do = _inputs()
    mesh = _ref_mesh()
    sh = NamedSharding(mesh, P("dp", "mp", None, None))
    want = _grads(jax.jit(lambda a, b, c: ref_fa.mha_spmd(a, b, c, True),
                          in_shardings=(sh, sh, sh), out_shardings=sh),
                  q, k, v, do)
    port = world.run(ranks.flash_spmd, SHAPE, NAMES, q, k, v, do)
    pm = ProcessMesh(np.arange(8).reshape(SHAPE), list(NAMES))
    spec = {"t": ("dp", "mp", None, None)}
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = gather_shards([{"t": p[i]} for p in port], spec, pm)["t"]
        np.testing.assert_allclose(got, want[i], err_msg=name, **TOL)


# (batch, heads) on dp2 x mp4: both axes, mp alone, dp alone, neither
MANUAL = [(4, 8), (3, 8), (4, 6), (3, 6)]


@pytest.mark.parametrize("b,h", MANUAL, ids=[f"b{b}h{h}" for b, h in MANUAL])
def test_mha_manual_matches_reference(world, b, h):
    """None exactly where the reference returns None; elsewhere the same
    out and gradients, whole on every rank."""
    q, k, v, do = _inputs(b, h, seed=b * 10 + h)
    mesh = _ref_mesh()
    with jax.set_mesh(mesh):
        ref_out = jax.jit(lambda a, b_, c: ref_fa.mha_manual(
            a, b_, c, mesh, causal=True))(q, k, v)
        want = None if ref_out is None else _grads(
            jax.jit(lambda a, b_, c: ref_fa.mha_manual(
                a, b_, c, mesh, causal=True)), q, k, v, do)
    port = world.run(ranks.flash_manual, SHAPE, NAMES, q, k, v, do)
    if want is None:
        assert all(p == "none" for p in port)
        return
    for p in port:
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            np.testing.assert_allclose(p[i], want[i], err_msg=name, **TOL)


@pytest.mark.parametrize("shape,names", [((2, 4), ("dp", "mp")),
                                         ((8,), ("dp",)), ((2,), ("pp",)),
                                         ((2, 2, 2), ("dp", "pp", "mp"))])
def test_manual_axes_match_reference_choice(shape, names):
    """The axes the port splits over are the ones the reference's
    mha_manual puts in its shard_map (None: no axis)."""
    pm = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                     list(names))
    rm = Mesh(np.asarray(jax.devices()[:pm.size]).reshape(shape), names)
    for b in range(1, 9):
        for h in range(1, 9):
            want = tuple(a for a, dim in (("dp", b), ("mp", h))
                         if a in rm.axis_names and rm.shape[a] > 1
                         and dim % rm.shape[a] == 0)
            assert manual_axes(b, h, pm) == want
            if not want:  # the reference returns None before any tracing
                x = jax.ShapeDtypeStruct((b, h, S, D), jnp.float32)
                assert ref_fa.mha_manual(x, x, x, rm) is None
