"""The semi-auto API of the port (``paddle_tpu_torch/distributed``:
``placements``, ``api``, ``auto_parallel/reshard_functions``) on four gloo
ranks, against the reference run in this process on its virtual CPU
devices: the counterpart of ``tests/test_reshard_functions.py`` and
``tests/test_distributed.py``'s mesh tests.

- ``choose_reshard_function`` picks the reference's class for every pair
  of placements on a 1-D and a 2-D mesh, and across meshes.
- Every pair of {Replicate, Shard(0), Shard(1), Partial} on a 1-D ``[4]``
  mesh, and a set of multi-axis moves on a ``[2, 2]`` mesh (two axes
  splitting one dim among them), from ``shard_tensor`` through
  ``reshard``: each rank's piece equals the reference's shard on the
  device of the same number, exactly. For Partial that is the slice of
  the reference's stacked contributions at the rank's coordinate, so the
  Partial algebra (the split on the first coordinate, the sums) is held
  piece by piece. A dim the mesh does not divide raises ``ValueError`` in
  both.
- The cross-mesh move from ranks [0, 1] to [2, 3]; a Partial source there
  leaves no gradient edge, and backward does not fail.
- Gradients flow through layout moves (2x of ``sum(out * out)``), and
  not through Partial moves.
- ``dtensor_from_local`` / ``dtensor_to_local`` / ``unshard_dtensor``, and
  ``shard_layer`` (parameters sharded in place).

The rank functions are ``tests/torch_dist_ranks.py``.
"""
import itertools

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed as rdist
import torch_dist_ranks as W
from paddle_tpu.distributed.auto_parallel import reshard_functions as rrf
from paddle_tpu_torch.distributed import mesh as pt_mesh
from paddle_tpu_torch.distributed import placements as pt_pl
from paddle_tpu_torch.distributed.auto_parallel import \
    reshard_functions as prf
from paddle_tpu_torch.testing.dist import World

WORDS = ("R", "S0", "S1", "P")


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=60) as w:
        yield w


def _ref_placements(spec):
    return [rdist.Replicate() if w == "R" else rdist.Partial() if w == "P"
            else rdist.Shard(int(w[1:])) for w in spec.split()]


def _pt_placements(spec):
    return [pt_pl.Replicate() if w == "R" else pt_pl.Partial() if w == "P"
            else pt_pl.Shard(int(w[1:])) for w in spec.split()]


def _ref_mesh(shape, names):
    return rdist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                             dim_names=list(names))


def _value(shape=(8, 12)):
    return np.arange(int(np.prod(shape)), dtype="float32").reshape(shape)


def _ref_pieces(t):
    """The reference's shard of ``t`` on each device, the stacked Partial
    dims (one per Partial axis, each of size 1 in a shard) dropped."""
    n_partial = sum(p.is_partial() for p in t._dist_attr.placements)
    out = {}
    for sh in t._value.addressable_shards:
        a = np.asarray(sh.data)
        out[sh.device.id] = a.reshape(a.shape[n_partial:])
    return out


def _ref_chain(shape, names, x, chain):
    mesh = _ref_mesh(shape, names)
    t = rdist.shard_tensor(ref.to_tensor(x), mesh,
                           _ref_placements(" ".join("R" * len(shape))))
    out = []
    for spec in chain:
        chosen = rrf.choose_reshard_function(
            rrf.DistAttrLite(mesh, t._dist_attr.placements),
            rrf.DistAttrLite(mesh, _ref_placements(spec))).name
        t = rdist.reshard(t, mesh, _ref_placements(spec))
        out.append((chosen, _ref_pieces(t)))
    return out


def _hold_chain(world, shape, names, x, chain):
    got = world.run(W.reshard_chain, shape, names, x, chain)
    want = _ref_chain(shape, names, x, chain)
    for step, (chosen, pieces) in enumerate(want):
        for r, rank_steps in enumerate(got):
            name, piece, gshape = rank_steps[step]
            assert name == chosen, (chain[:step + 1], name, chosen)
            assert gshape == list(x.shape)
            np.testing.assert_array_equal(
                piece, pieces[r], err_msg=f"{chain[:step + 1]} rank {r}")


# ------------------------------------------------------------ dispatch

def _chosen(mod, mesh_a, src, dst, mesh_b=None, pl=None):
    return mod.choose_reshard_function(
        mod.DistAttrLite(mesh_a, pl(src)),
        mod.DistAttrLite(mesh_b or mesh_a, pl(dst))).name


def test_registry_order_is_the_reference_s():
    assert [f.name for f in prf.all_reshard_functions()] == \
        [f.name for f in rrf.all_reshard_functions()]


@pytest.mark.parametrize("ndim", [1, 2])
def test_registry_chooses_the_reference_s_function_for_every_pair(ndim):
    shape, names = [(4,), (2, 2)][ndim - 1], ["x", "y"][:ndim]
    rmesh = _ref_mesh(shape, names)
    pmesh = pt_mesh.ProcessMesh(np.arange(4).reshape(shape), names)
    specs = [" ".join(c) for c in itertools.product(WORDS, repeat=ndim)]
    for src, dst in itertools.product(specs, repeat=2):
        assert _chosen(prf, pmesh, src, dst, pl=_pt_placements) == \
            _chosen(rrf, rmesh, src, dst, pl=_ref_placements), (src, dst)


def test_registry_chooses_cross_mesh_for_another_mesh():
    a = pt_mesh.ProcessMesh(np.arange(2), ["x"])
    b = pt_mesh.ProcessMesh(np.arange(2), ["x"])  # equal, not the same
    ra, rb = _ref_mesh((2,), ["x"]), _ref_mesh((2,), ["x"])
    for src, dst in itertools.product(WORDS, repeat=2):
        assert _chosen(prf, a, src, dst, b, _pt_placements) == \
            _chosen(rrf, ra, src, dst, rb, _ref_placements) == "cross_mesh"


# ------------------------------------------------------ every pair, 1-D

@pytest.mark.parametrize("src,dst", list(itertools.product(WORDS, WORDS)))
def test_pair_on_a_1d_mesh_matches_the_reference_piece_by_piece(
        world, src, dst):
    _hold_chain(world, (4,), ["x"], _value(), [src, dst])


# --------------------------------------------------- multi-axis, 2-D

ND_CHAINS = [
    ["S0 R", "R S1"],          # test_nd_mesh_multi_axis_change
    ["P R", "R S0"],           # test_nd_mesh_partial_then_shard
    ["S0 S1", "R R"],
    ["S1 S0", "S0 S1"],
    ["S0 R", "R S0"],
    ["R S0", "S0 S0"],         # a split ahead of an existing one
    ["S0 S0", "R R"],
    ["S0 S0", "S1 R"],
    ["S0 S0", "R S0"],         # the outer of two splits of one dim
    ["P P", "R R"],
    ["P S1", "S0 R"],
    ["R P", "S0 S1"],
    ["S1 P", "P S1"],
    ["S0 R", "P P"],
    ["S0 S1", "S1 S1"],        # an all-to-all onto a dim split further in
    ["P S0", "S0 S0"],         # a reduce-scatter the same way
]


@pytest.mark.parametrize("chain", ND_CHAINS, ids=" / ".join)
def test_move_on_a_2d_mesh_matches_the_reference_piece_by_piece(
        world, chain):
    _hold_chain(world, (2, 2), ["x", "y"], _value(), chain)


@pytest.mark.parametrize("spec", ["S0 S1", "S0 R", "S1 S1", "R S0"])
def test_shard_tensor_layouts_match_the_reference(world, spec):
    """test_shard_tensor_layouts on a [2, 2] mesh: ``shard_tensor``
    straight to the placements, each rank's piece the reference's
    shard."""
    x = _value()
    mesh = _ref_mesh((2, 2), ["dp", "mp"])
    want = _ref_pieces(rdist.shard_tensor(ref.to_tensor(x), mesh,
                                          _ref_placements(spec)))
    for r, piece in enumerate(world.run(W.shard_pieces, (2, 2),
                                        ["dp", "mp"], x, spec)):
        np.testing.assert_array_equal(piece, want[r])


def test_a_dim_the_mesh_does_not_divide_raises_as_in_the_reference(world):
    x = _value((6, 12))
    got = world.run(W.shard_pieces, (4,), ["x"], x, "S0")
    assert all(g.startswith("ValueError") for g in got), got
    mesh = _ref_mesh((4,), ["x"])
    with pytest.raises(ValueError):
        rdist.shard_tensor(ref.to_tensor(x), mesh, _ref_placements("S0"))
    # a Partial move never splits: it works on both sides
    _hold_chain(world, (4,), ["x"], x, ["P", "R"])
    got = world.run(W.reshard_chain, (4,), ["x"], x, ["P", "S0"])
    assert all(steps[-1][0] == "ValueError" for steps in got), got


# --------------------------------------------------------- cross mesh

def test_cross_mesh_move_matches_the_reference(world):
    x = _value((4, 6))
    got = world.run(W.cross_mesh, x, "S0", "S1")
    mesh_a = _ref_mesh((2,), ["x"])
    mesh_b = rdist.ProcessMesh(np.array([2, 3]), dim_names=["y"])
    t = rdist.shard_tensor(ref.to_tensor(x), mesh_a, _ref_placements("S0"))
    before = _ref_pieces(t)
    after = _ref_pieces(rdist.reshard(t, mesh_b, _ref_placements("S1")))
    for r, (src_piece, dst_piece, _) in enumerate(got):
        if r < 2:
            np.testing.assert_array_equal(src_piece, before[r])
            assert dst_piece.size == 0   # outside the destination mesh
        else:
            assert src_piece.size == 0   # outside the source mesh
            np.testing.assert_array_equal(dst_piece, after[r])


def test_partial_cross_mesh_records_no_gradient_edge(world):
    """test_reshard_functions.py:214: a Partial source resolved across
    meshes keeps stop_gradient False and backward does not raise."""
    x = _value((2, 2))
    got = world.run(W.cross_mesh, x, "R", "R", True)
    for r in (2, 3):
        np.testing.assert_array_equal(got[r][1], x)
        assert got[r][2] is False


# ----------------------------------------------------------- gradients

@pytest.mark.parametrize("shape,names,src,dst", [
    ((4,), ["x"], "R", "S0"),                   # layout reshards
    ((2, 2), ["x", "y"], "S0 S1", "R R"),       # nd mesh layout move
    ((2, 2), ["x", "y"], "S0 R", "R S1"),       # test_reshard_grad_flows
    ((4,), ["x"], "S1", "S0"),                  # the all-to-all's adjoint
])
def test_gradient_flows_through_layout_moves(world, shape, names, src,
                                             dst):
    """The reference's d sum(out * out) / d x is 2x; each rank's loss is
    its own piece's here, so the pieces' losses sum to the reference's
    whenever ``out`` is split, and equal it when it is replicated."""
    x = _value()
    for grad, stop in world.run(W.reshard_grad, shape, names, x, src, dst):
        assert stop is False
        np.testing.assert_allclose(grad, 2 * x, rtol=1e-6)
    t = ref.to_tensor(x)
    t.stop_gradient = False
    mesh = _ref_mesh(shape, names)
    out = rdist.reshard(rdist.shard_tensor(t, mesh, _ref_placements(src)),
                        mesh, _ref_placements(dst))
    (out * out).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), 2 * x, rtol=1e-6)


def test_no_gradient_edge_through_partial(world):
    """A move to Partial is grad-opaque: the result is a leaf."""
    x = _value()
    for grad, stop in world.run(W.reshard_grad, (4,), ["x"], x, "R", "P"):
        assert stop is False and grad is None


# --------------------------------------- dtensor_{from,to}_local, layer

@pytest.mark.parametrize("spec", ["S0", "R", "S1"])
def test_dtensor_from_local_with_the_same_local_matches_the_reference(
        world, spec):
    """The reference's single controller gives every device the same
    local; the port's ranks do the same here."""
    x = _value((2, 3))
    mesh = _ref_mesh((4,), ["x"])
    want = rdist.dtensor_from_local(ref.to_tensor(x), mesh,
                                    _ref_placements(spec))
    whole = np.asarray(rdist.unshard_dtensor(want)._value)
    for gshape, local, got_whole, _, pl in world.run(
            W.local_round_trip, (4,), ["x"], x, spec, True):
        assert gshape == list(want.shape)
        np.testing.assert_array_equal(local, x)
        np.testing.assert_array_equal(got_whole, whole)
        assert pl == [repr(p) for p in want._dist_attr.placements]


def test_dtensor_local_round_trip_of_the_ranks_pieces(world):
    """test_dtensor_to_local: each rank's piece in, the whole value back,
    and the gradient of the whole value's loss reaches each local."""
    x = _value()
    mesh = _ref_mesh((2, 2), ["x", "y"])
    xs = rdist.shard_tensor(ref.to_tensor(x), mesh,
                            _ref_placements("S0 R"))
    assert rdist.dtensor_to_local(xs).shape == [4, 12]
    np.testing.assert_array_equal(rdist.unshard_dtensor(xs).numpy(), x)
    got = world.run(W.local_round_trip, (2, 2), ["x", "y"], x, "S0 R",
                    False)
    for r, (gshape, local, whole, grad, _) in enumerate(got):
        assert gshape == [8, 12] and local.shape == (4, 12)
        np.testing.assert_array_equal(local, x[4 * (r // 2):][:4])
        np.testing.assert_array_equal(whole, x)
        np.testing.assert_array_equal(grad, 2 * local)


def test_shard_layer_shards_parameters_in_place(world):
    r = np.random.RandomState(0)
    state = {"weight": r.randn(4, 8).astype("float32"),
             "bias": r.randn(8).astype("float32")}
    layer = ref.nn.Linear(4, 8)
    layer.set_state_dict(state)
    mesh = _ref_mesh((4,), ["x"])

    def shard_fn(name, sub, m):
        if isinstance(sub, ref.nn.Linear):
            rdist.shard_tensor(sub.weight, m, _ref_placements("S1"))
            rdist.shard_tensor(sub.bias, m, _ref_placements("R"))

    rdist.shard_layer(layer, mesh, shard_fn)
    wp, bp = _ref_pieces(layer.weight), _ref_pieces(layer.bias)
    for rank, (w, b, same, pl) in enumerate(world.run(
            W.shard_layer_pieces, (4,), ["x"], state, "S1")):
        np.testing.assert_array_equal(w, wp[rank])
        np.testing.assert_array_equal(b, bp[rank])
        assert same and pl == ["Shard(dim=1)"]


def test_placements_compare_hash_and_print_as_the_reference_s():
    for a, b in itertools.product(WORDS + ("S2",), repeat=2):
        pa, pb = _pt_placements(a)[0], _pt_placements(b)[0]
        ra, rb = _ref_placements(a)[0], _ref_placements(b)[0]
        assert (pa == pb) == (ra == rb)
        assert repr(pa) == repr(ra)
        assert (hash(pa) == hash(pb)) == (hash(ra) == hash(rb))
        assert (pa.is_shard(), pa.is_replicate(), pa.is_partial()) == \
            (ra.is_shard(), ra.is_replicate(), ra.is_partial())
    assert pt_pl.Partial("max") != pt_pl.Partial()


def test_placements_to_spec_matches_the_reference():
    from paddle_tpu_torch.distributed.api import placements_to_spec
    names = ["x", "y"]
    pmesh = pt_mesh.ProcessMesh(np.arange(4).reshape(2, 2), names)
    rmesh = _ref_mesh((2, 2), names)
    for spec in (" ".join(c) for c in itertools.product(
            ("R", "S0", "S1", "P"), repeat=2)):
        assert tuple(placements_to_spec(_pt_placements(spec), pmesh, 2)) \
            == tuple(rdist.placements_to_spec(_ref_placements(spec), rmesh,
                                              2)), spec
