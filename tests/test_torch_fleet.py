"""Fleet's hybrid-parallel API in one process (``paddle_tpu_torch/
distributed/fleet``, ``sharding.py``) against the reference's, on the CPU:
the counterpart of ``tests/test_distributed.py``'s topology, fleet and
tensor-parallel tests, with what one process can hold of the rest.

- ``CommunicateTopology``: the comm lists, coordinates, ranks and axis
  lists equal the reference's for dims ``[2,2,1,1,2]``, ``[1,2,2,1,1]`` and
  ``[1,1,1,1,4]``; ``HybridCommunicateGroup`` built as each rank of those
  (no process group) answers every getter as the reference's.
  ``DistributedStrategy()``'s attributes equal the reference's, and a
  dict assigned to a ``*_configs`` bag merges as the reference's does.
- ``fleet.init`` in one process: mode ``"single"``, the five mesh axes;
  ``distributed_model`` and ``distributed_optimizer`` there (the model
  itself, ``HybridParallelOptimizer`` without a clip swap).
  ``distributed_model`` in pipeline mode raises ``NotImplementedError``.
- The tensor-parallel layers at degree 1 (mirroring
  ``test_tp_layers_numerics_single`` and ``test_vocab_parallel_embedding``):
  the reference's weights, the same outputs and gradients at fp32 1e-6;
  the sequence-parallel linears and ops (the identity in the eager regime)
  the same; above degree 1 without a process group the layers raise, as
  the reference's (``test_mp_without_mesh_or_group_raises``).
- The RNG tracker's rules: a seed or a name added twice raises, a stream
  advances only inside its ``rng_state`` and the global generator only
  outside it, and the states copy and restore. (Its draws are
  ``torch.Generator``'s, not ``jax.random``'s.)
- ZeRO without a process group: ``group_sharded_parallel`` at each level
  passes through (the same step as the plain optimizer's, bit for bit),
  ``DygraphShardingOptimizer`` raises.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed.fleet as ref_fleet
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.fleet as pt_fleet
from paddle_tpu.distributed import mesh as ref_mesh
from paddle_tpu.distributed import parallel_env as ref_penv
from paddle_tpu.distributed.fleet import topology as ref_topo
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.distributed import mesh as pt_mesh
from paddle_tpu_torch.distributed import sharding as pt_sharding
from paddle_tpu_torch.distributed.fleet import mp_layers as pt_mp_layers
from paddle_tpu_torch.distributed.fleet import random_ as pt_random
from paddle_tpu_torch.distributed.fleet import topology as pt_topo

DIMS = [[2, 2, 1, 1, 2], [1, 2, 2, 1, 1], [1, 1, 1, 1, 4]]
AXES = ["pipe", "data", "sharding", "sep", "model"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' global fleet state, put back after the test."""
    for mod, names in ((ref_fleet, ("_fleet_initialized", "_strategy")),
                       (pt_fleet, ("_fleet_initialized", "_strategy")),
                       (ref_topo, ("_hcg",)), (pt_topo, ("_hcg",)),
                       (ref_mesh, ("_global_mesh",)),
                       (pt_mesh, ("_global_mesh",)),
                       (ref_penv, ("_initialized",))):
        for n in names:
            monkeypatch.setattr(mod, n, getattr(mod, n))


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# ------------------------------------------------------ topology, strategy

@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_topology_equals_the_reference(dims):
    a = ref_topo.CommunicateTopology(dims=dims)
    b = pt_topo.CommunicateTopology(dims=dims)
    assert b.world_size() == a.world_size()
    for axis in AXES:
        assert b.get_dim(axis) == a.get_dim(axis)
        assert b.get_comm_list(axis) == a.get_comm_list(axis)
        for i in range(a.get_dim(axis)):
            assert b.get_axis_list(axis, i) == a.get_axis_list(axis, i)
    for r in range(a.world_size()):
        coord = a.get_coord(r)
        assert b.get_coord(r) == coord
        assert b.get_rank(**coord) == a.get_rank(**coord) == r


def _hcg_view(hcg):
    out = {"mode": hcg.get_parallel_mode(), "rank": hcg.get_global_rank(),
           "stage": hcg.get_stage_id(), "first": hcg.is_first_stage(),
           "last": hcg.is_last_stage(),
           "dp_src": hcg.get_data_parallel_group_src_rank(),
           "mp_src": hcg.get_model_parallel_group_src_rank()}
    for kind in ("data", "model", "pipe", "sharding", "sep"):
        name = {"data": "data_parallel", "model": "model_parallel",
                "pipe": "pipe_parallel", "sharding": "sharding_parallel",
                "sep": "sep_parallel"}[kind]
        out[kind] = (getattr(hcg, f"get_{name}_rank")(),
                     getattr(hcg, f"get_{name}_world_size")(),
                     list(getattr(hcg, f"get_{name}_group")().ranks))
    return out


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_hybrid_group_equals_the_reference_on_every_rank(monkeypatch, dims):
    for r in range(int(np.prod(dims))):
        monkeypatch.setattr(ref_topo, "get_rank", lambda: r)
        monkeypatch.setattr(pt_topo, "get_rank", lambda: r)
        a = ref_topo.HybridCommunicateGroup(
            ref_topo.CommunicateTopology(dims=dims))
        b = pt_topo.HybridCommunicateGroup(
            pt_topo.CommunicateTopology(dims=dims))
        assert _hcg_view(b) == _hcg_view(a), r
        assert b.mesh.dim_names == a.mesh.dim_names
        assert b.mesh.shape == a.mesh.shape == list(dims)


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def test_strategy_defaults_and_merge_equal_the_reference():
    a, b = ref_fleet.DistributedStrategy(), pt_fleet.DistributedStrategy()
    assert _plain(vars(b)) == _plain(vars(a))
    for s in (a, b):
        s.hybrid_configs = {"mp_degree": 2}
        s.amp = True
    assert _plain(vars(b)) == _plain(vars(a))
    assert b.hybrid_configs.dp_degree == 1 and b.hybrid_configs.mp_degree == 2
    assert repr(b) == repr(a)


# ------------------------------------------------------------ fleet.init

def test_fleet_init_and_mode(fresh):
    for fleet in (ref_fleet, pt_fleet):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs["mp_degree"] = 1
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        assert fleet.is_initialized()
        assert hcg is fleet.get_hybrid_communicate_group_()
        assert hcg.get_parallel_mode() == "single"
        assert hcg.get_model_parallel_world_size() == 1
        assert hcg.mesh.dim_names == ["pp", "dp", "sharding", "sep", "mp"]
        assert (fleet.worker_index(), fleet.worker_num(),
                fleet.is_first_worker()) == (0, 1, True)
    assert pt_mesh.get_mesh() is pt_fleet.get_hybrid_communicate_group().mesh
    pt_fleet.barrier_worker()


def test_single_mode_wrappers_change_nothing(fresh):
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelOptimizer
    pt_fleet.init()
    runs = []
    for wrap in (False, True):
        pt.seed(1)
        model = pt.nn.Linear(8, 4)
        opt = pt.optimizer.AdamW(
            0.1, parameters=model.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(0.01))
        if wrap:
            assert pt_fleet.distributed_model(model) is model
            opt = pt_fleet.distributed_optimizer(opt)
            assert isinstance(opt, HybridParallelOptimizer)
            assert isinstance(opt._grad_clip, pt.nn.ClipGradByGlobalNorm)
        x = pt.to_tensor(np.random.RandomState(2).randn(3, 8)
                         .astype("float32"))
        model(x).sum().backward()
        opt.step()
        runs.append(model.weight.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_distributed_model_in_pipeline_mode_raises(fresh):
    """Pipeline mode with no process group, as in the reference: a
    ``PipelineLayer`` comes back as ``PipelineParallel``, any other model
    as itself; nothing raises."""
    got = []
    for P, topo, fleet in ((ref, ref_topo, ref_fleet),
                           (pt, pt_topo, pt_fleet)):
        hcg = topo.HybridCommunicateGroup(
            topo.CommunicateTopology(dims=[2, 1, 1, 1, 1]))
        assert hcg.get_parallel_mode() == "pipeline"
        topo.set_hybrid_communicate_group(hcg)
        plain = P.nn.Linear(2, 2)
        layers = P.distributed.PipelineLayer(
            [P.nn.Linear(2, 2), P.nn.Linear(2, 2)], num_stages=2)
        assert fleet.distributed_model(plain) is plain
        got.append(type(fleet.distributed_model(layers)).__name__)
    assert got == ["PipelineParallel"] * 2


# ------------------------------------------------ tensor parallel, degree 1

def test_tp_layers_numerics_single():
    ref.seed(0)
    rcol = ref_fleet.meta_parallel.ColumnParallelLinear(16, 32,
                                                       gather_output=False)
    rrow = ref_fleet.meta_parallel.RowParallelLinear(32, 16)
    col = pt_fleet.meta_parallel.ColumnParallelLinear(16, 32,
                                                     gather_output=False)
    row = pt_fleet.meta_parallel.RowParallelLinear(32, 16)
    for a, b in ((rcol, col), (rrow, row)):
        assert sorted(b.state_dict()) == sorted(a.state_dict())
        b.set_state_dict({k: np.array(v.numpy())
                          for k, v in a.state_dict().items()})
    xv = np.random.RandomState(3).rand(4, 16).astype("float32")
    ry = rrow(rcol(ref.to_tensor(xv)))
    y = row(col(pt.to_tensor(xv)))
    _close(y.numpy(), ry.numpy())
    want = (xv @ col.weight.numpy() + col.bias.numpy()) \
        @ row.weight.numpy() + row.bias.numpy()
    _close(y.numpy(), want, 1e-5)
    ry.sum().backward()
    y.sum().backward()
    for a, b in ((rcol, col), (rrow, row)):
        _close(b.weight.grad.numpy(), a.weight.grad.numpy())
        _close(b.bias.grad.numpy(), a.bias.grad.numpy())


def test_vocab_parallel_embedding():
    remb = ref_fleet.meta_parallel.VocabParallelEmbedding(32, 8)
    emb = pt_fleet.meta_parallel.VocabParallelEmbedding(32, 8)
    emb.weight.set_value(np.array(remb.weight.numpy()))
    ids = [[0, 5], [31, 2]]
    out = emb(pt.to_tensor(ids))
    assert out.shape == [2, 2, 8]
    _close(out.numpy(), remb(ref.to_tensor(ids)).numpy())
    _close(out.numpy(), emb.weight.numpy()[np.asarray(ids)])


def test_parallel_cross_entropy_single():
    lv = np.random.RandomState(4).randn(2, 3, 7).astype("float32")
    yv = np.random.RandomState(5).randint(0, 7, (2, 3, 1))
    yv[0, 0, 0] = -100
    got = pt_fleet.ParallelCrossEntropy()(pt.to_tensor(lv), pt.to_tensor(yv))
    want = ref_fleet.ParallelCrossEntropy()(ref.to_tensor(lv),
                                            ref.to_tensor(yv))
    _close(got.numpy(), want.numpy())


def test_sequence_parallel_single():
    spu = pt_fleet.sequence_parallel_utils
    rspu = ref_fleet.sequence_parallel_utils
    ref.seed(0)
    rcol = rspu.ColumnSequenceParallelLinear(8, 16)
    rrow = rspu.RowSequenceParallelLinear(16, 8)
    col = spu.ColumnSequenceParallelLinear(8, 16)
    row = spu.RowSequenceParallelLinear(16, 8)
    assert (col.gather_output, row.input_is_parallel) == \
        (rcol.gather_output, rrow.input_is_parallel)
    for a, b in ((rcol, col), (rrow, row)):
        b.set_state_dict({k: np.array(v.numpy())
                          for k, v in a.state_dict().items()})
    xv = np.random.RandomState(6).randn(5, 2, 8).astype("float32")
    _close(row(col(pt.to_tensor(xv))).numpy(),
           rrow(rcol(ref.to_tensor(xv))).numpy())
    x = pt.to_tensor(xv)
    for op in (spu.scatter(x), spu.all_gather(x), spu.reduce_scatter(x),
               spu.GatherOp.apply(x), spu.ScatterOp.apply(x)):
        assert op is x
    p = spu.mark_as_sequence_parallel_parameter(col.weight)
    assert spu.is_sequence_parallel_parameter(p)
    assert not spu.is_sequence_parallel_parameter(row.weight)
    assert spu.register_sequence_parallel_allreduce_hooks(col) is col


def test_mp_without_mesh_or_group_raises(monkeypatch):
    class _FakeHCG:
        def get_model_parallel_world_size(self):
            return 2

        def get_model_parallel_rank(self):
            return 0

        def get_model_parallel_group(self):
            return None

    monkeypatch.setattr(pt_mp_layers, "get_hybrid_communicate_group",
                        lambda: _FakeHCG())
    for make in (lambda: pt_mp_layers.ColumnParallelLinear(8, 16),
                 lambda: pt_mp_layers.RowParallelLinear(8, 16),
                 lambda: pt_mp_layers.VocabParallelEmbedding(8, 16),
                 lambda: pt_mp_layers.ParallelCrossEntropy()):
        with pytest.raises(RuntimeError, match="un-sharded"):
            make()


# ------------------------------------------------------------ RNG tracker

def test_rng_tracker_rules(monkeypatch):
    monkeypatch.setattr(pt_random, "_tracker", pt_random.RNGStatesTracker())
    tracker = pt_random.get_rng_state_tracker()
    local, glob = pt_random.model_parallel_random_seed(7)
    assert (local, glob) == (7 + 1024, 7)
    with pytest.raises(ValueError, match="already added"):
        tracker.add("other", local)
    with pytest.raises(ValueError, match="already added"):
        tracker.add(pt_random.MODEL_PARALLEL_RNG, 5)
    with pytest.raises(ValueError, match="not added"):
        with tracker.rng_state("missing"):
            pass
    saved = tracker.get_states_tracker()

    def draw():
        return pt.rand([4]).numpy()

    g1 = draw()
    with tracker.rng_state():
        s1 = draw()
    g2 = draw()
    with tracker.rng_state():
        s2 = draw()
    # again from the same seeds, with no global draw in between: each
    # stream's sequence is its own
    pt_random.model_parallel_random_seed(7)
    with tracker.rng_state():
        np.testing.assert_array_equal(draw(), s1)
        np.testing.assert_array_equal(draw(), s2)
    np.testing.assert_array_equal(draw(), g1)
    np.testing.assert_array_equal(draw(), g2)
    assert not np.array_equal(s1, g1)
    # a copy of the states restores the stream
    tracker.set_states_tracker(saved)
    with tracker.rng_state():
        np.testing.assert_array_equal(draw(), s1)


# ------------------------------------------------ ZeRO without a process group

@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_group_sharded_parallel_passes_through_in_one_process(level):
    runs = []
    for shard in (False, True):
        pt.seed(3)
        model = pt.nn.Linear(8, 4)
        opt = pt.optimizer.AdamW(0.1, parameters=model.parameters())
        net = model
        if shard:
            net, opt2, scaler = pt_sharding.group_sharded_parallel(
                model, opt, level)
            assert scaler is None
            if level == "p_g_os":
                assert isinstance(net, pt_sharding.GroupShardedStage3)
                assert net._group is None and opt2 is opt
                assert net.param_bytes() == 4 * (8 * 4 + 4)
            else:
                assert isinstance(net, pt_sharding.GroupShardedStage2)
                assert isinstance(opt2,
                                  pt_sharding.GroupShardedOptimizerStage2)
                assert opt2._zero is None
            opt = opt2
        x = pt.to_tensor(np.random.RandomState(2).randn(3, 8)
                         .astype("float32"))
        for _ in range(2):
            net(x).sum().backward()
            opt.step()
            opt.clear_grad()
        runs.append(model.weight.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_dygraph_sharding_needs_a_process_group():
    model = pt.nn.Linear(2, 2)
    opt = pt.optimizer.AdamW(0.1, parameters=model.parameters())
    with pytest.raises(RuntimeError, match="process group"):
        pt_sharding.DygraphShardingOptimizer(opt)
    with pytest.raises(RuntimeError, match="process group"):
        pt_sharding.DygraphShardingStage3(model, opt)
    assert pt_sharding.ShardingOptimizerStage.P_G_OS == 3
