"""The port's world shrink and growth on gloo ranks, against the JAX
package's: the counterpart of the multi-device and multi-process rows of
``tests/test_resilience.py`` (``shrink_world`` / ``grow_world`` on a mesh,
the rank-death drill at ``:1210-1379``, the grow drill at
``:1562-1665``).

- Four ranks (``World(4)``; rank functions in ``tests/torch_dist_ranks.py``)
  on a ``[4]`` dp mesh and a ``[2, 2]`` dp x mp mesh: after losing rank 3
  the survivors form a world of three and each survivor's new piece, and
  its Adam moments, equal the reference's shard of the same global array
  on the reference's shrunk mesh (the reference's pieces are its
  ``addressable_shards`` by device id); growing a ``[3]`` and a ``[1, 2]``
  mesh by the other ranks the same way, the joiners cutting their pieces
  from the global value as a received broadcast gives it.
- A block only the lost rank held (a ``[4]`` split of rows, rank 3's rows
  gone) raises ``EnforceNotMet`` naming the tensor before anything moves,
  and an ``AdaptiveTrainer`` takes its checkpoint fallback: the planned
  layout, filled from the saved generation.
- The death drill through the port's launcher (``--elastic_mode shrink
  --min_np 3``, 4 processes, LeNet, gradients averaged over the world):
  rank 1 is SIGKILLed after step 2; the survivors' ElasticManager sees
  it, each survivor's AdaptiveTrainer re-plans, forms a world of three
  and finishes 5 steps with losses within 1e-5 of the plain run, and
  ``shrink_sweeps == replans >= 1``.
- The grow drill (``--elastic_mode grow --max_np 4``, 3 actives and one
  hot spare): after step 2 the spare joins (``join_world``), the actives
  grow to 4 and publish their state, the spare forms the grown world,
  restores from the broadcast and runs steps 3-5; every rank's losses are
  the plain run's within 1e-5.

Every subprocess and world is bounded by its own timeout (no
``pytest-timeout`` here), so a hang fails its test.
"""
import itertools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed as rdist
import torch_dist_ranks as W
from paddle_tpu.distributed.resilience import elastic as relastic
from paddle_tpu_torch._core import native
from paddle_tpu_torch.testing.dist import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
_EPOCHS = itertools.count(10, 10)


@pytest.fixture(scope="module")
def world():
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    with World(4, timeout=60) as w:
        yield w


def _ref_placements(spec):
    return [rdist.Replicate() if w == "R" else rdist.Partial() if w == "P"
            else rdist.Shard(int(w[1:])) for w in spec.split()]


def _ref_pieces(shape, names, x, spec, ids=None):
    """The reference's shards of ``x`` on its mesh of ``shape`` over
    ``ids`` (default 0..n-1), by device id."""
    ids = np.arange(int(np.prod(shape))) if ids is None else np.asarray(ids)
    mesh = rdist.ProcessMesh(ids.reshape(shape), dim_names=list(names))
    t = rdist.shard_tensor(ref.to_tensor(x), mesh, _ref_placements(spec))
    return {sh.device.id: np.asarray(sh.data)
            for sh in t._value.addressable_shards}


def _ref_shrunk(shape, names, x, spec, lost):
    """The reference's shrink_world of ``x``: its new mesh (shape, names,
    ids), the placements and its shards by device id."""
    mesh = rdist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                             dim_names=list(names))
    t = rdist.shard_tensor(ref.to_tensor(x), mesh, _ref_placements(spec))
    new = relastic.shrink_world(mesh, lost, {"w": t}, set_global=False)
    words = " ".join(("S%d" % p.get_dim()) if p.is_shard() else "R"
                     for p in t._dist_attr.placements)
    return (new.shape, new.dim_names, [int(i) for i in new.process_ids],
            words, {sh.device.id: np.asarray(sh.data)
                    for sh in t._value.addressable_shards})


def _check_piece(out, want):
    me, piece, m, v = out[:4]
    np.testing.assert_array_equal(piece, want[me])
    np.testing.assert_array_equal(m, want[me] * 2)
    np.testing.assert_array_equal(v, want[me] * 3)


# each block of each survivor's new piece is held by a survivor
SHRINKS = [((4,), ("dp",), (12, 6), "R"),
           ((2, 2), ("dp", "mp"), (8, 6), "R S1"),
           ((2, 2), ("dp", "mp"), (6, 8), "S0 R"),
           ((2, 2), ("dp", "mp"), (8, 12), "R S0")]


@pytest.mark.parametrize("shape,names,gshape,spec", SHRINKS)
def test_shrink_world_pieces_match_reference(world, shape, names, gshape,
                                             spec):
    x = np.arange(np.prod(gshape), dtype=np.float32).reshape(gshape) / 7
    rshape, rnames, rids, rwords, want = _ref_shrunk(shape, names, x, spec,
                                                     [3])
    outs = world.run(W.elastic_shrink, shape, names, x, spec, [3],
                     next(_EPOCHS))
    assert outs[3] is None
    for rank, out in enumerate(outs[:3]):
        assert out[0] == rank
        _check_piece(out, want)
        new_shape, new_names, new_ids, words, new_rank, size = out[4:]
        assert (new_shape, new_names, new_ids, words) \
            == (rshape, rnames, rids, rwords)
        assert (new_rank, size) == (rank, 3)


GROWS = [((3,), ("dp",), (12, 6), "S0", [3]),
         ((3,), ("dp",), (12, 6), "R", [3]),
         ((1, 2), ("dp", "mp"), (8, 6), "R S1", [2, 3])]


@pytest.mark.parametrize("shape,names,gshape,spec,joined", GROWS)
def test_grow_world_pieces_match_reference(world, shape, names, gshape,
                                           spec, joined):
    x = np.arange(np.prod(gshape), dtype=np.float32).reshape(gshape) / 7
    mesh = rdist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                             dim_names=list(names))
    t = rdist.shard_tensor(ref.to_tensor(x), mesh, _ref_placements(spec))
    new = relastic.grow_world(mesh, joined, {"w": t}, set_global=False)
    want = {sh.device.id: np.asarray(sh.data)
            for sh in t._value.addressable_shards}
    words = " ".join(("S%d" % p.get_dim()) if p.is_shard() else "R"
                     for p in t._dist_attr.placements)
    outs = world.run(W.elastic_grow, shape, names, x, spec, joined,
                     next(_EPOCHS))
    for rank, out in enumerate(outs):
        assert out[0] == rank
        _check_piece(out, want)
        assert (out[4], out[5], out[6]) == (new.shape, new.dim_names, words)


@pytest.mark.parametrize("shape,names,spec,piece", [
    ((4,), ("dp",), "S0", (3, 6)), ((2, 2), ("dp", "mp"), "S0 S1", (6, 3))])
def test_unrecoverable_block_raises_before_moving(world, shape, names, spec,
                                                  piece):
    """A block that lived only on rank 3 (rows 9-11 of a ``[4]`` split;
    the bottom-right quarter of a ``[2, 2]`` one): every survivor raises
    ``EnforceNotMet`` naming the tensor, its piece untouched."""
    x = np.arange(72, dtype=np.float32).reshape(12, 6)
    outs = world.run(W.elastic_shrink, shape, names, x, spec, [3],
                     next(_EPOCHS))
    for rank, out in enumerate(outs[:3]):
        assert out[:2] == (rank, "EnforceNotMet"), out
        assert "'w'" in out[2] and "lost" in out[2]
        assert out[3] == piece


def test_adaptive_trainer_reloads_unrecoverable_block(world, tmp_path):
    """The same loss under an ``AdaptiveTrainer``: it adopts the planned
    survivor layout and fills it from its checkpoint; each survivor's
    piece and moments are the reference's shards of the saved values on
    that mesh."""
    x = np.arange(72, dtype=np.float32).reshape(12, 6) / 5
    outs = world.run(W.elastic_fallback, (4,), ("dp",), x, "S0", [3],
                     next(_EPOCHS), str(tmp_path / "ck"))
    assert outs[3] is None
    shapes = {(tuple(o[4]), tuple(o[5]), o[6]) for o in outs[:3]}
    assert len(shapes) == 1
    shape, names, words = shapes.pop()
    want = _ref_pieces(shape, names, x, words)
    for rank, out in enumerate(outs[:3]):
        assert out[0] == rank and out[7] == 1
        _check_piece(out, want)


# ------------------------------------------------------------- drills

_DRILL_COMMON = """
import json, os, signal, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.distributed.resilience import (AdaptiveTrainer,
                                                     join_world)
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.vision.models import LeNet

paddle.set_device("cpu")
RANK = int(os.environ["PADDLE_TRAINER_ID"])
WORLD = int(os.environ["PADDLE_TRAINERS_NUM"])
NSPAWN = len(os.environ["PADDLE_TRAINER_ENDPOINTS"].split(","))
STEPS = 5


def build():
    paddle.seed(0)
    model = LeNet()
    opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(8, 1, 28, 28).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 10, (8,)).astype(np.int64))

    def step():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        if dist.is_initialized():   # every replica the same batch
            for p in model.parameters():
                dist.all_reduce(p.grad, op=dist.ReduceOp.AVG)
        opt.step()
        opt.clear_grad()
        return float(loss)

    return step, opt


store = TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                 is_master=RANK == 0, world_size=NSPAWN, timeout=60)


def manager():
    # a generous node_timeout: tier-1 runs beside five other workers
    return ElasticManager(str(RANK), store, min_np=1,
                          heartbeat_interval=0.2, node_timeout=6.0)


def active_trainer():
    mgr = manager()
    mgr.register()
    if RANK == 0:
        mgr.watch([str(r) for r in range(WORLD)])
    m = mgr.wait_for_members(lambda m: len(m["members"]) == WORLD,
                             timeout=60)
    assert len(m["members"]) == WORLD, f"rendezvous failed: {m}"
    dist.rebuild_world(range(WORLD), 0, store=store, device="cpu")
    step, opt = build()
    trainer = AdaptiveTrainer(
        optimizer=opt, mesh=dist.ProcessMesh(list(range(WORLD)), ["dp"]),
        manager=mgr)
    events = []
    orig = trainer._membership_event

    def traced(ev, **kw):
        events.append({"epoch": ev.epoch, "lost": list(ev.lost),
                       "joined": list(ev.joined), "source": ev.source})
        return orig(ev, **kw)

    trainer._membership_event = traced
    return mgr, trainer, step, events


def finish(mgr, out):
    with open(f"result_{RANK}.json", "w") as f:
        json.dump(out, f)
    mgr.shutdown()
    # the store's host leaves last: the others' clients go first
    store.barrier("exit", timeout=30)
    dist.destroy_process_group()
    if RANK:
        store.close()
    else:
        time.sleep(0.5)
        store.close()
"""

_DEATH_DRILL = _DRILL_COMMON + """
KILL_RANK, KILL_STEP = 1, 2
mgr, trainer, step, events = active_trainer()
sweeps0 = metrics.counter("sanitizer.shrink_sweeps").value
losses = []
for s in range(1, STEPS + 1):
    if RANK == KILL_RANK and s == KILL_STEP:
        losses.append(trainer.run(step))   # completes step 2...
        os.kill(os.getpid(), signal.SIGKILL)   # ...then dies
    if RANK != KILL_RANK and s == KILL_STEP + 1:
        # survivors hold at the step-3 boundary until the master has
        # noticed the death (the re-plan happens mid-run)
        mgr.wait_for_members(lambda m: str(KILL_RANK) not in m["members"],
                             timeout=60)
    losses.append(trainer.run(step))
store.world_size = WORLD - 1
plan = trainer.last_plan or {}
finish(mgr, {
    "rank": RANK, "losses": losses, "replans": trainer.replans,
    "events": events, "mesh": trainer.mesh.shape,
    "plan": [plan.get(k) for k in ("dp_degree", "mp_degree", "pp_degree")],
    "world": [dist.get_rank(), dist.get_world_size()],
    "shrink_sweeps": metrics.counter("sanitizer.shrink_sweeps").value
    - sweeps0})
"""

_GROW_DRILL = _DRILL_COMMON + """
GROW_STEP = 2
if os.environ.get("PADDLE_ELASTIC_SPARE") == "1":
    store.wait("go_join", 60)
    mgr = manager()
    m = join_world(mgr, min_members=NSPAWN, timeout=60)
    ids = sorted(int(i) for i in m["members"])
    dist.rebuild_world(ids, int(m["epoch"]), store=store, device="cpu")
    step, opt = build()
    trainer = AdaptiveTrainer(optimizer=opt,
                              mesh=dist.ProcessMesh(ids, ["dp"]),
                              manager=mgr)
    trainer.restore_from_broadcast(store, int(m["epoch"]), timeout=60)
    resumed = trainer.step_index
    losses = [trainer.run(step) for _ in range(STEPS - resumed)]
    finish(mgr, {"rank": RANK, "spare": True, "losses": losses,
                 "resumed_at": resumed,
                 "world": [dist.get_rank(), dist.get_world_size()],
                 "bcast_restores":
                     metrics.counter("resilience.bcast_restores").value})
    sys.exit(0)

mgr, trainer, step, events = active_trainer()
losses = []
for s in range(1, STEPS + 1):
    losses.append(trainer.run(step))
    if s == GROW_STEP:
        if RANK == 0:
            store.set("go_join", "1")
        mgr.wait_for_members(lambda m: len(m["members"]) == NSPAWN,
                             timeout=60)
plan = trainer.last_plan or {}
finish(mgr, {
    "rank": RANK, "spare": False, "losses": losses, "grows": trainer.grows,
    "replans": trainer.replans, "events": events,
    "mesh": trainer.mesh.shape,
    "plan": [plan.get(k) for k in ("dp_degree", "mp_degree", "pp_degree")],
    "world": [dist.get_rank(), dist.get_world_size()],
    "grow_latency_s": trainer.last_grow_latency_s})
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plain_losses():
    """The port's LeNet run alone in this process (no world)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch._core import device as pt_device
    from paddle_tpu_torch.vision.models import LeNet
    saved = pt_device._current
    pt_device._current = "cpu"
    try:
        pt.seed(0)
        model = LeNet()
        opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
        rng = np.random.RandomState(0)
        x = pt.to_tensor(rng.randn(8, 1, 28, 28).astype(np.float32))
        y = pt.to_tensor(rng.randint(0, 10, (8,)).astype(np.int64))
        losses = []
        for _ in range(5):
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses
    finally:
        pt_device._current = saved


def _launch(tmp_path, script, args, timeout=120):
    path = tmp_path / "drill.py"
    path.write_text(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]
        + args + ["--master", f"127.0.0.1:{_free_port()}", str(path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=timeout)
    logs = ""
    logdir = tmp_path / "log"
    if logdir.exists():
        for f in sorted(os.listdir(logdir)):
            logs += f"\n--- {f}\n" + (logdir / f).read_text()[-3000:]
    return proc, logs


def _result(tmp_path, rank, logs):
    path = tmp_path / f"result_{rank}.json"
    assert path.exists(), f"rank {rank} wrote no result\n{logs}"
    return json.loads(path.read_text())


def test_multiprocess_rank_death_drill(tmp_path):
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    proc, logs = _launch(tmp_path, _DEATH_DRILL, [
        "--nproc_per_node", "4", "--elastic_mode", "shrink",
        "--min_np", "3"])
    assert proc.returncode == 0, \
        f"launcher rc={proc.returncode}\n{proc.stderr}\n{logs}"
    assert "shrink mode keeps the pod" in proc.stderr
    assert not (tmp_path / "result_1.json").exists()
    plain = _plain_losses()
    for r in (0, 2, 3):
        out = _result(tmp_path, r, logs)
        assert out["replans"] >= 1, (r, out)
        assert any(1 in e["lost"] for e in out["events"]), (r, out)
        assert out["shrink_sweeps"] == out["replans"], (r, out)
        assert int(np.prod(out["mesh"])) == 3, (r, out)
        assert int(np.prod(out["plan"])) == 3, (r, out)
        assert out["world"] == [[0, 2, 3].index(r), 3], (r, out)
        assert len(out["losses"]) == 5, (r, out)
        np.testing.assert_allclose(out["losses"], plain, rtol=RTOL,
                                   err_msg=f"rank {r}")


def test_multiprocess_grow_drill(tmp_path):
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    proc, logs = _launch(tmp_path, _GROW_DRILL, [
        "--nproc_per_node", "3", "--elastic_mode", "grow", "--max_np", "4",
        "--min_np", "3"])
    assert proc.returncode == 0, \
        f"launcher rc={proc.returncode}\n{proc.stderr}\n{logs}"
    plain = _plain_losses()
    for r in range(3):
        out = _result(tmp_path, r, logs)
        assert out["grows"] == 1 and out["replans"] == 0, (r, out)
        assert any(e["joined"] == ["3"] for e in out["events"]), (r, out)
        assert int(np.prod(out["mesh"])) == 4, (r, out)
        assert out["world"] == [r, 4], (r, out)
        assert out["grow_latency_s"] > 0, (r, out)
        np.testing.assert_allclose(out["losses"], plain, rtol=RTOL,
                                   err_msg=f"rank {r}")
    out = _result(tmp_path, 3, logs)
    assert out["spare"] and out["bcast_restores"] == 1, out
    assert out["resumed_at"] == 2 and out["world"] == [3, 4], out
    np.testing.assert_allclose(out["losses"], plain[2:], rtol=RTOL)
