"""The port's launcher, ``spawn``, watchdog, ``CommContext`` and
``distributed.utils``, on the CPU.

- ``tests/test_launch.py``'s four cases through
  ``python -m paddle_tpu_torch.distributed.launch``: a restart after a
  worker's failure, then success; restarts exhausted; the one-process
  path (run in the launcher's process); two launchers meeting through the
  master. The port's one difference, pinned: one worker with
  ``--max_restarts`` runs as a child, so it is restarted. A worker's card
  follows from the environment the launcher exports.
- ``spawn`` at one process (``func`` runs in the caller, as the
  reference's) and at two (two gloo ranks from the launcher's
  environment).
- The watchdog: a task beaten in time never fires; a stalled one fires
  within its timeout plus an interval, with the host stacks, and
  ``check`` raises in the waiting thread; ``shutdown`` joins the thread.
- ``CommContext`` on 2 gloo ranks against numpy, every operation, and
  ``create_negotiated`` returning None on every rank when the transport
  is off.
- ``utils``: the identity at one rank, ``NotImplementedError`` above one.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch.distributed as D
from paddle_tpu_torch.testing.dist import World

import torch_dist_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "PADDLE_MASTER")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_launch(launch_args, script_body, tmp_path, name, timeout=180):
    script = tmp_path / f"{name}.py"
    script.write_text(script_body)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *launch_args, str(script)],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True,
        timeout=timeout)


# ---------------------------------------------------------------- launcher

def test_restart_on_failure_then_success(tmp_path):
    """Worker 1 dies in epoch 0; the launcher relaunches the whole pod
    with PADDLE_RESTART_COUNT=1 and the job completes."""
    marker = tmp_path / "first_try_done"
    body = f"""
import os, sys
rank = os.environ["PADDLE_TRAINER_ID"]
epoch = int(os.environ["PADDLE_RESTART_COUNT"])
marker = {str(marker)!r}
if rank == "1" and not os.path.exists(marker):
    open(marker, "w").write("x")
    sys.exit(3)   # simulated fault, epoch 0 only
open(f"ok_{{rank}}_e{{epoch}}", "w").write("done")
"""
    proc = _run_launch(
        ["--nproc_per_node", "2", "--max_restarts", "2",
         "--master", f"127.0.0.1:{_free_port()}"],
        body, tmp_path, "restart_job")
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "ok_0_e1").exists()
    assert (tmp_path / "ok_1_e1").exists()
    assert "restart 1/2" in proc.stderr


def test_failure_exhausts_restarts(tmp_path):
    proc = _run_launch(
        ["--nproc_per_node", "2", "--max_restarts", "1",
         "--master", f"127.0.0.1:{_free_port()}"],
        "import sys\nsys.exit(7)\n", tmp_path, "always_fail")
    assert proc.returncode == 7
    logs = os.listdir(tmp_path / "log")
    assert any(".e0" in f for f in logs)
    assert any(".e1" in f for f in logs)


def test_single_process_fast_path(tmp_path):
    body = """
import os, sys
assert os.environ["PADDLE_TRAINERS_NUM"] == "1"
open("solo_ok", "w").write(sys.modules["__main__"].__name__)
"""
    proc = _run_launch(["--master", f"127.0.0.1:{_free_port()}"], body,
                       tmp_path, "solo")
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "solo_ok").exists()
    assert not (tmp_path / "log").exists()   # no child, no worker log


def test_one_worker_with_restarts_runs_as_a_restartable_child(tmp_path):
    """The port's one departure: with --max_restarts one worker runs as a
    child, so its failure is restarted (in the launcher's process it could
    not be); both epochs' logs are written."""
    body = """
import os, sys
print("epoch", os.environ["PADDLE_RESTART_COUNT"], flush=True)
sys.exit(1 if os.environ["PADDLE_RESTART_COUNT"] == "0" else 0)
"""
    proc = _run_launch(["--nproc_per_node", "1", "--max_restarts", "1",
                        "--master", f"127.0.0.1:{_free_port()}"], body,
                       tmp_path, "restart_one")
    assert proc.returncode == 0, proc.stderr
    assert "restart 1/1" in proc.stderr
    for epoch in (0, 1):
        log = tmp_path / "log" / f"workerlog.0.0.e{epoch}"
        assert log.read_text().strip() == f"epoch {epoch}"


def test_two_node_master_rendezvous(tmp_path):
    """Two launcher processes (one per node) meet through the master;
    workers see a world of 2 and distinct ranks."""
    port = _free_port()
    body = """
import os
rank = os.environ["PADDLE_TRAINER_ID"]
eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
assert os.environ["PADDLE_TRAINERS_NUM"] == "2"
assert len(eps) == 2
open(f"node_ok_{rank}", "w").write(os.environ["PADDLE_CURRENT_ENDPOINT"])
"""
    script = tmp_path / "two_node.py"
    script.write_text(body)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", "2", "--node_rank", str(node), "--nproc_per_node", "1",
         "--master", f"127.0.0.1:{port}", str(script)],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for node in range(2)]
    for node, p in enumerate(procs):
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, f"node {node}:\n{out}"
    eps = {(tmp_path / f"node_ok_{r}").read_text() for r in (0, 1)}
    assert len(eps) == 2


def test_a_worker_card_follows_the_launcher_environment(monkeypatch):
    """Worker r of a node is PADDLE_TRAINER_ID node * nproc + r;
    ``init_parallel_env`` puts it on card (that id) mod the card count,
    its local rank when a node runs a worker a card."""
    import importlib
    from paddle_tpu_torch.distributed.parallel_env import ParallelEnv
    # the package binds ``main`` to the function: import the module by name
    launch_main = importlib.import_module(
        "paddle_tpu_torch.distributed.launch.main")
    args = launch_main._parse_args(["--nnodes", "2", "--nproc_per_node",
                                    "4", "x.py"])
    eps = [f"10.0.0.{n}:{6170 + i}" for n in (1, 2) for i in range(4)]
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "FLAGS_selected_gpus",
                "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    for node in (0, 1):
        for local in range(4):
            env = launch_main._worker_env(args, node, local, 8, eps, 0)
            assert env["PADDLE_CURRENT_ENDPOINT"] == eps[node * 4 + local]
            assert env["MASTER_ADDR"] == "10.0.0.1"
            for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM"):
                monkeypatch.setenv(k, env[k])
            pe = ParallelEnv()
            assert (pe.rank, pe.world_size) == (node * 4 + local, 8)
            assert pe.device_id % 4 == local


# ------------------------------------------------------------------- spawn

def test_spawn_one_process_runs_in_the_caller():
    seen = []
    D.spawn(lambda *a: seen.append((os.getpid(), a)), args=(1, 2),
            nprocs=1)
    assert seen == [(os.getpid(), (1, 2))]


def test_spawn_two_processes_join_one_gloo_world(tmp_path):
    D.spawn(ranks.spawned_all_reduce, args=(str(tmp_path),), nprocs=2)
    got = sorted((tmp_path / f"rank{r}").read_text().split()
                 for r in (0, 1))
    assert [g[:3] for g in got] == [["2", "3.0", "0"], ["2", "3.0", "1"]]
    assert got[0][3] != got[1][3]


def test_spawn_raises_when_a_worker_fails():
    with pytest.raises(RuntimeError, match="exited with codes"):
        D.spawn(ranks.spawned_all_reduce, args=("/nonexistent/dir",),
                nprocs=2)


# ---------------------------------------------------------------- watchdog

def test_watchdog_fires_only_on_the_stalled_task():
    from paddle_tpu_torch.base.core import EnforceNotMet
    fired = []
    wd = D.CommTaskManager(check_interval=0.05,
                           on_timeout=lambda t: fired.append(
                               (t.name, time.monotonic())))
    try:
        wd.register("beaten", timeout=0.3)
        start = time.monotonic()
        wd.register("stalled", timeout=0.3)
        deadline = start + 1.0
        while time.monotonic() < deadline:
            wd.heartbeat("beaten")
            wd.check("beaten")
            time.sleep(0.02)
        assert [name for name, _ in fired] == ["stalled"]
        assert fired[0][1] - start < 0.3 + 0.2
        assert wd.timed_out("stalled") and not wd.timed_out("beaten")
        with pytest.raises(EnforceNotMet, match="stalled") as err:
            wd.check("stalled")
        assert "--- thread" in str(err.value)
        wd.heartbeat("stalled")          # a beat recovers the task
        assert not wd.timed_out("stalled")
    finally:
        wd.shutdown()
    assert not any(t.name == "comm-task-watchdog"
                   for t in threading.enumerate())


def test_watchdog_defaults_come_from_the_flags():
    wd = D.get_comm_task_manager()
    assert wd is D.get_comm_task_manager()
    assert wd._interval == 1.0
    try:
        task = wd.register("flagged")
        assert task.timeout == 1800.0
    finally:
        wd.deregister("flagged")
        wd.shutdown()


# ------------------------------------------------------------- comm context

@pytest.fixture(scope="module")
def world():
    w = World(2, timeout=120)
    yield w
    w.close()


def test_comm_context_matches_numpy(world):
    n = 2
    got = world.run(ranks.comm_context_ops, _free_port(), n)
    for rank, out in enumerate(got):
        np.testing.assert_array_equal(out["big"], np.full(1 << 16, 3.0,
                                                          np.float32))
        v = np.arange(10, dtype=np.int64)
        np.testing.assert_array_equal(out["max"], v + n - 1)
        np.testing.assert_array_equal(out["min"], v)
        np.testing.assert_array_equal(out["avg"], np.full(4, 0.5))
        assert out["f16"][0] == "float16"
        np.testing.assert_array_equal(out["f16"][1], np.full(8, 1.5))
        full = sum(np.arange(n * 6, dtype=np.float32).reshape(n * 3, 2)
                   + 100 * r for r in range(n))
        np.testing.assert_array_equal(out["rs"],
                                      full[rank * 3:(rank + 1) * 3])
        for r, g in enumerate(out["gather"]):
            np.testing.assert_array_equal(g, np.full((2, 2), r, np.int32))
        assert out["bcast"] == b"hello-from-1"
        assert out["p2p"][0] == ((rank - 1) % n) * 11.0
        assert out["off"] is None


# -------------------------------------------------------------------- utils

def test_utils_identity_at_one_rank_and_refused_above():
    from paddle_tpu_torch.distributed import utils
    from paddle_tpu_torch.distributed.communication import Group
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (utils.global_scatter, utils.global_gather):
        assert fn(x, None, None) is x
        assert fn(x, None, None, group=Group([0])) is x
        with pytest.raises(NotImplementedError, match="item 10"):
            fn(x, None, None, group=Group([0, 1]))
    assert utils.all_to_all_on_axis(x, "ep", 0, 1) is x
