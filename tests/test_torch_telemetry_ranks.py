"""The port's cross-rank telemetry on gloo ranks, against the JAX package's
(``paddle_tpu_torch/observability/distributed.py`` over the port's
``TCPStore``): the counterpart of the multi-rank rows of
``tests/test_distributed_telemetry.py``.

- Two ranks (``World(2)``; rank functions ``telemetry_*`` in
  ``tests/torch_dist_ranks.py``) publish a frame a step (a compute chain
  and a gloo all-reduce under ``ElasticStep``) through rank 0's TCPStore;
  rank 0's aggregator covers both ranks in its step table and prices the
  all-reduce's bytes in its overlap report. The frames on the store decode
  in the reference's codec as in the port's, and a frame the reference
  encodes decodes in the port's.
- The postmortem: rank 1's published ring and rank 0's interleave in one
  report that names the rank that never published; a second aggregation
  finds the keys consumed.
- An ``AdaptiveTrainer``'s rank death (``member::leave``) triggers the
  distributed postmortem before its re-plan (one process, as the
  reference's test).
- The aggregation drill through the port's launcher (``python -m
  paddle_tpu_torch.observability budget --distributed``) at four ranks,
  as the reference's: rank 2 slowed by an injected delay and flagged a
  straggler (the comm-wait rule needs three survivors: its median of two
  is their minimum), rank 3 killed after step 2 and reported missing, the
  overlap of host-driven collectives 0, one lane a survivor in the merged
  trace.

Every world and subprocess is bounded by its own timeout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_ranks as W
from paddle_tpu.observability import distributed as rdtel
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import native
from paddle_tpu_torch.observability import distributed as dtel
from paddle_tpu_torch.testing.dist import World

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world():
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    with World(2, timeout=60) as w:
        yield w


def test_publisher_to_aggregator_over_the_store(world):
    outs = world.run(W.telemetry_publish, 5)
    got = outs[0]
    assert outs[1] is None
    table = got["table"]
    assert [row["step"] for row in table["steps"]] == [2, 3, 4, 5]
    for row in table["steps"]:
        assert set(row["ranks"]) == {"0", "1"}
    total = got["overlap"]["total"]
    assert total["bytes"] >= 4 * 2 * 64 * 64 * 4
    assert total["comm_us"] > 0
    # the frames on the store are the reference's format
    for blob, frame in zip(got["blobs"], got["decoded"]):
        assert rdtel.decode_frame(blob) == frame
        assert frame["v"] == rdtel.FRAME_VERSION
    assert {f["rank"] for f in got["decoded"]} == {0, 1}


def test_a_frame_crosses_both_codecs():
    frame = {"v": rdtel.FRAME_VERSION, "rank": 1, "pid": 7, "seq": 3,
             "step": 3, "mesh_epoch": 2, "t_wall": 1.5, "t_perf_us": 9.25,
             "counters": {"comm.calls.all_reduce": 2},
             "hists": {"comm.all_reduce_us": [12.5, 2]},
             "spans": [["comm::all_reduce", 1.0, 2.0, 4096]],
             "marks": [[3, 10.0, 5.0]], "mem": {"live": 1, "peak": 2}}
    assert dtel.decode_frame(rdtel.encode_frame(frame)) == frame
    assert rdtel.decode_frame(dtel.encode_frame(frame)) == frame


def test_postmortem_missing_ranks_and_consumed_keys(world, tmp_path):
    outs = world.run(W.telemetry_postmortem, str(tmp_path))
    got = outs[0]
    body = got["first"]
    assert "DISTRIBUTED flight record" in body
    assert "[r0]" in body and "[r1]" in body
    assert "rank0::work" in body and "rank1::work" in body
    assert "missing rank(s)" in body and "[2]" in body
    # the first pass consumed rank 1's key: nothing left to aggregate
    assert got["second"] is None


def test_adaptive_rank_death_triggers_postmortem(tmp_path, monkeypatch):
    """A membership event with lost ranks inside AdaptiveTrainer fires the
    distributed postmortem before the re-plan."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch._core import flags as pt_flags
    from paddle_tpu_torch.distributed.mesh import ProcessMesh
    from paddle_tpu_torch.distributed.resilience import AdaptiveTrainer
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.vision.models import LeNet
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    monkeypatch.setattr(pt_device, "_current", "cpu")
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                     timeout=10)
    saved = {k: pt_flags.flag_value(k) for k in (
        "FLAGS_distributed_telemetry", "FLAGS_flight_recorder",
        "FLAGS_flight_recorder_dir", "FLAGS_fault_inject")}
    try:
        pt.set_flags({"FLAGS_distributed_telemetry": True,
                      "FLAGS_flight_recorder": True,
                      "FLAGS_flight_recorder_dir": str(tmp_path)})
        flight.reset()
        dtel.init(store, rank=0, world_size=1)
        pt.seed(0)
        model = LeNet()
        opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
        rng = np.random.RandomState(0)
        bx = pt.to_tensor(rng.randn(4, 1, 28, 28).astype(np.float32))
        by = pt.to_tensor(rng.randint(0, 10, (4,)).astype(np.int64))
        trainer = AdaptiveTrainer(
            optimizer=opt, mesh=ProcessMesh(list(range(4)),
                                            dim_names=["dp"]),
            lost_ranks=[3])

        def step():
            loss = F.cross_entropy(model(bx), by)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)

        trainer.run(step)
        pt.set_flags({"FLAGS_fault_inject": "member::leave@1=die"})
        trainer.run(step)
        pt.set_flags({"FLAGS_fault_inject": ""})
        assert trainer.replans == 1
        reports = [f for f in os.listdir(tmp_path)
                   if f.startswith("flight_distributed_")]
        assert len(reports) == 1
        assert "lost ranks [3]" in open(tmp_path / reports[0]).read()
        trainer.shutdown()
    finally:
        pt.set_flags(saved)
        flight.reset()
        dtel.shutdown()
        store.close()


def test_multiprocess_aggregation_drill(tmp_path):
    """Four ranks through the launcher: rank 2 slowed by an injected step
    delay, rank 3 SIGKILLed after step 2. The merged table covers the
    survivors and loses rank 3, flags rank 2, the overlap of host-driven
    collectives is 0 with their bytes counted, and the aggregated
    postmortem interleaves the survivors' rings and names rank 3
    missing."""
    if not native.get_lib():
        pytest.skip("native lib unavailable")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(TELEM_SLOW_RANK="2", TELEM_SLOW_DELAY="0.15",
               TELEM_KILL_RANK="3", TELEM_KILL_STEP="2")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability", "budget",
         "--distributed", "--nranks", "4", "--steps", "5",
         "--out", str(tmp_path), "--json", "--device", "cpu"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, \
        f"rc={proc.returncode}\n{proc.stderr[-3000:]}\n{proc.stdout[-2000:]}"
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    table = out["step_table"]
    late = [r for r in table["steps"] if r["step"] >= 4]
    assert late, table
    for row in late:
        assert {"0", "1", "2"} <= set(row["ranks"]) \
            and "3" not in row["ranks"]
    assert table["straggler_counts"].get("2", 0) >= 2, table
    total = out["overlap"]["total"]
    assert total["comm_us"] > 0 and total["bytes"] > 0
    assert total["overlap_frac"] is not None and total["overlap_frac"] < 0.05
    post = out["postmortem"]
    path = post if os.path.isabs(post) else os.path.join(str(tmp_path), post)
    body = open(path).read()
    for r in (0, 1, 2):
        assert f"[r{r}]" in body
    assert "missing rank(s)" in body and "[3]" in body
    trace = json.load(open(tmp_path / "merged_trace.json"))
    assert {0, 1, 2} <= {e["pid"] for e in trace["traceEvents"]}
