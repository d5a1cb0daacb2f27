"""The port's eager pipeline runtimes on 2 and 4 gloo ranks (the first
two or all four ranks of one world of four), against the reference's
single-process run of the whole model: the counterpart of
``tests/test_pipeline_hostdriven.py``.

- The setting of ``tests/test_pipeline_hostdriven.py:24-48``: each
  virtual stage is relu(Linear(8, 8)), micro-batches of 2 rows, loss mse /
  m. 1F1B, FThenB, ZeroBubble (one stage a rank, m = 4 at P = 2 and 8 at
  P = 4) and VPP (two chunks a rank, virtual stage v = chunk * P + rank,
  m = 4 and 8): the last rank's loss and every rank's gradients equal the
  reference's at 1e-6, and each stage runs one forward a micro-batch (a
  chunk's).
- 1F1B's peak of stashed micro-batches on the first rank is below
  FThenB's (m); ZeroBubble runs F = B = W = m in the reference's schedule,
  W(0) after B(1) on the first rank.
- A stage output of 8 MB (the first stage's output tiled 131072 times,
  the second stage reading its first block back) under 1F1B and
  ZeroBubble: a send that waited for its receiver would hang there (each
  rank of a pair sends before it receives).
- A wrong micro-batch count raises ``ValueError`` on the first and last
  ranks before any send.
- ``fleet.distributed_model`` of a ``PipelineLayer`` in pipeline mode
  builds the runtime that ``schedule_mode`` names (VPP refused: one stage
  Layer a rank, as in the reference) over this rank's pp line, and trains
  to the reference's loss: at pp 2 (two dp replicas of the pipeline, ranks
  [0, 2] and [1, 3]) and pp 4.

The world times out after 60 s, so a deadlock fails fast. The rank
functions are ``tests/torch_dist_ranks.py``.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed.pipeline as rpipe
import torch_dist_ranks as W
from paddle_tpu_torch.testing.dist import World

MB, DIM = 2, 8
WIDE = 1 << 17   # 8 MB of fp32 a stage output at MB x DIM


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=60) as w:
        yield w


def _weights(v, m):
    r = np.random.RandomState(7)
    ws = [(r.randn(DIM, DIM) * 0.5).astype("float32") for _ in range(v)]
    bs = [(r.randn(DIM) * 0.1).astype("float32") for _ in range(v)]
    x = r.randn(m * MB, DIM).astype("float32")
    y = r.randn(m * MB, DIM).astype("float32")
    return ws, bs, x, y


def _reference(ws, bs, x, y, m):
    """The reference's single-process model: loss and each stage's
    (weight, bias) gradients."""
    F = ref.nn.functional
    lins = []
    for w, b in zip(ws, bs):
        lin = ref.nn.Linear(DIM, DIM)
        lin.set_state_dict({"weight": w, "bias": b})
        lins.append(lin)
    total = 0.0
    for i in range(m):
        h = ref.to_tensor(x[i * MB:(i + 1) * MB])
        for lin in lins:
            h = F.relu(lin(h))
        loss = F.mse_loss(h, ref.to_tensor(y[i * MB:(i + 1) * MB])) / m
        loss.backward()
        total += float(loss.numpy())
    return total, [[np.array(l.weight.grad.numpy()),
                    np.array(l.bias.grad.numpy())] for l in lins]


def _hold(reports, ref_loss, ref_grads, P, C=1):
    reports = reports[:P]
    assert abs(reports[-1]["loss"] - ref_loss) <= 1e-6 * abs(ref_loss)
    for r, rep in enumerate(reports):
        for c, grads in enumerate(rep["grads"]):
            for g, want in zip(grads, ref_grads[c * P + r]):
                np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {r} chunk {c}")


CASES = [(n, s) for n in (2, 4)
         for s in ("1F1B", "FThenB", "ZeroBubble", "VPP")]


@pytest.mark.parametrize("n,schedule", CASES)
def test_schedule_matches_the_reference(world, n, schedule):
    C = 2 if schedule == "VPP" else 1
    m = 4 if n == 2 else 8
    ws, bs, x, y = _weights(n * C, m)
    reports = world.run(W.eager_pipeline, n, schedule, ws, bs, x, y, m, C)
    assert reports[n:] == [None] * (4 - n)
    reports = reports[:n]
    _hold(reports, *_reference(ws, bs, x, y, m), n, C)
    for r, rep in enumerate(reports):
        assert rep["forward_calls"] == m * C
        assert (rep["loss"] is None) == (r < n - 1)
    if schedule == "ZeroBubble":
        for r, rep in enumerate(reports):
            assert rep["counts"] == {"F": m, "B": m, "W": m}
            assert [tuple(a) for a in rep["executed"]] == \
                rpipe._zero_bubble_schedule(r, n, m)
        ex = [tuple(a) for a in reports[0]["executed"]]
        assert ex.index(("W", 0)) > ex.index(("B", 1)), ex


@pytest.mark.parametrize("n", [2, 4])
def test_1f1b_stashes_fewer_micro_batches_than_fthenb(world, n):
    m = 4 if n == 2 else 8
    ws, bs, x, y = _weights(n, m)
    peak = {s: world.run(W.eager_pipeline, n, s, ws, bs, x, y, m)[0]
            for s in ("FThenB", "1F1B")}
    assert peak["FThenB"]["max_inflight"] == m
    assert peak["1F1B"]["max_inflight"] <= n
    assert peak["1F1B"]["max_inflight"] < peak["FThenB"]["max_inflight"]
    assert peak["1F1B"]["max_stash_bytes"] < \
        peak["FThenB"]["max_stash_bytes"]


@pytest.mark.parametrize("schedule", ["1F1B", "ZeroBubble"])
def test_an_8_mb_activation_crosses_without_a_blocking_send(world,
                                                            schedule):
    m = 4
    ws, bs, x, y = _weights(2, m)
    reports = world.run(W.eager_pipeline, 2, schedule, ws, bs, x, y, m, 1,
                        WIDE)
    _hold(reports, *_reference(ws, bs, x, y, m), 2)
    assert reports[0]["max_stash_bytes"] >= MB * DIM * WIDE * 4 >= 8 << 20
    assert reports[0]["sends"] == reports[1]["sends"] == m


@pytest.mark.parametrize("schedule", ["1F1B", "ZeroBubble"])
def test_a_wrong_micro_batch_count_raises_before_any_send(world, schedule):
    ws, bs, x, y = _weights(2, 4)
    for msg, sends in world.run(W.pipeline_bad_micros, 2, schedule, ws, bs,
                                x, y, 4)[:2]:
        assert msg.startswith("ValueError") and "num_microbatches=4" in msg
        assert sends == 0


@pytest.mark.parametrize("n,schedule", [(2, "1F1B"), (2, "FThenB"),
                                        (2, "ZeroBubble"), (2, "VPP"),
                                        (4, "1F1B")])
def test_fleet_distributed_model_builds_the_named_runtime(world, n,
                                                          schedule):
    m = 4
    ws, bs, x, y = _weights(n, m)
    reports = world.run(W.fleet_pipeline, n, schedule, ws, bs, x, y, m)
    if schedule == "VPP":
        assert all("list of model-chunk" in r["error"] for r in reports)
        return
    want = {"1F1B": ("DistPipelineRuntime", "1F1B"),
            "FThenB": ("DistPipelineRuntime", "FThenB"),
            "ZeroBubble": ("DistPipelineRuntimeZB", None)}[schedule]
    ref_loss, ref_grads = _reference(ws, bs, x, y, m)
    dp = 4 // n
    for replica in range(dp):   # grid [pp, dp]: rank = stage * dp + replica
        line = [s * dp + replica for s in range(n)]
        for s, r in enumerate(line):
            rep = reports[r]
            assert (rep["type"], rep["schedule"]) == want
            assert rep["stage"] == s and rep["pp_ranks"] == line
        _hold([{"loss": reports[r]["loss"], "grads": [reports[r]["grads"]]}
               for r in line], ref_loss, ref_grads, n)
