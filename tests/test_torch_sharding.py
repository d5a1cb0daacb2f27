"""Eager ZeRO (``paddle_tpu_torch/distributed/sharding.py``) on the CPU
over 2 gloo ranks, against the reference run in this process: the
counterpart of ``tests/test_sharding_eager.py``.

``tests/test_sharding_eager.py``'s model (Linear 16-32, ReLU, Linear
32-16, AdamW 1e-2) from numpy weights; rank r trains on batch r. The
reference runs both batches in one process (the mean of the two losses
backward, three steps). Each route of the port:
``DygraphShardingOptimizer`` (stage 2), with ``offload``,
``DygraphShardingStage3``, and ``group_sharded_parallel`` at ``os``,
``os_g`` and ``p_g_os``. Held, at that test's rtol 1e-5 / atol 2e-5 for
the parameters (1e-5 / 1e-7 for the losses): the losses and the
parameters after the steps against the reference's; the owned states
split (their count over the ranks is the parameter count, each rank
holds some) and ``state_bytes`` balanced within the reference test's 0.2
ratio; the released parameter bytes of the two ranks complementary; the
offloaded states on the CPU; a step's collectives (one for the flags, a
reduce and a broadcast per parameter); ``group_sharded_parallel`` at each
level running the eager classes over more than one rank (and passing
through in one process without a process group, in
``tests/test_torch_fleet.py``); ``save_group_sharded_model``'s files read
back equal by ``framework.load``.

The rank functions are ``tests/torch_fleet_workers.py``.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import torch_fleet_workers as W
from paddle_tpu_torch.testing.dist import World

KINDS = ["2", "2off", "3", "os", "os_g", "p_g_os"]
N_PARAMS = 4


@pytest.fixture(scope="module")
def world():
    with World(W.WORLD) as w:
        yield w


@pytest.fixture(scope="module")
def reference():
    """Losses and parameters of the reference's full-batch run."""
    nn, F = ref.nn, ref.nn.functional
    model = nn.Sequential(nn.Linear(W.DIM, 32), nn.ReLU(),
                          nn.Linear(32, W.DIM))
    for p, w in zip(model.parameters(), W.zero_weights()):
        p.set_value(w)
    opt = ref.optimizer.AdamW(1e-2, parameters=model.parameters())
    X, Y = W.zero_data()
    losses = []
    for _ in range(W.STEPS):
        step_loss = 0.0
        for r in range(W.WORLD):
            loss = F.mse_loss(model(ref.to_tensor(X[r])),
                              ref.to_tensor(Y[r])) / W.WORLD
            loss.backward()
            step_loss += float(loss.numpy())
        opt.step()
        opt.clear_grad()
        losses.append(step_loss)
    return losses, [np.array(p.numpy()) for p in model.parameters()]


@pytest.fixture(scope="module")
def runs(world):
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = world.run(W.zero_run, kind)
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", KINDS)
def test_losses_and_params_match_the_reference(runs, reference, kind):
    ref_losses, ref_params = reference
    for rep in runs(kind):
        np.testing.assert_allclose(rep["losses"], ref_losses, rtol=1e-5,
                                   atol=1e-7)
        for got, want in zip(rep["params"], ref_params):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["2", "3", "os_g"])
def test_owned_states_split_and_balanced(runs, kind):
    reps = runs(kind)
    counts = [r["n_owned_states"] for r in reps]
    assert sum(counts) == N_PARAMS
    assert all(0 < c < N_PARAMS for c in counts), counts
    b0, b1 = (r["state_bytes"] for r in reps)
    assert min(b0, b1) > 0.2 * max(b0, b1), (b0, b1)


@pytest.mark.parametrize("kind", ["2", "3", "os_g"])
def test_collectives_a_step(runs, kind):
    for rep in runs(kind):
        assert rep["collectives"] == [1 + 2 * N_PARAMS] * W.STEPS


def test_offloaded_states_sit_on_the_cpu(runs):
    for rep in runs("2off"):
        assert rep["states_on_cpu"] is True
        assert rep["n_owned_states"] > 0


@pytest.mark.parametrize("kind", ["3", "p_g_os"])
def test_released_param_bytes_are_complementary(runs, kind):
    r0, r1 = runs(kind)
    full = r0["full_param_bytes"]
    assert r0["released_param_bytes"] + r1["released_param_bytes"] == full
    assert 0 < r0["released_param_bytes"] < 0.75 * full


@pytest.mark.parametrize("kind,route", [
    ("os", "GroupShardedOptimizerStage2+DygraphShardingOptimizer"),
    ("os_g", "GroupShardedOptimizerStage2+DygraphShardingOptimizer"),
    ("p_g_os", "GroupShardedStage3+DygraphShardingStage3")])
def test_group_sharded_parallel_runs_eager_zero_over_ranks(runs, kind,
                                                          route):
    for rep in runs(kind):
        assert rep["route"] == route


def test_save_group_sharded_model_reads_back(world, tmp_path):
    reps = world.run(W.zero_save, str(tmp_path))
    first = reps[0]
    assert sorted(first["loaded_model"]) == sorted(first["model"])
    for k, v in first["model"].items():
        np.testing.assert_array_equal(first["loaded_model"][k], v)
    # the optimizer file holds every rank's owned states
    want = {}
    for rep in reps:
        want.update(rep["opt"])
    assert sorted(first["loaded_opt"]) == sorted(want)
    assert len(want) == 1 + 2 * N_PARAMS   # step, m and v of each
    for k, v in want.items():
        np.testing.assert_array_equal(first["loaded_opt"][k], v)
