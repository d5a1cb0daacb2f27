"""``DataParallel`` (``paddle_tpu_torch/distributed/parallel.py``) on the
CPU over gloo ranks: the counterpart of ``tests/test_data_parallel.py``.

The small GPT of ``tests/test_torch_lazy_gpt.py`` (2 layers, hidden 64,
seq 128, fp32; the reference's weights moved to the port as numpy) is
wrapped on 2 ranks, each taking half of every batch of 4: a batch under
``no_sync()`` (gradients accumulate locally), a synced batch and an SGD
step, a second synced batch and step, with a bucket size (0.02 MB) that
cuts the parameters into several buckets. The reference runs the same
three batches whole in one process (two backwards accumulating, then the
steps). Held: the ranks' mean loss against the reference's at 1e-5
relative, the synced gradients (equal on both ranks) and the parameters
after the steps against the reference's at 1e-5 absolute; the gradients
inside ``no_sync()`` stay local (they differ between ranks). Also: the
replicas start equal whatever their seeds (rank 0's parameters are
broadcast), ``find_unused_parameters`` with ranks that used different
parameters, and the wrapped layer's ``state_dict`` keys.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
import torch_comm_ranks as ranks
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.testing.dist import World

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dtype="float32")
LR = 0.1
BUCKET_MB = 0.02


@pytest.fixture(scope="module")
def world():
    with World(2) as w:
        yield w


@pytest.fixture(scope="module")
def runs(world):
    """The reference's single-process run and the two ranks' runs."""
    import os
    old = os.environ.get("PT_FLASH_INTERPRET")
    os.environ["PT_FLASH_INTERPRET"] = "1"
    try:
        ref.seed(0)
        rm = ref_gpt.GPTForPretraining(ref_gpt.GPTConfig(**CFG))
        weights = {k: np.array(v.numpy())
                   for k, v in rm.state_dict().items()}
        rng = np.random.RandomState(0)
        batches = [(rng.randint(0, 256, (4, 128)),
                    rng.randint(0, 256, (4, 128))) for _ in range(3)]
        crit = ref_gpt.GPTPretrainingCriterion()
        opt = ref.optimizer.SGD(LR, parameters=rm.parameters())
        losses = []
        for i, (x, y) in enumerate(batches):
            loss = crit(rm(ref.to_tensor(x)), ref.to_tensor(y))
            loss.backward()
            losses.append(float(loss.numpy()))
            if i == 1:
                grads = [np.array(p.grad.numpy()) for p in rm.parameters()]
            if i >= 1:
                opt.step()
                opt.clear_grad()
        want = dict(losses=losses, grads=grads, keys=sorted(weights),
                    params=[np.array(p.numpy()) for p in rm.parameters()])
    finally:
        if old is None:
            os.environ.pop("PT_FLASH_INTERPRET")
        else:
            os.environ["PT_FLASH_INTERPRET"] = old
    got = world.run(ranks.dp_gpt, CFG, weights, batches, BUCKET_MB, LR)
    return want, got


def test_losses_match_the_full_batch_step(runs):
    want, got = runs
    mean = np.mean([g["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean, want["losses"], rtol=1e-5)


def test_synced_gradients_are_equal_and_match_the_reference(runs):
    want, got = runs
    for a, b in zip(got[0]["synced"], got[1]["synced"]):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got[0]["synced"], want["grads"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_no_sync_gradients_stay_local(runs):
    _, got = runs
    assert any(not np.array_equal(a, b)
               for a, b in zip(got[0]["local"], got[1]["local"]))


def test_parameters_after_the_steps_match_the_reference(runs):
    want, got = runs
    for r in range(2):
        for p, w in zip(got[r]["params"], want["params"]):
            np.testing.assert_allclose(p, w, rtol=0, atol=1e-5)


def test_buckets_split_the_parameters(runs):
    _, got = runs
    for g in got:
        assert g["buckets"] > 1
        assert g["collectives"] == g["buckets"] + 1


def test_state_dict_has_the_wrapped_layers_keys(runs):
    want, got = runs
    assert got[0]["keys"] == want["keys"]


def test_replicas_start_equal(world):
    a, b = world.run(ranks.dp_start_equal, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_find_unused_parameters(world):
    (g0, c0), (g1, c1) = world.run(ranks.dp_unused, 1e-5)
    assert c0 == c1 > 2
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name])
    # the b branch: rank 1's gradient over 2 (rank 0 sent zeros)
    x1 = np.arange(8, dtype="float32").reshape(2, 4) * 2
    np.testing.assert_allclose(g0["b.weight"],
                               np.tile(x1.sum(0)[:, None], (1, 2)) / 2)
    np.testing.assert_allclose(g0["b.bias"], np.full(2, 2 / 2))


def test_one_rank_without_a_process_group_is_a_plain_wrapper(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    inner = pt.nn.Linear(4, 3)
    dp = pt.DataParallel(inner)
    assert dp._unregister is None
    assert sorted(dp.state_dict()) == sorted(inner.state_dict())
    x = pt.to_tensor(np.ones((2, 4), "float32"))
    np.testing.assert_array_equal(dp(x).numpy(), inner(x).numpy())
    assert dp.scale_loss(x) is x
    with dp.no_sync():
        assert not dp._grad_sync_enabled
    assert dp._grad_sync_enabled
