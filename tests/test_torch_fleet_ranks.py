"""Fleet's eager multi-process regime (``paddle_tpu_torch/distributed/
fleet``) on the CPU over gloo ranks, against the reference run in this
process: the counterpart of ``tests/test_mp_multiproc.py`` and
``tests/test_hybrid_optimizer.py``.

- Tensor parallelism at 2 and 4 ranks: ``tests/test_mp_multiproc.py``'s
  model (embedding, column linear, gelu, row linear, vocab-parallel head
  with ``ParallelCrossEntropy``; VOCAB 12, H 8, FF 16, one label
  ignored, labels with a trailing unit dim), each rank holding numpy
  slices of the reference's full weights, wrapped by
  ``fleet.distributed_model`` (``TensorParallel``). Its loss equals the
  reference's single-process full model and each rank's shard gradients
  the slices of the reference's full gradients, at that test's rtol 1e-5 /
  atol 1e-6; once with the parallel input of the row linear, once with the
  column output gathered and cut again (``mp_concat``, ``mp_split``).
- The hybrid optimizer at mp 2: replicated gradients that differ between
  the ranks are averaged, the clip becomes ``HybridParallelClipGrad``, and
  one SGD step equals the reference's single-process step over the same
  parameters (the replicated gradient averaged, each rank's block its
  own) with the true global norm, at fp32 1e-6; the replicated weights
  are equal on both ranks. ``HybridParallelGradScaler`` skips the step on
  both ranks when one finds an inf. ``metrics`` give the reference test's
  values.
- The RNG tracker on mp 2: the global stream is the same on both ranks,
  the mp streams differ, and the seeds are the reference's.

The rank functions are ``tests/torch_fleet_workers.py``.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import torch_fleet_workers as W
from paddle_tpu_torch.testing.dist import World


@pytest.fixture(scope="module")
def world2():
    with World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4) as w:
        yield w


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


@pytest.fixture(scope="module")
def tp_reference():
    """The reference's single-process full model: loss and gradients."""
    F = ref.nn.functional
    w = {k: ref.to_tensor(v) for k, v in W.tp_weights().items()}
    for t in w.values():
        t.stop_gradient = False
    ids, labels = W.tp_data()
    h = F.embedding(ref.to_tensor(ids), w["emb"])
    h = F.gelu(F.linear(h, w["w_col"], w["b_col"]))
    h = F.linear(h, w["w_row"], w["b_row"])
    logits = F.linear(h, w["w_head"], None)
    loss = F.cross_entropy(logits, ref.to_tensor(labels),
                           reduction="none").mean()
    loss.backward()
    return float(loss.numpy()), {k: np.array(t.grad.numpy())
                                 for k, t in w.items()}


@pytest.mark.parametrize("gathered", [False, True],
                         ids=["parallel", "gathered"])
@pytest.mark.parametrize("n", [2, 4])
def test_tensor_parallel_matches_single_process(request, tp_reference, n,
                                                gathered):
    ref_loss, ref_g = tp_reference
    reports = _world(request, n).run(W.tp_step, gathered)
    vper, fper = W.VOCAB // n, W.FF // n
    b_row = W.tp_weights()["b_row"]
    for rank, rep in enumerate(reports):
        assert rep["mode"] == "model_parallel"
        assert rep["wrapper"] == "TensorParallel"
        # rank 0's replicated bias reached every rank
        np.testing.assert_array_equal(rep["b_row"], b_row)
        assert abs(rep["loss"] - ref_loss) < 1e-5, (rep["loss"], ref_loss)
        v = slice(rank * vper, (rank + 1) * vper)
        f = slice(rank * fper, (rank + 1) * fper)
        want = {"emb": ref_g["emb"][v], "w_col": ref_g["w_col"][:, f],
                "b_col": ref_g["b_col"][f], "w_row": ref_g["w_row"][f],
                "b_row": ref_g["b_row"], "w_head": ref_g["w_head"][:, v]}
        for k, g in want.items():
            np.testing.assert_allclose(rep["grads"][k], g, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _hybrid_reference():
    """One SGD step of the reference over the replicated layer and both
    ranks' blocks: the layer's gradient is the mean of the ranks', each
    block's gradient its own rank's (constants stand in for the other
    factor: the reference's detach() keeps the gradient)."""
    w = W.hybrid_weights()
    layer = ref.nn.Linear(4, 4)
    layer.weight.set_value(w["w"])
    layer.bias.set_value(w["b"])
    tps = []
    for t in w["tp"]:
        p = ref.create_parameter([4, 2], "float32")
        p.set_value(t)
        tps.append(p)
    opt = ref.optimizer.SGD(0.1, parameters=list(layer.parameters()) + tps,
                            grad_clip=ref.nn.ClipGradByGlobalNorm(1.0))
    total = None
    for r, tp in enumerate(tps):
        x = ref.to_tensor(W.hybrid_x(r))
        out = layer(x)
        tp_sum = ref.to_tensor(np.array(tp.numpy()).sum())
        out_c = ref.to_tensor(np.array(out.numpy()))
        term = (out * tp_sum).sum() * 0.5 + (out_c * tp.sum()).sum()
        total = term if total is None else total + term
    total.backward()
    grads = [np.array(p.grad.numpy()) for p in
             list(layer.parameters()) + tps]
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads)))
    opt.step()
    return {"w": np.array(layer.weight.numpy()),
            "b": np.array(layer.bias.numpy()),
            "tp": [np.array(p.numpy()) for p in tps], "norm": norm}


def test_hybrid_optimizer_clips_by_the_global_norm(world2):
    want = _hybrid_reference()
    assert want["norm"] > 1.0  # the clip bites
    reports = world2.run(W.hybrid_step)
    for rank, rep in enumerate(reports):
        assert rep["swapped"] and rep["wrapper"] == "HybridParallelOptimizer"
        np.testing.assert_allclose(rep["w"], want["w"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rep["b"], want["b"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rep["tp"], want["tp"][rank], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(reports[0]["w"], reports[1]["w"])
    np.testing.assert_array_equal(reports[0]["b"], reports[1]["b"])


def test_grad_scaler_skips_on_every_rank(world2):
    reports = world2.run(W.scaler_skip)
    for rep in reports:
        assert rep["found_inf"] is True
        assert rep["unchanged"]
        assert rep["scale"] == 512.0


def test_metrics_match_the_reference_test(world2):
    for rep in world2.run(W.metrics_values):
        assert float(rep["sum"][0]) == 3.0
        assert float(rep["max"][0]) == 2.0
        assert float(rep["min"][0]) == 1.0
        assert float(rep["mean"][0]) == 1.5
        assert float(rep["tensor_sum"][0]) == 3.0
        assert rep["acc"] == (80 + 90) / 200
        assert rep["auc"] == 1.0


def test_rng_streams_across_mp_ranks(world2):
    a, b = world2.run(W.rng_streams)
    assert (a["local"], a["global"]) == (100 + 1024, 100)
    assert (b["local"], b["global"]) == (100 + 1024 + 1, 100)
    np.testing.assert_array_equal(a["outside"], b["outside"])
    assert not np.array_equal(a["inside"], b["inside"])


def test_destroy_process_group_forgets_fleet():
    """Leaving the world drops what ``fleet.init`` set (the hybrid group,
    the fleet's flag, the global mesh), whose groups are gone with it: a
    later layer sees no hybrid group. On a world of its own, since it ends
    the world."""
    from paddle_tpu_torch.testing.dist import run
    [(before, after, joined)] = run(W.destroy_forgets_fleet, 1)
    assert before == ((True, True, True, "single"), True)
    assert after == (False, False, False, "single")
    assert not joined
