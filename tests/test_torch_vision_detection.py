"""The port's ``vision.ops`` (the detection operators) against the JAX
package's on the CPU.

- The ``vision`` group of the op tables (``testing/op_cases.py``):
  ``roi_align`` (aligned and not, ``sampling_ratio`` 2 and -1),
  ``roi_pool``, ``nms_mask`` by name, ``nms`` (with ``top_k``,
  ``category_idxs``, no scores), ``box_coder`` (encode and decode, with
  and without variances), ``prior_box`` and ``yolo_box``; forward and,
  for the RoI ops and ``box_coder``, the gradient, at fp32 1e-5
  (``op_cases.limit``); ``nms`` indices exactly.
- Larger checks: ``roi_align`` and ``roi_pool`` with their gradient wrt x
  at fp32 1e-5 on 64 RoIs over two images, ``roi_pool`` in several
  chunks of RoIs bit-equal to one chunk (its gradient within 1e-5), and
  ``nms`` indices over 300 crowded boxes exactly (also when the sweep
  takes many batches of rounds); ``sampling_ratio=-1`` is 2, as the
  reference reads it.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.vision.ops as RV
import paddle_tpu_torch as pt
import paddle_tpu_torch.vision.ops as PV
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.testing import op_cases as oc

import torch_ops_harness as h

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("c,dtype", h.cases("vision"))
def test_vision_ops_match_reference(c, dtype):
    h.check_case(c, dtype)


def _roi_inputs(seed=0, n=2, c=8, hgt=20, wid=26, rois=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, hgt, wid).astype(np.float32)
    boxes = oc.Spec("box", (rois, 4 * hgt)).make(rng, oc.SMALL) \
        .astype(np.float32)
    num = np.array([rois // 3, rois - rois // 3], np.int32)
    return x, boxes, num


def _run(P, op, x, boxes, num, **kw):
    xt = P.to_tensor(x, stop_gradient=False)
    out = op(xt, P.to_tensor(boxes), P.to_tensor(num), **kw)
    r = np.random.RandomState(9).uniform(-1, 1, out.shape) \
        .astype(np.float32)
    (out * P.to_tensor(r)).sum().backward()
    return np.asarray(out.numpy()), np.asarray(xt.grad.numpy())


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kw", [
    dict(output_size=7, spatial_scale=0.25, sampling_ratio=2, aligned=True),
    dict(output_size=(3, 5), spatial_scale=0.25, sampling_ratio=3,
         aligned=False),
    dict(output_size=4, spatial_scale=0.25)])
def test_roi_align_and_its_x_gradient(kw):
    x, boxes, num = _roi_inputs()
    for g, w in zip(_run(pt, PV.roi_align, x, boxes, num, **kw),
                    _run(ref, RV.roi_align, x, boxes, num, **kw)):
        _close(g, w)


def test_roi_align_sampling_ratio_minus_one_is_two():
    x, boxes, num = _roi_inputs(rois=9)
    a = PV.roi_align(pt.to_tensor(x), pt.to_tensor(boxes), pt.to_tensor(num),
                     5, 0.25, sampling_ratio=-1).numpy()
    b = PV.roi_align(pt.to_tensor(x), pt.to_tensor(boxes), pt.to_tensor(num),
                     5, 0.25, sampling_ratio=2).numpy()
    np.testing.assert_array_equal(a, b)


def test_roi_pool_and_its_x_gradient(monkeypatch):
    x, boxes, num = _roi_inputs(seed=1)
    want = _run(ref, RV.roi_pool, x, boxes, num, output_size=7,
                spatial_scale=0.25)
    one = _run(pt, PV.roi_pool, x, boxes, num, output_size=7,
               spatial_scale=0.25)
    for g, w in zip(one, want):
        _close(g, w)
    # several chunks of RoIs give the same output as one (the gradient
    # sums the RoIs of a pixel in another order)
    monkeypatch.setattr(PV, "ROI_POOL_CHUNK", 8 * 20 * 7 * 26 * 5)
    out, grad = _run(pt, PV.roi_pool, x, boxes, num, output_size=7,
                     spatial_scale=0.25)
    np.testing.assert_array_equal(out, one[0])
    _close(grad, want[1])


def _nms(P, V, boxes, scores, thr, cats=None, **kw):
    if cats is not None:
        kw.update(category_idxs=P.to_tensor(cats), categories=[0, 1, 2, 3])
    return np.asarray(V.nms(P.to_tensor(boxes), P.to_tensor(scores), thr,
                            **kw).numpy())


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_indices_match_reference_exactly(thr, monkeypatch):
    rng = np.random.RandomState(int(thr * 10))
    # crowded: 300 boxes in a 100-pixel image, long suppression chains
    boxes = oc.Spec("box", (300, 100)).make(rng, oc.SMALL) \
        .astype(np.float32)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    cats = rng.randint(0, 4, 300).astype(np.int64)
    for kw in ({}, dict(cats=cats), dict(top_k=17)):
        mine = _nms(pt, PV, boxes, scores, thr, **kw)
        assert mine.dtype == np.int64
        np.testing.assert_array_equal(mine, _nms(ref, RV, boxes, scores,
                                                 thr, **kw))
    # one round a batch: many batches before the sweep settles, same keep
    want = _nms(pt, PV, boxes, scores, thr)
    monkeypatch.setattr(PV, "NMS_ROUNDS", 1)
    np.testing.assert_array_equal(_nms(pt, PV, boxes, scores, thr), want)


def test_nms_of_no_boxes():
    out = PV.nms(pt.to_tensor(np.zeros((0, 4), np.float32)),
                 pt.to_tensor(np.zeros((0,), np.float32)), 0.5)
    assert out.shape == [0] and out.dtype == pt.int64


def test_yolo_box_refuses_iou_aware_as_the_reference():
    x = pt.to_tensor(np.zeros((1, 18, 2, 2), np.float32))
    size = pt.to_tensor(np.array([[64, 64]], np.int32))
    with pytest.raises(NotImplementedError, match="iou_aware"):
        PV.yolo_box(x, size, [10, 13, 16, 30, 33, 23], 1, 0.1, 32,
                    iou_aware=True)
