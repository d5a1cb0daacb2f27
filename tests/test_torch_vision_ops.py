"""The port's convolution, pooling and batch norm functionals against the
JAX package's, on the CPU.

The same numpy inputs (from a seed) go through ``paddle_tpu.nn.functional``
and ``paddle_tpu_torch.nn.functional``; each output is weighted by a fixed
random array and summed, and the gradients of the input, the weight and
the bias are compared too. Neither side has a Pallas kernel on this path:
the reference convolves and pools in plain XLA.

Tolerances: fp32 on both sides, 1e-5 relative and absolute (sums of at
most a few hundred products of order 1 taken in other orders); the batch
norm's running statistics after three train steps 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch._core import device as pt_device

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _both(fn_ref, fn_pt, arrays, seed=99):
    """``fn(*tensors)`` on both sides; returns (ref out, port out, ref
    grads, port grads), the gradients of ``sum(out * w)`` for a fixed
    random ``w``. ``None`` entries of ``arrays`` pass as ``None``."""
    def run(p, fn):
        ts = [None if a is None else p.to_tensor(a, stop_gradient=False)
              for a in arrays]
        out = fn(*ts)
        w = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
        (out * p.to_tensor(w)).sum().backward()
        return (np.asarray(out.numpy()),
                [None if t is None else np.asarray(t.grad.numpy())
                 for t in ts])
    ro, rg = run(ref, fn_ref)
    po, pg = run(pt, fn_pt)
    return ro, po, rg, pg


def _check(fn_ref, fn_pt, arrays, tol=TOL):
    ro, po, rg, pg = _both(fn_ref, fn_pt, arrays)
    assert po.shape == ro.shape
    _close(po, ro, tol)
    for got, want in zip(pg, rg):
        if want is not None:
            _close(got, want, tol)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ conv

# name: (x shape, weight shape, kwargs). Odd input sizes, so that SAME at
# stride 2 pads one more row on the high side than the low one.
CONV2D = {
    "pad_int": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "pad_pair": ((2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 2])),
    "pad_2n": ((2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[0, 2, 1, 0])),
    "pad_pairs": ((2, 4, 9, 8), (6, 4, 3, 3),
                  dict(padding=[[2, 1], [0, 1]])),
    "same_stride2": ((2, 4, 9, 9), (6, 4, 3, 3),
                     dict(padding="SAME", stride=2)),
    "same_stride2_k4": ((2, 4, 9, 7), (6, 4, 4, 4),
                        dict(padding="same", stride=2)),
    "valid_stride2": ((2, 4, 9, 9), (6, 4, 3, 3),
                      dict(padding="VALID", stride=2)),
    "dilation2": ((2, 4, 11, 11), (6, 4, 3, 3),
                  dict(padding=2, dilation=2)),
    "same_dilation2": ((2, 4, 10, 9), (6, 4, 3, 3),
                       dict(padding="SAME", dilation=2)),
    "groups2": ((2, 4, 9, 9), (6, 2, 3, 3), dict(padding=1, groups=2)),
    "depthwise": ((2, 4, 9, 9), (4, 1, 3, 3), dict(padding=1, groups=4)),
    "stride2_7x7": ((2, 3, 17, 17), (8, 3, 7, 7),
                    dict(padding=3, stride=2)),
    "nhwc": ((2, 9, 9, 4), (6, 4, 3, 3),
             dict(padding=1, stride=2, data_format="NHWC")),
}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("case", sorted(CONV2D))
def test_conv2d_matches_reference(case, bias):
    xs, ws, kw = CONV2D[case]
    arrays = [_rand(0, *xs), _rand(1, *ws) * 0.3,
              _rand(2, ws[0]) if bias else None]
    _check(lambda x, w, b: RF.conv2d(x, w, b, **kw),
           lambda x, w, b: F.conv2d(x, w, b, **kw), arrays)


@pytest.mark.parametrize("case", ["pad1", "same_stride2", "dilation2",
                                  "groups2", "nlc"])
def test_conv1d_matches_reference(case):
    kw = {"pad1": dict(padding=1), "same_stride2": dict(padding="SAME",
                                                        stride=2),
          "dilation2": dict(padding=2, dilation=2),
          "groups2": dict(padding=1, groups=2),
          "nlc": dict(padding=1, data_format="NLC")}[case]
    cin = 4
    xs = (2, 13, cin) if case == "nlc" else (2, cin, 13)
    ws = (6, cin // kw.get("groups", 1), 3)
    arrays = [_rand(3, *xs), _rand(4, *ws) * 0.3, _rand(5, 6)]
    _check(lambda x, w, b: RF.conv1d(x, w, b, **kw),
           lambda x, w, b: F.conv1d(x, w, b, **kw), arrays)


@pytest.mark.parametrize("case", ["stride2_pad1", "asym_pad", "out_pad",
                                  "groups2_dilation2", "nhwc"])
def test_conv2d_transpose_matches_reference(case):
    kw = {"stride2_pad1": dict(stride=2, padding=1),
          "asym_pad": dict(stride=2, padding=[[2, 0], [0, 1]]),
          "out_pad": dict(stride=2, padding=1, output_padding=1),
          "groups2_dilation2": dict(stride=1, padding=1, groups=2,
                                    dilation=2),
          "nhwc": dict(stride=2, padding=1, data_format="NHWC")}[case]
    xs = (2, 5, 5, 4) if case == "nhwc" else (2, 4, 5, 5)
    ws = (4, 6 // kw.get("groups", 1), 3, 3)
    arrays = [_rand(6, *xs), _rand(7, *ws) * 0.3, _rand(8, 6)]
    _check(lambda x, w, b: RF.conv2d_transpose(x, w, b, **kw),
           lambda x, w, b: F.conv2d_transpose(x, w, b, **kw), arrays)


# --------------------------------------------------------------- pooling

POOL = {
    "k3s2p1": dict(kernel_size=3, stride=2, padding=1),
    "k2": dict(kernel_size=2),
    "ceil": dict(kernel_size=3, stride=2, ceil_mode=True),
    "ceil_pad": dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    "same": dict(kernel_size=3, stride=2, padding="SAME"),
    "pairs": dict(kernel_size=(3, 2), stride=(2, 1), padding=[[1, 0],
                                                              [0, 1]]),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL))
def test_max_pool2d_matches_reference(case, fmt):
    kw = dict(POOL[case], data_format=fmt)
    shape = (2, 8, 8, 3) if fmt == "NHWC" else (2, 3, 8, 8)
    _check(lambda x: RF.max_pool2d(x, **kw), lambda x: F.max_pool2d(x, **kw),
           [_rand(9, *shape)])


@pytest.mark.parametrize("case", ["k3s2p1", "ceil_pad", "k2"])
def test_max_pool2d_mask_matches_reference(case):
    x = _rand(10, 2, 3, 9, 9)
    r_out, r_idx = RF.max_pool2d(ref.to_tensor(x), return_mask=True,
                                 **POOL[case])
    p_out, p_idx = F.max_pool2d(pt.to_tensor(x), return_mask=True,
                                **POOL[case])
    _close(p_out.numpy(), r_out.numpy())
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx.numpy()))
    assert p_idx.dtype == pt.int32


@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["exclusive", "inclusive"])
@pytest.mark.parametrize("case", sorted(POOL))
def test_avg_pool2d_matches_reference(case, exclusive):
    kw = dict(POOL[case], exclusive=exclusive)
    _check(lambda x: RF.avg_pool2d(x, **kw), lambda x: F.avg_pool2d(x, **kw),
           [_rand(11, 2, 3, 9, 9)])


def test_avg_pool2d_inclusive_ceil_rule_is_the_reference_one():
    """``exclusive=False`` with ``ceil_mode``: the symmetric padding counts
    and the ceil extension does not. On 6 x 6, kernel 3, stride 2, padding
    1, the last window holds one real row and column, one padding row and
    column and the extension: it divides x[5, 5] by 2 x 2, where the
    exclusive rule divides by 1. torch's ``count_include_pad=True`` follows
    the same rule at symmetric padding (it takes no other)."""
    import torch
    x = _rand(12, 1, 1, 6, 6)
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)
    got = F.avg_pool2d(pt.to_tensor(x), exclusive=False, **kw).numpy()
    _close(got, RF.avg_pool2d(ref.to_tensor(x), exclusive=False,
                              **kw).numpy())
    assert got.shape == (1, 1, 4, 4)
    _close(got[0, 0, -1, -1], x[0, 0, 5, 5] / 4)
    excl = F.avg_pool2d(pt.to_tensor(x), exclusive=True, **kw).numpy()
    _close(excl[0, 0, -1, -1], x[0, 0, 5, 5])
    theirs = torch.nn.functional.avg_pool2d(
        torch.from_numpy(x), 3, 2, 1, ceil_mode=True,
        count_include_pad=True).numpy()
    _close(got, theirs)


@pytest.mark.parametrize("divisor", [4, 7])
def test_avg_pool2d_divisor_override_matches_reference(divisor):
    kw = dict(kernel_size=3, stride=2, padding=1, divisor_override=divisor)
    _check(lambda x: RF.avg_pool2d(x, **kw), lambda x: F.avg_pool2d(x, **kw),
           [_rand(13, 2, 3, 9, 9)])


@pytest.mark.parametrize("case", ["k3s2p1", "ceil", "mask"])
def test_pool1d_matches_reference(case):
    kw = dict(kernel_size=3, stride=2, padding=1) if case != "ceil" \
        else dict(kernel_size=3, stride=2, ceil_mode=True)
    x = _rand(14, 2, 3, 12)
    if case == "mask":
        r_out, r_idx = RF.max_pool1d(ref.to_tensor(x), return_mask=True,
                                     **kw)
        p_out, p_idx = F.max_pool1d(pt.to_tensor(x), return_mask=True, **kw)
        _close(p_out.numpy(), r_out.numpy())
        np.testing.assert_array_equal(p_idx.numpy(),
                                      np.asarray(r_idx.numpy()))
        return
    _check(lambda x: RF.max_pool1d(x, **kw), lambda x: F.max_pool1d(x, **kw),
           [x])
    _check(lambda x: RF.avg_pool1d(x, **kw), lambda x: F.avg_pool1d(x, **kw),
           [x])


@pytest.mark.parametrize("out", [3, 1, (2, 3)], ids=["7to3", "7to1",
                                                     "7to2x3"])
@pytest.mark.parametrize("kind", ["avg", "max", "avg_nhwc"])
def test_adaptive_pool2d_matches_reference(kind, out):
    if kind == "max":
        _check(lambda x: RF.adaptive_max_pool2d(x, out),
               lambda x: F.adaptive_max_pool2d(x, out), [_rand(15, 2, 3, 7,
                                                               7)])
        return
    fmt = "NHWC" if kind == "avg_nhwc" else "NCHW"
    shape = (2, 7, 7, 3) if fmt == "NHWC" else (2, 3, 7, 7)
    _check(lambda x: RF.adaptive_avg_pool2d(x, out, data_format=fmt),
           lambda x: F.adaptive_avg_pool2d(x, out, data_format=fmt),
           [_rand(16, *shape)])


def test_adaptive_avg_pool1d_matches_reference():
    _check(lambda x: RF.adaptive_avg_pool1d(x, 3),
           lambda x: F.adaptive_avg_pool1d(x, 3), [_rand(17, 2, 3, 7)])


# ------------------------------------------------------------ batch norm

# name: (input shape, data_format)
BN = {
    "1d": ((8, 5), "NCHW"),
    "1d_ncl": ((4, 5, 6), "NCL"),
    "2d": ((4, 5, 6, 6), "NCHW"),
    "2d_nhwc": ((4, 6, 6, 5), "NHWC"),
    "3d": ((2, 5, 3, 4, 4), "NCDHW"),
}


@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
@pytest.mark.parametrize("case", sorted(BN))
def test_batch_norm_matches_reference(case, mode):
    """Forward and gradients of x, weight and bias; in train mode three
    steps, after which the running mean and variance equal the
    reference's (biased batch variance, momentum 0.9 on the old value)."""
    shape, fmt = BN[case]
    c = shape[-1] if fmt == "NHWC" else shape[1]
    rng = np.random.RandomState(18)
    rm0 = rng.randn(c).astype(np.float32) * 0.1
    rv0 = rng.rand(c).astype(np.float32) + 0.5
    w, b = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    training = mode == "train"
    glob = True if mode == "global_stats" else None
    run = {}
    for name, p, fn in (("ref", ref, RF.batch_norm), ("pt", pt, F.batch_norm)):
        rm, rv = p.to_tensor(rm0), p.to_tensor(rv0)
        outs, grads = [], []
        for step in range(3 if training else 1):
            x = p.to_tensor(_rand(19 + step, *shape) * 2 + 0.5,
                            stop_gradient=False)
            tw = p.to_tensor(w, stop_gradient=False)
            tb = p.to_tensor(b, stop_gradient=False)
            out = fn(x, rm, rv, tw, tb, training=training, momentum=0.9,
                     epsilon=1e-5, data_format=fmt, use_global_stats=glob)
            g = np.random.RandomState(7).randn(*out.shape).astype(
                np.float32)
            (out * p.to_tensor(g)).sum().backward()
            outs.append(np.asarray(out.numpy()))
            grads.append([np.asarray(t.grad.numpy()) for t in (x, tw, tb)])
        run[name] = (outs, grads, np.asarray(rm.numpy()),
                     np.asarray(rv.numpy()))
    for got, want in zip(run["pt"][0], run["ref"][0]):
        _close(got, want)
    for got, want in zip(run["pt"][1], run["ref"][1]):
        for g1, g2 in zip(got, want):
            _close(g1, g2)
    _close(run["pt"][2], run["ref"][2], 1e-6)
    _close(run["pt"][3], run["ref"][3], 1e-6)
    if not training:
        _close(run["pt"][2], rm0, 0)  # eval leaves the buffers as they were


def test_batch_norm_running_stats_are_not_torch_s():
    """torch's own running update (unbiased variance, momentum on the new
    batch) would give other buffers: the port's are the reference's."""
    import torch
    x = _rand(30, 4, 3, 5, 5)
    rm, rv = pt.zeros([3]), pt.ones([3])
    F.batch_norm(pt.to_tensor(x), rm, rv, training=True, momentum=0.9)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3))
    _close(rm.numpy(), 0.1 * mean, 1e-6)
    _close(rv.numpy(), 0.9 + 0.1 * var, 1e-6)
    trm, trv = torch.zeros(3), torch.ones(3)
    torch.nn.functional.batch_norm(torch.from_numpy(x), trm, trv,
                                   training=True, momentum=0.9)
    assert not np.allclose(trm.numpy(), rm.numpy())
    assert not np.allclose(trv.numpy(), rv.numpy())


@pytest.mark.parametrize("kind", ["group2", "group2_nhwc", "instance"])
def test_group_and_instance_norm_match_reference(kind):
    rng = np.random.RandomState(31)
    w, b = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    if kind == "instance":
        _check(lambda x, w, b: RF.instance_norm(x, weight=w, bias=b),
               lambda x, w, b: F.instance_norm(x, weight=w, bias=b),
               [_rand(32, 2, 4, 5, 5), w, b])
        return
    fmt = "NHWC" if kind == "group2_nhwc" else "NCHW"
    shape = (2, 5, 5, 4) if fmt == "NHWC" else (2, 4, 5, 5)
    _check(lambda x, w, b: RF.group_norm(x, 2, 1e-5, w, b, fmt),
           lambda x, w, b: F.group_norm(x, 2, 1e-5, w, b, fmt),
           [_rand(33, *shape), w, b])
