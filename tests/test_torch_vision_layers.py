"""The port's vision layers, activation layers and loss layers against
the JAX package's, on the CPU.

Each layer is built on both sides with the same weights (the port's, from
a seed) and must have the reference's ``state_dict`` keys and shapes; its
output, weighted by a fixed random array and summed, and the input's
gradient are compared, and in train mode the batch norms' buffers after
the step. The losses at each reduction, the activations at their
arguments. Tolerance: fp32 1e-5 relative and absolute.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from test_torch_vision_ops import _check, _close, _rand


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


ACTIVATIONS = {
    "ReLU": {}, "ReLU6": {}, "GELU": {}, "Sigmoid": {}, "Tanh": {},
    "Silu": {}, "Swish": {}, "Mish": {}, "LeakyReLU": dict(negative_slope=0.2),
    "ELU": dict(alpha=0.7), "Hardswish": {}, "Hardsigmoid": {},
    "Softplus": dict(beta=2.0, threshold=5.0), "LogSoftmax": {},
    "Softmax": dict(axis=1),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_layers_match_reference(name):
    kw = ACTIVATIONS[name]
    x = _rand(40, 3, 5, 7) * 3
    _check(lambda t: getattr(ref.nn, name)(**kw)(t),
           lambda t: getattr(pt.nn, name)(**kw)(t), [x])


def _loss_inputs(name):
    rng = np.random.RandomState(41)
    x = rng.randn(6, 5).astype(np.float32)
    if name in ("CrossEntropyLoss", "NLLLoss"):
        y = rng.randint(0, 5, (6,)).astype(np.int64)
        y[2] = -100  # ignored
        if name == "NLLLoss":
            x = x - np.log(np.exp(x).sum(-1, keepdims=True))
        return x, y
    if name == "BCEWithLogitsLoss":
        return x, (rng.rand(6, 5) > 0.5).astype(np.float32)
    return x, rng.randn(6, 5).astype(np.float32)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["CrossEntropyLoss", "MSELoss", "L1Loss",
                                  "NLLLoss", "BCEWithLogitsLoss"])
def test_loss_layers_match_reference(name, reduction):
    x, y = _loss_inputs(name)

    def run(p):
        t = p.to_tensor(x, stop_gradient=False)
        loss = getattr(p.nn, name)(reduction=reduction)(t, p.to_tensor(y))
        loss.sum().backward()
        return np.asarray(loss.numpy()), np.asarray(t.grad.numpy())

    for got, want in zip(run(pt), run(ref)):
        _close(got, want)


def test_bce_with_logits_weights_match_reference():
    x, y = _loss_inputs("BCEWithLogitsLoss")
    w = np.random.RandomState(42).rand(5).astype(np.float32)
    pw = np.random.RandomState(43).rand(5).astype(np.float32) + 0.5
    for kw in (dict(weight=w), dict(pos_weight=pw),
               dict(weight=w, pos_weight=pw)):
        outs = [np.asarray(p.nn.functional.binary_cross_entropy_with_logits(
            p.to_tensor(x), p.to_tensor(y),
            **{k: p.to_tensor(v) for k, v in kw.items()}).numpy())
            for p in (pt, ref)]
        _close(*outs)


# name: (constructor on either package, input shape)
LAYERS = {
    "Conv2D": (lambda p: p.nn.Conv2D(4, 6, 3, stride=2, padding=1),
               (2, 4, 9, 9)),
    "Conv2D_nhwc_groups": (lambda p: p.nn.Conv2D(
        4, 6, 3, padding="SAME", groups=2, bias_attr=False,
        data_format="NHWC"), (2, 9, 9, 4)),
    "Conv1D": (lambda p: p.nn.Conv1D(4, 6, 3, padding=1), (2, 4, 11)),
    "Conv2DTranspose": (lambda p: p.nn.Conv2DTranspose(4, 6, 3, stride=2,
                                                       padding=1),
                        (2, 4, 5, 5)),
    "BatchNorm1D": (lambda p: p.nn.BatchNorm1D(4), (6, 4)),
    "BatchNorm2D": (lambda p: p.nn.BatchNorm2D(4), (3, 4, 5, 5)),
    "BatchNorm3D": (lambda p: p.nn.layers_common.BatchNorm3D(4),
                    (2, 4, 3, 3, 3)),
    "BatchNorm_relu": (lambda p: p.nn.BatchNorm(4, act="relu"),
                       (3, 4, 5, 5)),
    "SyncBatchNorm": (lambda p: p.nn.SyncBatchNorm(4), (3, 4, 5, 5)),
    "GroupNorm": (lambda p: p.nn.GroupNorm(2, 4), (3, 4, 5, 5)),
    "InstanceNorm2D": (lambda p: p.nn.InstanceNorm2D(4), (3, 4, 5, 5)),
    "MaxPool2D": (lambda p: p.nn.MaxPool2D(3, 2, 1), (2, 4, 9, 9)),
    "AvgPool2D": (lambda p: p.nn.AvgPool2D(3, 2, 1, exclusive=False),
                  (2, 4, 9, 9)),
    "MaxPool1D": (lambda p: p.nn.MaxPool1D(3, 2, 1), (2, 4, 11)),
    "AvgPool1D": (lambda p: p.nn.AvgPool1D(3, 2, 1), (2, 4, 11)),
    "AdaptiveAvgPool2D": (lambda p: p.nn.AdaptiveAvgPool2D(3),
                          (2, 4, 7, 7)),
    "AdaptiveMaxPool2D": (lambda p: p.nn.AdaptiveMaxPool2D((2, 3)),
                          (2, 4, 7, 7)),
    "Flatten": (lambda p: p.nn.Flatten(), (2, 4, 3, 3)),
    "Identity": (lambda p: p.nn.Identity(), (2, 4, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_reference(name):
    """State-dict keys and shapes, then forward and input gradient with
    the port's weights on both sides (train mode: the batch norms use the
    batch's statistics and update their buffers, compared after)."""
    build, shape = LAYERS[name]
    ref.seed(0)
    pt.seed(0)
    r, p = build(ref), build(pt)
    assert [(k, tuple(v.shape)) for k, v in p.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in r.state_dict().items()]
    r.set_state_dict({k: np.array(v.numpy())
                      for k, v in p.state_dict().items()})
    _check(lambda t: r(t), lambda t: p(t), [_rand(44, *shape)])
    for (k, rv), (_, pv) in zip(r.state_dict().items(),
                                p.state_dict().items()):
        _close(pv.numpy(), rv.numpy())


def test_flatten_squeeze_unsqueeze_match_reference():
    x = _rand(45, 2, 1, 3, 1)
    for fn in (lambda p, t: p.flatten(t, 1, 2),
               lambda p, t: p.flatten(t),
               lambda p, t: p.squeeze(t),
               lambda p, t: p.squeeze(t, [1, 2]),
               lambda p, t: p.unsqueeze(t, [0, -1]),
               lambda p, t: t.flatten(2)):
        got = fn(pt, pt.to_tensor(x)).numpy()
        want = np.asarray(fn(ref, ref.to_tensor(x)).numpy())
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
