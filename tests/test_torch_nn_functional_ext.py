"""The port's ``nn.functional`` additions against the JAX package's, on
the CPU, beyond the op table (``tests/test_torch_ops_nn.py``): every mode
of ``interpolate``, ``grid_sample`` and ``ctc_loss``, the elementwise
activations at 1e-6, the random functionals by their laws, and the
options the port refuses.

Limits, fp32, relative and absolute: 1e-6 for the elementwise
activations and the pure rearrangements; 1e-5 for the rest (a resize, a
bilinear tap, a CTC forward recursion over 12 steps); the gradients the
same. The random functionals (``dropout2d``/``3d``, ``alpha_dropout``,
``rrelu``, ``gumbel_softmax``) draw from the device's generator, so they
are held by their laws (keep rate, scale, mean, within five standard
errors), not bit for bit against ``jax.random``.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _run(P, fn, arrays, grad=()):
    ts = [P.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    out = fn(P, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if grad:
        loss = None
        for k, o in enumerate(outs):
            r = np.random.RandomState(100 + k).uniform(
                -1, 1, o.shape).astype(np.float32)
            term = (o.astype("float32") * P.to_tensor(r)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
    return ([np.asarray(o.numpy(), np.float64) for o in outs],
            [np.asarray(ts[i].grad.numpy(), np.float64) for i in grad])


def _hold(fn, arrays, grad=(), tol=1e-5):
    want, wgrad = _run(ref, fn, arrays, grad)
    got, ggrad = _run(pt, fn, arrays, grad)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got + ggrad, want + wgrad)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=str(k))


RNG = np.random.RandomState(0)
X = RNG.uniform(-3, 3, (3, 4, 6)).astype(np.float32)

ACTIVATIONS = {
    "celu": lambda F, x: F.celu(x, 1.3),
    "elu": lambda F, x: F.elu(x, 0.7),
    "selu": lambda F, x: F.selu(x),
    "hardtanh": lambda F, x: F.hardtanh(x, -0.5, 0.7),
    "hardshrink": lambda F, x: F.hardshrink(x, 0.3),
    "softshrink": lambda F, x: F.softshrink(x, 0.3),
    "thresholded_relu": lambda F, x: F.thresholded_relu(x, 0.2, 0.1),
    "leaky_relu": lambda F, x: F.leaky_relu(x, 0.05),
    "softplus": lambda F, x: F.softplus(x, 2.0, 5.0),
    "log_sigmoid": lambda F, x: F.log_sigmoid(x),
    "glu": lambda F, x: F.glu(x, 1),
    "silu_": lambda F, x: F.silu_(x),
    "tanh_": lambda F, x: F.tanh_(x),
    "prelu": lambda F, x: F.prelu(x, x[0, :, 0] * 0.1),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activations_match_reference(name):
    fn = ACTIVATIONS[name]
    _hold(lambda P, x: fn(P.nn.functional, x), [X], grad=(0,), tol=1e-6)


IMG = RNG.randn(2, 3, 7, 9).astype(np.float32)
SIZES = [(14, 18), (3, 4), (7, 13), (10, 5), (1, 1)]


@pytest.mark.parametrize("mode,align", [
    ("nearest", False), ("bilinear", False), ("bilinear", True),
    ("bicubic", False), ("bicubic", True), ("area", False)])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_interpolate_every_mode(mode, align, fmt):
    """jax.image.resize's half-pixel rules (antialiased when shrinking,
    Keys a = -0.5) and the reference's own align_corners sampling (Keys a
    = -0.75): up, down, mixed and 1x1, forward and gradient at 1e-5."""
    x = IMG if fmt == "NCHW" else IMG.transpose(0, 2, 3, 1).copy()

    def fn(P, t):
        F = P.nn.functional
        return [F.interpolate(t, size=s, mode=mode, align_corners=align,
                              data_format=fmt) for s in SIZES] + [
            F.upsample(t, scale_factor=2, mode=mode, align_corners=align,
                       data_format=fmt)]
    _hold(fn, [x], grad=(0,))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_every_mode(mode, padding, align):
    """Samples inside, on and past the edges (grid in [-1.3, 1.3])."""
    grid = RNG.uniform(-1.3, 1.3, (2, 5, 4, 2)).astype(np.float32)
    grad = (0, 1) if mode == "bilinear" else (0,)
    _hold(lambda P, x, g: P.nn.functional.grid_sample(
        x, g, mode, padding, align), [IMG, grid], grad=grad)


def _ctc_inputs(seed=1):
    rng = np.random.RandomState(seed)
    logits = rng.randn(12, 4, 6).astype(np.float32)
    labels = rng.randint(1, 6, (4, 5)).astype(np.int32)
    labels[1, 1] = labels[1, 2]  # a repeated label needs a blank between
    in_len = np.array([12, 9, 11, 12], np.int64)
    lab_len = np.array([5, 3, 4, 1], np.int64)
    return logits, labels, in_len, lab_len


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_loss_every_reduction(reduction, blank):
    """Raw logits (log-softmaxed inside), per-sequence input and label
    lengths, a repeated label; ``mean`` divides by the label lengths
    first. Forward and the logits' gradient at 1e-5."""
    _hold(lambda P, lp, lb, il, ll: P.nn.functional.ctc_loss(
        lp, lb, il, ll, blank=blank, reduction=reduction),
        list(_ctc_inputs()), grad=(0,))


def test_ctc_loss_refuses_norm_by_times():
    lp, lb, il, ll = (pt.to_tensor(a) for a in _ctc_inputs())
    with pytest.raises(NotImplementedError):
        pt.nn.functional.ctc_loss(lp, lb, il, ll, norm_by_times=True)


def test_cross_entropy_soft_labels_and_smoothing():
    logits = RNG.randn(6, 5).astype(np.float32)
    soft = np.abs(RNG.randn(6, 5)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    lbl = np.array([0, 4, 1, -100, 2, 3])

    def fn(P, x, s, y):
        F = P.nn.functional
        return (F.cross_entropy(x, y, label_smoothing=0.1),
                F.cross_entropy(x, y, label_smoothing=0.2,
                                reduction="none"),
                F.cross_entropy(x, s, soft_label=True),
                F.cross_entropy(x, s, soft_label=True, reduction="sum"),
                F.cross_entropy(F.softmax(x), y, use_softmax=False))
    _hold(fn, [logits, soft, lbl], grad=(0, 1))


def test_cross_entropy_refuses_weight_with_soft_labels():
    x = pt.to_tensor(np.ones((2, 3), np.float32))
    with pytest.raises(NotImplementedError):
        pt.nn.functional.cross_entropy(x, x, weight=pt.ones([3]),
                                       soft_label=True)


def test_label_smooth_and_one_hot():
    lbl = np.array([[0, 2], [1, 3]])

    def fn(P, y):
        F = P.nn.functional
        oh = F.one_hot(y, 4)
        return oh, F.label_smooth(oh), F.label_smooth(
            oh, P.to_tensor(np.full((1, 4), 0.25, np.float32)), 0.2)
    _hold(fn, [lbl], tol=1e-6)


def test_gather_tree_and_sequence_mask():
    ids = RNG.randint(0, 9, (5, 3, 4))
    parents = RNG.randint(0, 4, (5, 3, 4))
    lens = np.array([3, 0, 5])
    _hold(lambda P, i, p: P.nn.functional.gather_tree(i, p),
          [ids, parents], tol=0)
    _hold(lambda P, n: (P.nn.functional.sequence_mask(n),
                        P.nn.functional.sequence_mask(n, 7, "float32")),
          [lens], tol=0)


def test_rearrangements_and_pads():
    x = RNG.randn(2, 8, 4, 6).astype(np.float32)

    def fn(P, t):
        F = P.nn.functional
        return (F.pixel_shuffle(t, 2), F.pixel_unshuffle(t, 2),
                F.channel_shuffle(t, 4), F.temporal_shift(t, 2, 0.25),
                F.maxout(t, 4), F.zeropad2d(t, [1, 0, 2, 1]),
                F.pad(t, [1, 1, 2, 0], mode="reflect"))
    _hold(fn, [x], grad=(0,), tol=1e-6)


def test_norm_conv_and_pool_additions():
    vol = RNG.randn(2, 3, 4, 5, 6).astype(np.float32)
    w = RNG.randn(4, 3, 3, 3, 3).astype(np.float32)
    wt = RNG.randn(3, 2, 2, 3, 3).astype(np.float32)

    def fn(P, v, w_, wt_):
        F = P.nn.functional
        return (F.conv3d(v, w_, None, 1, 1), F.conv3d(v, w_, None, 2, 0),
                F.conv3d_transpose(v, wt_, None, 2, 1),
                F.conv3d_transpose(v, wt_, None, 2, 1,
                                   output_size=[7, 10, 12]),
                F.local_response_norm(v[:, :, 0], 3),
                F.max_pool3d(v, 2), F.avg_pool3d(v, 3, 2, 1),
                F.lp_pool2d(P.abs(v[:, :, 0]) + 0.1, 3, 2))
    _hold(fn, [vol, w, wt], grad=(0, 1, 2))


def test_losses_the_table_does_not_reach():
    x = RNG.randn(6, 5).astype(np.float32)
    y = RNG.randn(6, 5).astype(np.float32)
    lbl = RNG.randint(0, 5, (6,))

    def fn(P, a, b, t):
        F = P.nn.functional
        return (F.dice_loss(F.softmax(a), P.unsqueeze(t, -1)),
                F.margin_cross_entropy(a * 0.3, t, reduction="sum"),
                F.sigmoid_focal_loss(a, F.sigmoid(b), P.to_tensor(
                    np.float32(3.0)), reduction="mean"),
                F.softmax_with_cross_entropy(a, P.unsqueeze(t, -1),
                                             return_softmax=True)[1],
                F.hsigmoid_loss(a, t, 6, b, None))
    _hold(fn, [x, y, lbl], grad=(0, 1))


@pytest.mark.parametrize("call", [
    "hsigmoid_path_table", "hsigmoid_is_sparse", "interpolate_align_mode",
    "interpolate_5d", "adaptive_log_softmax", "conv3d_ndhwc"])
def test_options_the_reference_ignores_are_refused(call):
    F = pt.nn.functional
    x = pt.to_tensor(RNG.randn(2, 3, 4, 4).astype(np.float32))
    calls = {
        "hsigmoid_path_table": lambda: F.hsigmoid_loss(
            x[:, :, 0, 0], pt.to_tensor([0, 1]), 3, x[:2, :, 0, 0],
            path_table=pt.to_tensor([[0]])),
        "hsigmoid_is_sparse": lambda: F.hsigmoid_loss(
            x[:, :, 0, 0], pt.to_tensor([0, 1]), 3, x[:2, :, 0, 0],
            is_sparse=True),
        "interpolate_align_mode": lambda: F.interpolate(
            x, size=[8, 8], mode="bilinear", align_mode=1),
        "interpolate_5d": lambda: F.interpolate(
            pt.unsqueeze(x, 2), size=[8, 8], mode="bilinear"),
        "adaptive_log_softmax": lambda: F.adaptive_log_softmax_with_loss(
            x, None, None, None, None),
        "conv3d_ndhwc": lambda: F.conv3d(
            pt.unsqueeze(x, 2), pt.ones([2, 4, 1, 1, 3]),
            data_format="NDHWC"),
    }
    with pytest.raises((NotImplementedError, ValueError)):
        calls[call]()


# ------------------------------------------------------- random functionals
def _ones(shape):
    return pt.ones(shape)


def _within(value, mean, var, n):
    return abs(value - mean) < 5 * np.sqrt(var / n)


@pytest.mark.parametrize("fn,shape,axes", [
    ("dropout2d", [64, 32, 5, 5], (2, 3)),
    ("dropout3d", [32, 32, 3, 4, 5], (2, 3, 4))])
def test_channel_dropouts_keep_rate_and_scale(fn, shape, axes):
    """Whole channels are dropped together, the kept ones scaled by
    1 / (1 - p), at the rate 1 - p; nothing outside training."""
    p = 0.3
    out = getattr(pt.nn.functional, fn)(_ones(shape), p).numpy()
    per_channel = out.reshape(shape[0], shape[1], -1)
    assert (per_channel == per_channel[..., :1]).all()
    vals = np.unique(out)
    np.testing.assert_allclose(sorted(vals), [0.0, 1 / (1 - p)], rtol=1e-6)
    kept = (per_channel[..., 0] != 0).mean()
    assert _within(kept, 1 - p, p * (1 - p), shape[0] * shape[1])
    same = getattr(pt.nn.functional, fn)(_ones(shape), p, training=False)
    assert (same.numpy() == 1).all()


def test_alpha_dropout_keeps_mean_and_variance():
    """SELU's dropout keeps a standard normal's mean and variance; the
    dropped elements share one value; the reference's too."""
    p, n = 0.2, 200_000
    x = RNG.randn(n).astype(np.float32)
    for P in (ref, pt):
        out = P.nn.functional.alpha_dropout(P.to_tensor(x), p).numpy()
        assert _within(out.mean(), 0.0, 1.0, n), P.__name__
        assert abs(out.var() - 1.0) < 0.02, (P.__name__, out.var())
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    kept = np.isclose(out, a * x + b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[~kept], a * alpha_p + b, rtol=1e-6)
    assert _within((~kept).mean(), p, p * (1 - p), n)


def test_rrelu_draws_slopes_in_its_range():
    lower, upper = 0.1, 0.3
    x = -np.abs(RNG.randn(100_000).astype(np.float32)) - 0.1
    slope = pt.nn.functional.rrelu(pt.to_tensor(x), lower, upper,
                                   training=True).numpy() / x
    assert slope.min() >= lower and slope.max() < upper + 1e-6
    assert _within(slope.mean(), 0.2, (upper - lower) ** 2 / 12, x.size)
    _hold(lambda P, t: P.nn.functional.rrelu(t, lower, upper), [x],
          tol=1e-6)


def test_gumbel_softmax_law():
    """Soft samples sum to 1; hard ones are one-hot with the soft
    gradient; the argmax of softmax(logits + g) follows softmax(logits)."""
    logits = np.log(np.array([0.1, 0.2, 0.7], np.float32))
    n = 100_000
    x = pt.to_tensor(np.tile(logits, (n, 1)), stop_gradient=False)
    soft = pt.nn.functional.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(soft.numpy().sum(-1), 1.0, rtol=1e-5)
    hard = pt.nn.functional.gumbel_softmax(x, hard=True)
    h = hard.numpy()
    assert ((h == 0) | (h == 1)).all() and (h.sum(-1) == 1).all()
    freq = h.mean(0)
    for f, q in zip(freq, [0.1, 0.2, 0.7]):
        assert _within(f, q, q * (1 - q), n), freq
    hard.sum().backward()
    assert x.grad is not None


def test_random_functionals_follow_the_seed():
    for make in (lambda: pt.nn.functional.dropout2d(_ones([8, 16, 2, 2])),
                 lambda: pt.nn.functional.gumbel_softmax(_ones([16, 4])),
                 lambda: pt.nn.functional.rrelu(-_ones([64]),
                                                training=True)):
        pt.seed(3)
        a = make().numpy()
        pt.seed(3)
        np.testing.assert_array_equal(make().numpy(), a)
