"""The port's ``incubate`` against the JAX package's, on the CPU.

- The fused layers (``FusedLinear``, ``FusedMultiHeadAttention``,
  ``FusedFeedForward``, ``FusedTransformerEncoderLayer``), pre- and
  post-norm, with the reference's weights crossed by ``set_state_dict``:
  forward and every gradient (input and parameters) at dropout 0 in
  training and with dropout on in eval mode, fp32, 1e-5 relative and
  absolute. Their dropout in training is held by its law; the options the
  reference takes and ignores raise.
- The segment reductions, forward and gradient of ``sum(out * r)``:
  unsorted ids, an empty segment, integer data and ids, and tied maxima
  and minima (the gradient shared evenly among the tied elements, as the
  reference's ``jax.ops.segment_max`` shares it), fp32 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(build):
    rm, tm = build(ref), build(pt)
    state = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert list(v.shape) == list(state[k].shape), k
    tm.set_state_dict(state)
    return rm, tm


def _mask(P, b, s):
    """A bool padding mask [B, 1, 1, S]: the second row drops its last
    quarter of keys."""
    m = np.ones((b, 1, 1, s), bool)
    m[1, ..., -s // 4:] = False
    return P.to_tensor(m)


def _run(P, m, x, masked, train):
    m.train() if train else m.eval()
    t = P.to_tensor(x, stop_gradient=False)
    args = (t, _mask(P, *x.shape[:2])) if masked else (t,)
    out = m(*args)
    (out * P.to_tensor(_x(*out.shape, seed=9))).sum().backward()
    return [out.numpy(), t.grad.numpy()] + [
        p.grad.numpy() for p in m.parameters()]


LAYERS = {
    "linear": lambda P, p: P.incubate.nn.FusedLinear(16, 24),
    "linear_t": lambda P, p: P.incubate.nn.FusedLinear(
        16, 24, transpose_weight=True),
    "attention": lambda P, p: P.incubate.nn.FusedMultiHeadAttention(
        16, 2, dropout_rate=p, attn_dropout_rate=p),
    "attention_pre": lambda P, p: P.incubate.nn.FusedMultiHeadAttention(
        16, 2, dropout_rate=p, attn_dropout_rate=p, normalize_before=True),
    "ffn": lambda P, p: P.incubate.nn.FusedFeedForward(
        16, 32, dropout_rate=p, activation="gelu"),
    "ffn_pre": lambda P, p: P.incubate.nn.FusedFeedForward(
        16, 32, dropout_rate=p, normalize_before=True),
    "encoder": lambda P, p: P.incubate.nn.FusedTransformerEncoderLayer(
        16, 2, 32, dropout_rate=p, activation="gelu"),
    "encoder_pre": lambda P, p: P.incubate.nn.FusedTransformerEncoderLayer(
        16, 2, 32, dropout_rate=p, normalize_before=True),
}
MASKED = {"attention", "attention_pre", "encoder", "encoder_pre"}


@pytest.mark.parametrize("mode", ["eval", "train_p0"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fused_layers_match_reference(name, mode):
    """Forward and every gradient: in eval mode with dropout 0.5 (no
    dropout runs), and in training with dropout 0; with the padding mask
    where the layer takes one."""
    p = 0.5 if mode == "eval" else 0.0
    rm, tm = _pair(lambda P: LAYERS[name](P, p))
    x = _x(2, 8, 16)
    for masked in ([False, True] if name in MASKED else [False]):
        want = _run(ref, rm, x, masked, mode != "eval")
        got = _run(pt, tm, x, masked, mode != "eval")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        for m in (rm, tm):
            m.clear_gradients()


@pytest.mark.parametrize("name", ["attention_pre", "ffn_pre"])
def test_dropout_keeps_the_expectation(name):
    """In training, the dropout (p 0.3) is unbiased: pre-norm, each block
    is linear in every dropout mask, so the mean of 400 train-mode outputs
    is the eval output within five standard errors of each element; each
    draw differs from the eval output."""
    layer = LAYERS[name](pt, 0.3)
    x = pt.to_tensor(_x(1, 6, 16))
    want = layer.eval()(x).numpy()
    layer.train()
    pt.seed(3)
    draws = np.stack([layer(x).numpy() for _ in range(400)])
    assert not np.allclose(draws[0], want)
    se = draws.std(0) / np.sqrt(len(draws))
    assert (np.abs(draws.mean(0) - want) <= 5 * se + 1e-6).all()


def test_encoder_runs_the_dense_sdpa_in_bf16_under_o1():
    """The attention is the ``sdpa`` op, on AMP's white list: O1 runs it
    in bf16, as the reference's O1 does."""
    from paddle_tpu_torch.nn.functional import attention
    seen = []
    body = attention._sdpa

    def spy(q, *a, **k):
        seen.append(q.dtype)
        return body(q, *a, **k)

    layer = LAYERS["encoder"](pt, 0.0)
    x = pt.to_tensor(_x(2, 8, 16))
    attention._sdpa = spy
    try:
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = layer(x, _mask(pt, 2, 8))
    finally:
        attention._sdpa = body
    assert [str(d) for d in seen] == ["torch.bfloat16"]
    with ref.amp.auto_cast(level="O1", dtype="bfloat16"):
        ref_out = _pair(lambda P: LAYERS["encoder"](P, 0.0))[0](
            ref.to_tensor(_x(2, 8, 16)), _mask(ref, 2, 8))
    assert out.dtype.name == ref_out.dtype.name


REFUSED = {
    "need_weights": lambda: pt.incubate.nn.FusedMultiHeadAttention(
        16, 2, need_weights=True),
    "nranks_attention": lambda: pt.incubate.nn.FusedMultiHeadAttention(
        16, 2, nranks=2),
    "kdim": lambda: pt.incubate.nn.FusedMultiHeadAttention(16, 2, kdim=8),
    "vdim": lambda: pt.incubate.nn.FusedMultiHeadAttention(16, 2, vdim=8),
    "ln_scale_attr": lambda: pt.incubate.nn.FusedMultiHeadAttention(
        16, 2, ln_scale_attr=pt.nn.ParamAttr()),
    "pre_ln_bias_attr": lambda: pt.incubate.nn.FusedMultiHeadAttention(
        16, 2, pre_ln_bias_attr=pt.nn.ParamAttr()),
    "nranks_ffn": lambda: pt.incubate.nn.FusedFeedForward(16, 32, nranks=4),
    "ln1_scale_attr": lambda: pt.incubate.nn.FusedFeedForward(
        16, 32, ln1_scale_attr=pt.nn.ParamAttr()),
    "encoder_weight_attr": lambda: pt.incubate.nn.FusedTransformerEncoderLayer(
        16, 2, 32, weight_attr=pt.nn.ParamAttr()),
    "attention_cache": lambda: pt.incubate.nn.FusedMultiHeadAttention(16, 2)(
        pt.to_tensor(_x(1, 3, 16)), cache=object()),
    "encoder_cache": lambda: pt.incubate.nn.FusedTransformerEncoderLayer(
        16, 2, 32)(pt.to_tensor(_x(1, 3, 16)), cache=object()),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_options_the_reference_ignores_are_refused(what):
    with pytest.raises(NotImplementedError):
        REFUSED[what]()


def test_kdim_equal_to_embed_dim_is_accepted():
    pt.incubate.nn.FusedMultiHeadAttention(16, 2, kdim=16, vdim=16)


# ------------------------------------------------------------ segment ops

OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min")


def _segment(P, name, data, ids, grad):
    d = P.to_tensor(data, stop_gradient=not grad)
    out = getattr(P.incubate, name)(d, P.to_tensor(ids))
    res = [out.numpy(), out.dtype.name]
    if grad:
        r = np.random.RandomState(5).uniform(-1, 1, out.shape)
        (out * P.to_tensor(r.astype(np.float32))).sum().backward()
        res.append(d.grad.numpy())
    return res


def _hold_segment(name, data, ids, grad=True):
    want = _segment(ref, name, data, ids, grad)
    got = _segment(pt, name, data, ids, grad)
    assert got[1] == want[1], (name, got[1], want[1])
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert g.shape == w.shape
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    return got


@pytest.mark.parametrize("name", OPS)
def test_segments_unsorted_with_an_empty_segment(name):
    """Unsorted ids over 6 segments, segment 3 empty: 0 there for every
    reduction."""
    ids = np.array([5, 0, 2, 0, 4, 1, 2, 5, 0, 1], np.int64)
    got = _hold_segment(name, _x(10, 3), ids)
    assert got[0].shape == (6, 3)
    assert not got[0][3].any()


@pytest.mark.parametrize("ids_dtype", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", OPS)
def test_segments_of_integers(name, dtype, ids_dtype):
    """Integer data keeps its type (the mean: float32, float64 for int64)
    and the empty segment 1 is 0."""
    data = np.random.RandomState(2).randint(-50, 50, (7, 2)).astype(dtype)
    ids = np.array([0, 2, 2, 3, 0, 3, 3], ids_dtype)
    got = _hold_segment(name, data, ids, grad=False)
    assert not got[0][1].any()


@pytest.mark.parametrize("name", ["segment_max", "segment_min"])
def test_tied_extremes_share_the_gradient(name):
    """Three elements tie for segment 0's extreme in column 0 and two in
    column 1: each gets its share of the output's gradient, as in the
    reference."""
    v = 5.0 if name == "segment_max" else -5.0
    data = np.array([[v, 1.0], [v, v], [v, v], [0.0, 0.5], [2.0, 3.0]],
                    np.float32)
    ids = np.array([0, 0, 0, 0, 1])
    got = _hold_segment(name, data, ids)
    r = np.random.RandomState(5).uniform(-1, 1, (2, 2)).astype(np.float32)
    np.testing.assert_allclose(got[2][:3, 0], r[0, 0] / 3, rtol=1e-6)
    np.testing.assert_allclose(got[2][1:3, 1], r[0, 1] / 2, rtol=1e-6)


def test_no_segment_ids_give_no_segments():
    for P in (ref, pt):
        out = P.incubate.segment_sum(P.to_tensor(np.zeros((0, 3),
                                                          np.float32)),
                                     P.to_tensor(np.zeros(0, np.int64)))
        assert list(out.shape) == [0, 3]


# ------------------------------------ the fused functionals on Tensors

def _moe_args(P):
    rng = np.random.RandomState(7)
    return [P.to_tensor(a, stop_gradient=False) for a in (
        rng.randn(2, 8, 6).astype(np.float32),
        rng.uniform(-0.2, 0.2, (6, 4)).astype(np.float32),
        rng.uniform(-0.1, 0.1, (4, 6, 8)).astype(np.float32),
        rng.uniform(-0.1, 0.1, (4, 8, 6)).astype(np.float32))]


FUNCTIONALS = {
    "fused_rms_norm": (lambda F, x, w, b: F.fused_rms_norm(
        x, w, norm_bias=b, bias=b, residual=x, epsilon=1e-5), "xwb"),
    "swiglu_split": (lambda F, x, w, b: F.swiglu(x), "x"),
    "swiglu": (lambda F, x, w, b: F.swiglu(x, x * 0.5), "x"),
    "fused_layer_norm": (lambda F, x, w, b: F.fused_layer_norm(
        x, w, b, residual=x), "xwb"),
    "rope": (lambda F, x, w, b: F.fused_rotary_position_embedding(
        x.reshape([2, 3, 2, 8]), x.reshape([2, 3, 2, 8]) * 2.0), "x"),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS) + ["fused_moe"])
def test_fused_functionals_take_tensors(name):
    """``incubate.nn.functional`` on the eager API's ``Tensor``s, as a
    Paddle script calls it: outputs and gradients against the reference's
    (which routes them through its registered ops), fp32 1e-5."""
    got = []
    for P in (ref, pt):
        F = P.incubate.nn.functional
        if name == "fused_moe":
            args = _moe_args(P)
            outs = [F.fused_moe(*args)]
        else:
            fn, grads = FUNCTIONALS[name]
            x, w, b = (P.to_tensor(a, stop_gradient=False) for a in (
                _x(2, 3, 16), _x(16, seed=1), _x(16, seed=2)))
            args = [{"x": x, "w": w, "b": b}[c] for c in grads]
            outs = fn(F, x, w, b)
        outs = [o for o in (outs if isinstance(outs, (tuple, list))
                            else [outs]) if o is not None]
        loss = None
        for k, o in enumerate(outs):
            term = (o * P.to_tensor(_x(*o.shape, seed=20 + k))).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        got.append([o.numpy() for o in outs]
                   + [a.grad.numpy() for a in args])
    assert len(got[0]) == len(got[1])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
