"""The port's ``nn.MultiHeadAttention`` and Transformer layers against the
JAX package's, on the CPU, with the reference's weights crossed by
``set_state_dict({k: v.numpy() ...})``.

- ``MultiHeadAttention`` with a bool and a float mask, with an
  incremental ``Cache`` and a ``StaticCache``;
- ``TransformerEncoder``, ``TransformerDecoder`` and ``Transformer`` (2
  layers, d_model 32, 4 heads, pre- and post-norm): the forward and every
  parameter's gradient, and the loss of three AdamW steps (lr 1e-4:
  Adam magnifies rounding noise in a gradient that is 0 in exact
  arithmetic, a key bias);
- the attention dropout, held by its law: the train-mode output averages
  to the eval one;
- ``state_dict`` keys, the deep-copied layers, the causal mask, and the
  options the port refuses.

Limits: fp32, 1e-5 relative and absolute (forward, gradients, losses).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _pair(build):
    """The reference's layer and the port's, the port holding the
    reference's weights; both in eval mode (no dropout)."""
    rm, tm = build(ref), build(pt)
    state = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    return rm.eval(), tm.eval()


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grads_close(rm, tm):
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        assert (rp.grad is None) == (tp.grad is None), name
        if rp.grad is not None:
            _close(tp.grad.numpy(), rp.grad.numpy(), what=name)


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_mha_matches_reference(mask):
    rm, tm = _pair(lambda P: P.nn.MultiHeadAttention(32, 4, kdim=24,
                                                     vdim=16))
    q, k, v = _x(2, 5, 32), _x(2, 7, 24, seed=1), _x(2, 7, 16, seed=2)
    m = None
    if mask == "bool":
        m = np.random.RandomState(3).rand(2, 1, 5, 7) > 0.4
        m[..., 0] = True
    elif mask == "float":
        m = _x(2, 4, 5, 7, seed=3)
    outs = []
    for P, model in ((ref, rm), (pt, tm)):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out = model(*ts, attn_mask=None if m is None else P.to_tensor(m))
        (out * P.to_tensor(_x(2, 5, 32, seed=4))).sum().backward()
        outs.append([out.numpy()] + [t.grad.numpy() for t in ts])
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)
    _grads_close(rm, tm)


def test_mha_caches_match_reference():
    """An incremental Cache grown one step at a time, and a StaticCache
    of the memory's projections."""
    rm, tm = _pair(lambda P: P.nn.MultiHeadAttention(32, 4))
    seq, mem = _x(2, 4, 32), _x(2, 6, 32, seed=1)
    outs = []
    for P, model in ((ref, rm), (pt, tm)):
        MHA = P.nn.MultiHeadAttention
        cache = model.gen_cache(P.to_tensor(seq))
        steps = []
        for t in range(4):
            x = P.to_tensor(seq[:, t:t + 1])
            out, cache = model(x, x, x, None, cache)
            steps.append(out.numpy())
        static = model.gen_cache(P.to_tensor(mem), type=MHA.StaticCache)
        assert isinstance(static, MHA.StaticCache)
        assert isinstance(cache, MHA.Cache)
        outs.append(steps + [cache.k.numpy(), cache.v.numpy(),
                             static.k.numpy(), static.v.numpy()])
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)


def _encoder(P, pre=False):
    layer = P.nn.TransformerEncoderLayer(32, 4, 64, dropout=0.1,
                                         normalize_before=pre)
    return P.nn.TransformerEncoder(layer, 2, P.nn.LayerNorm(32)
                                   if pre else None)


def _decoder(P, pre=False):
    layer = P.nn.TransformerDecoderLayer(32, 4, 64, dropout=0.1,
                                         activation="gelu",
                                         normalize_before=pre)
    return P.nn.TransformerDecoder(layer, 2, P.nn.LayerNorm(32)
                                   if pre else None)


@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_encoder_forward_and_gradients(pre):
    rm, tm = _pair(lambda P: _encoder(P, pre))
    src = _x(2, 6, 32)
    mask = np.tril(np.ones((6, 6), bool))
    outs = []
    for P, model in ((ref, rm), (pt, tm)):
        x = P.to_tensor(src, stop_gradient=False)
        out = model(x, P.to_tensor(mask))
        (out * P.to_tensor(_x(2, 6, 32, seed=5))).sum().backward()
        outs.append((out.numpy(), x.grad.numpy()))
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)
    _grads_close(rm, tm)


def test_encoder_layer_cache():
    rm, tm = _pair(lambda P: _encoder(P))
    src = _x(2, 3, 32)
    outs = []
    for P, model in ((ref, rm), (pt, tm)):
        cache = model.gen_cache(P.to_tensor(src))
        out, cache = model(P.to_tensor(src), None, cache)
        outs.append([out.numpy(), cache[1].k.numpy()])
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)


@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_decoder_forward_and_gradients(pre):
    rm, tm = _pair(lambda P: _decoder(P, pre))
    tgt, mem = _x(2, 5, 32), _x(2, 7, 32, seed=1)
    outs = []
    for P, model in ((ref, rm), (pt, tm)):
        t = P.to_tensor(tgt, stop_gradient=False)
        m = P.to_tensor(mem, stop_gradient=False)
        mask = P.nn.Transformer.generate_square_subsequent_mask(5)
        out = model(t, m, tgt_mask=mask)
        (out * P.to_tensor(_x(2, 5, 32, seed=6))).sum().backward()
        outs.append((out.numpy(), t.grad.numpy(), m.grad.numpy()))
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)
    _grads_close(rm, tm)


def _transformer(P):
    return P.nn.Transformer(32, 4, 2, 2, 64, dropout=0.1)


def _seq_loss(P, model, step):
    r = np.random.RandomState(10 + step)
    src = P.to_tensor(r.randn(2, 6, 32).astype(np.float32))
    tgt = P.to_tensor(r.randn(2, 5, 32).astype(np.float32))
    lbl = P.to_tensor(r.randint(0, 32, (2, 5)))
    mask = model.generate_square_subsequent_mask(5)
    out = model(src, tgt, tgt_mask=mask)
    return P.nn.functional.cross_entropy(out, lbl, label_smoothing=0.1)


def test_transformer_forward_and_gradients():
    rm, tm = _pair(_transformer)
    losses = []
    for P, model in ((ref, rm), (pt, tm)):
        loss = _seq_loss(P, model, 0)
        loss.backward()
        losses.append(float(loss.numpy()))
    _close(losses[1], losses[0])
    _grads_close(rm, tm)


def test_transformer_three_adamw_steps():
    rm, tm = _pair(_transformer)
    opts = [P.optimizer.AdamW(1e-4, beta1=0.9, beta2=0.98, epsilon=1e-9,
                              parameters=m.parameters())
            for P, m in ((ref, rm), (pt, tm))]
    for step in range(3):
        got = []
        for (P, m), o in zip(((ref, rm), (pt, tm)), opts):
            loss = _seq_loss(P, m, step)
            loss.backward()
            o.step()
            o.clear_grad()
            got.append(float(loss.numpy()))
        _close(got[1], got[0], what=f"step {step}")
    # a key projection's bias has a gradient of 0 in exact arithmetic
    # (softmax ignores a shift of every logit of a row): Adam turns its
    # rounding noise into steps of lr, so those are not compared
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        if not name.endswith("k_proj.bias"):
            _close(tp.numpy(), rp.numpy(), what=name)


def test_state_dict_keys_and_deep_copies():
    tm = _transformer(pt)
    keys = list(tm.state_dict())
    assert "encoder.layers.1.self_attn.q_proj.weight" in keys
    assert "decoder.layers.0.cross_attn.out_proj.bias" in keys
    assert keys == list(_transformer(ref).state_dict())
    a = tm.encoder.layers[0].linear1.weight
    b = tm.encoder.layers[1].linear1.weight
    assert a is not b and np.array_equal(a.numpy(), b.numpy())


def test_square_subsequent_mask():
    m = pt.nn.Transformer.generate_square_subsequent_mask(4)
    assert m.dtype == pt.bool
    np.testing.assert_array_equal(
        m.numpy(), ref.nn.Transformer.generate_square_subsequent_mask(
            4).numpy())


def test_attention_dropout_keeps_the_expectation():
    """In training, the attention dropout (p 0.3, MultiHeadAttention's
    own) is unbiased: the mean of 400 train-mode outputs is the eval
    output within five standard errors of each element; each draw
    differs from the eval output."""
    mha = pt.nn.MultiHeadAttention(16, 2, dropout=0.3)
    x = pt.to_tensor(_x(1, 6, 16))
    want = mha.eval()(x).numpy()
    mha.train()
    draws = np.stack([mha(x).numpy() for _ in range(400)])
    assert not np.allclose(draws[0], want)
    se = draws.std(0) / np.sqrt(len(draws))
    assert (np.abs(draws.mean(0) - want) <= 5 * se + 1e-6).all()


def test_dropout_layers_in_training_use_the_generator():
    layer = pt.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.5)
    x = pt.to_tensor(_x(2, 4, 16))
    pt.seed(1)
    a = layer(x).numpy()
    pt.seed(1)
    np.testing.assert_array_equal(layer(x).numpy(), a)
    assert not np.allclose(layer.eval()(x).numpy(), a)


@pytest.mark.parametrize("what", ["need_weights", "decoder_cache",
                                  "decoder_layer_cache"])
def test_options_the_reference_ignores_are_refused(what):
    t = pt.to_tensor(_x(1, 3, 16))
    with pytest.raises(NotImplementedError):
        if what == "need_weights":
            pt.nn.MultiHeadAttention(16, 2, need_weights=True)
        elif what == "decoder_cache":
            layer = pt.nn.TransformerDecoderLayer(16, 2, 32)
            pt.nn.TransformerDecoder(layer, 1)(t, t, cache=[None])
        else:
            pt.nn.TransformerDecoderLayer(16, 2, 32)(t, t, cache=object())
