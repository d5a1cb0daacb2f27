"""The port's recurrent layers against the JAX package's, on the CPU,
with the reference's weights crossed by ``set_state_dict``: the cells
against numpy's formulas (mirroring ``tests/test_rnn.py``), and
``SimpleRNN`` / ``LSTM`` / ``GRU`` forward and backward (one and two
directions, one and two layers, batch- and time-major, with and without
initial states), their outputs, final-state packing ``[layers x
directions, B, H]``, input and every parameter's gradient; the refused
``sequence_length`` and ``proj_size``.

Limits: fp32, 1e-5 relative and absolute.
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


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def test_lstm_cell_matches_numpy():
    cell = pt.nn.LSTMCell(4, 8)
    x, h0, c0 = _x(2, 4), _x(2, 8, seed=1), _x(2, 8, seed=2)
    out, (h, c) = cell(pt.to_tensor(x), (pt.to_tensor(h0),
                                         pt.to_tensor(c0)))
    wih, whh, bih, bhh = (getattr(cell, n).numpy() for n in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    i, f, g, o = np.split(x @ wih.T + bih + h0 @ whh.T + bhh, 4, -1)
    c_ref = _sig(f) * c0 + _sig(i) * np.tanh(g)
    h_ref = _sig(o) * np.tanh(c_ref)
    _close(h.numpy(), h_ref)
    _close(c.numpy(), c_ref)
    _close(out.numpy(), h_ref)


def test_gru_cell_matches_numpy():
    cell = pt.nn.GRUCell(4, 6)
    x, h0 = _x(3, 4, seed=1), _x(3, 6, seed=2)
    out, h = cell(pt.to_tensor(x), pt.to_tensor(h0))
    wih, whh, bih, bhh = (getattr(cell, n).numpy() for n in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    xr, xz, xc = np.split(x @ wih.T + bih, 3, -1)
    hr, hz, hc = np.split(h0 @ whh.T + bhh, 3, -1)
    r, z = _sig(xr + hr), _sig(xz + hz)
    c = np.tanh(xc + r * hc)
    _close(h.numpy(), (1 - z) * c + z * h0)
    _close(out.numpy(), h.numpy())


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_simple_rnn_cell_matches_numpy(act):
    cell = pt.nn.SimpleRNNCell(4, 5, activation=act)
    x, h0 = _x(3, 4), _x(3, 5, seed=1)
    out, h = cell(pt.to_tensor(x), pt.to_tensor(h0))
    z = x @ cell.weight_ih.numpy().T + cell.bias_ih.numpy() \
        + h0 @ cell.weight_hh.numpy().T + cell.bias_hh.numpy()
    _close(h.numpy(), np.tanh(z) if act == "tanh" else np.maximum(z, 0))


def _pair(kind, **kw):
    rm = getattr(ref.nn, kind)(**kw)
    tm = getattr(pt.nn, kind)(**kw)
    state = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    tm.set_state_dict(state)
    return rm, tm


def _states(kind, layers, dirs, batch, hidden, seed=7):
    h = _x(layers * dirs, batch, hidden, seed=seed)
    if kind == "LSTM":
        return h, _x(layers * dirs, batch, hidden, seed=seed + 1)
    return (h,)


CONFIGS = [
    # kind, layers, direction, time_major, initial states
    (k, n, d, tm, init)
    for k in ("SimpleRNN", "LSTM", "GRU")
    for n, d, tm, init in ((1, "forward", False, False),
                           (2, "bidirect", False, True),
                           (2, "forward", True, True),
                           (1, "bidirectional", True, False))]


@pytest.mark.parametrize("kind,layers,direction,time_major,init", CONFIGS,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{'tm' if c[3] else 'bm'}"
                              f"{'-h0' if c[4] else ''}" for c in CONFIGS])
def test_rnn_layers_match_reference(kind, layers, direction, time_major,
                                    init):
    batch, steps, inp, hidden = 3, 5, 4, 6
    dirs = 2 if direction.startswith("bidirect") else 1
    rm, tm = _pair(kind, input_size=inp, hidden_size=hidden,
                   num_layers=layers, direction=direction,
                   time_major=time_major)
    shape = (steps, batch, inp) if time_major else (batch, steps, inp)
    x = _x(*shape, seed=3)
    st = _states(kind, layers, dirs, batch, hidden)
    got = []
    for P, model in ((ref, rm), (pt, tm)):
        xs = P.to_tensor(x, stop_gradient=False)
        s0 = [P.to_tensor(a, stop_gradient=False) for a in st]
        init_states = None if not init else (
            tuple(s0) if kind == "LSTM" else s0[0])
        y, final = model(xs, init_states)
        finals = list(final) if kind == "LSTM" else [final]
        for f in finals:
            assert f.shape == [layers * dirs, batch, hidden]
        assert y.shape == list(shape[:2]) + [hidden * dirs]
        loss = (y * P.to_tensor(_x(*y.shape, seed=4))).sum()
        for k, f in enumerate(finals):
            loss = loss + (f * P.to_tensor(_x(*f.shape, seed=5 + k))).sum()
        loss.backward()
        got.append([y.numpy()] + [f.numpy() for f in finals]
                   + [xs.grad.numpy()]
                   + ([s.grad.numpy() for s in s0] if init else []))
    for k, (g, w) in enumerate(zip(got[1], got[0])):
        _close(g, w, what=str(k))
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        _close(tp.grad.numpy(), rp.grad.numpy(), what=name)


def test_rnn_and_birnn_wrappers_match_reference():
    x = _x(2, 4, 3)
    got = []
    for P in (ref, pt):
        fw, bw = P.nn.GRUCell(3, 5), P.nn.GRUCell(3, 5)
        if P is pt:
            for cell, rc in zip((fw, bw), cells):
                cell.set_state_dict({k: np.array(v.numpy()) for k, v in
                                     rc.state_dict().items()})
        else:
            cells = (fw, bw)
        y, (s_fw, s_bw) = P.nn.BiRNN(fw, bw)(P.to_tensor(x))
        yr, sr = P.nn.RNN(fw, is_reverse=True)(P.to_tensor(x))
        got.append([y.numpy(), s_fw.numpy(), s_bw.numpy(), yr.numpy(),
                    sr.numpy()])
    for g, w in zip(got[1], got[0]):
        _close(g, w)


def test_dropout_between_layers_uses_the_generator():
    lstm = pt.nn.LSTM(4, 6, num_layers=2, dropout=0.5)
    x = pt.to_tensor(_x(2, 3, 4))
    pt.seed(2)
    a = lstm(x)[0].numpy()
    pt.seed(2)
    np.testing.assert_array_equal(lstm(x)[0].numpy(), a)
    assert not np.allclose(lstm.eval()(x)[0].numpy(), a)


def test_parameter_names_match_reference():
    for kind in ("SimpleRNN", "LSTM", "GRU"):
        kw = dict(input_size=3, hidden_size=4, num_layers=2,
                  direction="bidirect")
        assert list(getattr(pt.nn, kind)(**kw).state_dict()) == \
            list(getattr(ref.nn, kind)(**kw).state_dict())


@pytest.mark.parametrize("what", ["rnn", "birnn", "lstm", "gru",
                                  "simple_rnn", "proj_size"])
def test_options_the_reference_ignores_are_refused(what):
    """The reference takes ``sequence_length`` and runs every sequence to
    the full length; the port refuses it (and ``proj_size``)."""
    x = pt.to_tensor(_x(2, 3, 4))
    lens = pt.to_tensor(np.array([3, 2]))
    with pytest.raises(NotImplementedError):
        if what == "rnn":
            pt.nn.RNN(pt.nn.LSTMCell(4, 5))(x, sequence_length=lens)
        elif what == "birnn":
            pt.nn.BiRNN(pt.nn.GRUCell(4, 5), pt.nn.GRUCell(4, 5))(
                x, sequence_length=lens)
        elif what == "proj_size":
            pt.nn.LSTMCell(4, 5, proj_size=2)
        else:
            layer = {"lstm": pt.nn.LSTM, "gru": pt.nn.GRU,
                     "simple_rnn": pt.nn.SimpleRNN}[what](4, 5)
            layer(x, sequence_length=lens)
