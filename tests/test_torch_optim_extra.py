"""The optimizers of this slice against the JAX package's, on the CPU:
three steps of ``Adagrad``, ``RMSProp`` (plain; centered with momentum),
``Adadelta``, ``Adamax``, ``Lamb``, ``Adam``/``AdamW`` with ``amsgrad``
and ``AdamW`` with ``lr_ratio`` on a small MLP with the reference's
weights, parameters held at fp32 1e-6 absolute (as
``test_torch_eager_optimizer.py``); ``LBFGS`` on a least-squares problem
(a quadratic) at 1e-5; and the ``amp`` aliases, the same objects as their
targets.

Two options the reference accepts and ignores are held against the
reference's own parameter groups, which do what Paddle documents for
them: ``AdamW(lr_ratio=f)`` against groups whose ``learning_rate`` is
``f(param)``, and ``Lamb(exclude_from_weight_decay_fn=f)`` against groups
whose ``weight_decay`` is 0 where ``f(param)``.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _mlp(p):
    return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.LayerNorm(16),
                           p.nn.Linear(16, 4))


def _pair():
    ref.seed(1)
    rm, tm = _mlp(ref), _mlp(pt)
    tm.set_state_dict({k: np.array(v.numpy())
                       for k, v in rm.state_dict().items()})
    return rm, tm


def _loss(p, m, seed):
    r = np.random.RandomState(seed)
    x = p.to_tensor(r.randn(6, 8).astype(np.float32))
    w = p.to_tensor(r.randn(6, 4).astype(np.float32))
    return p.mean(m(x) * w) + p.mean(m(x) ** 2)


def _vector(param):
    return len(param.shape) == 1


def _split(m, key, value):
    """The reference's parameter groups: matrices, then vectors with
    ``{key: value}``."""
    ps = m.parameters()
    return [{"params": [q for q in ps if not _vector(q)]},
            {"params": [q for q in ps if _vector(q)], key: value}]


def same(make):
    return make, make


OPTS = {
    "adagrad": same(lambda p, m: p.optimizer.Adagrad(
        0.1, parameters=m.parameters(), weight_decay=0.01,
        initial_accumulator_value=0.1)),
    "rmsprop": same(lambda p, m: p.optimizer.RMSProp(
        0.01, rho=0.9, parameters=m.parameters())),
    "rmsprop_centered_momentum": same(lambda p, m: p.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=m.parameters(),
        weight_decay=0.01)),
    "adadelta": same(lambda p, m: p.optimizer.Adadelta(
        1.0, rho=0.9, parameters=m.parameters(), weight_decay=0.01)),
    "adamax": same(lambda p, m: p.optimizer.Adamax(
        0.01, beta1=0.8, parameters=m.parameters(), weight_decay=0.01)),
    "lamb": same(lambda p, m: p.optimizer.Lamb(
        0.01, lamb_weight_decay=0.05, parameters=m.parameters())),
    "lamb_exclude": (
        lambda p, m: p.optimizer.Lamb(
            0.01, lamb_weight_decay=0.05, parameters=m.parameters(),
            exclude_from_weight_decay_fn=_vector),
        lambda p, m: p.optimizer.Lamb(
            0.01, lamb_weight_decay=0.05,
            parameters=_split(m, "weight_decay", 0.0))),
    "adam_amsgrad": same(lambda p, m: p.optimizer.Adam(
        1e-2, parameters=m.parameters(), weight_decay=0.01, amsgrad=True)),
    "adamw_amsgrad": same(lambda p, m: p.optimizer.AdamW(
        1e-2, parameters=m.parameters(), amsgrad=True)),
    "adamw_lr_ratio": (
        lambda p, m: p.optimizer.AdamW(
            1e-2, parameters=m.parameters(), weight_decay=0.05,
            lr_ratio=lambda q: 0.25 if _vector(q) else 1.0),
        lambda p, m: p.optimizer.AdamW(
            1e-2, weight_decay=0.05,
            parameters=_split(m, "learning_rate", 0.25))),
}


@pytest.mark.parametrize("case", sorted(OPTS))
def test_three_steps_match_reference(case):
    rm, tm = _pair()
    make_port, make_ref = OPTS[case]
    ro, to = make_ref(ref, rm), make_port(pt, tm)
    for step in range(3):
        for p, m, o in ((ref, rm, ro), (pt, tm, to)):
            _loss(p, m, step).backward()
            o.step()
            o.clear_grad()
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.numpy(), np.array(rp.numpy()), rtol=0,
                                   atol=TOL, err_msg=name)


def test_lr_ratio_and_exclusion_change_the_step():
    """``lr_ratio`` is applied, not ignored: under a ratio of 0.25 the
    vectors' first step is a quarter of the plain one, the matrices'
    the same."""
    runs = {}
    for key in ("plain", "ratio"):
        _, tm = _pair()
        kw = dict(lr_ratio=lambda q: 0.25 if _vector(q) else 1.0) \
            if key == "ratio" else {}
        opt = pt.optimizer.AdamW(1e-2, parameters=tm.parameters(), **kw)
        before = [q.numpy().copy() for q in tm.parameters()]
        _loss(pt, tm, 0).backward()
        opt.step()
        runs[key] = [np.abs(q.numpy() - b).max()
                     for q, b in zip(tm.parameters(), before)]
    for q, a, b in zip(tm.parameters(), runs["plain"], runs["ratio"]):
        if _vector(q):
            np.testing.assert_allclose(b, 0.25 * a, rtol=1e-3)
        else:
            assert a == b


def test_lamb_state_and_no_host_read(monkeypatch):
    """Lamb's step reads nothing back: ``Tensor.item``/``tolist``/
    ``numpy`` and ``float`` of a tensor stay uncalled."""
    import torch
    _, tm = _pair()
    opt = pt.optimizer.Lamb(0.01, parameters=tm.parameters())
    _loss(pt, tm, 0).backward()
    reads = []
    for name in ("item", "tolist", "numpy", "__float__", "__bool__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _o=orig,
                            _n=name, **k: reads.append(_n) or _o(self, *a,
                                                                 **k))
    opt.step()
    monkeypatch.undo()
    assert not reads, reads
    assert sorted(k.rsplit(".", 1)[1] for k in opt.state_dict()
                  if k != "step") == sorted(["m", "v"] * len(tm.parameters()))


def _least_squares(p, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(20, 6).astype(np.float32)
    y = r.randn(20, 1).astype(np.float32)
    p.seed(0)
    layer = p.nn.Linear(6, 1, bias_attr=False)
    return layer, p.to_tensor(x), p.to_tensor(y), x, y


def test_lbfgs_on_a_quadratic_matches_reference():
    outs = []
    w0 = None
    for p in (ref, pt):
        layer, x, y, xn, yn = _least_squares(p)
        if w0 is None:
            w0 = np.array(layer.weight.numpy())
        layer.weight.set_value(w0)
        opt = p.optimizer.LBFGS(learning_rate=1.0, max_iter=20,
                                history_size=10,
                                parameters=layer.parameters())

        def closure():
            opt.clear_grad()
            loss = p.mean((layer(x) - y) ** 2)
            loss.backward()
            return loss
        for _ in range(2):
            loss = opt.step(closure)
        outs.append((np.array(layer.weight.numpy()),
                     float(np.asarray(loss.numpy()))))
    (w_pt, l_pt), (w_ref, l_ref) = outs[1], outs[0]
    np.testing.assert_allclose(w_pt, w_ref, rtol=1e-5, atol=1e-5)
    best = np.linalg.lstsq(xn.astype(np.float64), yn.astype(np.float64),
                           rcond=None)[0]
    np.testing.assert_allclose(w_pt, best, rtol=1e-3, atol=1e-3)
    assert abs(l_pt - l_ref) <= 1e-5 * max(1.0, abs(l_ref))


def test_lbfgs_needs_a_closure():
    layer, *_ = _least_squares(pt)
    opt = pt.optimizer.LBFGS(parameters=layer.parameters())
    with pytest.raises(ValueError, match="closure"):
        opt.step()


def test_amp_aliases_are_their_targets():
    for P in (pt, ref):
        assert P.amp.AmpScaler is P.amp.GradScaler
        assert P.amp.amp_guard is P.amp.auto_cast
        assert P.amp.autocast is P.amp.auto_cast
    for name in ("Adagrad", "RMSProp", "Adadelta", "Adamax", "Lamb",
                 "LBFGS"):
        assert issubclass(getattr(pt.optimizer, name),
                          pt.optimizer.Optimizer)
