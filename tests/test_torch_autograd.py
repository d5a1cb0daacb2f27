"""The port's ``paddle.autograd`` (``PyLayer``, ``backward``, ``grad``)
and ``Tensor.register_hook`` against the JAX package's, on the CPU.

Mirrors the reference's own cases (``tests/test_autograd.py``
``test_register_hook`` / ``test_pylayer``, ``tests/test_review_regressions
.py``'s ``PyLayer`` cases) and holds the port's results against the
reference's on the same inputs (fp32, exact where both compute the same
few products, else 1e-6).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _both(fn):
    """``fn(P)`` for the reference and the port, as numpy."""
    out = []
    for P in (ref, pt):
        res = fn(P)
        out.append([np.asarray(r.numpy() if hasattr(r, "numpy") else r)
                    for r in (res if isinstance(res, (list, tuple))
                              else [res])])
    return out


def _close(fn, tol=1e-6):
    want, got = _both(fn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _double(P):
    class Double(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, gy):
            return gy * 2
    return Double


def test_pylayer():
    def run(P):
        x = P.to_tensor([1.5], stop_gradient=False)
        _double(P).apply(x).sum().backward()
        return x.grad
    _close(run)
    np.testing.assert_allclose(_both(run)[1][0], [2.0])


def test_register_hook():
    def run(P):
        x = P.to_tensor([1.0], stop_gradient=False)
        seen = []

        def hook(g):
            seen.append(g.numpy().copy())
            return g * 2

        x.register_hook(hook)
        (x * 5).sum().backward()
        return seen[0], x.grad
    _close(run)
    np.testing.assert_allclose(_both(run)[1][1], [10.0])


def test_register_hook_returning_none_keeps_the_gradient():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: seen.append(g.numpy().copy()))
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    h.remove()
    x.clear_grad()
    (x * 3).sum().backward()
    assert len(seen) == 1


def test_engine_decrements_on_none_grad():
    """A PyLayer whose backward returns None for one input: the other
    path's gradient still reaches it."""
    def run(P):
        class TakeFirst(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, u, v):
                return u * 1.0

            @staticmethod
            def backward(ctx, g):
                return g, None

        a = P.to_tensor([2.0], stop_gradient=False)
        b = a * 3
        c = (b * b).sum()
        x = P.to_tensor([1.0], stop_gradient=False)
        d = TakeFirst.apply(x, b).sum()
        (c + d).backward()
        return a.grad, x.grad
    _close(run)
    np.testing.assert_allclose(_both(run)[1][0], [36.0])


def test_fewer_gradients_are_padded_with_none():
    def run(P):
        class First(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, u, v, w):
                return u * v + w

            @staticmethod
            def backward(ctx, g):
                return g * 4.0  # one gradient for three edges

        u, v, w = (P.to_tensor([1.0, 2.0], stop_gradient=False)
                   for _ in range(3))
        First.apply(u, v, w).sum().backward()
        return u.grad, v.grad is None, w.grad is None
    _close(run)


def test_pylayer_mark_non_differentiable():
    def run(P):
        class WithAux(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, u):
                aux = u * 100.0
                ctx.mark_non_differentiable(aux)
                return u * 2.0, aux

            @staticmethod
            def backward(ctx, g):
                return g * 2.0

        x = P.to_tensor([1.0], stop_gradient=False)
        y, aux = WithAux.apply(x)
        flags = (aux.stop_gradient, y.stop_gradient)
        y.sum().backward()
        return x.grad, flags
    (gw, fw), (gp, fp) = _both(run)
    np.testing.assert_allclose(gp, gw)
    assert tuple(fp) == tuple(fw) == (True, False)


def test_only_positional_tensors_are_edges_and_forward_has_no_graph():
    """A ``Tensor`` passed by keyword gets no gradient; forward runs under
    no_grad; ``saved_tensor`` is a property, ``saved_tensors()`` a
    method; an integer output gets no gradient."""
    seen = {}

    class Scale(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=None):
            seen["grad_on"] = pt.is_grad_enabled()
            ctx.save_for_backward(x, k)
            return x * k, (x > 0).astype("int64")

        @staticmethod
        def backward(ctx, gy, gi):
            x, k = ctx.saved_tensor
            assert ctx.saved_tensors()[1] is k
            seen["gi"] = gi
            return gy * k

    x = pt.to_tensor([1.0, -2.0], stop_gradient=False)
    k = pt.to_tensor([3.0, 4.0], stop_gradient=False)
    y, pos = Scale.apply(x, k=k)
    assert seen["grad_on"] is False
    assert pos.stop_gradient and not y.stop_gradient
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 4.0])
    assert k.grad is None
    assert seen["gi"] is not None  # materialised zeros, as the reference


def test_no_grad_inputs_make_no_graph():
    x = pt.to_tensor([1.0])
    y = _double(pt).apply(x)
    assert y.stop_gradient
    with pt.no_grad():
        z = _double(pt).apply(pt.to_tensor([1.0], stop_gradient=False))
    assert z.stop_gradient


def _step(P, use_pylayer, hook=True):
    """A small two-layer step: a hook halves the first product's
    gradient, and the cube of its tanh is a PyLayer with a hand-written
    backward (or the same expression in ops)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 6).astype(np.float32)
    w1 = rng.randn(6, 5).astype(np.float32)
    w2 = rng.randn(5, 3).astype(np.float32)

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, h):
            ctx.save_for_backward(h)
            return h * h * h

        @staticmethod
        def backward(ctx, g):
            (h,) = ctx.saved_tensor
            return g * 3.0 * h * h

    a = P.to_tensor(w1, stop_gradient=False)
    b = P.to_tensor(w2, stop_gradient=False)
    h = P.matmul(P.to_tensor(xs), a)
    if hook:
        h.register_hook(lambda g: g * 0.5)
    t = P.tanh(h)
    loss = P.matmul(Cube.apply(t) if use_pylayer else t * t * t, b).sum()
    loss.backward()
    return loss, a.grad, b.grad


def test_pylayer_and_hook_in_a_step():
    """The port's step through the PyLayer gives the gradients of the
    same step in ops (1e-6); without the hook those equal the reference's
    (1e-5), and the hook halves the first weight's gradient alone. The
    reference's own PyLayer drops the gradient of an input that an op
    produced (``a.grad`` is None there), and a hook on an op's output
    leaves its gradients as they were: so it is held in ops, unhooked."""
    _close(lambda P: _step(P, False, hook=False), 1e-5)
    got = [t.numpy() for t in _step(pt, True)]
    want = [t.numpy() for t in _step(pt, False)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    plain = [t.numpy() for t in _step(ref, False, hook=False)]
    np.testing.assert_allclose(got[1], plain[1] * 0.5, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[2], plain[2], rtol=1e-5, atol=1e-5)


def test_backward_and_grad_match_reference():
    def run(P):
        x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        y = x * x
        (g,) = P.autograd.grad(y.sum(), x, retain_graph=True)
        P.autograd.backward([y], [P.to_tensor([1.0, 0.5, 0.25])])
        return g, x.grad
    _close(run)


def test_autograd_names():
    assert pt.autograd.run_backward is pt.autograd.backward
    assert issubclass(pt.autograd.LegacyPyLayer, pt.autograd.PyLayer)
    assert type(pt.autograd.PyLayer) is pt.autograd.PyLayerMeta
    ctx = pt.autograd.PyLayerContext()
    ctx.set_materialize_grads(False)
    ctx.mark_not_inplace(1)
    assert not ctx.materialize_grads and ctx.not_inplace_tensors == (1,)
