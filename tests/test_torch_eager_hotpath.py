"""The eager hot path of the port's runtime against the reference's, on
the CPU: the counterpart of ``tests/test_eager_hotpath.py``, test for test.

A steady training step under the ambient window runs as one fused
forward+backward (``lazy.try_fused_backward``, the step cache
``_FUSED_CACHE``) plus one optimizer update: at most 2 executions a step
(``dispatch.exec_count``), no runner built after warm-up. The port's
window is off by default (ROADMAP.md §3): its side turns it on, the
reference runs at its default (on).

The reference's donation reads in the port as "no per-step copy of a
parameter": the update writes parameters and moments in place, so each
``data_ptr()`` stays; a buffer tied into two places is updated once; a
dead or overwritten input's buffer is released by its reference count.
Two reference tests have no counterpart: ``FLAGS_optimizer_donate_params``
(the port has no copying update to choose) and the lowered module's
``tf.aliasing_output`` count (no XLA). A ``detach()`` snapshot of a
parameter shares its storage in the port, as torch's ``detach`` does,
where the reference's keeps the old buffer: a snapshot meant to outlive
an update is taken with ``clone()`` (``test_optimizer_update_spares_
param_snapshots``).

Values: the same 3-layer MLP from the reference's weights, six Adam steps
at lr 1e-3: losses 1e-5 relative (fp32, other summation orders); the
port's fused path against its own per-op path bit-equal.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import dispatch as ref_dispatch
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import dispatch as pt_dispatch
from paddle_tpu_torch._core import lazy as pt_lazy


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture
def fusion():
    """The port's ambient window on for the test (the reference's is on by
    default), off again after."""
    pt_lazy.enable_eager_fusion(True)
    try:
        yield
    finally:
        pt_lazy.enable_eager_fusion(False)


def _weights(seed):
    ref.seed(seed)
    net = ref.nn.Sequential(ref.nn.Linear(8, 16), ref.nn.ReLU(),
                            ref.nn.Linear(16, 4))
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def _train_setup(paddle, seed=0):
    nn, F = paddle.nn, paddle.nn.functional
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    net.set_state_dict({k: paddle.to_tensor(v)
                        for k, v in _weights(seed).items()})
    opt = paddle.optimizer.Adam(1e-3, parameters=net.parameters())
    r = np.random.RandomState(seed)
    x = paddle.to_tensor(r.randn(16, 8).astype("float32"))
    y = paddle.to_tensor(r.randint(0, 4, (16,)).astype("int64"))

    def step():
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.numpy())
    return net, opt, step


SIDES = [(ref, ref_lazy, ref_dispatch), (pt, pt_lazy, pt_dispatch)]


def test_steady_state_two_executions_per_step(fusion):
    assert ref_lazy.eager_fusion_enabled() and pt_lazy.eager_fusion_enabled()
    got = []
    for paddle, lazy, dispatch in SIDES:
        _, _, step = _train_setup(paddle)
        for _ in range(3):
            step()
        ctx = lazy.current_context()
        seg0 = ctx.segments_run
        n0 = dispatch.exec_count()
        for _ in range(5):
            step()
        got.append(((dispatch.exec_count() - n0) / 5,
                    ctx.segments_run - seg0, ctx.breaks[-5:]))
    assert got[1] == got[0] == (2.0, 5, ["backward_fused"] * 5)


def test_step_cache_hits_no_recompile(fusion):
    """Steady replay builds no runner: the step and segment caches stay
    flat (the reference's segment-backward cache has no port counterpart:
    torch's autograd runs the backward)."""
    for paddle, lazy, _ in SIDES:
        _, _, step = _train_setup(paddle, seed=1)
        for _ in range(3):
            step()
        sizes0 = (len(lazy._FUSED_CACHE), len(lazy._SEG_CACHE))
        for _ in range(4):
            step()
        assert (len(lazy._FUSED_CACHE), len(lazy._SEG_CACHE)) == sizes0


def test_optimizer_updates_param_and_state_buffers_in_place(fusion):
    """The counterpart of the reference's donated update: every parameter
    and every Adam moment keeps its storage across steps, and the values
    track the reference's."""
    net, opt, step = _train_setup(pt, seed=2)
    rnet, _, rstep = _train_setup(ref, seed=2)
    step()
    rstep()
    params = [p for p in net.parameters() if not p.stop_gradient]
    ptrs = [p._t.data_ptr() for p in params]
    states = [{k: v.data_ptr() for k, v in opt._states[id(p)].items()}
              for p in params]
    for _ in range(3):
        step()
        rstep()
    assert [p._t.data_ptr() for p in params] == ptrs
    assert [{k: v.data_ptr() for k, v in opt._states[id(p)].items()}
            for p in params] == states
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              rnet.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_tied_buffers_never_donated(fusion):
    """One parameter listed twice (tied): the reference picks its
    non-donating update, whose two outputs agree; the port writes the
    buffer once. Both equal one update of the untied parameter."""
    got = []
    for paddle, _, _ in SIDES:
        out = []
        for tied in (True, False):
            w = paddle.to_tensor(np.ones((4,), "float32"),
                                 stop_gradient=False)
            opt = paddle.optimizer.SGD(0.5, parameters=[w, w] if tied
                                       else [w])
            (w * 3.0).sum().backward()
            opt.step()
            out.append(w.numpy().copy())
        got.append(out)
    for tied, untied in got:
        np.testing.assert_array_equal(tied, untied)
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_array_equal(got[1][0], np.full((4,), -0.5))


def test_segment_releases_overwritten_input():
    """The in-place ``param.copy_(new)`` pattern: the reference donates
    the orphaned old buffer into the segment; the port's is released by
    its reference count once the segment ran."""
    import weakref
    pt_lazy.clear_segment_cache()
    with pt_lazy.lazy_guard():
        w = pt.to_tensor(np.ones((8, 8), "float32"))
        old = weakref.ref(w._payload)
        w.set_value(w * 0.9)
    assert old() is None
    np.testing.assert_allclose(w.numpy(), np.full((8, 8), 0.9), rtol=1e-6)
    ref_lazy.clear_segment_cache()
    with ref_lazy.lazy_guard():
        rw = ref.to_tensor(np.ones((8, 8), "float32"))
        rw.set_value(rw * 0.9)
    np.testing.assert_array_equal(w.numpy(), rw.numpy())


def test_segment_donation_spares_live_aliases():
    """A detach() alias of a tensor overwritten in place keeps the old
    values."""
    got = []
    for paddle, lazy, _ in SIDES:
        lazy.clear_segment_cache()
        with lazy.lazy_guard():
            w = paddle.to_tensor(np.ones((8, 8), "float32"))
            snap = w.detach()
            w.set_value(w * 0.9)
        got.append((w.numpy(), snap.numpy()))
    for w, snap in got:
        np.testing.assert_allclose(w, np.full((8, 8), 0.9), rtol=1e-6)
        np.testing.assert_array_equal(snap, np.ones((8, 8)))


def test_optimizer_update_spares_param_snapshots(fusion):
    """A checkpoint-style snapshot taken before ``step()`` keeps its
    values (the reference's ``detach()`` one; the port's ``clone()``, since
    its ``detach()`` shares the storage the update writes)."""
    for paddle, take in ((ref, lambda p: p.detach()),
                         (pt, lambda p: p.clone())):
        net, _, step = _train_setup(paddle, seed=6)
        step()
        params = [p for p in net.parameters() if not p.stop_gradient]
        snaps = [(take(p), p.numpy().copy()) for p in params]
        step()
        for snap, before in snaps:
            np.testing.assert_array_equal(snap.numpy(), before)
        assert any((p.numpy() != before).any()
                   for p, (_, before) in zip(params, snaps))


@pytest.mark.parametrize("window", [False, True])
def test_scalar_cache_keeps_signed_zero(window):
    """-0.0 and 0.0 hash equal: the record-time metadata cache keys floats
    by their bits, so one never stands in for the other."""
    for paddle, lazy, _ in SIDES:
        old = lazy.eager_fusion_enabled()
        lazy.enable_eager_fusion(window or paddle is ref)
        try:
            t = paddle.to_tensor(np.ones((1,), "float32"))
            _ = (t * 0.0).numpy()
            got = (t / -0.0).numpy()
        finally:
            lazy.enable_eager_fusion(old)
        assert np.isneginf(got).all(), got


def test_fused_backward_grad_parity():
    """The fused step against per-op dispatch: the port bit-equal to
    itself, and to the reference at 1e-5."""
    def run(paddle, lazy, fusion):
        old = lazy.eager_fusion_enabled()
        lazy.enable_eager_fusion(fusion)
        try:
            _, _, step = _train_setup(paddle, seed=5)
            return [step() for _ in range(6)]
        finally:
            lazy.enable_eager_fusion(old)
    on, off = run(pt, pt_lazy, True), run(pt, pt_lazy, False)
    assert on == off
    np.testing.assert_allclose(on, run(ref, ref_lazy, True), rtol=1e-5)
    np.testing.assert_allclose(run(ref, ref_lazy, False),
                               run(ref, ref_lazy, True), rtol=1e-5)


def test_fused_backward_consumes_graph_second_backward_raises(fusion):
    """retain_graph=False: a second backward() on the same root raises the
    generic engine's 'second time' error in both."""
    for paddle, lazy, _ in SIDES:
        x = paddle.to_tensor(np.ones((3,), "float32"))
        x.stop_gradient = False
        loss = (x * 2.0).sum()
        loss.backward()
        assert lazy.current_context().breaks[-1] == "backward_fused"
        np.testing.assert_array_equal(x.grad.numpy(), np.full((3,), 2.0))
        with pytest.raises(RuntimeError, match="second time"):
            loss.backward()


def test_fused_backward_falls_back_when_grads_flow_beyond_segment(fusion):
    """A gradient chain that crosses a segment boundary (h flushed, then
    used) takes the generic engine in both; gradients equal one eager
    graph's."""
    r0, r1 = np.random.RandomState(0), np.random.RandomState(1)
    x_np = r0.randn(4, 4).astype("float32")
    w_np = r1.randn(4, 4).astype("float32")
    got = []
    for paddle, lazy, dispatch in SIDES:
        F = paddle.nn.functional
        x = paddle.to_tensor(x_np)
        w = paddle.to_tensor(w_np)
        w.stop_gradient = False
        h = paddle.matmul(x, w)
        _ = h.numpy()
        ctx = lazy.current_context()
        b0 = len(ctx.breaks)
        loss = F.relu(h).sum()
        loss.backward()
        assert "backward_fused" not in ctx.breaks[b0:]
        got.append(w.grad.numpy())
    w2 = pt.to_tensor(w_np, stop_gradient=False)
    pt.nn.functional.relu(pt.matmul(pt.to_tensor(x_np), w2)).sum() \
        .backward()
    np.testing.assert_allclose(got[1], w2.grad.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)
