"""The port's async flush pipeline (``_core/async_flush.py``,
``FLAGS_async_flush``) against the reference's, on the CPU: the
counterpart of ``tests/test_async_flush.py``.

A cap- or guard-exit-sealed segment runs on one FIFO worker; live outputs
are ``PendingValue``s until read. The pipeline only moves work in time:
async on and off are bit-equal. The port's window is off by default
(ROADMAP.md §3), so its side turns the ambient window on with the flag
(the reference's is on by default).

Values: the same inputs on both sides; the chains are fp32 elementwise
arithmetic, held at 1e-5 relative against the reference (its compiled
segment may contract a multiply and an add into one rounding where the
port rounds twice: 1.2e-6 seen after 40 steps) and bit-equal between the
port's async and sync runs. LeNet: the reference's weights
moved to the port, four Adam steps, losses 1e-5 relative against the
reference (fp32 convolutions sum in other orders), bit-equal async on
against off in the port.

No counterpart yet, each waiting for its plane: the injected
``segment::compile`` fault keeping ``TransientFault`` (the resilience
plane, ROADMAP.md §1 item 8), the sanitizer's error- and warn-mode sweeps
on the worker (the analysis plane, item 9), and ``ElasticStep``'s drain
around rollback (item 8). A foreign worker error re-raises with its own
type in the port (the reference wraps it in ``EnforceNotMet``).
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import async_flush as ref_af
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu_torch._core import async_flush as pt_af
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import lazy as pt_lazy

SIDES = [(ref, ref_lazy, ref_af), (pt, pt_lazy, pt_af)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


class _Flags:
    """Sets flags on one package (and the port's window with them), puts
    them back after."""

    def __init__(self, paddle, **flags):
        self.paddle, self.flags = paddle, flags

    def __enter__(self):
        self.old = self.paddle.get_flags(list(self.flags))
        self.paddle.set_flags(self.flags)

    def __exit__(self, *exc):
        self.paddle.set_flags(self.old)


def _async(paddle, cap=16, on=True):
    flags = {"FLAGS_async_flush": on, "FLAGS_lazy_max_segment_ops": cap}
    if paddle is pt:
        flags["FLAGS_eager_fusion"] = True
    return _Flags(paddle, **flags)


@pytest.fixture(autouse=True)
def _drained():
    yield
    ref_af.drain(raise_latched=False)
    pt_af.drain(raise_latched=False)


def _lenet_weights():
    ref.seed(0)
    from paddle_tpu.vision.models import LeNet
    return {k: np.array(v.numpy()) for k, v in LeNet().state_dict().items()}


def _lenet_losses_params(paddle, weights, steps=4):
    from importlib import import_module
    lenet = import_module(paddle.__name__ + ".vision.models").LeNet
    F = paddle.nn.functional
    model = lenet()
    model.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(8, 1, 28, 28).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 10, (8,)).astype(np.int64))
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(np.array(loss.numpy()))
    return losses, [np.array(p.numpy()) for p in model.parameters()]


def test_async_on_off_bit_exact_lenet():
    w = _lenet_weights()
    with _async(pt, cap=24, on=False):
        l_sync, p_sync = _lenet_losses_params(pt, w)
    with _async(pt, cap=24, on=True):
        l_async, p_async = _lenet_losses_params(pt, w)
        pt_af.drain()
    with _async(ref, cap=24, on=True):
        l_ref, _ = _lenet_losses_params(ref, w)
        ref_af.drain()
    assert all((a == b).all() for a, b in zip(l_sync, l_async))
    assert all((a == b).all() for a, b in zip(p_sync, p_async))
    np.testing.assert_allclose(np.array(l_async), np.array(l_ref),
                               rtol=1e-5)


def _chain(paddle, n=40):
    x = paddle.to_tensor(np.full((8, 8), 1.25, "float32"))
    y = x
    for _ in range(n):
        y = y * 1.01 + 0.001
    return y


def test_async_chain_matches_sync_and_overlaps():
    got = []
    for paddle, _, af in SIDES:
        with _async(paddle):
            y = _chain(paddle)
            assert y.shape == [8, 8]      # metadata reads never block
            a = y.numpy()
        with _async(paddle, on=False):
            s = _chain(paddle).numpy()
        np.testing.assert_array_equal(a, s)
        got.append(a)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5)


def test_backward_through_async_segments():
    """Gradients through segments sealed on the worker equal the
    synchronous path's."""
    def run(paddle, on):
        with _async(paddle, on=on):
            w = paddle.to_tensor(np.full((4, 4), 0.5, "float32"),
                                 stop_gradient=False)
            z = w
            for _ in range(24):
                z = z * 1.1 + 0.1
            z.sum().backward()
            return np.array(w.grad.numpy())
    for paddle, _, _ in SIDES:
        np.testing.assert_array_equal(run(paddle, True), run(paddle, False))
    np.testing.assert_allclose(run(pt, True), run(ref, True), rtol=1e-5)


def test_worker_failure_surfaces_with_its_type(monkeypatch):
    """A failure on the worker re-raises at the next sync point: the port
    keeps the original type (ValueError), the reference wraps it in
    EnforceNotMet with the original as its cause."""
    from paddle_tpu.base.core import EnforceNotMet

    def boom(*a, **k):
        raise ValueError("synthetic build failure")

    for paddle, lazy, af in SIDES:
        with _async(paddle):
            lazy.clear_segment_cache()
            with monkeypatch.context() as m:
                m.setattr(lazy, "_build_segment_fn", boom)
                x = paddle.to_tensor(np.ones((3, 3), "float32"))
                z = x
                for _ in range(20):
                    z = z * 2.0 + 1.0
                if paddle is pt:
                    with pytest.raises(ValueError, match="synthetic"):
                        float(z.sum())
                else:
                    with pytest.raises(EnforceNotMet) as ei:
                        float(z.sum())
                    assert isinstance(ei.value.__cause__, ValueError)
            af.drain(raise_latched=False)


def test_executor_drains_and_shuts_down_clean():
    for paddle, _, af in SIDES:
        with _async(paddle):
            x = paddle.to_tensor(np.ones((4, 4), "float32"))
            z = x
            for _ in range(40):
                z = z * 1.001
            z.numpy()
            af.drain()
            assert af.get_executor().inflight() == 0
            af.shutdown()
            assert not any(t.name == af._WORKER_NAME
                           for t in threading.enumerate())
            z = x                      # the pipeline restarts cleanly
            for _ in range(20):
                z = z * 1.002
            np.testing.assert_allclose(z.numpy(), np.full(
                (4, 4), 1.002 ** 20), rtol=1e-5)
            af.drain()


def test_device_prefetcher_order_and_depth():
    """DevicePrefetcher yields every batch in order, numpy leaves as
    Tensors, at each depth (1: degraded synchronous), with the window on
    (the port's staging thread lands its values before handing them
    over)."""
    batches = [(np.full((2, 2), i, "float32"), np.array([i], "int64"))
               for i in range(6)]
    for paddle, lazy, _ in SIDES:
        from importlib import import_module
        io = import_module(paddle.__name__ + ".io")
        with _Flags(paddle, FLAGS_eager_fusion=True):
            for depth in (1, 2, 4):
                out = list(io.DevicePrefetcher(iter(batches), depth=depth))
                assert len(out) == 6
                for i, (a, b) in enumerate(out):
                    assert float(a.numpy()[0, 0]) == float(i)
                    assert int(b.numpy()[0]) == i


def test_async_off_leaves_sync_path_untouched():
    """With the flag off (the default) a workload never makes an
    executor."""
    for paddle, _, af in SIDES:
        af.shutdown()
        with _Flags(paddle, FLAGS_eager_fusion=True):
            x = paddle.to_tensor(np.ones((4, 4), "float32"))
            z = x
            for _ in range(20):
                z = z * 1.003
            z.numpy()
        assert af._EXECUTOR is None


@pytest.mark.parametrize("af", [ref_af, pt_af], ids=["ref", "port"])
def test_executor_backpressure_bounds_inflight(af):
    """submit() blocks once max_inflight jobs are queued or running and
    wakes as the worker drains."""
    ex = af.FlushExecutor(max_inflight=2)
    gate = threading.Event()
    for _ in range(2):
        ex.submit(lambda: gate.wait(10))
    unblocked = []

    def third():
        ex.submit(lambda: None)
        unblocked.append(True)

    th = threading.Thread(target=third, daemon=True)
    th.start()
    time.sleep(0.2)
    assert not unblocked, "the third submit should block"
    gate.set()
    th.join(10)
    assert unblocked, "submit never released after the worker drained"
    ex.drain()
    ex.shutdown()


def test_guard_exit_seal_rides_async():
    """A lazy_guard exit seals asynchronously: the outputs carry
    PendingValues after the block and land on the synchronous result."""
    def build(paddle):
        from importlib import import_module
        framework = import_module(paddle.__name__ + ".framework")
        with framework.lazy_guard():
            z = paddle.to_tensor(np.full((6, 6), 1.5, "float32"))
            for _ in range(10):
                z = z * 1.02 + 0.01
        return z

    got = []
    for paddle, _, af in SIDES:
        with _Flags(paddle, FLAGS_async_flush=True):
            z = build(paddle)
            assert getattr(z._payload, "_is_pending_value", False)
            assert z.shape == [6, 6]
            a = z.numpy()
            af.drain()
        np.testing.assert_array_equal(a, build(paddle).numpy())
        got.append(a)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5)


def test_sot_entry_built_from_async_guard_exit():
    """SOT's capture accepts pending outputs: with async on, its guard-exit
    seal goes through the pipeline and still installs the guarded entry;
    the fast hit matches the synchronous result."""
    def fn(a):
        b = a * 1.5 + 0.25
        c = b * b
        return c - a

    for paddle, _, af in SIDES:
        from importlib import import_module
        sot = import_module(paddle.__name__ + ".jit.sot")
        x = paddle.to_tensor(np.full((4, 4), 0.5, "float32"))
        want = fn(x).numpy()
        sfn = sot.symbolic_translate(fn)
        with _Flags(paddle, FLAGS_async_flush=True):
            out1 = sfn(x)
            assert getattr(out1._payload, "_is_pending_value", False)
            got1 = out1.numpy()
            assert sfn.stats["captures"] == 1 and len(sfn._entries) == 1
            got2 = sfn(x).numpy()
            assert sfn.stats["fast_hits"] == 1
            af.drain()
        np.testing.assert_allclose(got1, want, rtol=1e-5)
        np.testing.assert_allclose(got2, want, rtol=1e-5)
