"""The lazy fusion window (``paddle_tpu_torch/_core/lazy.py``) against the
reference's (``paddle_tpu/_core/lazy.py``), on the CPU: the counterpart of
``tests/test_lazy.py``, test for test.

Each scenario runs through both packages from the same numpy inputs (the
reference under ``JAX_PLATFORMS=cpu``, the port with ``device="cpu"``).
Values are held at 1e-6 relative (fp32 elementwise chains, the same
arithmetic; 2e-5 and 1e-6 absolute for the SGD step, whose products sum in
another order). Where both packages record the same ops the counts are
compared exactly: ``segments_run``, ``breaks``, the pending and input
lists, the segment cache's size. Not compared: ``ops_recorded`` where the
port's op decomposes differently (it is compared where it does not), and
the reference's ``_autograd_meta`` grad nodes (the port's graph is
torch's: ``grad_fn`` of the payload). The reference's ambient window is on
by default, the port's off (ROADMAP.md §3): each port scenario opens its
window itself, as each reference scenario's ``lazy_guard`` does.
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import lazy as pt_lazy

PACKAGES = [(ref, ref_lazy), (pt, pt_lazy)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's eager API on the CPU (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _is_lazy(t):
    return getattr(t._payload, "_is_lazy_ref", False)


def _both(scenario):
    """``scenario(paddle, lazy)`` for the reference, then the port."""
    return [scenario(p, lz) for p, lz in PACKAGES]


def _close(a, b, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_fuses_and_matches_eager():
    x_np = np.random.RandomState(0).randn(4, 8).astype("float32")

    def run(paddle, lazy):
        F = paddle.nn.functional
        x = paddle.to_tensor(x_np)
        with lazy.lazy_guard() as ctx:
            out = (F.relu(x * 2.0) + 1.0).sum()
            pending = _is_lazy(out)
        return out.numpy(), pending, ctx.segments_run, ctx.ops_recorded, \
            ctx.breaks
    (r_out, r_lazy, r_seg, r_ops, r_br), (p_out, p_lazy, p_seg, p_ops,
                                          p_br) = _both(run)
    assert r_lazy and p_lazy
    assert (p_seg, p_ops, p_br) == (r_seg, r_ops, r_br) == (
        1, 4, ["guard_exit"])
    _close(p_out, r_out)
    _close(p_out, (np.maximum(x_np * 2, 0) + 1).sum(), rtol=1e-5)


def test_metadata_reads_do_not_flush():
    def run(paddle, lazy):
        x = paddle.to_tensor(np.zeros((3, 5), "float32"))
        with lazy.lazy_guard() as ctx:
            y = x * 2.0
            meta = (y.shape, y.ndim, y.dtype == paddle.float32, len(y),
                    y.stop_gradient)
            still = _is_lazy(y)
            _ = float(y.sum().numpy())
            landed = not _is_lazy(y)
        return meta, still, landed, ctx.segments_run
    r, p = _both(run)
    assert p == r == (([3, 5], 2, True, 3, True), True, True, 1)


def test_value_access_is_a_graph_break():
    def run(paddle, lazy):
        x = paddle.to_tensor(np.ones((2, 2), "float32"))
        with lazy.lazy_guard() as ctx:
            a = x + 1.0
            _ = a.numpy()
            b = a * 3.0
            _ = b.numpy()
        return b.numpy(), ctx.segments_run, ctx.breaks
    (rv, rs, rb), (pv, ps, pb) = _both(run)
    assert (ps, pb) == (rs, rb) == (2, ["materialize", "materialize"])
    _close(pv, rv)
    _close(pv, np.full((2, 2), 6.0))


def test_autograd_through_segments():
    r = np.random.RandomState(1)
    x_np, w_np = r.randn(4, 8).astype("float32"), \
        r.randn(8, 8).astype("float32")

    def run(paddle, lazy):
        F = paddle.nn.functional
        x = paddle.to_tensor(x_np)
        w = paddle.to_tensor(w_np)
        w.stop_gradient = False
        F.relu(paddle.matmul(x, w)).sum().backward()
        g_eager = w.grad.numpy().copy()
        w.clear_grad()
        with lazy.lazy_guard():
            loss = F.relu(paddle.matmul(x, w)).sum()
        loss.backward()
        g_one = w.grad.numpy().copy()
        w.clear_grad()
        # a break mid-graph: gradients chain across two segments
        with lazy.lazy_guard() as ctx:
            h = paddle.matmul(x, w)
            _ = h.numpy()
            loss = F.relu(h).sum()
        loss.backward()
        return g_eager, g_one, w.grad.numpy(), ctx.segments_run
    (re, r1, r2, rs), (pe, p1, p2, ps) = _both(run)
    assert ps == rs == 2
    for got in (p1, p2):
        _close(got, pe, rtol=1e-5)
    _close(pe, re, rtol=1e-5, atol=1e-6)


def test_train_step_parity():
    r = np.random.RandomState(2)
    x_np = r.randn(4, 8).astype("float32")
    ref.seed(0)
    st0 = {k: v.numpy().copy() for k, v in ref.nn.Sequential(
        ref.nn.Linear(8, 16), ref.nn.ReLU(),
        ref.nn.Linear(16, 4)).state_dict().items()}

    def run(paddle, lazy):
        nn = paddle.nn
        net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in st0.items()})
        xb = paddle.to_tensor(x_np)
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())

        def step():
            loss = (net(xb) ** 2).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
        step()
        eager = {k: v.numpy().copy() for k, v in net.state_dict().items()}
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in st0.items()})
        with lazy.lazy_guard():
            step()
        return eager, {k: v.numpy() for k, v in net.state_dict().items()}
    (r_eager, r_lazy), (p_eager, p_lazy) = _both(run)
    for k in r_eager:
        np.testing.assert_array_equal(p_lazy[k], p_eager[k])
        _close(p_lazy[k], r_lazy[k], rtol=2e-5, atol=1e-6)
        _close(r_lazy[k], r_eager[k], rtol=2e-5, atol=1e-6)


def test_segment_cache_replay():
    x_np = np.random.RandomState(3).randn(4, 4).astype("float32")

    def run(paddle, lazy):
        F = paddle.nn.functional
        x = paddle.to_tensor(x_np)

        def once():
            with lazy.lazy_guard() as ctx:
                out = F.relu(x * 2.0).sum()
            return float(out.numpy()), ctx
        v1, _ = once()
        n0 = lazy.segment_cache_size()
        v2, c2 = once()
        return v1, v2, lazy.segment_cache_size() - n0, c2.segments_run
    (r1, r2, rd, rs), (p1, p2, pd, ps) = _both(run)
    assert (pd, ps) == (rd, rs) == (0, 1)
    assert p1 == p2 and r1 == r2
    _close(p1, r1)


@pytest.mark.parametrize("cap", [4, 3])
def test_segment_cap_flag(cap):
    def run(paddle, lazy):
        flags = paddle.get_flags("FLAGS_lazy_max_segment_ops")
        paddle.set_flags({"FLAGS_lazy_max_segment_ops": cap})
        try:
            x = paddle.to_tensor(np.ones((2,), "float32"))
            with lazy.lazy_guard() as ctx:
                y = x
                for _ in range(10):
                    y = y + 1.0
            return y.numpy(), ctx.segments_run, ctx.breaks
        finally:
            paddle.set_flags(flags)
    (rv, rs, rb), (pv, ps, pb) = _both(run)
    assert (ps, pb) == (rs, rb)
    assert ps == -(-10 // cap) and pb[-1] == "guard_exit"
    _close(pv, rv)
    _close(pv, np.ones((2,)) + 10)


def test_trace_does_not_pin_dead_inputs():
    def run(paddle, lazy):
        with lazy.lazy_guard() as ctx:
            x = paddle.to_tensor(np.full((3, 3), 2.0, "float32"))
            y = x * 3.0
            wr = weakref.ref(x)
            del x
            gc.collect()
            dead = wr() is None
            n_pending = len(ctx.pending)
        return dead, n_pending, y.numpy()
    (rd, rn, rv), (pd, pn, pv) = _both(run)
    assert (pd, pn) == (rd, rn) == (True, 1)
    _close(pv, rv)
    _close(pv, np.full((3, 3), 6.0))


def test_failed_flush_drops_trace_state(monkeypatch):
    def run(paddle, lazy):
        x = paddle.to_tensor(np.ones((2, 2), "float32"))
        with lazy.lazy_guard() as ctx:
            y = x + 1.0
            del y
            lazy.clear_segment_cache()
            with monkeypatch.context() as m:
                m.setattr(lazy, "_build_segment_fn",
                          lambda *a, **k: (_ for _ in ()).throw(
                              RuntimeError("boom")))
                with pytest.raises(RuntimeError, match="boom"):
                    ctx.flush("forced")
            cleared = (ctx.pending == [] and ctx._in_tensors == []
                       and ctx._in_vals == [] and ctx._in_ids == {})
            z = x * 2.0   # the context keeps working after the failure
            return cleared, z.numpy()
    (rc, rz), (pc, pz) = _both(run)
    assert pc and rc
    _close(pz, rz)
    _close(pz, np.full((2, 2), 2.0))


def test_inplace_swap_mid_segment_uses_fresh_payload():
    def run(paddle, lazy):
        x = paddle.to_tensor(np.ones((2,), "float32"))
        with lazy.lazy_guard() as ctx:
            before = x + 1.0
            x.set_value(np.full((2,), 5.0, "float32"))
            after = x + 1.0
        return before.numpy(), after.numpy(), ctx.segments_run
    (rb, ra, rs), (pb, pa, ps) = _both(run)
    assert ps == rs
    _close(pb, rb)
    _close(pa, ra)
    _close(pb, [2.0, 2.0])
    _close(pa, [6.0, 6.0])


def test_uncapturable_op_falls_back():
    """nonzero's output length needs the data: the window lands what is
    pending (one segment in both) and the op runs eagerly. The reference's
    nonzero reads its input's value first (break reason "materialize"),
    the port's fails its record-time run on meta tensors
    ("record_fallback:nonzero")."""
    def run(paddle, lazy):
        F = paddle.nn.functional
        x = paddle.to_tensor(np.array([1.0, -2.0, 3.0], "float32"))
        want = paddle.nonzero(F.relu(x)).numpy()
        with lazy.lazy_guard() as ctx:
            out = paddle.nonzero(F.relu(x))
        return want, out.numpy(), ctx.breaks
    (rw, ro, rb), (pw, po, pb) = _both(run)
    assert rb == ["materialize"] and pb == ["record_fallback:nonzero"]
    np.testing.assert_array_equal(po, pw)
    np.testing.assert_array_equal(po, ro)


def _leaves_of(fn):
    """The leaf tensors a torch graph node reaches."""
    seen, out, todo = set(), [], [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if hasattr(node, "variable"):
            out.append(node.variable)
        todo.extend(n for n, _ in node.next_functions)
    return out


def test_disjoint_components_slice_saved_residuals():
    """Two independent graphs recorded in one window get independent
    gradient graphs, each reaching only its own input (the reference:
    independent GradNodes saving one input each; the port: torch's graph,
    read from the payloads' grad_fn)."""
    def run(paddle, lazy):
        a = paddle.to_tensor(np.full((4,), 3.0, "float32"))
        a.stop_gradient = False
        b = paddle.to_tensor(np.full((4,), 5.0, "float32"))
        b.stop_gradient = False
        with lazy.lazy_guard():
            ya = (a * a).sum()
            yb = (b + b).sum()
        if paddle is pt:
            na, nb = ya._t.grad_fn, yb._t.grad_fn
            sep = na is not nb and [id(v) for v in _leaves_of(na)] == [
                id(a._t)] and [id(v) for v in _leaves_of(nb)] == [id(b._t)]
        else:
            na = ya._autograd_meta.grad_node
            nb = yb._autograd_meta.grad_node
            sep = na is not nb and len(na.saved) == 1 and len(nb.saved) == 1
        ya.backward()
        yb.backward()
        return sep, a.grad.numpy(), b.grad.numpy()
    (rs, ra, rb), (ps, pa, pb) = _both(run)
    assert ps and rs
    _close(pa, ra)
    _close(pb, rb)
    _close(pa, np.full((4,), 6.0))
    _close(pb, np.full((4,), 2.0))


def test_ndarray_attr_digest_invalidates_on_mutation():
    """An ndarray constant's key follows its contents when the array is
    mutated in place (the reference digests large arrays by a memo with a
    sampled fingerprint, the port keys every array of up to 4096 elements
    by its bytes and does not cache larger ones)."""
    from paddle_tpu._core.dispatch import _digest_array
    for digest in (_digest_array, pt_lazy._const_key):
        big = np.arange(1024, dtype="float32")
        k1 = digest(big)
        assert digest(big) == k1
        big[0] = 999.0
        assert digest(big) != k1
        small = np.arange(4, dtype="float32")
        s1 = digest(small)
        small[1] = 7.0
        assert digest(small) != s1
    assert pt_lazy._const_key(np.zeros(4097, "float32")) is None


def test_fusion_window_is_per_thread():
    """Each thread records into its own window (the ambient one: the
    reference's is on by default, the port's is turned on for the test):
    four threads chaining 64 adds concurrently never interleave wiring."""
    def run(paddle, lazy):
        old = lazy.eager_fusion_enabled()
        lazy.enable_eager_fusion(True)
        results, errors = {}, []

        def worker(tag, base):
            try:
                t = paddle.to_tensor(np.full((8, 8), base, "float32"))
                y = t
                for _ in range(64):
                    y = y + 1.0
                results[tag] = y.numpy()[0, 0]
                lazy.flush_active()
            except Exception as e:   # pragma: no cover
                errors.append(e)
        try:
            threads = [threading.Thread(target=worker,
                                        args=(i, float(i * 100)))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            lazy.enable_eager_fusion(old)
        return errors, results
    (re_, rr), (pe, pr) = _both(run)
    assert not pe and not re_
    assert pr == rr == {i: i * 100 + 64.0 for i in range(4)}


def test_threaded_dataloader_with_tensor_dataset_trains():
    """A TensorDataset of live Tensors makes the loader's staging thread
    record slice ops into its own window; batches land on that thread, so
    the training thread's window never sees another thread's pending
    values. Port: LeNet trained by the loader under the window equals the
    same loop with the window off, bit for bit; the reference: four finite
    losses (its LeNet draws other initial weights)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 1, 28, 28).astype(np.float32)
    ys = rng.randint(0, 10, (64,)).astype(np.int64)

    def run(paddle, fusion):
        from importlib import import_module
        io = import_module(paddle.__name__ + ".io")
        lenet = import_module(paddle.__name__ + ".vision.models").LeNet
        lazy = import_module(paddle.__name__ + "._core.lazy")
        old = lazy.eager_fusion_enabled()
        lazy.enable_eager_fusion(fusion)
        try:
            paddle.seed(0)
            ds = io.TensorDataset([paddle.to_tensor(xs),
                                   paddle.to_tensor(ys)])
            model = lenet()
            opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
            losses = []
            for _ in range(2):
                for x, y in io.DataLoader(ds, batch_size=32,
                                          drop_last=True):
                    loss = paddle.nn.functional.cross_entropy(model(x), y)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(float(loss.numpy()))
        finally:
            lazy.enable_eager_fusion(old)
        return losses
    r = run(ref, True)
    on, off = run(pt, True), run(pt, False)
    assert len(r) == len(on) == 4 and np.isfinite(r).all()
    assert on == off and np.isfinite(on).all()


def test_to_static_traces_inside_a_window():
    """A ``to_static`` layer called inside a window traces its forward
    (the eager calls of the trace reach ``make_fx``, not the segment) and
    gives the eager result on both packages; the window records the same
    two ops and runs the same two segments in both (a trace recorded into
    the window would add one)."""
    w = {"weight": np.random.RandomState(5).randn(8, 4).astype("float32"),
         "bias": np.random.RandomState(6).randn(4).astype("float32")}
    x_np = np.random.RandomState(7).randn(3, 8).astype("float32")
    got = []
    for paddle, lazy in PACKAGES:
        net = paddle.nn.Linear(8, 4)
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        x = paddle.to_tensor(x_np)
        want = net(x).numpy()
        kw = {"backend": "aot_eager"} if paddle is pt else {}
        static = paddle.jit.to_static(net, **kw)
        with lazy.lazy_guard() as ctx:
            y = paddle.nn.functional.relu(static(x * 1.0))
        _close(y.numpy(), np.maximum(want, 0), rtol=1e-5)
        got.append((y.numpy(), ctx.segments_run, ctx.breaks,
                    ctx.ops_recorded))
    assert got[1][1:] == got[0][1:] == (2, ["materialize", "guard_exit"], 2)
    _close(got[1][0], got[0][0], rtol=1e-5, atol=1e-6)


def test_metadata_cache_holds_no_closure_alive():
    """The record-time metadata cache keys an op's function by id and keeps
    a weak reference to it: what a per-call closure captured is released
    once the call is done (the port's own cache; the reference keys by op
    name), and a new function at a reused id misses."""
    pt_lazy.clear_segment_cache()
    held = np.full((1000,), 0.001, "float32")
    ref_held = weakref.ref(held)
    x = pt.to_tensor(np.full((3,), 2.0, "float32"))
    with pt_lazy.lazy_guard():
        y = pt._core.dispatch.apply(
            "add_held", lambda t: t + float(held.sum()), x)
    assert pt_lazy.metadata_cache_size() == 1
    del held
    gc.collect()
    assert ref_held() is None
    _close(y.numpy(), np.full((3,), 3.0))
