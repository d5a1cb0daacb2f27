"""The record fast path and whole-step promotion of the port's window
(``_core/lazy.py``: ``_record_fast``, ``_Skeleton``, ``_step_plan_sig``,
``FLAGS_record_fast_path``, ``FLAGS_step_replay_after``) against the
reference's Python prong, on the CPU: the counterpart of
``tests/test_step_replay.py`` and of the Python-prong tests of
``tests/test_record_fastpath.py``.

A steady op stream arms its skeleton at the second identical seal and
replays every later record (``FAST_OPS``); after
``FLAGS_step_replay_after`` clean replays the seal skips the signature
rebuild (``REPLAY_STEPS``). Shape drift, ``set_flags`` of a watched flag,
an in-place swap mid-segment and a grad-mode flip demote it; the stream
re-proves and re-arms. The reference runs with its sanitizer off (its
fast path turns itself off under ``FLAGS_static_checks``) and its native
core unbound (``_NC = None``: its Python prong); the port with its
ambient window on (off by default, ROADMAP.md §3) and its Python prong
forced the same way. ``tests/test_torch_native_core.py`` holds the port's
native prong to these cases.
``FAST_OPS`` and ``REPLAY_STEPS`` deltas are compared exactly: both
packages record ``y * 1.01 + 0.001`` as two ops. Values: bit-equal to the
same run with the fast path or promotion off, and 1e-5 relative to the
reference (its compiled segments may contract a multiply-add).

No counterpart yet: ``bump_mesh_epoch`` waits for items 8–9 (ROADMAP.md
§1); ``budget --static-diff``, ``PERF_SRC``
provenance and the ``record.fast_ops`` metric wait for the observability
and analysis planes (item 9).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import async_flush as ref_af
from paddle_tpu._core import dispatch as ref_dispatch
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu_torch._core import async_flush as pt_af
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import dispatch as pt_dispatch
from paddle_tpu_torch._core import lazy as pt_lazy

SIDES = [(ref, ref_lazy), (pt, pt_lazy)]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """The port on the CPU with its window on; both packages with their
    Python prong forced, the reference with its sanitizer off."""
    monkeypatch.setattr(pt_device, "_current", "cpu")
    monkeypatch.setattr(pt_lazy, "_NC", None)
    monkeypatch.setattr(pt_lazy, "_NC_TRIED", True)
    monkeypatch.setattr(pt_lazy, "_DRIVE_OK", False)
    old = ref.get_flags(["FLAGS_static_checks"])
    ref.set_flags({"FLAGS_static_checks": "off"})
    monkeypatch.setattr(ref_lazy, "_NC", None)
    monkeypatch.setattr(ref_lazy, "_NC_TRIED", True)
    monkeypatch.setattr(ref_lazy, "_DRIVE_OK", False)
    monkeypatch.setattr(ref_dispatch, "_EAGER_CORE", None)
    pt_lazy.enable_eager_fusion(True)
    try:
        yield
    finally:
        pt_lazy.enable_eager_fusion(False)
        ref.set_flags(old)
        ref_af.drain(raise_latched=False)
        pt_af.drain(raise_latched=False)


class _Flag:
    def __init__(self, paddle, name, value):
        self.paddle, self.name, self.value = paddle, name, value

    def __enter__(self):
        self.old = self.paddle.get_flags([self.name])
        self.paddle.set_flags({self.name: self.value})

    def __exit__(self, *exc):
        self.paddle.set_flags(self.old)


def _chain(x, n=12):
    y = x
    for _ in range(n):
        y = y * 1.01 + 0.001
    return y.numpy()


def _promote(x, n=12, iters=8):
    """Warm a chain shape past arming (2 seals), the replay streak (3
    more) and the first promoted seal."""
    want = _chain(x, n)
    for _ in range(iters):
        np.testing.assert_array_equal(_chain(x, n), want)
    return want


def _x(paddle, v, shape=(8, 8)):
    return paddle.to_tensor(np.full(shape, v, "float32"))


# ------------------------------------------------------ record fast path

def test_fast_path_engages_and_matches():
    deltas, vals = [], []
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.25)
        want = _chain(x)
        f0 = lazy.FAST_OPS
        for _ in range(4):
            np.testing.assert_array_equal(_chain(x), want)
        assert lazy.FAST_OPS > f0
        f1 = lazy.FAST_OPS
        np.testing.assert_array_equal(_chain(x), want)
        deltas.append(lazy.FAST_OPS - f1)
        vals.append(want)
    assert deltas[1] == deltas[0] == 24
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)


def test_flag_off_freezes_fast_path():
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.25)
        for _ in range(3):
            _chain(x)
        with _Flag(paddle, "FLAGS_record_fast_path", False):
            f0 = lazy.FAST_OPS
            want = _chain(x)
            assert lazy.FAST_OPS == f0
        for _ in range(3):   # back on: re-proves, re-arms, matches
            np.testing.assert_array_equal(_chain(x), want)
        f1 = lazy.FAST_OPS
        _chain(x)
        assert lazy.FAST_OPS - f1 == 24


def _lenet_weights():
    ref.seed(0)
    from paddle_tpu.vision.models import LeNet
    return {k: np.array(v.numpy()) for k, v in LeNet().state_dict().items()}


def _lenet_losses_params(paddle, weights, steps):
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


@pytest.mark.parametrize("flag,counter", [
    ("FLAGS_record_fast_path", "FAST_OPS"),
    ("FLAGS_step_replay_after", "REPLAY_STEPS")])
def test_lenet_parity_on_off_with_async_flush(flag, counter):
    """The acceptance drill: LeNet's losses and parameters bit-equal with
    the fast path (or promotion) on and off, async flush on, and the
    counter moving during the on run; losses 1e-5 from the reference."""
    w = _lenet_weights()
    off_value = False if flag == "FLAGS_record_fast_path" else 0
    with _Flag(pt, "FLAGS_async_flush", True):
        with _Flag(pt, flag, off_value):
            l_off, p_off = _lenet_losses_params(pt, w, 8)
        pt_af.drain()
        c0 = getattr(pt_lazy, counter)
        l_on, p_on = _lenet_losses_params(pt, w, 8)
        pt_af.drain()
        assert getattr(pt_lazy, counter) > c0
    assert all((a == b).all() for a, b in zip(l_off, l_on))
    assert all((a == b).all() for a, b in zip(p_off, p_on))
    l_ref, _ = _lenet_losses_params(ref, w, 8)
    np.testing.assert_allclose(np.array(l_on), np.array(l_ref), rtol=1e-5)


def _warm_ctx(lazy, x):
    _chain(x)
    _chain(x)
    ctx = lazy.current_context()
    assert ctx._skels, "skeleton failed to arm"
    return ctx


def test_set_flags_mid_session_invalidates():
    for paddle, lazy in SIDES:
        x = _x(paddle, 2.0)
        _warm_ctx(lazy, x)
        want = _chain(x)
        gen = lazy._FAST_GEN
        with _Flag(paddle, "FLAGS_lazy_max_segment_ops", 255):
            assert lazy._FAST_GEN > gen
            f0 = lazy.FAST_OPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.FAST_OPS == f0, "replayed across a set_flags bump"
            _chain(x)
            f1 = lazy.FAST_OPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.FAST_OPS > f1, "never re-armed after set_flags"


def test_note_inplace_mid_segment_invalidates():
    """An in-place swap while ops are pending drops the skeleton; between
    segments (the optimizer's write-back) it survives."""
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.1)
        ctx = _warm_ctx(lazy, x)
        t = _x(paddle, 1.0, (4, 4))
        t.set_value(np.zeros((4, 4), "float32"))
        assert ctx._skels
        y = x * 1.01
        assert ctx.pending
        sel = ctx._skeleton
        assert sel is not None
        t.set_value(np.ones((4, 4), "float32"))
        assert ctx._skeleton is None and not ctx._skel_live
        assert all(sel not in b.values() for b in ctx._skels.values())
        y.numpy()
        _chain(x)
        _chain(x)
        f1 = lazy.FAST_OPS
        _chain(x)
        assert lazy.FAST_OPS > f1


def _grad_run(paddle, n=8):
    w = paddle.to_tensor(np.full((4, 4), 0.5, "float32"),
                         stop_gradient=False)
    z = w
    for _ in range(n):
        z = z * 1.1 + 0.1
    z.sum().backward()
    return np.array(w.grad.numpy())


def test_grad_mode_flip_falls_back_correctly():
    got = []
    for paddle, lazy in SIDES:
        g_ref = _grad_run(paddle)
        g2 = _grad_run(paddle)
        with paddle.no_grad():
            v = _x(paddle, 0.5, (4, 4))
            for _ in range(8):
                v = v * 1.1 + 0.1
            v.numpy()
        g3 = _grad_run(paddle)
        assert (g_ref == g2).all() and (g_ref == g3).all()
        got.append(g_ref)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5)


def test_shape_change_falls_back():
    for paddle, lazy in SIDES:
        x8, x4 = _x(paddle, 1.25), _x(paddle, 1.25, (4, 4))
        _warm_ctx(lazy, x8)
        want = _chain(x4)
        np.testing.assert_array_equal(_chain(x4), want)
        np.testing.assert_allclose(want, np.full((4, 4), want[0, 0]))


def test_aval_cache_lru_bounded():
    """The record-time metadata cache has the runner caches' capacity
    bound: distinct signatures evict the least recent."""
    for paddle, lazy in SIDES:
        lazy.clear_segment_cache()
        with _Flag(paddle, "FLAGS_executable_cache_capacity", 8):
            for n in range(1, 14):
                t = paddle.to_tensor(np.ones((n, 3), "float32"))
                (t * 2.0).numpy()
            assert 0 < len(lazy._AVAL_CACHE) <= 8


def test_sig_entry_intern_overflow_pinned():
    """The 65536-entry rule: the pool clears (identity reuse degrades to
    equality until repopulated, never correctness)."""
    for lazy in (ref_lazy, pt_lazy):
        saved = dict(lazy._SIG_ENTRY_INTERN)
        try:
            lazy._SIG_ENTRY_INTERN.clear()
            e1 = lazy._intern_sig_entry(("op_a", (), (None,), 1))
            assert lazy._intern_sig_entry(("op_a", (), (None,), 1)) is e1
            for i in range(65536):
                lazy._SIG_ENTRY_INTERN[("fill", i)] = ("fill", i)
            e2 = lazy._intern_sig_entry(("op_b", (), (None,), 1))
            assert len(lazy._SIG_ENTRY_INTERN) == 0
            assert e2 == ("op_b", (), (None,), 1)
            e3 = lazy._intern_sig_entry(("op_b", (), (None,), 1))
            assert lazy._intern_sig_entry(("op_b", (), (None,), 1)) is e3
            assert e3 == e2 and e1 == ("op_a", (), (None,), 1)
        finally:
            lazy._SIG_ENTRY_INTERN.clear()
            lazy._SIG_ENTRY_INTERN.update(saved)


def test_ndarray_attr_mismatch_is_miss_not_error():
    """An ndarray attr where the armed shape held primitives is a plain
    mismatch (full-path fallback), not numpy's ambiguous-truth error."""
    x = _x(pt, 1.25)
    ctx = _warm_ctx(pt_lazy, x)
    sk = ctx._select_skel("multiply")
    assert sk is not None
    s = sk.ops[0]
    saved = s.attrs
    s.attrs = {"v": 1.0}
    try:
        assert ctx._record_fast("multiply", s.fn, [x, 1.01],
                                {"v": np.zeros(3)}) is None
        assert not ctx._skel_live
    finally:
        s.attrs = saved
        ctx._skels.clear()
        ctx._skeleton = None
        ctx._skel_live = False
    rx = _x(ref, 1.25)
    rctx = _warm_ctx(ref_lazy, rx)
    from paddle_tpu._core.op_registry import get_op
    op = get_op("multiply")
    rs = rctx._select_skel(op).ops[0]
    saved = rs.attrs, rs.fast_attrs
    rs.attrs, rs.fast_attrs = {"v": 1.0}, True
    try:
        assert rctx._record_fast(op, [rx, rx], {"v": np.zeros(3)}) is None
    finally:
        rs.attrs, rs.fast_attrs = saved
        rctx._skels.clear()
        rctx._skeleton = None
        rctx._skel_live = False


def test_disabled_auto_cast_scope_keeps_fast_dispatch():
    """auto_cast(enable=False) installs no AMP hook, and the fast path
    keeps replaying inside it."""
    from paddle_tpu._core import executor as ref_executor
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.25)
        _warm_ctx(lazy, x)
        hook = (lambda: ref_executor._amp_hook) if paddle is ref \
            else (lambda: pt_dispatch.AMP_HOOK)
        assert hook() is None
        with paddle.amp.auto_cast(enable=False):
            assert hook() is None
            f0 = lazy.FAST_OPS
            _chain(x)
            assert lazy.FAST_OPS - f0 == 24
        with paddle.amp.auto_cast(level="O1"):
            assert hook() is not None
        assert hook() is None


# ------------------------------------------------------- step promotion

def test_step_replay_promotes_and_counts():
    deltas = []
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.25)
        want = _promote(x)
        r0 = lazy.REPLAY_STEPS
        for _ in range(3):
            np.testing.assert_array_equal(_chain(x), want)
        deltas.append(lazy.REPLAY_STEPS - r0)
    assert deltas[1] == deltas[0] == 3


def test_flag_zero_disables_promotion():
    for paddle, lazy in SIDES:
        with _Flag(paddle, "FLAGS_step_replay_after", 0):
            x = _x(paddle, 1.75)
            want = _promote(x)
            r0 = lazy.REPLAY_STEPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.REPLAY_STEPS == r0


def test_shape_drift_demotes_and_repromotes():
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.1)
        _promote(x, n=12)
        r0 = lazy.REPLAY_STEPS
        np.testing.assert_array_equal(_chain(x, 12), _chain(x, 12))
        assert lazy.REPLAY_STEPS > r0
        want18 = _chain(x, 18)
        for _ in range(8):
            np.testing.assert_array_equal(_chain(x, 18), want18)
        r2 = lazy.REPLAY_STEPS
        np.testing.assert_array_equal(_chain(x, 18), want18)
        assert lazy.REPLAY_STEPS > r2, "drifted shape never re-promoted"


def test_same_leading_op_shapes_both_replay():
    """Two alternating segment shapes sharing their leading op each keep a
    banked skeleton ((length, last entry) keys) and both replay."""
    deltas = []
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.3)
        want12, want18 = _chain(x, 12), _chain(x, 18)
        for _ in range(4):
            np.testing.assert_array_equal(_chain(x, 12), want12)
            np.testing.assert_array_equal(_chain(x, 18), want18)
        f0 = lazy.FAST_OPS
        np.testing.assert_array_equal(_chain(x, 12), want12)
        np.testing.assert_array_equal(_chain(x, 18), want18)
        deltas.append(lazy.FAST_OPS - f0)
    assert deltas[1] == deltas[0] == 24 + 36


def test_watched_flag_demotes_step_driver():
    for paddle, lazy in SIDES:
        x = _x(paddle, 1.9)
        want = _promote(x)
        with _Flag(paddle, "FLAGS_lazy_max_segment_ops", 255):
            r0 = lazy.REPLAY_STEPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.REPLAY_STEPS == r0, "drove across set_flags"
            for _ in range(6):
                np.testing.assert_array_equal(_chain(x), want)
            r1 = lazy.REPLAY_STEPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.REPLAY_STEPS > r1


def test_note_inplace_mid_segment_demotes_driver():
    for paddle, lazy in SIDES:
        x = _x(paddle, 0.9)
        want = _promote(x)
        ctx = lazy.current_context()
        t = _x(paddle, 1.0, (4, 4))
        y = x * 1.01
        y = y * 1.01 + 0.001
        assert ctx.pending
        t.set_value(np.zeros((4, 4), "float32"))
        assert ctx._skeleton is None and not ctx._skel_live
        y.numpy()
        r0 = lazy.REPLAY_STEPS
        np.testing.assert_array_equal(_chain(x), want)
        assert lazy.REPLAY_STEPS == r0, "drove a demoted shape"


def test_grad_mode_flip_demotes_driver():
    """A no_grad iteration of a promoted grad shape does not seal through
    the plan; gradients stay exact when grad mode returns."""
    for paddle, lazy in SIDES:
        g_ref = _grad_run(paddle)
        for _ in range(7):
            assert (_grad_run(paddle) == g_ref).all()
        with paddle.no_grad():
            v = _x(paddle, 0.5, (4, 4))
            for _ in range(8):
                v = v * 1.1 + 0.1
            v.numpy()
        assert (_grad_run(paddle) == g_ref).all()
