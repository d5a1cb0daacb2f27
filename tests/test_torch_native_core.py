"""The native record core and whole-step driver of the port's lazy window
(``paddle_tpu_torch/csrc/eager_core.cc``, bound in ``_core/lazy.py``
``_native_core``) and the runtime library of ``_core/native.py``, on the
CPU: the counterpart of the native-prong cases of
``tests/test_record_fastpath.py`` and ``tests/test_step_replay.py`` and of
the store and allocator cases of ``tests/test_native_runtime.py``.

Each prong is forced by setting ``lazy._NC`` / ``_NC_TRIED`` /
``_DRIVE_OK``, as the reference's tests force theirs. The native prong must
give what the Python prong gives: bit-equal losses, gradients and
parameters, and equal executions, ``FAST_OPS`` and ``REPLAY_STEPS``; the
eager GPT (the small model of ``tests/test_torch_lazy_gpt.py``) and LeNet
are also held against the reference at that file's tolerance (losses 1e-5
relative). A watched ``set_flags``, an in-place swap mid-segment, a
grad-mode flip and shape drift each retire the driver; the signature pool
and the metadata cache keep the Python prong's bounds.

The reference's ``discover`` (its engine's in-degree walk) has no
counterpart: the port's backward is torch's engine.
"""
import contextlib
import ctypes
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.vision.models import LeNet as RefLeNet
from paddle_tpu_torch._core import async_flush as pt_af
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import dispatch as pt_dispatch
from paddle_tpu_torch._core import lazy
from paddle_tpu_torch._core import native
from paddle_tpu_torch.models import gpt as pt_gpt

ROOT = Path(__file__).resolve().parents[1]
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=128, dtype="float32")


@pytest.fixture(scope="module")
def nc():
    core = lazy._NC if lazy._NC_TRIED and lazy._NC is not None \
        else lazy._native_core()
    assert core is not None, native.EAGER_CORE_ERROR
    assert lazy._DRIVE_OK
    return core


@pytest.fixture(autouse=True)
def _window(monkeypatch, nc):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")
    lazy.enable_eager_fusion(True)
    try:
        yield
    finally:
        lazy.enable_eager_fusion(False)
        pt_af.drain(raise_latched=False)


@contextlib.contextmanager
def prong(native_on: bool, core):
    saved = (lazy._NC, lazy._NC_TRIED, lazy._DRIVE_OK)
    lazy._NC, lazy._NC_TRIED = (core if native_on else None), True
    lazy._DRIVE_OK = native_on
    try:
        yield
    finally:
        lazy._DRIVE_OK = False
        lazy._drive_retire()
        lazy._NC, lazy._NC_TRIED, lazy._DRIVE_OK = saved


class _Driven:
    """Counts the ops the whole-step driver recorded inside the block."""

    def __enter__(self):
        self.n = 0
        self._inner = inner = pt_dispatch.NC_DRIVE

        def counted(*a):
            out = inner(*a)
            self.n += out is not None
            return out
        pt_dispatch.NC_DRIVE = counted
        return self

    def __exit__(self, *exc):
        pt_dispatch.NC_DRIVE = self._inner


def _flag(name, value):
    @contextlib.contextmanager
    def cm():
        old = pt.get_flags([name])
        pt.set_flags({name: value})
        try:
            yield
        finally:
            pt.set_flags(old)
    return cm()


def _chain(x, n=12):
    y = x
    for _ in range(n):
        y = y * 1.01 + 0.001
    return y.numpy()


def _x(v, shape=(8, 8)):
    return pt.to_tensor(np.full(shape, v, "float32"))


def _promote(x, n=12, iters=8):
    want = _chain(x, n)
    for _ in range(iters):
        np.testing.assert_array_equal(_chain(x, n), want)
    return want


# ------------------------------------------------------------ the builds

def test_libraries_build_from_the_repo_into_the_ignored_directory(nc):
    lib = native.get_lib(required=True)
    so = Path(lib._name)
    assert so == ROOT / "paddle_tpu_torch" / "csrc" / "build" / \
        "libpt_runtime.so"
    assert Path(nc.__file__).parent == so.parent
    assert Path(nc.__file__).name.startswith("pt_eager_core")
    assert "paddle_tpu_torch/csrc/build/" in (ROOT / ".gitignore").read_text()
    # staleness is by mtime: a fresh build is newer than its sources
    assert not native._stale(native.EAGER_CORE_SO, [native.EAGER_CORE_SRC])
    assert not native._stale(native.RUNTIME_SO, native._runtime_sources())


# ------------------------------------------------------- prongs side by side

def test_fast_path_engages_natively_with_the_python_counts(nc):
    got = {}
    for native_on in (True, False):
        with prong(native_on, nc):
            x = _x(1.25)
            want = _chain(x)
            for _ in range(3):
                np.testing.assert_array_equal(_chain(x), want)
            f0, r0 = lazy.FAST_OPS, lazy.REPLAY_STEPS
            n0 = pt_dispatch.exec_count()
            np.testing.assert_array_equal(_chain(x), want)
            got[native_on] = (want, lazy.FAST_OPS - f0,
                              lazy.REPLAY_STEPS - r0,
                              pt_dispatch.exec_count() - n0)
        lazy.enable_eager_fusion(False)
        lazy.enable_eager_fusion(True)
    np.testing.assert_array_equal(got[True][0], got[False][0])
    assert got[True][1:] == got[False][1:]
    assert got[True][1] == 24


def test_driver_engages_and_counters_are_exact(nc):
    with prong(True, nc):
        x = _x(0.5)
        want = _promote(x)
        f0, r0 = lazy.FAST_OPS, lazy.REPLAY_STEPS
        with _Driven() as driven:
            np.testing.assert_array_equal(_chain(x), want)
        assert lazy._DRIVE_CELL[0] is None, "drive left armed over a seal"
        assert lazy.FAST_OPS - f0 == 24
        assert lazy.REPLAY_STEPS - r0 == 1
        # the first op arms the driver; it records the other 23
        assert driven.n == 23


def test_segment_cap_seals_as_the_python_prong_does(nc):
    """A stream longer than the segment cap: the driver seals at the cap
    (it flushes where ``maybe_cap_flush`` would), so both prongs give the
    same segments, counts and values."""
    got = {}
    with _flag("FLAGS_lazy_max_segment_ops", 10):
        for native_on in (True, False):
            with prong(native_on, nc):
                ctx = lazy.current_context()
                x = _x(0.75)
                want = _promote(x)
                f0, r0 = lazy.FAST_OPS, lazy.REPLAY_STEPS
                n0, b0 = pt_dispatch.exec_count(), len(ctx.breaks)
                with _Driven() as driven:
                    for _ in range(3):
                        np.testing.assert_array_equal(_chain(x), want)
                got[native_on] = (want, lazy.FAST_OPS - f0,
                                  lazy.REPLAY_STEPS - r0,
                                  pt_dispatch.exec_count() - n0,
                                  ctx.breaks[b0:], driven.n > 0)
            lazy.enable_eager_fusion(False)
            lazy.enable_eager_fusion(True)
    np.testing.assert_array_equal(got[True][0], got[False][0])
    assert got[True][1:5] == got[False][1:5]
    assert got[True][4] == ["segment_cap", "segment_cap",
                            "materialize"] * 3
    assert got[True][5] and not got[False][5]


def _gpt_train(model, steps, native_on, nc, amp=None):
    """AdamW steps of the small GPT under the window: losses, step 1's
    gradients, executions a step, FAST_OPS and REPLAY_STEPS over the
    run."""
    crit = pt_gpt.GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    r = np.random.RandomState(0)
    x, y = r.randint(0, 256, (2, 128)), r.randint(0, 256, (2, 128))
    losses, grads, execs = [], None, []
    with prong(native_on, nc):
        f0, r0 = lazy.FAST_OPS, lazy.REPLAY_STEPS
        for i in range(steps):
            n0 = pt_dispatch.exec_count()
            with contextlib.ExitStack() as stack:
                if amp:
                    stack.enter_context(pt.amp.auto_cast(level="O1",
                                                         dtype=amp))
                loss = crit(model(pt.to_tensor(x)), pt.to_tensor(y))
            loss.backward()
            if i == 0:
                grads = [p.grad.numpy().copy() for p in model.parameters()]
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
            execs.append(pt_dispatch.exec_count() - n0)
        counts = (lazy.FAST_OPS - f0, lazy.REPLAY_STEPS - r0)
    return losses, grads, execs, counts


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_gpt_steps_native_equal_python_and_match_reference(nc, amp):
    ref.seed(0)
    rm = ref_gpt.GPTForPretraining(ref_gpt.GPTConfig(**GPT_CFG))
    w = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    runs = {}
    for native_on in (True, False):
        pm = pt_gpt.GPTForPretraining(pt_gpt.GPTConfig(**GPT_CFG))
        pm.set_state_dict(w)
        with _Driven() as driven:
            run = _gpt_train(pm, 8, native_on, nc, amp)
        runs[native_on] = run + (driven.n,
                                 [p.numpy() for p in pm.parameters()])
        lazy.enable_eager_fusion(False)
        lazy.enable_eager_fusion(True)
    nat, py = runs[True], runs[False]
    assert nat[0] == py[0], (nat[0], py[0])
    for a, b in zip(nat[1], py[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(nat[5], py[5]):
        np.testing.assert_array_equal(a, b)
    assert nat[2] == py[2] and nat[2][1:] == [2] * 7
    assert nat[3] == py[3] and nat[3][0] > 0 and nat[3][1] > 0
    assert nat[4] > 0 and py[4] == 0
    if amp is None:   # the reference's first three losses
        crit = ref_gpt.GPTPretrainingCriterion()
        opt = ref.optimizer.AdamW(1e-4, parameters=rm.parameters())
        r = np.random.RandomState(0)
        x, y = r.randint(0, 256, (2, 128)), r.randint(0, 256, (2, 128))
        want = []
        for _ in range(3):
            loss = crit(rm(ref.to_tensor(x)), ref.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            want.append(float(loss.numpy()))
        np.testing.assert_allclose(nat[0][:3], want, rtol=1e-5)


def _lenet_run(paddle, lenet_cls, weights, steps):
    F = paddle.nn.functional
    model = lenet_cls()
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


def test_lenet_native_equals_python_and_matches_reference(nc):
    from paddle_tpu_torch.vision.models import LeNet
    ref.seed(0)
    w = {k: np.array(v.numpy()) for k, v in RefLeNet().state_dict().items()}
    runs = {}
    for native_on in (True, False):
        with prong(native_on, nc):
            r0 = lazy.REPLAY_STEPS
            runs[native_on] = _lenet_run(pt, LeNet, w, 8) + (
                lazy.REPLAY_STEPS - r0,)
        lazy.enable_eager_fusion(False)   # a fresh context for the next
        lazy.enable_eager_fusion(True)
    assert all((a == b).all() for a, b in zip(runs[True][0], runs[False][0]))
    assert all((a == b).all() for a, b in zip(runs[True][1], runs[False][1]))
    assert runs[True][2] == runs[False][2] > 0
    want, _ = _lenet_run(ref, RefLeNet, w, 8)
    np.testing.assert_allclose(np.array(runs[True][0]), np.array(want),
                               rtol=1e-5)


# ---------------------------------------------------- demotion and freezing

def test_flag_off_freezes_the_native_path(nc):
    with prong(True, nc):
        x = _x(1.5)
        _promote(x)
        with _flag("FLAGS_record_fast_path", False), _Driven() as driven:
            f0 = lazy.FAST_OPS
            want = _chain(x)
            assert lazy.FAST_OPS == f0 and driven.n == 0
        for _ in range(3):
            np.testing.assert_array_equal(_chain(x), want)
        f1 = lazy.FAST_OPS
        _chain(x)
        assert lazy.FAST_OPS - f1 == 24


def test_watched_flag_retires_the_driver(nc):
    with prong(True, nc):
        x = _x(1.9)
        want = _promote(x)
        y = x * 1.01 + 0.001
        y = y * 1.01
        assert lazy._DRIVE_CELL[0] is not None, "the driver never armed"
        with _flag("FLAGS_lazy_max_segment_ops", 255), _Driven() as driven:
            z = y + 0.001         # the generation moved: the driver retires
            assert driven.n == 0 and lazy._DRIVE_CELL[0] is None
            z.numpy()
            r0 = lazy.REPLAY_STEPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.REPLAY_STEPS == r0, "drove across a set_flags bump"
            for _ in range(6):
                np.testing.assert_array_equal(_chain(x), want)
            r1 = lazy.REPLAY_STEPS
            np.testing.assert_array_equal(_chain(x), want)
            assert lazy.REPLAY_STEPS > r1 and driven.n > 0


def test_note_inplace_mid_segment_retires_the_driver(nc):
    with prong(True, nc):
        x = _x(0.9)
        want = _promote(x)
        ctx = lazy.current_context()
        t = _x(1.0, (4, 4))
        y = x * 1.01 + 0.001
        y = y * 1.01
        assert ctx.pending and lazy._DRIVE_CELL[0] is not None
        t.set_value(np.zeros((4, 4), "float32"))
        assert lazy._DRIVE_CELL[0] is None
        assert ctx._skeleton is None and not ctx._skel_live
        assert ctx._skel_pos == 3 and ctx._fast_ops == 3
        y.numpy()
        r0 = lazy.REPLAY_STEPS
        np.testing.assert_array_equal(_chain(x), want)
        assert lazy.REPLAY_STEPS == r0, "drove a demoted shape"


def test_grad_mode_flip_retires_the_driver(nc):
    def run():
        w = pt.to_tensor(np.full((4, 4), 0.5, "float32"),
                         stop_gradient=False)
        z = w
        for _ in range(8):
            z = z * 1.1 + 0.1
        z.sum().backward()
        return w.grad.numpy().copy()

    with prong(True, nc):
        g_ref = run()
        for _ in range(7):
            assert (run() == g_ref).all()
        w = pt.to_tensor(np.full((4, 4), 0.5, "float32"),
                         stop_gradient=False)
        z = w * 1.1 + 0.1
        assert lazy._DRIVE_CELL[0] is not None
        with pt.no_grad():
            z = z * 1.1         # recorded under no_grad: a mismatch
        assert lazy._DRIVE_CELL[0] is None
        z.numpy()
        assert (run() == g_ref).all()


def test_shape_drift_retires_the_driver_and_repromotes(nc):
    with prong(True, nc):
        x8, x4 = _x(1.25), _x(1.25, (4, 4))
        _promote(x8)
        with _Driven() as driven:
            r0 = lazy.REPLAY_STEPS
            want4 = _chain(x4)
            assert lazy.REPLAY_STEPS == r0 and driven.n == 0
            np.testing.assert_allclose(want4, np.full((4, 4), want4[0, 0]))
            for _ in range(8):
                np.testing.assert_array_equal(_chain(x4), want4)
        assert lazy.REPLAY_STEPS > r0 and driven.n > 0


# ------------------------------------------------------- pools and caches

def test_sig_entry_pool_is_shared_and_cleared_past_65536(nc):
    saved = dict(lazy._SIG_ENTRY_INTERN)
    try:
        lazy._SIG_ENTRY_INTERN.clear()
        e1 = nc.sig_entry(("op_a", (), (None,), 1))
        assert nc.sig_entry(("op_a", (), (None,), 1)) is e1
        assert lazy._SIG_ENTRY_INTERN[e1] is e1
        for i in range(65536):
            lazy._SIG_ENTRY_INTERN[("fill", i)] = ("fill", i)
        e2 = nc.sig_entry(("op_b", (), (None,), 1))
        assert len(lazy._SIG_ENTRY_INTERN) == 0
        assert e2 == ("op_b", (), (None,), 1)
        assert nc.intern_sizes()["sig_entry"] == 0
    finally:
        lazy._SIG_ENTRY_INTERN.clear()
        lazy._SIG_ENTRY_INTERN.update(saved)


def test_native_metadata_cache_honours_the_capacity_flag(nc):
    with prong(True, nc):
        lazy.clear_segment_cache()
        assert nc.intern_sizes()["meta_cache"] == 0
        with _flag("FLAGS_executable_cache_capacity", 8):
            for n in range(1, 14):
                (pt.to_tensor(np.ones((n, 3), "float32")) * 2.0).numpy()
            assert 0 < lazy.metadata_cache_size() <= 8
        assert len(lazy._AVAL_CACHE) == 0


@pytest.mark.parametrize("attrs", [
    {}, {"axis": 1, "keepdim": False}, {"alpha": -0.0, "beta": 0.0},
    {"shape": (2, [3, 4]), "name": None, "tag": b"x"},
    {"dtype": torch.float32, "approximate": "tanh"}])
def test_native_attrs_key_equals_the_python_key(nc, attrs):
    want = tuple(sorted((k, lazy._const_key(v)) for k, v in attrs.items()))
    assert nc.attrs_key(attrs) == want
    assert lazy._attrs_key(attrs) == want


def test_native_attrs_key_leaves_exotic_values_to_python(nc):
    assert nc.attrs_key({"w": np.zeros(3)}) is None
    assert nc.attrs_key({"d": {"a": 1}}) is None


def test_skel_record_changes_nothing_on_a_mismatch(nc):
    with prong(True, nc):
        x = _x(2.2)
        _promote(x)
        ctx = lazy.current_context()
        y = x * 1.01
        lazy._drive_retire()
        sk = ctx._skeleton
        name, fn = sk.ctups[1][:2]      # the add of 0.001

        def state():
            return (len(ctx.pending), len(ctx._in_vals), len(ctx._sig_ops),
                    ctx._skel_pos, ctx._fast_ops, lazy.FAST_OPS)
        before = state()
        for inputs in ((y, 0.002), (y, -0.0 + 0.001 + 1e-12),
                       (_x(1.0), 0.001), (y, y), (y,)):
            assert nc.skel_record(ctx, sk.ctups, sk.in_sig, name, fn,
                                  inputs, {}) is None, inputs
            assert state() == before
        out = nc.skel_record(ctx, sk.ctups, sk.in_sig, name, fn,
                             (y, 0.001), {})
        assert out is not None and state()[0] == before[0] + 1
        assert state()[3:] == (before[3] + 1, before[4] + 1, before[5] + 1)
        out.numpy()


# ------------------------------------------------ the runtime library

def test_tcp_store_set_get_add_wait_across_clients():
    from paddle_tpu_torch.distributed.store import TCPStore
    with TCPStore("127.0.0.1", 0, is_master=True, timeout=10) as master:
        master.set("alpha", b"hello")
        assert master.get("alpha") == b"hello"
        assert master.add("ctr", 3) == 3 and master.add("ctr", 4) == 7
        with TCPStore("127.0.0.1", master.port, timeout=10) as worker:
            assert worker.get("alpha") == b"hello"
            worker.set("beta", "from-worker")
            assert master.get("beta") == b"from-worker"
            got = {}
            t = threading.Thread(target=lambda: got.setdefault(
                "v", worker.get("late-key")))
            t.start()
            master.set("late-key", b"now")
            t.join(timeout=10)
            assert not t.is_alive() and got["v"] == b"now"
            worker.delete("beta")
            with pytest.raises(RuntimeError, match="timed out"):
                master.wait("beta", timeout=0.2)


def test_tcp_store_barrier_two_ranks_reusable():
    from paddle_tpu_torch.distributed.store import TCPStore
    with TCPStore("127.0.0.1", 0, is_master=True, world_size=2,
                  timeout=10) as master, \
            TCPStore("127.0.0.1", master.port, world_size=2,
                     timeout=10) as worker:
        done = []

        def rank1():
            for _ in range(3):
                worker.barrier("b0", timeout=10)
                done.append(1)

        t = threading.Thread(target=rank1)
        t.start()
        for _ in range(3):
            master.barrier("b0", timeout=10)
        t.join(timeout=10)
        assert not t.is_alive() and done == [1, 1, 1]


def test_host_allocator_alloc_free_coalesce():
    lib = native.get_lib(required=True)
    h = lib.pt_alloc_create(1 << 20)
    ptrs = [lib.pt_alloc_malloc(h, 1000) for _ in range(100)]
    assert all(ptrs) and len(set(ptrs)) == 100
    in_use, reserved = ctypes.c_uint64(), ctypes.c_uint64()
    lib.pt_alloc_stats(h, ctypes.byref(in_use), ctypes.byref(reserved))
    assert in_use.value >= 100 * 1000 and reserved.value >= in_use.value
    for p in ptrs:
        assert lib.pt_alloc_free(h, p) == 0
    lib.pt_alloc_stats(h, ctypes.byref(in_use), ctypes.byref(reserved))
    assert in_use.value == 0
    assert lib.pt_alloc_malloc(h, 90 * 1000)   # fits the coalesced space
    lib.pt_alloc_stats(h, ctypes.byref(in_use), ctypes.byref(reserved))
    assert reserved.value == 1 << 20
    assert lib.pt_alloc_free(h, 0xdead0) == -1
    lib.pt_alloc_destroy(h)


def test_host_pool_memory_is_usable():
    lib = native.get_lib(required=True)
    h = native.host_pool()
    assert h and native.host_pool() == h
    p = lib.pt_alloc_malloc(h, 4096)
    arr = (ctypes.c_uint8 * 4096).from_address(p)
    arr[:] = bytes(range(256)) * 16
    assert bytes(arr[:256]) == bytes(range(256))
    assert lib.pt_alloc_free(h, p) == 0
