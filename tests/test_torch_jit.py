"""The port's ``jit.to_static`` (make_fx + ``torch.compile``) against the
JAX package's, on the CPU, with ``backend="aot_eager"``.

Held here: Python guards retrace, ``FLAGS_dy2static_cache_limit`` evicts
the oldest key, BN buffers are written back, AMP under ``to_static`` (the
key difference pinned), ``full_graph=False`` raises, a forced graph break
raises instead of running eagerly, one trace and one forward and one
backward graph per key, and a tiny eager GPT (2 layers, hidden 64, 4
heads, seq 128, fp32) whose graph holds the flash-attention kernel op
``flash_fwd`` once a layer (and its backward ``flash_bwd_dkv`` and
``flash_bwd_dq`` once a layer), with loss and gradients against the
reference's ``to_static`` GPT (its Pallas kernel in interpret mode): loss
1e-5 relative, gradients 1e-4 absolute, as ``test_torch_eager_gpt.py``
holds the eager ones. Other fp32 outputs at rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.models import gpt as pt_gpt

BACKEND = "aot_eager"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _crossed(make):
    """``make(pkg)`` in both packages, the reference's weights in the
    port's layer."""
    ref.seed(0)
    r = make(ref)
    p = make(pt)
    missing, unexpected = p.set_state_dict(
        {k: np.array(v.numpy()) for k, v in r.state_dict().items()})
    assert not missing and not unexpected
    return r, p


def _entry(sf):
    assert len(sf._fwd_cache) == 1
    return next(iter(sf._fwd_cache.values()))


X = np.random.RandomState(0).randn(4, 8).astype("float32")


def test_guards_retrace_on_python_values():
    def fn(x, scale, mode="add"):
        if mode == "add":
            return x + scale
        return x * scale

    rs, ps = ref.jit.to_static(fn), pt.jit.to_static(fn, backend=BACKEND)
    for scale, mode in ((2, "add"), (3, "add"), (2, "mul"), (2, "add")):
        _close(ps(pt.to_tensor(X), scale, mode=mode).numpy(),
               rs(ref.to_tensor(X), scale, mode=mode).numpy())
    assert len(ps._fwd_cache) == len(rs._fwd_cache) == 3
    # a float leaf is dynamic: a new value reuses the entry and its trace
    ps(pt.to_tensor(X), 0.5)
    ps(pt.to_tensor(X), 0.25)
    assert len(ps._fwd_cache) == 4
    traced = [e.traces for e in ps._fwd_cache.values()]
    assert traced == [1, 1, 1, 1]


def test_cache_limit_evicts_the_oldest_key():
    def fn(x, k):
        return x * k

    rs, ps = ref.jit.to_static(fn), pt.jit.to_static(fn, backend=BACKEND)
    for pkg in (ref, pt):
        pkg.set_flags({"FLAGS_dy2static_cache_limit": 2})
    try:
        for k in (1, 2, 3):
            _close(ps(pt.to_tensor(X), k).numpy(),
                   rs(ref.to_tensor(X), k).numpy())
        assert len(ps._fwd_cache) == len(rs._fwd_cache) == 2
        kept = [key[4] for key in ps._fwd_cache]
        assert kept == [((1, 2),), ((1, 3),)]   # k = 1 went first
        first = ps._fwd_cache[next(iter(ps._fwd_cache))]
        ps(pt.to_tensor(X), 1)                   # back: a new trace
        assert len(ps._fwd_cache) == 2
        assert first not in ps._fwd_cache.values()
    finally:
        for pkg in (ref, pt):
            pkg.set_flags({"FLAGS_dy2static_cache_limit": 64})


def test_batch_norm_buffers_written_back():
    def make(pkg):
        return pkg.nn.Sequential(pkg.nn.Linear(8, 6), pkg.nn.BatchNorm1D(6))

    r, p = _crossed(make)
    _, eager = _crossed(make)
    rs, ps = ref.jit.to_static(r), pt.jit.to_static(p, backend=BACKEND)
    for step in range(2):
        x = X * (step + 1)
        _close(ps(pt.to_tensor(x)).numpy(), rs(ref.to_tensor(x)).numpy())
        eager(pt.to_tensor(x))
    for (name, rb), (pname, pb), (_, eb) in zip(
            r.named_buffers(), p.named_buffers(), eager.named_buffers()):
        assert name == pname
        _close(pb.numpy(), rb.numpy())
        _close(pb.numpy(), eb.numpy())
    # the running statistics moved, and stay out of autograd
    assert not np.allclose(p[1]._mean.numpy(), 0.0)
    assert p[1]._mean.stop_gradient and p[1]._mean._t.grad_fn is None


def test_amp_state_joins_the_cache_key():
    """The reference's key has no AMP state: a call inside ``auto_cast``
    after an fp32 call with the same shapes reuses the fp32 program (its
    output stays float32). The port's key holds the AMP state: the call
    retraces with the casts and gives the eager O1 result (bfloat16)."""
    def make(pkg):
        return pkg.nn.Linear(8, 4)

    r, p = _crossed(make)
    _, eager = _crossed(make)
    rs, ps = ref.jit.to_static(r), pt.jit.to_static(p, backend=BACKEND)
    _close(ps(pt.to_tensor(X)).numpy(), rs(ref.to_tensor(X)).numpy())
    with ref.amp.auto_cast(level="O1"):
        r_amp = rs(ref.to_tensor(X))
    with pt.amp.auto_cast(level="O1"):
        p_amp = ps(pt.to_tensor(X))
        e_amp = eager(pt.to_tensor(X))
    assert r_amp.dtype == ref.float32            # the reference's reuse
    assert len(ps.forward._fwd_cache) == 2
    assert p_amp.dtype == e_amp.dtype == pt.bfloat16
    _close(p_amp.numpy(), e_amp.numpy())
    # back outside the scope: the fp32 entry again, no new trace
    assert ps(pt.to_tensor(X)).dtype == pt.float32
    assert [e.traces for e in ps.forward._fwd_cache.values()] == [1, 1]


def test_full_graph_false_raises():
    """``full_graph=False`` raised until SOT was ported; it now wraps the
    function in ``jit.sot``'s bytecode capture, which raises nothing on a
    graph break (tests/test_torch_sot.py holds it against the
    reference)."""
    from paddle_tpu_torch.jit.sot import SotFunction
    sfn = pt.jit.to_static(lambda x: x * 2.0, full_graph=False)
    assert isinstance(sfn, SotFunction)
    x = pt.to_tensor(np.arange(3, dtype="float32"))
    np.testing.assert_array_equal(sfn(x).numpy(), [0.0, 2.0, 4.0])


def test_graph_break_raises_and_does_not_run_eagerly():
    ran = []

    def reads_the_value(x):
        ran.append(1)
        y = x * 2.0
        while y.sum() > 0:   # while/else: dy2static leaves it as it is
            y = y - 1.0
        else:
            y = y + 0.0
        return y

    for pkg, sf in ((ref, ref.jit.to_static(reads_the_value)),
                    (pt, pt.jit.to_static(reads_the_value,
                                          backend=BACKEND))):
        ran.clear()
        with pytest.raises(RuntimeError, match="branches on a tensor value"):
            sf(pkg.to_tensor(X))
        assert ran == [1]   # the trace ran the Python once, then raised

    def to_host(x):
        return x * float(x.sum().numpy())

    with pytest.raises(RuntimeError, match="branches on a tensor value"):
        pt.jit.to_static(to_host, backend=BACKEND)(pt.to_tensor(X))


def test_one_trace_and_one_graph_each_way_per_key():
    def make(pkg):
        return pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                                 pkg.nn.Linear(16, 4))

    r, p = _crossed(make)
    rs, ps = ref.jit.to_static(r), pt.jit.to_static(p, backend=BACKEND)
    for step in range(3):
        rl = (rs(ref.to_tensor(X)) ** 2).mean()
        rl.backward()
        pl = (ps(pt.to_tensor(X)) ** 2).mean()
        pl.backward()
        _close(float(pl), float(rl))
    for rp, pp in zip(r.parameters(), p.parameters()):
        _close(pp.grad.numpy(), rp.grad.numpy())
    entry = _entry(ps.forward)
    assert entry.traces == 1
    assert entry.counts == {"forward": 1, "backward": 1}


GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=128, dtype="float32")


def _targets(gm):
    return [n.target for n in gm.graph.nodes if n.op == "call_function"]


def test_tiny_gpt_reaches_flash_fwd_as_one_node_a_layer():
    def make(pkg):
        mod = ref_gpt if pkg is ref else pt_gpt
        return mod.GPTForPretraining(mod.GPTConfig(**GPT_CFG))

    r, p = _crossed(make)
    rc, pc = ref_gpt.GPTPretrainingCriterion(), \
        pt_gpt.GPTPretrainingCriterion()
    rs, ps = ref.jit.to_static(r), pt.jit.to_static(p, backend=BACKEND)
    rng = np.random.RandomState(0)
    x, y = rng.randint(0, 256, (2, 128)), rng.randint(0, 256, (2, 128))
    rl = rc(rs(ref.to_tensor(x)), ref.to_tensor(y))
    rl.backward()
    pl = pc(ps(pt.to_tensor(x)), pt.to_tensor(y))
    pl.backward()
    assert abs(float(pl) - float(rl)) <= 1e-5 * abs(float(rl))
    for (name, rp), (pname, pp) in zip(r.named_parameters(),
                                       p.named_parameters()):
        assert name == pname
        np.testing.assert_allclose(pp.grad.numpy(), rp.grad.numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
    entry = _entry(ps.forward)
    ops = torch.ops.paddle_tpu_torch
    (compiled, _), = entry.programs.values()
    traced = _targets(compiled.graph_module)
    assert traced.count(ops.flash_fwd.default) == GPT_CFG["num_layers"]
    assert not any("scaled_dot_product" in str(t) for t in traced)
    kinds = dict(entry.graphs)
    assert sorted(kinds) == ["backward", "forward"]
    bwd = _targets(kinds["backward"])
    for op in (ops.flash_bwd_dkv.default, ops.flash_bwd_dq.default):
        assert bwd.count(op) == GPT_CFG["num_layers"]
