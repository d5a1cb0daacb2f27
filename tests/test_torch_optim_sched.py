"""The port's Momentum, learning-rate schedulers and gradient clips
against the JAX package's, on the CPU.

The same weights and inputs (numpy, from a seed) on both sides; a few
optimizer steps on a small model, compared after each. The schedulers are
host arithmetic copied from the reference: their lr sequences must be
equal, not close.

Tolerances: fp32 1e-6 of each element plus 1e-6 of the tensor's largest
(a handful of elementwise updates; the gradients, summed in other orders,
carry their rounding to the small elements); bf16 parameters with
``multi_precision``, fed the same gradients, the same on the float32
master weights and velocity, and one bf16 ulp on the parameters.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.models.convert import optimizer_state_renamed


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _net(p):
    return p.nn.Sequential(p.nn.Linear(6, 8), p.nn.LayerNorm(8),
                           p.nn.Linear(8, 3))


def _pair(dtype="float32"):
    """The small net on both sides with the port's seeded weights."""
    pt.seed(0)
    pm, rm = _net(pt), _net(ref)
    state = {k: np.array(v.numpy()) for k, v in pm.state_dict().items()}
    rm.set_state_dict(state)
    if dtype != "float32":
        pm.astype(dtype)
        rm.astype(dtype)
    return rm, pm


def _loss(p, model, step):
    rng = np.random.RandomState(step)
    x = p.to_tensor(rng.randn(5, 6).astype(np.float32))
    w = p.to_tensor(rng.randn(5, 3).astype(np.float32))
    return (model(x) * w).sum()


def _close(got, want, tol=1e-6):
    """Within ``tol`` of each element and ``tol`` of the largest (a
    gradient's rounding carries over to its small elements)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _run(make_opt, steps=3, on_step=None):
    """``steps`` updates on both sides; after each the parameters are
    compared (``_close``)."""
    rm, pm = _pair()
    ropt, popt = make_opt(ref, rm), make_opt(pt, pm)
    for step in range(steps):
        for p, model, opt in ((ref, rm, ropt), (pt, pm, popt)):
            _loss(p, model, step).backward()
            opt.step()
            opt.clear_grad()
        for rp, pp in zip(rm.parameters(), pm.parameters()):
            want = np.asarray(rp.numpy(), np.float32)
            _close(pp.numpy(), want)
        if on_step is not None:
            on_step(ropt, popt)
    return rm, pm, ropt, popt


def _states(opt, params):
    """The optimizer's per-parameter state as numpy, keyed by position."""
    sd = opt.state_dict()
    return {f"{i}.{k.rpartition('.')[2]}": np.asarray(v.numpy(), np.float32)
            for i, p in enumerate(params)
            for k, v in sd.items() if k.rpartition(".")[0] == p.name}


def _params_of(opt):
    """An optimizer's parameters in order (the reference's
    ``_all_params`` pairs each with its group)."""
    return [q[0] if isinstance(q, tuple) else q for q in opt._all_params()]


def _same_states(ropt, popt, kinds):
    rs = _states(ropt, _params_of(ropt))
    ps = _states(popt, _params_of(popt))
    assert {k.split(".")[1] for k in ps} == kinds and set(rs) == set(ps)
    for k in rs:
        assert ps[k].dtype == np.float32
        _close(ps[k], rs[k])


@pytest.mark.parametrize("kw", [
    dict(), dict(use_nesterov=True), dict(weight_decay=0.01),
    dict(use_nesterov=True, weight_decay=0.02), dict(momentum=0.5)],
    ids=["plain", "nesterov", "l2", "nesterov_l2", "mu0.5"])
def test_momentum_matches_reference(kw):
    """v = mu v + g (L2 decay added into g first), p -= lr v, or with
    Nesterov p -= lr (g + mu v): parameters and velocities."""
    def make(p, m):
        return p.optimizer.Momentum(0.1, parameters=m.parameters(), **kw)

    _run(make, on_step=lambda r, q: _same_states(r, q, {"velocity"}))


def test_momentum_multi_precision_bf16_matches_reference():
    """bf16 parameters with float32 master weights and velocity. The loss
    is linear in the parameters, ``sum(p * w)`` with ``w`` from a seed, so
    that both sides get the same bf16 gradients and the update alone is
    compared: the masters and velocities to 1e-6, the bf16 parameters,
    each its master rounded, to one bf16 ulp."""
    rm, pm = _pair("bfloat16")
    kw = dict(use_nesterov=True, weight_decay=0.01, multi_precision=True)
    ropt = ref.optimizer.Momentum(0.1, parameters=rm.parameters(), **kw)
    popt = pt.optimizer.Momentum(0.1, parameters=pm.parameters(), **kw)
    for step in range(3):
        for p, model, opt in ((ref, rm, ropt), (pt, pm, popt)):
            rng = np.random.RandomState(step)
            loss = sum((q.astype("float32") * p.to_tensor(
                rng.randn(*q.shape).astype(np.float32))).sum()
                for q in model.parameters())
            loss.backward()
            opt.step()
            opt.clear_grad()
        _same_states(ropt, popt, {"velocity", "master"})
        for rp, pp in zip(rm.parameters(), pm.parameters()):
            want = np.asarray(rp.numpy(), np.float32)
            assert np.all(np.abs(pp.numpy() - want)
                          <= 2 ** -7 * np.abs(want) + 1e-30)


def test_momentum_state_dict_crosses_from_reference():
    """The reference's velocity, renamed by parameter order, loads into
    the port's optimizer and the next step matches."""
    rm, pm = _pair()
    ropt = ref.optimizer.Momentum(0.1, parameters=rm.parameters())
    _loss(ref, rm, 0).backward()
    ropt.step()
    ropt.clear_grad()
    pm.set_state_dict({k: np.array(v.numpy())
                       for k, v in rm.state_dict().items()})
    popt = pt.optimizer.Momentum(0.1, parameters=pm.parameters())
    popt.set_state_dict(optimizer_state_renamed(
        {k: v if isinstance(v, int) else np.array(v.numpy())
         for k, v in ropt.state_dict().items()},
        [q.name for q in rm.parameters()], [q.name for q in pm.parameters()]))
    assert popt.state_dict()["step"] == 1
    for p, model, opt in ((ref, rm, ropt), (pt, pm, popt)):
        _loss(p, model, 1).backward()
        opt.step()
    for rp, pp in zip(rm.parameters(), pm.parameters()):
        _close(pp.numpy(), rp.numpy())


# ------------------------------------------------------------ schedulers

SCHEDULERS = {
    "NoamDecay": lambda L: L.NoamDecay(64, 10, learning_rate=2.0),
    "ExponentialDecay": lambda L: L.ExponentialDecay(0.5, 0.9),
    "NaturalExpDecay": lambda L: L.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda L: L.InverseTimeDecay(0.5, 0.1),
    "PolynomialDecay": lambda L: L.PolynomialDecay(0.5, 20, 0.01, 2.0),
    "PolynomialDecay_cycle": lambda L: L.PolynomialDecay(0.5, 7, 0.01, 1.5,
                                                         cycle=True),
    "LinearWarmup": lambda L: L.LinearWarmup(0.5, 10, 0.0, 0.5),
    "LinearWarmup_sched": lambda L: L.LinearWarmup(
        L.CosineAnnealingDecay(0.5, 10), 5, 0.01, 0.5),
    "PiecewiseDecay": lambda L: L.PiecewiseDecay([5, 12, 20],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "CosineAnnealingDecay": lambda L: L.CosineAnnealingDecay(0.5, 12, 0.01),
    "CosineAnnealingWarmRestarts": lambda L: L.CosineAnnealingWarmRestarts(
        0.5, 4, 2, 0.001),
    "MultiStepDecay": lambda L: L.MultiStepDecay(0.5, [3, 9, 20], 0.3),
    "StepDecay": lambda L: L.StepDecay(0.5, 7, 0.5),
    "LambdaDecay": lambda L: L.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "OneCycleLR": lambda L: L.OneCycleLR(1.0, 30, phase_pct=0.25),
    "CyclicLR": lambda L: L.CyclicLR(0.01, 0.5, 4, 6),
    "CyclicLR_triangular2": lambda L: L.CyclicLR(0.01, 0.5, 3,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda L: L.CyclicLR(0.01, 0.5, 3,
                                               mode="exp_range",
                                               exp_gamma=0.9),
    "LinearLR": lambda L: L.LinearLR(0.5, 20, 0.25, 1.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_lr_sequence_equals_reference(name):
    r, p = SCHEDULERS[name](ref.optimizer.lr), SCHEDULERS[name](
        pt.optimizer.lr)
    rs, ps = [], []
    for _ in range(30):
        rs.append(r())
        ps.append(p())
        r.step()
        p.step()
    assert ps == rs
    assert p.state_dict() == r.state_dict()


def test_reduce_on_plateau_equals_reference():
    kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    r = ref.optimizer.lr.ReduceOnPlateau(0.5, **kw)
    p = pt.optimizer.lr.ReduceOnPlateau(0.5, **kw)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9,
               1.0, 0.4, 0.45, 0.46, 0.47, 0.48, 0.49, 0.5, 0.51]
    rs, ps = [], []
    for m in metrics + metrics:
        r.step(m)
        p.step(pt.to_tensor(np.float32(m)))
        rs.append(r())
        ps.append(p())
    assert ps == rs and ps[-1] < 0.5


def test_optimizer_reads_its_scheduler_at_every_step():
    """SGD under a StepDecay: the parameters follow the reference's, the
    lr read at each step; ``set_lr`` under a scheduler raises, and the
    scheduler's state rides in the optimizer's ``state_dict``."""
    scheds = {}

    def make(p, m):
        scheds[p] = p.optimizer.lr.StepDecay(0.5, 1, 0.5)
        return p.optimizer.SGD(scheds[p], parameters=m.parameters())

    def after(ropt, popt):
        assert popt.get_lr() == ropt.get_lr()
        scheds[ref].step()
        scheds[pt].step()

    _, _, ropt, popt = _run(make, steps=4, on_step=after)
    assert popt.get_lr() == 0.5 * 0.5 ** 4
    with pytest.raises(RuntimeError, match="LRScheduler"):
        popt.set_lr(0.1)
    assert popt.state_dict()["LR_Scheduler"] == \
        ropt.state_dict()["LR_Scheduler"]
    opt = pt.optimizer.SGD(0.3, parameters=_net(pt).parameters())
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    opt.set_lr_scheduler(pt.optimizer.lr.ExponentialDecay(0.4, 0.5))
    assert opt.get_lr() == 0.4


# ------------------------------------------------------------ grad clips

def _grads(p, model):
    _loss(p, model, 7).backward()
    return [(q, q.grad) for q in model.parameters()]


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm",
                                  "global_norm_loose"])
def test_grad_clip_matches_reference(clip):
    def make(p):
        return {"value": lambda: p.nn.ClipGradByValue(0.05, -0.02),
                "norm": lambda: p.nn.ClipGradByNorm(0.1),
                "global_norm": lambda: p.nn.ClipGradByGlobalNorm(0.2),
                "global_norm_loose": lambda: p.nn.ClipGradByGlobalNorm(
                    1e4)}[clip]()

    rm, pm = _pair()
    r_out = make(ref)(_grads(ref, rm))
    p_out = make(pt)(_grads(pt, pm))
    for (_, rg), (_, pg) in zip(r_out, p_out):
        _close(pg.numpy(), rg.numpy())

    # the same clip inside the optimizer
    def opt(p, m):
        return p.optimizer.SGD(0.5, parameters=m.parameters(),
                               grad_clip=make(p))
    _run(opt)


def test_global_norm_clip_skips_need_clip_false():
    rm, pm = _pair()
    for m in (rm, pm):
        m[0].weight.need_clip = False
    r_out = ref.nn.ClipGradByGlobalNorm(0.01)(_grads(ref, rm))
    p_out = pt.nn.ClipGradByGlobalNorm(0.01)(_grads(pt, pm))
    for (_, rg), (_, pg) in zip(r_out, p_out):
        _close(pg.numpy(), rg.numpy())
    np.testing.assert_array_equal(p_out[0][1].numpy(), pm[0].weight.grad
                                  .numpy())


def test_clip_grad_norm_matches_reference():
    rm, pm = _pair()
    for p, m in ((ref, rm), (pt, pm)):
        _loss(p, m, 3).backward()
    r_norm = ref.nn.clip.clip_grad_norm_(rm.parameters(), 0.1)
    p_norm = pt.nn.clip_grad_norm_(pm.parameters(), 0.1)
    _close(p_norm.numpy(), r_norm.numpy())
    for rp, pp in zip(rm.parameters(), pm.parameters()):
        _close(pp.grad.numpy(), rp.grad.numpy())
