"""The port's optimizers against the JAX package's, on the CPU: three steps
of AdamW (weight decay, ``apply_decay_param_fun``, parameter groups),
Adam and SGD on a small MLP with the reference's weights, ``get_lr`` /
``set_lr``, ``clear_grad`` and the state dict.

Tolerances: fp32 on both sides; parameters after three steps at 1e-6
absolute (the gradients agree to about 1e-7, and every gradient here is
far from 0, so Adam's normalisation does not magnify rounding noise).
bf16 parameters with ``multi_precision`` keep float32 masters: given the
same bf16 gradients, held at the same 1e-6, and the bf16 parameters
exactly.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here), restored
    after it."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _mlp(p):
    return p.nn.Sequential(p.nn.Linear(8, 16), p.nn.LayerNorm(16),
                           p.nn.Linear(16, 4))


def _pair():
    ref.seed(1)
    rm, tm = _mlp(ref), _mlp(pt)
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in rm.state_dict().items()})
    return rm, tm


def _no_decay_on_vectors(model):
    names = {p.name for p in model.parameters() if len(p.shape) == 1}
    return lambda name: name not in names


OPTS = {
    "adamw_wd": lambda p, m: p.optimizer.AdamW(
        1e-2, parameters=m.parameters(), weight_decay=0.1,
        apply_decay_param_fun=_no_decay_on_vectors(m)),
    "adamw_default": lambda p, m: p.optimizer.AdamW(
        3e-3, beta1=0.8, beta2=0.99, parameters=m.parameters()),
    "adamw_groups": lambda p, m: p.optimizer.AdamW(
        1e-2, weight_decay=0.05, parameters=[
            {"params": m[0].parameters(), "learning_rate": 0.5},
            {"params": m[1].parameters() + m[2].parameters(),
             "weight_decay": 0.2}]),
    "adam": lambda p, m: p.optimizer.Adam(1e-2, parameters=m.parameters(),
                                          weight_decay=0.01),
    "sgd": lambda p, m: p.optimizer.SGD(0.1, parameters=m.parameters(),
                                        weight_decay=0.01),
}


def _loss(p, m, seed):
    r = np.random.RandomState(seed)
    x = p.to_tensor(r.randn(6, 8).astype(np.float32))
    w = p.to_tensor(r.randn(6, 4).astype(np.float32))
    return p.mean(m(x) * w) + p.mean(m(x) ** 2)


@pytest.mark.parametrize("case", sorted(OPTS))
def test_three_steps_match_reference(case):
    rm, tm = _pair()
    ro, to = OPTS[case](ref, rm), OPTS[case](pt, tm)
    for step in range(3):
        for p, m, o in ((ref, rm, ro), (pt, tm, to)):
            _loss(p, m, step).backward()
            o.step()
            o.clear_grad()
    assert all(p.grad is None for p in tm.parameters())
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.numpy(), rp.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_multi_precision_bf16_matches_reference():
    """bf16 parameters, the same bf16 gradients handed to both (a bf16
    forward rounds at other places in the two frameworks): the float32
    masters after three steps, and the bf16 parameters rounded from them,
    match."""
    rm, tm = _pair()
    opts = []
    for p, m in ((ref, rm), (pt, tm)):
        m.astype("bfloat16")
        opts.append(p.optimizer.AdamW(1e-2, parameters=m.parameters(),
                                      multi_precision=True))
    for step in range(3):
        r = np.random.RandomState(10 + step)
        for (p, m), o in zip(((ref, rm), (pt, tm)), opts):
            for prm in m.parameters():
                prm.grad = p.to_tensor(r.randn(*prm.shape).astype(
                    np.float32)).astype("bfloat16")
            o.step()
            o.clear_grad()
            r = np.random.RandomState(10 + step)
    r_state, t_state = (o.state_dict() for o in opts)
    assert t_state["step"] == r_state["step"] == 3
    for rp, tp in zip(rm.parameters(), tm.parameters()):
        assert tp.dtype == pt.bfloat16
        np.testing.assert_allclose(t_state[f"{tp.name}.master"].numpy(),
                                   r_state[f"{rp.name}.master"].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tp.numpy(), rp.numpy())


def test_lr_and_state_dict_round_trip():
    _, tm = _pair()
    opt = pt.optimizer.AdamW(1e-3, parameters=tm.parameters())
    assert opt.get_lr() == 1e-3
    opt.set_lr(2e-3)
    assert opt.get_lr() == 2e-3
    _loss(pt, tm, 0).backward()
    opt.step()
    state = opt.state_dict()
    names = [p.name for p in tm.parameters()]
    assert state["step"] == 1
    assert sorted(state) == sorted(["step"] + [f"{n}.{k}" for n in names
                                               for k in ("m", "v")])
    fresh = pt.optimizer.AdamW(2e-3, parameters=tm.parameters())
    fresh.set_state_dict({k: (v.numpy() if hasattr(v, "numpy") else v)
                          for k, v in state.items()})
    for k, v in fresh.state_dict().items():
        want = state[k]
        if k == "step":
            assert v == want
        else:
            np.testing.assert_array_equal(v.numpy(), want.numpy())
