"""The slice as a whole: the port's eager GPT trained under its lazy
window against the reference's under its ambient fusion, on the CPU.

Model: ``GPTForPretraining`` at 2 layers, hidden 64, 4 heads, seq 128,
vocab 256, batch 2, fp32, the reference's weights moved to the port
through ``state_dict()`` as numpy arrays; tokens and labels from a numpy
seed. The reference's attention is pinned to its Pallas kernel in
interpret mode (``PT_FLASH_INTERPRET=1``); the port's kernels take their
plain versions (the tensors lie on the CPU).

- Three AdamW steps (lr 1e-4) under the window: losses 1e-5 relative,
  parameters 1e-5 absolute (7.8e-6 seen, in the key third of a qkv bias,
  whose gradient is 0 in exact arithmetic and which Adam moves by
  rounding noise on both sides); every steady step is one fused
  forward+backward and one update on both sides (the executions counted
  by each package's ``dispatch.exec_count``).
- The same steps in the port with the window on against off: bit-equal
  losses and parameters, fp32 and bf16 O1 (the same ops run in the same
  order).
- ``to_static(full_graph=False)`` of the model's loss with a ``print`` of
  a value inside (a graph break, two segments) against eager, on both
  packages: 1e-5 relative.

The window's step on the card against the window off is
``tests/test_torch_cuda_lazy.py`` (``cuda``-marked; it imports no JAX, so
it runs on the card's machine).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import dispatch as ref_dispatch
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import dispatch as pt_dispatch
from paddle_tpu_torch._core import lazy as pt_lazy
from paddle_tpu_torch.models import gpt as pt_gpt

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dtype="float32")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")


def _weights():
    ref.seed(0)
    rm = ref_gpt.GPTForPretraining(ref_gpt.GPTConfig(**CFG))
    return rm, {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}


def _port_model(weights):
    pm = pt_gpt.GPTForPretraining(pt_gpt.GPTConfig(**CFG))
    missing, unexpected = pm.set_state_dict(weights)
    assert not missing and not unexpected
    return pm


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, (2, 128)), r.randint(0, 256, (2, 128))


def _train(paddle, gpt, model, steps=3, amp=None):
    """``steps`` AdamW steps; (losses, execs a step, last breaks)."""
    from importlib import import_module
    lazy = import_module(paddle.__name__ + "._core.lazy")
    dispatch = import_module(paddle.__name__ + "._core.dispatch")
    crit = gpt.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    x, y = _batch()
    losses, execs = [], []
    for _ in range(steps):
        n0 = dispatch.exec_count()
        if amp is None:
            loss = crit(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        else:
            with paddle.amp.auto_cast(level="O1", dtype=amp):
                loss = crit(model(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        execs.append(dispatch.exec_count() - n0)
    ctx = lazy.current_context()
    return losses, execs, (ctx.breaks[-steps:] if ctx else None)


def _fusion(on):
    pt_lazy.enable_eager_fusion(on)


def test_three_adamw_steps_under_the_window_match_reference():
    rm, w = _weights()
    pm = _port_model(w)
    assert ref_lazy.eager_fusion_enabled()
    r_losses, r_execs, r_breaks = _train(ref, ref_gpt, rm)
    _fusion(True)
    try:
        p_losses, p_execs, p_breaks = _train(pt, pt_gpt, pm)
    finally:
        _fusion(False)
    np.testing.assert_allclose(p_losses, r_losses, rtol=1e-5)
    assert p_breaks == r_breaks == ["backward_fused"] * 3
    assert p_execs[1:] == r_execs[1:] == [2, 2]
    for (name, rp), (pname, pp) in zip(rm.named_parameters(),
                                       pm.named_parameters()):
        assert name == pname
        np.testing.assert_allclose(pp.numpy(), rp.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_window_on_equals_off_bit_for_bit(amp):
    _, w = _weights()
    runs = {}
    for on in (True, False):
        pm = _port_model(w)
        _fusion(on)
        try:
            losses, execs, _ = _train(pt, pt_gpt, pm, amp=amp)
        finally:
            _fusion(False)
        runs[on] = (losses, [p.numpy() for p in pm.parameters()], execs)
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        np.testing.assert_array_equal(a, b)
    # one execution an op off the window, two a step on it
    assert runs[True][2] == [2, 2, 2] and min(runs[False][2]) > 30


def test_sot_loss_with_a_print_break_matches_eager(capsys):
    rm, w = _weights()
    pm = _port_model(w)
    x, y = _batch(1)
    got = []
    for paddle, gpt, model in ((ref, ref_gpt, rm), (pt, pt_gpt, pm)):
        crit = gpt.GPTPretrainingCriterion()

        def loss_fn(m, a, b):
            logits = m(a)
            print("mean logit", float(logits.mean().numpy()))
            return crit(logits, b)
        sfn = paddle.jit.to_static(loss_fn, full_graph=False)
        a, b = paddle.to_tensor(x), paddle.to_tensor(y)
        want = float(loss_fn(model, a, b).numpy())
        have = float(sfn(model, a, b).numpy())
        assert abs(have - want) <= 1e-5 * abs(want)
        st = sfn.stats
        assert st["captures"] == 1 and not st["fallbacks"]
        assert len(st["breaks"][0]) == 2 and st["breaks"][0][-1] == \
            "guard_exit"
        got.append(have)
    assert abs(got[1] - got[0]) <= 1e-5 * abs(got[0])
    assert capsys.readouterr().out.count("mean logit") == 4

