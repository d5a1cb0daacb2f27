"""The port's eager GPT (``paddle_tpu_torch.models.gpt``) against the JAX
package's, on the CPU.

Config: 2 layers, hidden 64, 4 heads, seq 128, vocab 256, fp32. The
reference's eager GPT runs its Pallas flash kernel in interpret mode (as
its own tests do off the TPU); the port's reaches the plain versions of
its kernels (the tensors lie on the CPU). The reference's weights move to
the port through ``state_dict()`` as numpy arrays; tokens and labels are
made from a seed with numpy.

Tolerances: fp32 on both sides, summation orders differ. Loss 1e-5
relative, gradients 1e-4 absolute (observed about 1e-8). Three AdamW steps
at lr 1e-4: losses 1e-5 relative, parameters 1e-4 absolute. Adam scales
each gradient to about 1, so a parameter whose gradient is 0 in exact
arithmetic (the key bias: softmax ignores a constant added to a row of
logits) moves by rounding noise on both sides, by up to lr a step (about
1e-5 seen). bf16 ``auto_cast`` (O1): the products and attention run in
bf16, each output rounded to 8 bits at places that differ between the two
frameworks (the port's gelu and bias add round once from fp32), so the
loss is held at 2e-3 relative (about 2^-9, bf16's half ulp; 3e-5 seen).
fp16 ``auto_cast`` (O1, as upstream Paddle defaults): the same rounding
points at fp16's 11 bits, the loss held at 5e-4 relative (about 2^-11,
fp16's half ulp; 1.5e-6 seen); the gradients of a ``GradScaler``-scaled
loss, unscaled, within 1e-2 of each tensor's largest (about 20 fp16
roundings along the chain; 2e-3 seen).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch.models import gpt as pt_gpt
from paddle_tpu_torch.ops.cuda import flash_attention as pt_fa

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dtype="float32")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here), restored
    after it."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _pair(**over):
    """The reference's model and the port's, with the reference's weights."""
    ref.seed(0)
    rm = ref_gpt.GPTForPretraining(ref_gpt.GPTConfig(**{**CFG, **over}))
    pm = pt_gpt.GPTForPretraining(pt_gpt.GPTConfig(**{**CFG, **over}))
    missing, unexpected = pm.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()})
    assert not missing and not unexpected
    return rm, pm


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, (2, 128)), r.randint(0, 256, (2, 128))


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_state_dict_keys_and_shapes_match_reference():
    rm, pm = _pair()
    want = {k: tuple(v.shape) for k, v in rm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert list(got) == list(want) and got == want


def test_loss_grads_and_three_adamw_steps_match_reference():
    rm, pm = _pair()
    rc, pc = ref_gpt.GPTPretrainingCriterion(), pt_gpt.GPTPretrainingCriterion()
    ro = ref.optimizer.AdamW(1e-4, parameters=rm.parameters())
    po = pt.optimizer.AdamW(1e-4, parameters=pm.parameters())
    x, y = _batch()
    for step in range(3):
        rl = rc(rm(ref.to_tensor(x)), ref.to_tensor(y))
        rl.backward()
        pl = pc(pm(pt.to_tensor(x)), pt.to_tensor(y))
        pl.backward()
        assert pl.dtype == pt.float32 and pl.shape == []
        assert _rel(float(pl), float(rl.numpy())) <= 1e-5, step
        if step == 0:
            for (name, rp), (pname, pp) in zip(rm.named_parameters(),
                                               pm.named_parameters()):
                assert name == pname
                np.testing.assert_allclose(pp.grad.numpy(),
                                           rp.grad.numpy(), rtol=0,
                                           atol=1e-4, err_msg=name)
        ro.step()
        ro.clear_grad()
        po.step()
        po.clear_grad()
    for rp, pp in zip(rm.parameters(), pm.parameters()):
        assert pp.grad is None
        np.testing.assert_allclose(pp.numpy(), rp.numpy(), rtol=0,
                                   atol=1e-4)


def test_bf16_auto_cast_loss_matches_reference():
    rm, pm = _pair()
    rc, pc = ref_gpt.GPTPretrainingCriterion(), pt_gpt.GPTPretrainingCriterion()
    x, y = _batch(1)
    with ref.amp.auto_cast(dtype="bfloat16"):
        rlogits = rm(ref.to_tensor(x))
        rl = rc(rlogits, ref.to_tensor(y))
    with pt.amp.auto_cast(dtype="bfloat16"):
        plogits = pm(pt.to_tensor(x))
        pl = pc(plogits, pt.to_tensor(y))
    assert plogits.dtype.name == rlogits.dtype.name == "bfloat16"
    assert pl.dtype.name == rl.dtype.name == "float32"
    assert _rel(float(pl), float(rl.numpy())) <= 2e-3
    pl.backward()
    for p in pm.parameters():  # fp32 parameters get fp32 gradients
        assert p.grad.dtype == pt.float32
        assert bool(torch.isfinite(p.grad._t).all())


def test_fp16_auto_cast_with_grad_scaler_matches_reference():
    rm, pm = _pair()
    rc, pc = ref_gpt.GPTPretrainingCriterion(), pt_gpt.GPTPretrainingCriterion()
    x, y = _batch(1)
    with ref.amp.auto_cast(level="O1", dtype="float16"):
        rlogits = rm(ref.to_tensor(x))
        rl = rc(rlogits, ref.to_tensor(y))
    with pt.amp.auto_cast(level="O1", dtype="float16"):
        plogits = pm(pt.to_tensor(x))
        pl = pc(plogits, pt.to_tensor(y))
    assert plogits.dtype.name == rlogits.dtype.name == "float16"
    assert pl.dtype.name == rl.dtype.name == "float32"
    assert _rel(float(pl), float(rl.numpy())) <= 5e-4
    rs, ps = ref.amp.GradScaler(), pt.amp.GradScaler()
    assert ps._scale == 65536.0
    rs.scale(rl).backward()
    ps.scale(pl).backward()
    for (name, rp), (_, pp) in zip(rm.named_parameters(),
                                   pm.named_parameters()):
        assert pp.grad.dtype == pt.float32
        want = np.asarray(rp.grad.numpy(), np.float64) / 65536.0
        got = pp.grad.numpy().astype(np.float64) / 65536.0
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=name)


def test_attention_reaches_the_flash_wrappers_plain_path(monkeypatch):
    """``F.flash_attention`` goes to ``mha_forward`` and the forward
    kernel's wrapper, once a layer, at ``[B*H, S, D]``; on CPU tensors the
    wrapper runs the plain version, which counts no launch."""
    _, pm = _pair()
    before = dict(pt_fa.LAUNCHES)
    calls = []
    orig = pt_fa.flash_fwd

    def spy(q, *args, **kwargs):
        calls.append((tuple(q.shape), q.dtype))
        return orig(q, *args, **kwargs)

    monkeypatch.setattr(pt_fa, "flash_fwd", spy)
    x, _ = _batch(2)
    pm(pt.to_tensor(x))
    assert calls == [((8, 128, 16), torch.float32)] * 2
    assert pt_fa.LAUNCHES == before


def test_recompute_gives_the_same_loss_and_grads():
    _, pm = _pair()
    _, pr = _pair(use_recompute=True)
    x, y = _batch(3)
    crit = pt_gpt.GPTPretrainingCriterion()
    crit(pm(pt.to_tensor(x)), pt.to_tensor(y)).backward()
    crit(pr(pt.to_tensor(x)), pt.to_tensor(y)).backward()
    for a, b in zip(pm.parameters(), pr.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_mp_group_above_degree_one_raises():
    class Group:
        nranks = 2

    from paddle_tpu_torch.distributed.fleet import ColumnParallelLinear
    with pytest.raises(NotImplementedError):
        ColumnParallelLinear(8, 8, mp_group=Group())
