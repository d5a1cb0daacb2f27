"""The lazy window on the card (``cuda``-marked: skips without one; imports
no JAX, so ``python -m pytest --noconftest -m cuda`` runs it on the card's
machine).

- The eager GPT step (2 layers, hidden 64, 4 heads, seq 128, batch 2, O1
  bf16, AdamW) under the ambient window against the window off, each from
  seed 0: three losses and every parameter bit-equal, #1/#2/#3 launched
  once a layer a step both ways, 2 executions a steady step under the
  window.
- The async flush on the card: a chain sealed on the worker (cap 16)
  bit-equal to the synchronous run, recorded on a side stream (the worker
  runs it there), and gradients through worker-sealed segments bit-equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch._core import async_flush, dispatch, lazy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dtype="float32")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pt.set_device("gpu")
    yield
    lazy.enable_eager_fusion(False)
    pt.set_flags({"FLAGS_async_flush": False,
                  "FLAGS_lazy_max_segment_ops": 256})
    async_flush.drain(raise_latched=False)


def _gpt_run(on, steps=3):
    lazy.enable_eager_fusion(on)
    pt.seed(0)
    model = gpt.GPTForPretraining(gpt.GPTConfig(**CFG))
    crit = gpt.GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    r = np.random.RandomState(0)
    x = pt.to_tensor(r.randint(0, 256, (2, 128)))
    y = pt.to_tensor(r.randint(0, 256, (2, 128)))
    fa.reset_launches()
    losses, execs = [], []
    for _ in range(steps):
        n0 = dispatch.exec_count()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        execs.append(dispatch.exec_count() - n0)
    lazy.enable_eager_fusion(False)
    return losses, [p.numpy() for p in model.parameters()], \
        dict(fa.LAUNCHES), execs


def test_window_gpt_step_equals_off(card):
    on, off = _gpt_run(True), _gpt_run(False)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)
    assert on[2] == off[2] == {n: 3 * CFG["num_layers"] for n in fa.LAUNCHES}
    assert on[3][1:] == [2, 2]


def _chain(n=40):
    x = pt.to_tensor(np.full((64, 64), 1.25, "float32"))
    y = x
    for _ in range(n):
        y = y * 1.01 + 0.001
    return y.numpy()


def test_async_flush_on_a_side_stream_equals_sync(card):
    lazy.enable_eager_fusion(True)
    sync = _chain()
    pt.set_flags({"FLAGS_async_flush": True,
                  "FLAGS_lazy_max_segment_ops": 16})
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = _chain()
    async_flush.drain()
    np.testing.assert_array_equal(got, sync)

    def grads():
        w = pt.to_tensor(np.full((32, 32), 0.5, "float32"),
                         stop_gradient=False)
        z = w
        for _ in range(24):
            z = z * 1.1 + 0.1
        z.sum().backward()
        return w.grad.numpy()
    g_async = grads()
    pt.set_flags({"FLAGS_async_flush": False})
    np.testing.assert_array_equal(g_async, grads())
