"""The port's MoE core (``ops/moe.py``) and ``fused_moe`` against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and handed to both; the gating
jitter is off (``jitter_eps=0``), since the two packages draw different
noise. fp32 throughout, held at 1e-5: the gates, positions and capacity
drops are decided by argmax and integer cumsums, equal on both sides, and
the values differ only in the order of fp32 sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as ref_inc
from paddle_tpu.ops import moe as ref_moe
from paddle_tpu_torch.incubate.nn import functional as pt_inc
from paddle_tpu_torch.ops import moe as pt_moe


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _logits(seed, s=64, e=4, ties=False):
    rng = np.random.RandomState(seed)
    if ties:  # few distinct values: argmax ties on most rows
        return rng.randint(0, 3, (s, e)).astype(np.float32)
    return (rng.randn(s, e) * 2).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 64, 5],
                         ids=["factor", "no_drop", "drops"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_gating_matches_reference(k, capacity, ties):
    logits = _logits(0, ties=ties)
    ref_fn = ref_moe.top1_gating if k == 1 else ref_moe.top2_gating
    pt_fn = pt_moe.top1_gating if k == 1 else pt_moe.top2_gating
    c_ref, d_ref, aux_ref = ref_fn(jnp.asarray(logits), 1.25, capacity)
    c, d, aux = pt_fn(torch.from_numpy(logits), 1.25, capacity)
    assert tuple(c.shape) == tuple(c_ref.shape)
    _close(c, c_ref)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    _close(aux, aux_ref)
    if capacity == 5:  # some tokens were dropped on both sides
        assert int(d.any(-1).any(-1).sum()) < logits.shape[0]


def test_top2_default_capacity_factor_is_the_reference_flag_default():
    logits = _logits(1, s=48, e=6)
    c_ref, _, _ = ref_moe.top2_gating(jnp.asarray(logits))
    c, _, _ = pt_moe.top2_gating(torch.from_numpy(logits))
    assert c.shape[-1] == c_ref.shape[-1]
    _close(c, c_ref)


def test_top1_jitter_takes_a_generator():
    logits = torch.from_numpy(_logits(2))
    plain = pt_moe.top1_gating(logits)[0]
    same = pt_moe.top1_gating(logits, jitter_eps=0.5)[0]
    assert torch.equal(plain, same)   # no generator: no jitter
    gen = torch.Generator().manual_seed(0)
    jit = pt_moe.top1_gating(logits, jitter_eps=0.5, generator=gen)[0]
    assert jit.shape == plain.shape and not torch.equal(jit, plain)


def test_dispatch_and_combine_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    logits = _logits(4, s=16)
    c_ref, d_ref, _ = ref_moe.top2_gating(jnp.asarray(logits), capacity=16)
    c, d, _ = pt_moe.top2_gating(torch.from_numpy(logits), capacity=16)
    xe_ref = ref_moe.moe_dispatch(jnp.asarray(x), d_ref)
    xe = pt_moe.moe_dispatch(torch.from_numpy(x), d)
    _close(xe, xe_ref)
    _close(pt_moe.moe_combine(xe, c), ref_moe.moe_combine(xe_ref, c_ref))


def _ffn_weights(seed, s=32, m=8, e=4, h=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(s, m).astype(np.float32),
            rng.randn(m, e).astype(np.float32),
            (rng.randn(e, m, h) * 0.3).astype(np.float32),
            (rng.randn(e, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, m) * 0.3).astype(np.float32),
            (rng.randn(e, m) * 0.1).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_moe_ffn_matches_reference(k, activation):
    arrs = _ffn_weights(5)
    out_ref, aux_ref = ref_moe.moe_ffn(*map(jnp.asarray, arrs), k=k,
                                       activation=activation)
    out, aux = pt_moe.moe_ffn(*map(torch.from_numpy, arrs), k=k,
                              activation=activation)
    assert aux.dtype == torch.float32
    _close(out, out_ref)
    _close(aux, aux_ref)


def test_moe_ffn_grads_match_reference():
    """Gradients through the gates' probabilities and the experts."""
    arrs = _ffn_weights(6)
    cot = np.random.RandomState(7).randn(32, 8).astype(np.float32)

    def ref_loss(*a):
        out, aux = ref_moe.moe_ffn(*a, k=2)
        return jnp.sum(out * cot) + aux

    grads_ref = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out, aux = pt_moe.moe_ffn(*ts, k=2)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    for t, g in zip(ts, grads_ref):
        _close(t.grad, g, 1e-4)


def test_moe_ffn_refuses_an_unported_activation():
    arrs = [torch.from_numpy(a) for a in _ffn_weights(8)]
    with pytest.raises(NotImplementedError, match="activation"):
        pt_moe.moe_ffn(*arrs, activation="swish")


@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("biases", [False, True])
def test_fused_moe_matches_reference(topk, biases):
    x, gate_w, w0, b0, w1, b1 = _ffn_weights(9)
    x3 = x.reshape(2, 16, 8)
    kw_ref, kw_pt = {}, {}
    if biases:
        kw_ref = {"ffn1_bias": paddle.to_tensor(b0),
                  "ffn2_bias": paddle.to_tensor(b1)}
        kw_pt = {"ffn1_bias": torch.from_numpy(b0),
                 "ffn2_bias": torch.from_numpy(b1)}
    ref = ref_inc.fused_moe(paddle.to_tensor(x3), paddle.to_tensor(gate_w),
                            paddle.to_tensor(w0), paddle.to_tensor(w1),
                            moe_topk=topk, **kw_ref)
    out = pt_inc.fused_moe(torch.from_numpy(x3), torch.from_numpy(gate_w),
                           torch.from_numpy(w0), torch.from_numpy(w1),
                           moe_topk=topk, **kw_pt)
    assert tuple(out.shape) == (2, 16, 8)
    _close(out, ref.numpy())


def test_fused_moe_refuses_a_quantized_method():
    x, gate_w, w0, _, w1, _ = (torch.from_numpy(a) for a in _ffn_weights(10))
    with pytest.raises(NotImplementedError, match="quantized"):
        pt_inc.fused_moe(x, gate_w, w0, w1, quant_method="weight_only_int8")
