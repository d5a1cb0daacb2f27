"""The port's attention functionals against the JAX package's, on the CPU.

``paddle_tpu_torch.nn.functional`` against ``paddle_tpu.nn.functional``, in
paddle's signatures, on the same numpy inputs: the varlen entry and its
dense oracle, the fixed-length flash entries (at seq 256 the reference runs
its Pallas kernel, at seq 200 its dense fallback; the port runs its
kernels' plain versions at both), and the dense ``scaled_dot_product_attention``.

Tolerances, fp32: 2e-5 (the same softmax attention summed in other
orders). bf16 ``scaled_dot_product_attention``: both sides round the
logits, the probabilities and the output to bf16 at the same points, so
they differ where one fp32 sum rounds the other way: one bf16 ulp of the
element (2^-7 relative) plus 1e-2 absolute.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.nn.functional.flash_attention import \
    flash_attn_unpadded_dense as ref_dense
import paddle_tpu_torch.nn.functional as F


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _np(t):
    return np.asarray(t.numpy())


def _varlen_inputs():
    # segment 1 has keys and no query, segment 3 queries and no key; five
    # padding query rows and three padding key rows
    lq, lk = [6, 0, 11, 4], [8, 5, 9, 0]
    rng = np.random.RandomState(0)
    q = rng.randn(sum(lq) + 5, 2, 32).astype(np.float32)
    k = rng.randn(sum(lk) + 3, 2, 32).astype(np.float32)
    v = rng.randn(sum(lk) + 3, 2, 32).astype(np.float32)
    cu_q = np.cumsum([0] + lq).astype(np.int32)
    cu_k = np.cumsum([0] + lk).astype(np.int32)
    sees_a_key = np.zeros(q.shape[0], bool)
    sees_a_key[:cu_q[3]] = True
    return q, k, v, cu_q, cu_k, sees_a_key


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attn_unpadded_and_dense_match_reference(causal):
    q, k, v, cu_q, cu_k, sees = _varlen_inputs()
    ref_args = [paddle.to_tensor(x) for x in (q, k, v, cu_q, cu_k)]
    pt_args = [torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)]
    scale = 0.2
    ref_out, ref_soft = RF.flash_attn_unpadded(*ref_args, 11, 9, scale,
                                               causal=causal)
    out, soft = F.flash_attn_unpadded(*pt_args, 11, 9, scale, causal=causal)
    assert soft is None and ref_soft is None
    _close(out.numpy(), _np(ref_out))
    ref_d = _np(ref_dense(*ref_args, 11, 9, scale, causal=causal)[0])
    dense = F.flash_attn_unpadded_dense(*pt_args, 11, 9, scale,
                                        causal=causal)[0].numpy()
    _close(dense, ref_d)
    # the dense oracle spreads a row that sees no key over every key
    # (uniform softmax); the kernels give it 0
    _close(out.numpy()[sees], dense[sees])
    assert not out.numpy()[~sees].any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [256, 200], ids=["kernel", "fallback"])
def test_flash_attention_matches_reference(seq, causal):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, seq, 2, 32).astype(np.float32)
               for _ in range(3))
    ref_out, _ = RF.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                    causal=causal)
    out, soft = F.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
    assert soft is None and out.shape == q.shape
    _close(out.numpy(), _np(ref_out))
    qkv = np.stack([q, k, v], axis=2)
    ref_p, _ = RF.flash_attn_qkvpacked(paddle.to_tensor(qkv), causal=causal)
    packed, _ = F.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)
    _close(packed.numpy(), _np(ref_p))


def test_flash_attention_trains_through_the_kernels():
    """Gradients through ``F.flash_attention`` are the fixed-length
    kernels' backward: equal to the dense path's at seq 200."""
    rng = np.random.RandomState(2)
    x = [rng.randn(1, 200, 2, 32).astype(np.float32) for _ in range(3)]
    w = torch.from_numpy(rng.randn(1, 200, 2, 32).astype(np.float32))
    a = [torch.from_numpy(t).requires_grad_() for t in x]
    b = [torch.from_numpy(t).requires_grad_() for t in x]
    (F.flash_attention(*a, causal=True)[0] * w).sum().backward()
    (F.scaled_dot_product_attention(*b, is_causal=True) * w).sum().backward()
    for s, t in zip(a, b):
        _close(s.grad.numpy(), t.grad.numpy(), 1e-4)


@pytest.mark.parametrize("entry,what", [
    (e, w) for e in ("flash_attention", "qkvpacked", "unpadded")
    for w in ("dropout", "return_softmax")])
def test_not_yet_ported_options_raise(entry, what):
    q = torch.zeros(1, 8, 2, 32)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    kw = {"dropout": 0.1} if what == "dropout" else {"return_softmax": True}
    if entry == "flash_attention":
        call = lambda: F.flash_attention(q, q, q, **kw)
    elif entry == "qkvpacked":
        call = lambda: F.flash_attn_qkvpacked(torch.stack([q] * 3, 2), **kw)
    else:
        call = lambda: F.flash_attn_unpadded(q[0], q[0], q[0], cu, cu, 8, 8,
                                             0.2, **kw)
    with pytest.raises(NotImplementedError):
        call()


def test_sdpa_dropout_keeps_its_rate_and_scale():
    """The dense SDPA's training dropout, held by its law (the reference
    draws from jax.random, the port from the device's generator): with v
    the identity, each output row is the kept probabilities times
    1 / (1 - p); the kept share is 1 - p within five standard errors,
    every kept value is the plain probability scaled, and the mean output
    equals the plain one within five standard errors. No mask outside
    training."""
    p, sq, sk = 0.3, 64, 64
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(4, sq, 2, sk).astype(np.float32))
    k = torch.from_numpy(rng.randn(4, sk, 2, sk).astype(np.float32))
    v = torch.eye(sk).expand(4, 2, sk, sk).transpose(1, 2).contiguous()
    plain = F.scaled_dot_product_attention(q, k, v, training=False)
    assert torch.equal(plain, F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, training=False))
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=p)
    kept = out != 0
    n = kept.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n), share
    torch.testing.assert_close(out[kept], plain[kept] / (1 - p),
                               rtol=1e-6, atol=1e-7)
    # each element of out is plain/(1-p) with probability 1-p, else 0
    var = (plain ** 2 * p / (1 - p)).sum()
    assert abs((out - plain).sum().item()) < 5 * var.sqrt().item()


def test_dropout_is_a_no_op_outside_training():
    q = torch.from_numpy(np.random.RandomState(3).randn(1, 8, 2, 32)
                         .astype(np.float32))
    a, _ = F.flash_attention(q, q, q, dropout=0.1, training=False)
    b, _ = F.flash_attention(q, q, q)
    assert torch.equal(a, b)


SDPA_CASES = {
    # (sq, sk, mask kind, causal)
    "causal_cross": (6, 10, None, True),
    "bool_mask": (8, 8, "bool", False),
    "float_mask": (8, 12, "float", False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_matches_reference(case, dtype):
    import ml_dtypes
    sq, sk, kind, causal = SDPA_CASES[case]
    rng = np.random.RandomState(4)
    q = rng.randn(2, sq, 2, 16).astype(np.float32)
    k, v = (rng.randn(2, sk, 2, 16).astype(np.float32) for _ in range(2))
    mask = None
    if kind == "bool":
        mask = rng.rand(2, 1, sq, sk) > 0.3
        mask[..., 0] = True  # every row sees a key
    elif kind == "float":
        mask = rng.randn(1, 2, sq, sk).astype(np.float32)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ref_in = [paddle.to_tensor(x.astype(np_dt)) for x in (q, k, v)]
    pt_in = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    ref_mask = None if mask is None else paddle.to_tensor(
        mask if kind == "bool" else mask.astype(np_dt))
    pt_mask = None if mask is None else torch.from_numpy(mask).to(
        torch.bool if kind == "bool" else getattr(torch, dtype))
    ref = RF.scaled_dot_product_attention(*ref_in, ref_mask,
                                          is_causal=causal)
    out = F.scaled_dot_product_attention(*pt_in, pt_mask, is_causal=causal)
    assert out.dtype == getattr(torch, dtype)
    want = _np(ref).astype(np.float32)
    if dtype == "float32":
        _close(out.numpy(), want)
    else:
        np.testing.assert_allclose(out.float().numpy(), want,
                                   rtol=2 ** -7, atol=1e-2)
