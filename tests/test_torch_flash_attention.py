"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run the plain PyTorch versions of the
three CUDA kernels; the reference runs its Pallas kernels in interpret mode
(as its own tests do off the TPU) with 128-row blocks, so that at seq 256
it runs two query and two key blocks and its causal block skipping is
exercised. Inputs are made from a seed with numpy and handed to both.

Tolerances: fp32 on both sides. The forward agrees to 2e-5 (the
reference's online softmax over two key blocks against the plain
version's one-pass softmax: a few ulp). Gradients agree to 1e-4: dK and
dV sum over 256 query rows of products of order 1.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu._core.flags import flag_value, set_flags
from paddle_tpu_torch.ops.cuda import flash_attention as pt_fa

# the package re-exports a function of the module's name
ref_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
_BLOCK_FLAGS = ("FLAGS_flash_block_q", "FLAGS_flash_block_k")


@pytest.fixture(autouse=True)
def _blocks_128():
    old = {n: flag_value(n) for n in _BLOCK_FLAGS}
    set_flags({n: 128 for n in _BLOCK_FLAGS})
    yield
    set_flags(old)


def _qkv(seed, q_shape, k_shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*q_shape).astype(np.float32),
            rng.randn(*k_shape).astype(np.float32),
            rng.randn(*k_shape).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# [BH, Sq, D], [BH, Sk, D], kv_len: the training shape cut down, the cross
# shape (bottom-right causal mask with q_offset = 128) and a ragged key
# length that the kernel masks itself
FWD_CASES = {
    "self": ((4, 256, 32), (4, 256, 32), 256),
    "cross": ((2, 128, 32), (2, 256, 32), 256),
    "kv_len": ((2, 128, 32), (2, 256, 32), 200),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_out_and_lse_match_reference(case, causal):
    q_shape, k_shape, kv_len = FWD_CASES[case]
    q, k, v = _qkv(0, q_shape, k_shape)
    sq, sk = q_shape[1], k_shape[1]
    scale = 1.0 / np.sqrt(q_shape[-1])
    ref_out, ref_lse = ref_fa._fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, scale, 128, 128,
                                   kv_len, sk - sq)
    out, lse = pt_fa.flash_fwd(*_t(q, k, v), causal, scale, kv_len, sk - sq)
    assert out.shape == q.shape and lse.shape == (q_shape[0], sq, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_backward_kernels_match_reference(case, causal):
    """dK/dV and dQ from the same saved lse and delta as the reference's
    ``_bwd``: each plain version against its Pallas kernel."""
    q_shape, k_shape, kv_len = FWD_CASES[case]
    q, k, v = _qkv(1, q_shape, k_shape)
    do = np.random.RandomState(2).randn(*q_shape).astype(np.float32)
    sq, sk = q_shape[1], k_shape[1]
    scale = 0.17
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = ref_fa._fwd(jq, jk, jv, causal, scale, 128, 128, kv_len,
                           sk - sq)
    ref_dq, ref_dk, ref_dv = ref_fa._bwd(jq, jk, jv, out, lse, jdo, causal,
                                         scale, 128, 128, kv_len, sk - sq)
    tq, tk, tv, tdo = _t(q, k, v, do)
    tout, tlse = _t(np.asarray(out), np.asarray(lse))
    delta = pt_fa.attention_delta(tdo, tout)
    args = (causal, scale, kv_len, sk - sq)
    dk, dv = pt_fa.flash_bwd_dkv(tq, tk, tv, tdo, tlse, delta, *args)
    dq = pt_fa.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, *args)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shapes", [((2, 2, 256, 32), (2, 2, 256, 32)),
                                    ((2, 128, 32), (2, 256, 32))],
                         ids=["bhsd", "cross"])
def test_mha_forward_and_grads_match_reference(shapes, causal):
    q, k, v = _qkv(3, *shapes)
    w = np.random.RandomState(4).randn(*shapes[0]).astype(np.float32)
    scale = 0.15

    def ref_loss(q, k, v):
        out = ref_fa.mha_forward(q, k, v, causal=causal, scale=scale)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = pt_fa.mha_forward(tq, tk, tv, causal=causal, scale=scale)
    assert out.shape == q.shape
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=2e-5, atol=2e-5)
    for t, ref in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def test_rows_that_see_no_key_differ_from_reference():
    """A known divergence, pinned. With a causal mask and sq > sk, the
    first sq - sk query rows see no key. The port gives them output 0 and
    lse -1e30 (the ``l == 0`` rule). The reference does too when no row of
    the query block sees a key, but in a block where other rows do, it
    runs the key loop, and for a row whose logits are all -1e30 its
    ``exp(s - m_new)`` is exp(0) = 1 for every masked key: that row comes
    out as the mean of v. Rows that see keys agree."""
    q, k, v = _qkv(10, (1, 256, 32), (1, 192, 32))
    ref_out, ref_lse = ref_fa._fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True, 0.2, 128, 192,
                                   192, -64)
    out, lse = pt_fa.flash_fwd(*_t(q, k, v), True, 0.2, 192, -64)
    ref_out, ref_lse = np.asarray(ref_out), np.asarray(ref_lse)
    np.testing.assert_allclose(out[0, 64:].numpy(), ref_out[0, 64:],
                               rtol=2e-5, atol=2e-5)
    assert not out[0, :64].any()
    np.testing.assert_allclose(lse[0, :64].numpy(), -1e30, rtol=1e-6)
    np.testing.assert_allclose(ref_out[0, :64],
                               np.broadcast_to(v[0].mean(0), (64, 32)),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_paddle_layout_matches_reference():
    # [B, S, H, D], default scale
    q, k, v = _qkv(5, (2, 256, 2, 32), (2, 256, 2, 32))
    ref = ref_fa._fa_kernel_body(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), True, 1.0 / np.sqrt(32))
    out = pt_fa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_rejects_untiled_seq():
    q, k, v = _t(*_qkv(6, (1, 100, 2, 32), (1, 100, 2, 32)))
    with pytest.raises(ValueError, match="seq % 128"):
        pt_fa.flash_attention(q, k, v)


def test_plain_path_counts_no_launch():
    before = dict(pt_fa.LAUNCHES)
    q, k, v = (t.requires_grad_() for t in
               _t(*_qkv(7, (2, 128, 32), (2, 128, 32))))
    pt_fa.mha_forward(q, k, v, causal=True).sum().backward()
    assert pt_fa.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "shape", "kv_len"])
def test_wrappers_reject_bad_inputs(bad):
    q, k, v = _t(*_qkv(9, (2, 128, 32), (2, 128, 32)))
    kv_len = 128
    if bad == "shape":
        k = k[:, :, :16]
    elif bad == "kv_len":
        kv_len = 129
    if bad in ("dtype", "head_dim"):
        # the CPU path takes any type; the CUDA checks run before a launch
        if bad == "dtype":
            q, k, v = q.half(), k.half(), v.half()
            err = TypeError
        else:
            q, k, v = (t[..., :24] for t in (q, k, v))
            err = ValueError
        with pytest.raises(err):
            pt_fa._check_cuda("flash_fwd", (q, k, v))
        return
    with pytest.raises(ValueError):
        pt_fa.flash_fwd(q, k, v, True, 0.1, kv_len, 0)
