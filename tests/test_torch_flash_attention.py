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
    """The kernels' contract, as the forward wrapper gives it. With a
    causal mask and sq > sk, the first sq - sk query rows see no key: the
    forward kernel (and its plain version) gives them output 0 and lse
    -1e30 (the ``l == 0`` rule). The reference's ``_fwd`` does too when no
    row of the query block sees a key, but in a block where other rows do,
    it runs the key loop, and for a row whose logits are all -1e30 its
    ``exp(s - m_new)`` is exp(0) = 1 for every masked key: that row comes
    out as the mean of v. Rows that see keys agree. ``mha_forward`` gives
    those rows the reference's output (the test below)."""
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


# (q shape, k shape) with sq > sk, causal, at the reference's default
# 512-row block caps: one query block of 576 rows whose first 64 see no key
# (mixed: those rows take the mean of v over the one key block); query
# blocks of 128 rows whose first block sees no key at all (0 on both
# sides); 512-row query blocks over 128-row key blocks, whose first block
# mixes 256 keyless rows with rows that reach two key blocks; and the
# [B, H, S, D] entry.
KEYLESS_CASES = {
    "mixed_block": ((1, 576, 32), (1, 512, 32)),
    "empty_block": ((1, 640, 32), (1, 512, 32)),
    "multi_block": ((1, 1536, 32), (1, 1280, 32)),
    "bhsd": ((1, 2, 576, 32), (1, 2, 512, 32)),
}


@pytest.mark.parametrize("case", sorted(KEYLESS_CASES))
def test_rows_that_see_no_key_match_reference(case):
    """``mha_forward`` against the reference's public ``mha_forward`` at
    its own default blocks (512): output, lse and the three gradients. Rows
    that see no key come out as the reference's (mean of v over its
    visited key blocks, or 0) at fp32 2e-5; lse -1e30 on both sides; the
    gradients at 1e-4 (neither side gives those rows a gradient)."""
    set_flags({n: 512 for n in _BLOCK_FLAGS})  # the reference's defaults
    assert pt_fa.REF_BLOCK_CAP == 512
    q_shape, k_shape = KEYLESS_CASES[case]
    q, k, v = _qkv(16, q_shape, k_shape)
    w = np.random.RandomState(17).randn(*q_shape).astype(np.float32)
    scale = 0.2

    def ref_loss(q, k, v):
        out = ref_fa.mha_forward(q, k, v, causal=True, scale=scale)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = pt_fa.mha_forward(tq, tk, tv, causal=True, scale=scale)
    (out * torch.from_numpy(w)).sum().backward()
    sq, sk = q_shape[-2], k_shape[-2]
    keyless = out.detach().reshape(-1, sq, q_shape[-1])[:, :sq - sk]
    if case == "empty_block":
        assert not keyless.any()
    else:
        assert keyless.abs().sum() > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=2e-5, atol=2e-5)
    for t, ref in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
    bh = int(np.prod(q_shape[:-2]))
    jq, jk, jv = (jnp.asarray(x.reshape(bh, -1, q_shape[-1]))
                  for x in (q, k, v))
    _, (_, _, _, _, ref_lse) = ref_fa._mha_fwd(jq, jk, jv, True, scale)
    _, lse = pt_fa.flash_fwd(*_t(*(np.asarray(x) for x in (jq, jk, jv))),
                             True, scale, sk, sk - sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-6)
    assert (lse[:, :sq - sk] == -1e30).all()


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
    if bad == "dtype":
        # the CPU path takes any type; the CUDA checks run before a launch
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
        with pytest.raises(TypeError):
            pt_fa._check_cuda("flash_fwd", (q, k, v))
        return
    if bad == "head_dim":
        # a head_dim above 256 is no longer refused: the CUDA checks take
        # 288 and 512 (the FMA kernels split over them)
        for d in (288, 512):
            wide = [torch.cat([t] * (d // 32), -1) for t in (q, k, v)]
            pt_fa._check_cuda("flash_fwd", wide)
            assert pt_fa.kernel_head_dim(d) == 512
        return
    with pytest.raises(ValueError):
        pt_fa.flash_fwd(q, k, v, True, 0.1, kv_len, 0)


def _odd_offset(shape):
    """A contiguous bf16 view one element past the start of a flat buffer:
    its base sits 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


@pytest.mark.parametrize("layout", ["fixed", "packed", "odd_offset",
                                    "odd_row_stride"])
def test_check_tma_takes_aligned_layouts_and_refuses_the_rest(layout):
    """The predicate the bf16 kernels' wrappers run before a launch, on
    CPU tensors: contiguous ``[BH, S, D]`` and packed ``[T, H, D]`` pass; a
    view at an odd element offset (base not 16-byte aligned) and a row
    stride of 18 bytes do not. A refused bf16 tensor reaches the kernel as
    a fresh contiguous copy, which passes."""
    if layout == "fixed":
        assert pt_fa.check_tma(torch.zeros(4, 100, 64, dtype=torch.bfloat16))
        return
    if layout == "packed":
        for d in (32, 64, 128):
            assert pt_fa.check_tma(torch.zeros(37, 3, d,
                                               dtype=torch.bfloat16))
        return
    if layout == "odd_offset":
        t = _odd_offset((2, 64, 64))
    else:
        t = torch.zeros(2, 64, 9, dtype=torch.bfloat16)
    assert t.is_contiguous() and not pt_fa.check_tma(t)
    if layout == "odd_offset":
        (copy,) = pt_fa._tma_inputs(t)
        assert copy.data_ptr() != t.data_ptr() and torch.equal(copy, t)
        assert pt_fa.check_tma(copy)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [48, 80, 160, 256, 288, 512])
def test_padded_head_dim_matches_reference(d, causal):
    """On the card a head_dim of 48, 80, 160 or 288 runs at 64, 128, 256 or
    512: the wrappers pad q, k, v and dO with zero columns and slice the
    results back (``_pad_head_dim``; 256 and 512 are kernel sizes and pass
    as they are). The same pad and slice around the plain versions
    matches the reference at the caller's head_dim, forward and
    gradients, at the fp32 tolerances above."""
    q, k, v = _qkv(11, (2, 256, d), (2, 256, d))
    do = np.random.RandomState(12).randn(2, 256, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    ref_out, ref_lse = ref_fa._fwd(jq, jk, jv, causal, scale, 128, 128, 256,
                                   0)
    ref_dq, ref_dk, ref_dv = ref_fa._bwd(jq, jk, jv, ref_out, ref_lse, jdo,
                                         causal, scale, 128, 128, 256, 0)
    tq, tk, tv, tdo = _t(q, k, v, do)
    args = (causal, scale, 256, 0)
    out, lse = pt_fa._pad_head_dim(
        lambda *t: pt_fa.flash_fwd_plain(*t, *args), tq, tk, tv)
    assert out.shape == (2, 256, d) and lse.shape == (2, 256, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=2e-5,
                               atol=2e-5)
    delta = pt_fa.attention_delta(tdo, out)
    dk, dv = pt_fa._pad_head_dim(lambda *t: pt_fa.flash_bwd_dkv_plain(
        *t, lse, delta, *args), tq, tk, tv, tdo)
    dq = pt_fa._pad_head_dim(lambda *t: pt_fa.flash_bwd_dq_plain(
        *t, lse, delta, *args), tq, tk, tv, tdo)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape == (2, 256, d) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_pad_head_dim_is_exact_and_keeps_kernel_sizes():
    """Zero columns leave every product as it was: the padded plain
    forward equals the unpadded one bit for bit at d = 80, and a head_dim
    the kernels are built for passes through without a copy."""
    q, k, v = _t(*_qkv(13, (2, 64, 80), (2, 64, 80)))
    args = (True, 0.11, 64, 0)
    padded = pt_fa._pad_head_dim(
        lambda *t: pt_fa.flash_fwd_plain(*t, *args), q, k, v)
    plain = pt_fa.flash_fwd_plain(q, k, v, *args)
    assert pt_fa.kernel_head_dim(80) == 128 and pt_fa.kernel_head_dim(1) == 32
    assert pt_fa.kernel_head_dim(160) == 256
    assert pt_fa.kernel_head_dim(257) == 512
    np.testing.assert_allclose(padded[0].numpy(), plain[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    q64 = q[..., :64].contiguous()
    assert pt_fa._pad_head_dim(lambda t: t, q64) is q64
    # above 256 the kernels run at the next multiple of 256
    assert pt_fa.kernel_head_dim(288) == 512
    assert pt_fa.kernel_head_dim(512) == 512
    assert pt_fa.kernel_head_dim(513) == 768


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_fp16_plain_path_matches_reference(causal):
    """fp16 io on both sides (the card runs it on the FMA kernels), compute
    in fp32: each output is rounded once to fp16, and P is rounded to fp16
    against the running max in the reference and against the final max in
    the plain version; gradients take out through delta. Held at one fp16
    ulp of the element (2^-10 relative) plus 2e-3 absolute, about an ulp
    at 2..4 where the largest values lie; lse (fp32 from fp16 q and k) at
    1e-5."""
    q, k, v = _qkv(14, (2, 256, 32), (2, 256, 32))
    do = np.random.RandomState(15).randn(2, 256, 32).astype(np.float32)
    q, k, v, do = (x.astype(np.float16) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    ref_out, ref_lse = ref_fa._fwd(jq, jk, jv, causal, scale, 128, 128, 256,
                                   0)
    ref_grads = ref_fa._bwd(jq, jk, jv, ref_out, ref_lse, jdo, causal, scale,
                            128, 128, 256, 0)
    tq, tk, tv, tdo = _t(q, k, v, do)
    args = (causal, scale, 256, 0)
    out, lse = pt_fa.flash_fwd(tq, tk, tv, *args)
    assert out.dtype == torch.float16
    delta = pt_fa.attention_delta(tdo, out)
    dk, dv = pt_fa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, *args)
    dq = pt_fa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, *args)
    fp16 = dict(rtol=2 ** -10, atol=2e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref_out).astype(np.float32), **fp16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)
    for got, ref in zip((dq, dk, dv), ref_grads):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref).astype(np.float32), **fp16)


@pytest.mark.parametrize("entry", ["mha_forward", "flash_attn_unpadded",
                                   "flashmask_attention"])
def test_head_dim_288_public_entries_match_reference(entry):
    """A head_dim above 256, which the card runs on the FMA kernels split
    over 512 columns: each public entry at head_dim 288 against the
    reference's, forward and gradients, at the fp32 tolerances above."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    import paddle_tpu_torch.nn.functional as F
    d, rng = 288, np.random.RandomState(21)
    if entry == "mha_forward":
        shapes = [(2, 256, d)] * 4
    elif entry == "flash_attn_unpadded":
        shapes = [(60, 2, d)] * 4
        cu = np.array([0, 25, 60], np.int32)
    else:
        shapes = [(1, 128, 2, d)] * 4
        idx = rng.randint(40, 129, size=(1, 1, 128, 1)).astype(np.int32)
    q, k, v, w = (rng.randn(*s).astype(np.float32) for s in shapes)

    def ref_fn(q, k, v):
        if entry == "mha_forward":
            return ref_fa.mha_forward(q, k, v, causal=True, scale=0.06)
        if entry == "flash_attn_unpadded":
            c = paddle.to_tensor(cu)
            return RF.flash_attn_unpadded(q, k, v, c, c, 35, 35, 0.06,
                                          causal=True)[0]
        return RF.flashmask_attention(q, k, v, paddle.to_tensor(idx),
                                      causal=True)

    def port_fn(q, k, v):
        if entry == "mha_forward":
            return pt_fa.mha_forward(q, k, v, causal=True, scale=0.06)
        if entry == "flash_attn_unpadded":
            c = torch.from_numpy(cu)
            return F.flash_attn_unpadded(q, k, v, c, c, 35, 35, 0.06,
                                         causal=True)[0]
        return F.flashmask_attention(q, k, v, torch.from_numpy(idx),
                                     causal=True)

    if entry == "mha_forward":
        def ref_loss(q, k, v):
            out = ref_fn(q, k, v)
            return jnp.sum(out * jnp.asarray(w)), out

        (_, ref_out), ref_grads = jax.value_and_grad(
            ref_loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref_out = np.asarray(ref_out)
        ref_grads = [np.asarray(g) for g in ref_grads]
    else:
        rq, rk, rv = (paddle.to_tensor(x, stop_gradient=False)
                      for x in (q, k, v))
        out_r = ref_fn(rq, rk, rv)
        (out_r * paddle.to_tensor(w)).sum().backward()
        ref_out = np.asarray(out_r.numpy())
        ref_grads = [np.asarray(t.grad.numpy()) for t in (rq, rk, rv)]
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = port_fn(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=2e-5,
                               atol=2e-5)
    for t, ref in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4, atol=1e-4)
