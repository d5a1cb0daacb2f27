"""The port's flashmask attention against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run the plain PyTorch versions of the
three flashmask CUDA kernels; the reference runs its Pallas kernels in
interpret mode (as its own tests do off the TPU), with blocks of
``min(128, S)`` rows as its ``_flashmask_body`` picks them. Inputs are
made from a seed with numpy and handed to both.

Tolerances, fp32 on both sides: out and lse agree to 2e-5 (the
reference's online softmax over up to two key blocks against the plain
version's one-pass softmax: a few ulp of values of order 1 to 10);
gradients to 1e-4 (sums over up to 200 rows of products of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.nn.functional.flash_attention import \
    flashmask_attention_dense as ref_dense
from paddle_tpu.ops.pallas import flash_varlen as ref_fv
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.ops.cuda import flash_varlen as pt_fv

HEAD_DIM, SCALE = 32, 0.2
DOCS = [70, 10, 90, 30]  # sums to 200; key tiles of 64 get skipped
# name: (batch, sq, sk, heads, start/end rows per batch row (1: shared by
# the heads), columns, kind). "random": starts anywhere in [0, sq], two
# columns end up to sq/2 later; "docs": a causal document mask (whole
# 64-row tiles banned); "band": every column bans rows [100, 130), so
# those rows see no key. Sq 160 and 200 span the kernels' 64-row tiles
# and the reference's 128-row blocks; sq > sk start-only bans must reach
# the rows past the keys (the end is INT32_MAX, not sk).
CASES = {
    "random_1col_shared": (2, 160, 160, 2, 1, 1, "random"),
    "random_2col_per_head": (1, 200, 200, 2, 2, 2, "random"),
    "docs_1col_shared": (2, 200, 200, 2, 1, 1, "docs"),
    "band_2col_per_head": (1, 160, 160, 2, 2, 2, "band"),
    "sq_gt_sk_start_only": (1, 200, 72, 2, 2, 1, "random"),
    "sq_lt_sk_2col": (1, 72, 200, 2, 1, 2, "random"),
}


def _startend(kind, b, hs, sq, sk, cols, rng):
    shape = (b, hs, sk, 1)
    if kind == "docs":
        start = np.broadcast_to(
            chip_smoke.document_starts(DOCS)[None, None, :, None], shape)
        end = np.full(shape, sq + 1)
    elif kind == "band":
        start = rng.randint(0, 101, size=shape)
        end = rng.randint(130, sq + 21, size=shape)
    else:
        start = rng.randint(0, sq + 1, size=shape)
        end = start + rng.randint(0, sq // 2 + 1, size=shape)
    idx = np.concatenate([start, end], -1) if cols == 2 else start
    return np.ascontiguousarray(idx).astype(np.int32)


def _case(name, seed=0, d=HEAD_DIM):
    b, sq, sk, h, hs, cols, kind = CASES[name]
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    return q, k, v, do, _startend(kind, b, hs, sq, sk, cols, rng)


def _ref_run(q, k, v, do, idx, causal, scale=SCALE):
    """Reference out, lse ``[B*H, Sq, 1]`` and (dq, dk, dv): out and
    gradients through ``_flashmask_body``, lse from ``_fm_fwd`` on the
    reference's own padding."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(lambda a, b_, c: ref_fv._flashmask_body(
        a, b_, c, jnp.asarray(idx), scale, causal), jq, jk, jv)
    grads = vjp(jnp.asarray(do))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bq, bk = min(ref_fv._BQ, sq), min(ref_fv._BK, sk)
    sq_pad, sk_pad = -(-sq // bq) * bq, -(-sk // bk) * bk

    def heads(x, s, n):
        return ref_fv._pad_to(jnp.swapaxes(x, 1, 2).reshape(b * h, s, d),
                              n, 1)

    full = jnp.broadcast_to(jnp.asarray(idx), (b, h, sk, idx.shape[-1]))
    st = full[..., 0].reshape(b * h, sk)
    en = full[..., 1].reshape(b * h, sk) if idx.shape[-1] > 1 else \
        jnp.full_like(st, pt_fv.INT32_MAX)
    _, lse = ref_fv._fm_fwd(
        heads(jq, sq, sq_pad), heads(jk, sk, sk_pad), heads(jv, sk, sk_pad),
        ref_fv._pad_to(st, sk_pad, 1)[..., None],
        ref_fv._pad_to(en, sk_pad, 1)[..., None], scale, causal, bq, bk, sk)
    return (np.asarray(out), np.asarray(lse)[:, :sq],
            tuple(np.asarray(g) for g in grads))


def _port_run(q, k, v, do, idx, causal, scale=SCALE):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    t_idx = torch.from_numpy(idx)
    out = pt_fv.flashmask_attention_kernel(tq, tk, tv, t_idx, scale, causal)
    out.backward(torch.from_numpy(do))
    b, sq, h, d = q.shape
    plan = pt_fv.flashmask_plan(t_idx, h, causal)
    _, lse = pt_fv.flashmask_fwd(
        *(torch.from_numpy(x).transpose(1, 2).reshape(b * h, -1, d)
          .contiguous() for x in (q, k, v)), plan, scale)
    return (out.detach().numpy(), lse.numpy(),
            tuple(t.grad.numpy() for t in (tq, tk, tv)))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _blind_rows(idx, b, h, sq, sk, causal):
    """bool [B, Sq, H]: query rows that see no key."""
    full = np.broadcast_to(idx, (b, h, sk, idx.shape[-1]))
    st = full[..., 0][:, :, None, :]
    en = full[..., 1][:, :, None, :] if idx.shape[-1] > 1 \
        else np.iinfo(np.int32).max
    qp = np.arange(sq)[None, None, :, None]
    sees = ~((qp >= st) & (qp < en))
    if causal:
        sees &= np.arange(sk)[None, None, None, :] <= qp
    return ~sees.any(-1).transpose(0, 2, 1)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flashmask_matches_reference(case, causal):
    q, k, v, do, idx = _case(case)
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, idx, causal)
    out, lse, grads = _port_run(q, k, v, do, idx, causal)
    b, sq, h, _ = q.shape
    assert out.shape == q.shape and lse.shape == (b * h, sq, 1)
    _close(out, ref_out, 2e-5)
    _close(lse, ref_lse, 2e-5)
    for got, want in zip(grads, ref_grads):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_rows_that_see_no_key_are_zero(causal):
    """Rows [100, 130) of the band case, and under causal rows banned by
    every key up to them: out, lse and dq exactly 0 on both sides."""
    q, k, v, do, idx = _case("band_2col_per_head")
    b, sq, h, _ = q.shape
    blind = _blind_rows(idx, b, h, sq, k.shape[1], causal)
    assert blind[:, 100:130].all() and not blind.all()
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, idx, causal)
    out, lse, grads = _port_run(q, k, v, do, idx, causal)
    for a in (out, ref_out, grads[0], ref_grads[0]):
        assert not a[blind].any()
    lse_rows = blind.transpose(0, 2, 1).reshape(b * h, sq)
    assert not lse[lse_rows].any() and not ref_lse[lse_rows].any()
    assert out[~blind].any()


def test_bf16_matches_reference():
    """bf16 io on both sides, compute in fp32, as the varlen bf16 test:
    one bf16 ulp of the element (2^-7 relative) plus 1e-2 absolute; lse
    (fp32 from bf16 q and k) at 1e-5."""
    q, k, v, do, idx = _case("docs_1col_shared", seed=3)
    q, k, v, do = (x.astype(jnp.bfloat16) for x in (q, k, v, do))
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, idx, True)
    tq, tk, tv = (torch.from_numpy(x.astype(np.float32)).bfloat16()
                  .requires_grad_() for x in (q, k, v))
    out = pt_fv.flashmask_attention_kernel(tq, tk, tv, torch.from_numpy(idx),
                                           SCALE, True)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(do.astype(np.float32)).bfloat16())
    b, sq, h, d = q.shape
    _, lse = pt_fv.flashmask_fwd(
        *(t.detach().transpose(1, 2).reshape(b * h, sq, d).contiguous()
          for t in (tq, tk, tv)),
        pt_fv.flashmask_plan(torch.from_numpy(idx), h, True), SCALE)
    bf16 = dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               ref_out.astype(np.float32), **bf16)
    _close(lse.numpy(), ref_lse, 1e-5)
    for t, want in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   want.astype(np.float32), **bf16)


def test_fp16_matches_reference():
    """fp16 io on both sides (the card runs it on the tensor-core
    kernels), as the bf16 test above at fp16's ulp: 2^-10 relative plus
    2e-3 absolute, about an ulp at 2..4; lse (fp32 from fp16 q and k) at
    1e-5."""
    q, k, v, do, idx = _case("random_2col_per_head", seed=4)
    q, k, v, do = (x.astype(np.float16) for x in (q, k, v, do))
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, idx, True)
    out, lse, grads = _port_run(q, k, v, do, idx, True)
    assert out.dtype == np.float16
    fp16 = dict(rtol=2 ** -10, atol=2e-3)
    np.testing.assert_allclose(out.astype(np.float32),
                               ref_out.astype(np.float32), **fp16)
    _close(lse, ref_lse, 1e-5)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == np.float16
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), **fp16)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [48, 80, 160, 256, 288])
def test_padded_head_dim_matches_reference(d, causal):
    """On the card a head_dim of 48, 80, 160 or 288 runs at 64, 128, 256
    or 512 (``_pad_head_dim``: zero columns in, results sliced back; 256 is
    a kernel size and passes as it is). The same
    pad and slice around the plain versions matches the reference at the
    caller's head_dim, at the fp32 tolerances above."""
    from paddle_tpu_torch.ops.cuda import flash_attention as pt_fa
    q, k, v, do, idx = _case("band_2col_per_head", seed=5, d=d)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, idx, causal, scale)
    b, sq, h, _ = q.shape
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       .reshape(b * h, -1, d).contiguous()
                       for x in (q, k, v, do))
    plan = pt_fv.flashmask_plan(torch.from_numpy(idx), h, causal)
    out, lse = pt_fa._pad_head_dim(
        lambda *t: pt_fv.flashmask_fwd_plain(*t, plan, scale), tq, tk, tv)
    assert out.shape == tq.shape
    back = lambda x: x.view(b, h, -1, d).transpose(1, 2).numpy()
    _close(back(out), ref_out, 2e-5)
    _close(lse.numpy(), ref_lse, 2e-5)
    delta = pt_fa.attention_delta(tdo, out)
    dk, dv = pt_fa._pad_head_dim(lambda *t: pt_fv.flashmask_bwd_dkv_plain(
        *t, lse, delta, plan, scale), tq, tk, tv, tdo)
    dq = pt_fa._pad_head_dim(lambda *t: pt_fv.flashmask_bwd_dq_plain(
        *t, lse, delta, plan, scale), tq, tk, tv, tdo)
    for got, want in zip((dq, dk, dv), ref_grads):
        _close(back(got), want, 1e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["startend", "none"])
def test_functional_matches_reference(with_mask, causal):
    """``flashmask_attention`` against the reference's (its Pallas kernel
    with a startend, its dense causal SDPA without one); the dense oracles
    against each other."""
    q, k, v, _, idx = _case("random_2col_per_head")
    ref_in = [paddle.to_tensor(x) for x in (q, k, v)]
    pt_in = [torch.from_numpy(x) for x in (q, k, v)]
    ref_idx = paddle.to_tensor(idx) if with_mask else None
    pt_idx = torch.from_numpy(idx) if with_mask else None
    ref = np.asarray(RF.flashmask_attention(*ref_in, ref_idx,
                                            causal=causal).numpy())
    out = F.flashmask_attention(*pt_in, pt_idx, causal=causal)
    assert out.shape == q.shape
    _close(out.numpy(), ref, 2e-5)
    ref_d = np.asarray(ref_dense(*ref_in, ref_idx, causal=causal).numpy())
    dense = F.flashmask_attention_dense(*pt_in, pt_idx, causal=causal)
    _close(dense.numpy(), ref_d, 2e-5)
    # the dense oracle spreads a row that sees no key over every key; the
    # kernels give it 0; elsewhere the two agree
    b, sq, h, _ = q.shape
    sees = ~_blind_rows(idx, b, h, sq, k.shape[1], causal) if with_mask \
        else np.ones(q.shape[:3], bool)
    _close(out.numpy()[sees], dense.numpy()[sees], 2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_tile_statistics_match_brute_force(case):
    q, k, _, _, idx = _case(case)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    plan = pt_fv.flashmask_plan(torch.from_numpy(idx), h, True)
    hs = idx.shape[1]
    st = idx[..., 0].reshape(b * hs, sk)
    en = idx[..., 1].reshape(b * hs, sk) if idx.shape[-1] > 1 \
        else np.full_like(st, np.iinfo(np.int32).max)
    nkt = -(-sk // 64)
    for t in (plan.st, plan.en, plan.st_max, plan.en_min):
        assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(plan.st.numpy(), st)
    np.testing.assert_array_equal(plan.en.numpy(), en)
    for j in range(nkt):
        cols = slice(64 * j, min(64 * j + 64, sk))  # real columns only
        np.testing.assert_array_equal(plan.st_max[:, j].numpy(),
                                      st[:, cols].max(1))
        np.testing.assert_array_equal(plan.en_min[:, j].numpy(),
                                      en[:, cols].min(1))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_visible_pair_lies_in_an_open_tile(case, causal):
    q, k, _, _, idx = _case(case)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    plan = pt_fv.flashmask_plan(torch.from_numpy(idx), h, causal)
    tiles = pt_fv.flashmask_tiles(plan, sq).numpy()
    hs = idx.shape[1]
    mask = pt_fv.flashmask_mask(plan, b * h, sq, sk).numpy()
    row_of = np.array([plan.row(i) for i in range(b * h)])
    bh, qp, kp = np.nonzero(mask)
    assert tiles[row_of[bh], qp // 64, kp // 64].all()
    assert tiles.shape == (b * hs, -(-sq // 64), -(-sk // 64))
    if CASES[case][6] == "docs":
        assert not tiles.all()  # whole tiles are skipped


def test_path_shape_plan_opens_1467_tiles_per_head():
    """At the card's path shape (batch 2 x seq 4096, a share-question and
    a document mask, causal) the mask keeps 5,315,973 pairs per head and
    the kernels visit 1,467 of the 4,160 causal 64x64 tiles: exactly the
    tiles that hold a visible pair."""
    idx = torch.from_numpy(chip_smoke.flashmask_startend())
    s = chip_smoke.FM_SEQ
    plan = pt_fv.flashmask_plan(idx, 16, True)
    tiles = pt_fv.flashmask_tiles(plan, s)
    assert tiles.shape == (2, 64, 64) and int(tiles.sum()) == 1467
    # grid heads 0 and 16: head 0 of batch rows 0 and 1
    mask = torch.cat([pt_fv.flashmask_mask(plan.select(i), 1, s, s)
                      for i in (0, 16)])
    assert int(mask.sum()) == 5315973
    holds_a_pair = mask.view(2, 64, 64, 64, 64).any(4).any(2)
    assert torch.equal(tiles, holds_a_pair)


def test_document_mask_equals_varlen_on_the_documents():
    """A causal document mask is varlen attention over the documents:
    out and gradients equal those of ``flash_attn_varlen`` to 1e-6."""
    rng = np.random.RandomState(4)
    t, h = sum(DOCS), 2
    q, k, v, do = (rng.randn(t, h, HEAD_DIM).astype(np.float32)
                   for _ in range(4))
    idx = torch.from_numpy(chip_smoke.document_starts(DOCS))[None, None, :,
                                                             None]
    cu = torch.tensor(np.cumsum([0] + DOCS), dtype=torch.int32)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out_m = pt_fv.flashmask_attention_kernel(*(x[None] for x in a), idx,
                                             SCALE, causal=True)[0]
    out_m.backward(torch.from_numpy(do))
    out_v = pt_fv.flash_attn_varlen(*b, cu, cu, SCALE, causal=True)
    out_v.backward(torch.from_numpy(do))
    _close(out_m.detach().numpy(), out_v.detach().numpy(), 1e-6)
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy(), 1e-6)


def test_plan_select_is_one_head_of_the_plan():
    """``select(i)`` is grid head i's row: the plain forward one head at a
    time equals it over all heads (how the card's check runs it)."""
    q, k, v, _, idx = _case("random_2col_per_head")
    b, sq, h, d = q.shape
    plan = pt_fv.flashmask_plan(torch.from_numpy(idx), h, True)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).reshape(b * h, -1, d)
                  for x in (q, k, v))
    out, lse = pt_fv.flashmask_fwd_plain(qt, kt, vt, plan, SCALE)
    for i in range(b * h):
        o1, l1 = pt_fv.flashmask_fwd_plain(qt[i:i + 1], kt[i:i + 1],
                                           vt[i:i + 1], plan.select(i), SCALE)
        assert torch.equal(o1, out[i:i + 1]) and torch.equal(l1, lse[i:i + 1])


def test_plain_path_counts_no_launch():
    before = dict(pt_fv.LAUNCHES)
    q, k, v, do, idx = _case("docs_1col_shared")
    _port_run(q, k, v, do, idx, causal=True)
    assert pt_fv.LAUNCHES == before


def test_int64_startend_gives_the_same_result():
    q, k, v, _, idx = _case("sq_lt_sk_2col")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    a = pt_fv.flashmask_attention_kernel(*args, torch.from_numpy(idx))
    b = pt_fv.flashmask_attention_kernel(*args,
                                         torch.from_numpy(idx).long())
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float", "rank", "four_columns", "heads",
                                 "keys", "batch", "qkv", "plan"])
def test_flashmask_rejects_bad_inputs(bad):
    q, k, v, _, idx = _case("random_2col_per_head")
    q, k, v, idx = (torch.from_numpy(x) for x in (q, k, v, idx))
    if bad == "plan":
        # a plan made for another head count is refused before a launch
        # (the kernels would index past its arrays)
        plan = pt_fv.flashmask_plan(idx, 4, True)
        x = q.transpose(1, 2).reshape(-1, q.shape[1], q.shape[3])
        with pytest.raises(ValueError, match="does not fit"):
            pt_fv.flashmask_fwd(x, x, x, plan, SCALE)
        return
    err = ValueError
    if bad == "float":
        idx, err = idx.float(), TypeError
    elif bad == "rank":
        idx = idx[0]
    elif bad == "four_columns":
        idx = torch.cat([idx, idx], -1)
    elif bad == "heads":
        idx = torch.cat([idx, idx], 1)
    elif bad == "keys":
        idx = idx[:, :, :-1]
    elif bad == "batch":
        idx = torch.cat([idx, idx], 0)
    else:
        k = k[:, :, :1]
    with pytest.raises(err):
        F.flashmask_attention(q, k, v, idx)


@pytest.mark.parametrize("kw", [dict(dropout=0.1), dict(window_size=(8, 8)),
                                dict(return_softmax_lse=True),
                                dict(return_seed_offset=True)],
                         ids=["dropout", "window_size", "return_softmax_lse",
                              "return_seed_offset"])
def test_not_yet_ported_options_raise(kw):
    q = torch.zeros(1, 8, 2, 32)
    idx = torch.full((1, 1, 8, 1), 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        F.flashmask_attention(q, q, q, idx, **kw)
