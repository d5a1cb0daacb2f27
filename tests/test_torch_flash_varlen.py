"""The port's varlen flash attention against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run the plain PyTorch versions of the
three varlen CUDA kernels; the reference runs its Pallas kernels in
interpret mode (as its own tests do off the TPU), with blocks of
``min(128, T)`` rows as its ``_varlen_body`` picks them. Inputs are made
from a seed with numpy and handed to both.

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

from paddle_tpu.ops.pallas import flash_varlen as ref_fv
from paddle_tpu_torch.ops.cuda import flash_attention as pt_fa
from paddle_tpu_torch.ops.cuda import flash_varlen as pt_fv

# (query segment lengths, key segment lengths, padding query rows, padding
# key rows): equal lengths, cross lengths (top-left causal alignment:
# with lq != lk the bottom-right rule would differ), segments spanning
# blocks of 64 and 128, an empty segment on each side with padding
# rows (T > cu[-1]): segment 1 has keys and no query, segment 3 queries
# and no key; a causal key bound that ends one past a tile edge (the
# one query of segment 1 sees key 64, the first row of the second
# 64-row key tile); and a causal query bound that starts on the last row
# of a tile (key 64 is first seen by query 63)
CASES = {
    "equal": ([5, 9, 3], [5, 9, 3], 0, 0),
    "cross": ([4, 6], [7, 5], 0, 0),
    "spanning": ([70, 90, 40], [70, 90, 40], 0, 0),
    "empty_pad": ([6, 0, 11, 4], [8, 5, 9, 0], 5, 3),
    "tile_edge": ([3, 1], [64, 65], 0, 0),
    "tile_edge_k": ([3, 100], [4, 100], 0, 0),
}
HEADS, HEAD_DIM, SCALE = 2, 32, 0.2


def _case(name, seed=0, d=HEAD_DIM):
    lq, lk, pad_q, pad_k = CASES[name]
    tq, tk = sum(lq) + pad_q, sum(lk) + pad_k
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(t, HEADS, d).astype(np.float32)
                   for t in (tq, tk, tk, tq))
    cu_q = np.cumsum([0] + lq).astype(np.int32)
    cu_k = np.cumsum([0] + lk).astype(np.int32)
    return q, k, v, do, cu_q, cu_k


def _ref_prep(q, k, cu_q, cu_k, causal):
    """The reference's own padding, metadata and block bounds, as
    ``_varlen_body`` builds them."""
    tq, tk = q.shape[0], k.shape[0]
    bq, bk = min(ref_fv._BQ, tq), min(ref_fv._BK, tk)
    tq_pad, tk_pad = -(-tq // bq) * bq, -(-tk // bk) * bk
    segq, posq = ref_fv._varlen_meta(jnp.asarray(cu_q), tq_pad, pad_seg=-1)
    segk, posk = ref_fv._varlen_meta(jnp.asarray(cu_k), tk_pad, pad_seg=-2)
    qlo, qhi = ref_fv._varlen_qblock_bounds(segq, posq, jnp.asarray(cu_k),
                                            bq, bk, tk_pad, causal)
    klo, khi = ref_fv._varlen_kblock_bounds(segk, posk, jnp.asarray(cu_q),
                                            bk, bq, tq_pad, causal)
    return dict(bq=bq, bk=bk, tq_pad=tq_pad, tk_pad=tk_pad, segq=segq,
                posq=posq, segk=segk, posk=posk, qlo=qlo, qhi=qhi, klo=klo,
                khi=khi)


def _ref_run(q, k, v, do, cu_q, cu_k, causal, scale=SCALE):
    """Reference out, lse ``[H, Tq, 1]`` and (dq, dk, dv)."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: ref_fv._varlen_body(
        a, b, c, jnp.asarray(cu_q), jnp.asarray(cu_k), scale, causal),
        jq, jk, jv)
    grads = vjp(jnp.asarray(do))
    p = _ref_prep(q, k, cu_q, cu_k, causal)
    pad = lambda x, n: ref_fv._pad_to(jnp.moveaxis(x, 1, 0), n, 1)
    _, lse = ref_fv._varlen_fwd(
        pad(jq, p["tq_pad"]), pad(jk, p["tk_pad"]), pad(jv, p["tk_pad"]),
        p["segq"], p["posq"], p["segk"], p["posk"], p["qlo"], p["qhi"],
        scale, causal, p["bq"], p["bk"])
    return (np.asarray(out), np.asarray(lse)[:, :q.shape[0]],
            tuple(np.asarray(g) for g in grads))


def _port_run(q, k, v, do, cu_q, cu_k, causal, scale=SCALE):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    out = pt_fv.flash_attn_varlen(tq, tk, tv, cq, ck, scale, causal)
    out.backward(torch.from_numpy(do))
    plan = pt_fv.varlen_plan(cq, ck, q.shape[0], k.shape[0], causal)
    _, lse = pt_fv.varlen_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                              plan, scale)
    return (out.detach().numpy(), lse.numpy(),
            tuple(t.grad.numpy() for t in (tq, tk, tv)))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_varlen_matches_reference(case, causal):
    q, k, v, do, cu_q, cu_k = _case(case)
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, cu_q, cu_k, causal)
    out, lse, grads = _port_run(q, k, v, do, cu_q, cu_k, causal)
    assert out.shape == q.shape and lse.shape == (HEADS, q.shape[0], 1)
    _close(out, ref_out, 2e-5)
    _close(lse, ref_lse, 2e-5)
    for got, want in zip(grads, ref_grads):
        _close(got, want, 1e-4)


def test_rows_that_see_no_key_are_zero():
    """Padding rows past cu_q[-1] and the queries of a segment with no key:
    out, lse and dq exactly 0; padding keys and keys of a segment with no
    query: dk and dv exactly 0 (on both sides)."""
    q, k, v, do, cu_q, cu_k = _case("empty_pad")
    for causal in (False, True):
        ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, cu_q, cu_k,
                                               causal)
        out, lse, (dq, dk, dv) = _port_run(q, k, v, do, cu_q, cu_k, causal)
        blind_q = np.r_[cu_q[3]:cu_q[4], cu_q[-1]:q.shape[0]]
        unseen_k = np.r_[cu_k[1]:cu_k[2], cu_k[-1]:k.shape[0]]
        for a in (out, ref_out, dq, ref_grads[0]):
            assert not a[blind_q].any()
        assert not lse[:, blind_q].any() and not ref_lse[:, blind_q].any()
        for a in (dk, dv, ref_grads[1], ref_grads[2]):
            assert not a[unseen_k].any()
        assert out[:cu_q[3]].any()


def test_cross_lengths_causal_is_top_left():
    """Segments of 4 and 6 queries against 7 and 5 keys: the first query
    of each segment sees only the first key of its segment (top left),
    not the first Lk - Lq + 1 keys (bottom right)."""
    q, k, v, do, cu_q, cu_k = _case("cross")
    out, _, _ = _port_run(q, k, v, do, cu_q, cu_k, causal=True)
    for sq, sk in zip(cu_q[:-1], cu_k[:-1]):
        np.testing.assert_allclose(out[sq], v[sk], rtol=1e-6, atol=1e-6)


def test_bf16_matches_reference():
    """bf16 io on both sides, compute in fp32: each output is rounded once
    to bf16, and P is rounded to bf16 against the running max in the
    reference and against the final max in the plain version; gradients
    take out through delta. Held at one bf16 ulp of the element (2^-7
    relative) plus 1e-2 absolute, about an ulp at 2..4 where the largest
    values lie (seen: at most 7.8e-3 over three seeds); lse (fp32 from
    bf16 q and k) at 1e-5 (seen: 4.8e-7)."""
    q, k, v, do, cu_q, cu_k = _case("spanning", seed=3)
    q, k, v, do = (x.astype(jnp.bfloat16) for x in (q, k, v, do))
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, cu_q, cu_k, True)
    tq, tk, tv = (torch.from_numpy(x.astype(np.float32)).bfloat16()
                  .requires_grad_() for x in (q, k, v))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    out = pt_fv.flash_attn_varlen(tq, tk, tv, cq, ck, SCALE, True)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(do.astype(np.float32)).bfloat16())
    plan = pt_fv.varlen_plan(cq, ck, q.shape[0], k.shape[0], True)
    _, lse = pt_fv.varlen_fwd(tq.detach(), tk.detach(), tv.detach(), plan,
                              SCALE)
    bf16 = dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               ref_out.astype(np.float32), **bf16)
    _close(lse.numpy(), ref_lse, 1e-5)
    for t, want in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   want.astype(np.float32), **bf16)


def test_fp16_matches_reference():
    """fp16 io on both sides (the card runs it on the FMA kernels), compute
    in fp32, as the bf16 test above: one fp16 ulp of the element (2^-10
    relative) plus 2e-3 absolute, about an ulp at 2..4 where the largest
    values lie; lse (fp32 from fp16 q and k) at 1e-5."""
    q, k, v, do, cu_q, cu_k = _case("spanning", seed=5)
    q, k, v, do = (x.astype(np.float16) for x in (q, k, v, do))
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, cu_q, cu_k, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    out = pt_fv.flash_attn_varlen(tq, tk, tv, cq, ck, SCALE, True)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(do))
    plan = pt_fv.varlen_plan(cq, ck, q.shape[0], k.shape[0], True)
    _, lse = pt_fv.varlen_fwd(tq.detach(), tk.detach(), tv.detach(), plan,
                              SCALE)
    fp16 = dict(rtol=2 ** -10, atol=2e-3)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               ref_out.astype(np.float32), **fp16)
    _close(lse.numpy(), ref_lse, 1e-5)
    for t, want in zip((tq, tk, tv), ref_grads):
        assert t.grad.dtype == torch.float16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   want.astype(np.float32), **fp16)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [48, 80, 160, 256, 288])
def test_padded_head_dim_matches_reference(d, causal):
    """On the card a head_dim of 48, 80, 160 or 288 runs at 64, 128, 256
    or 512 (``_pad_head_dim``: zero columns in, results sliced back; 256 is
    a kernel size and passes as it is). The same
    pad and slice around the plain versions matches the reference at the
    caller's head_dim, at the fp32 tolerances above."""
    q, k, v, do, cu_q, cu_k = _case("empty_pad", seed=6, d=d)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse, ref_grads = _ref_run(q, k, v, do, cu_q, cu_k, causal,
                                           scale)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    plan = pt_fv.varlen_plan(torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                             q.shape[0], k.shape[0], causal)
    out, lse = pt_fa._pad_head_dim(
        lambda *t: pt_fv.varlen_fwd_plain(*t, plan, scale), tq, tk, tv)
    assert out.shape == q.shape
    _close(out.numpy(), ref_out, 2e-5)
    _close(lse.numpy(), ref_lse, 2e-5)
    delta = pt_fv.varlen_delta(tdo, out)
    dk, dv = pt_fa._pad_head_dim(lambda *t: pt_fv.varlen_bwd_dkv_plain(
        *t, lse, delta, plan, scale), tq, tk, tv, tdo)
    dq = pt_fa._pad_head_dim(lambda *t: pt_fv.varlen_bwd_dq_plain(
        *t, lse, delta, plan, scale), tq, tk, tv, tdo)
    for got, want in zip((dq, dk, dv), ref_grads):
        assert got.shape == want.shape
        _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_reference_bounds(case, causal):
    """At the reference's own block sizes the port's metadata and block
    bounds are the reference's, integer for integer."""
    q, k, _, _, cu_q, cu_k = _case(case)
    ref = _ref_prep(q, k, cu_q, cu_k, causal)
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    bq, bk, tq_pad, tk_pad = ref["bq"], ref["bk"], ref["tq_pad"], ref["tk_pad"]
    segq, posq = pt_fv.varlen_meta(cq, tq_pad, pad_seg=-1)
    segk, posk = pt_fv.varlen_meta(ck, tk_pad, pad_seg=-2)
    qlo, qhi = pt_fv.varlen_qblock_bounds(segq, posq, ck, bq, bk, tk_pad,
                                          causal)
    klo, khi = pt_fv.varlen_kblock_bounds(segk, posk, cq, bk, bq, tq_pad,
                                          causal)
    ours = dict(segq=segq, posq=posq, segk=segk, posk=posk, qlo=qlo,
                qhi=qhi, klo=klo, khi=khi)
    for key, t in ours.items():
        assert t.dtype == torch.int32, key
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[key]).ravel(),
                                      err_msg=key)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_at_kernel_tile_covers_every_visible_pair(case, causal):
    """At the kernels' 64-row tile, every (query, key) pair the mask keeps
    lies inside its query tile's key-tile bounds and its key tile's
    query-tile bounds, and tiles outside them hold no visible pair."""
    q, k, _, _, cu_q, cu_k = _case(case)
    tq, tk = q.shape[0], k.shape[0]
    plan = pt_fv.varlen_plan(torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                             tq, tk, causal)
    assert pt_fv.TILE == 64 and plan.seg_q.numel() == -(-tq // 64) * 64
    mask = pt_fv._mask(plan, tq, tk).numpy()
    qt, kt = np.nonzero(mask)
    qt, kt = qt // 64, kt // 64
    qlo, qhi, klo, khi = (t.numpy() for t in (plan.qlo, plan.qhi, plan.klo,
                                              plan.khi))
    assert ((qlo[qt] <= kt) & (kt < qhi[qt])).all()
    assert ((klo[kt] <= qt) & (qt < khi[kt])).all()
    assert qhi.max() <= -(-tk // 64) and khi.max() <= -(-tq // 64)


def test_one_segment_matches_fixed_length_kernels():
    """One segment with cu_q == cu_k is causal attention over the whole
    sequence: the varlen path equals the fixed-length one (slice 1's
    ``mha_forward``) in out and gradients."""
    rng = np.random.RandomState(4)
    t = 150
    q, k, v, do = (rng.randn(t, HEADS, HEAD_DIM).astype(np.float32)
                   for _ in range(4))
    cu = torch.tensor([0, t], dtype=torch.int32)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out_v = pt_fv.flash_attn_varlen(*a, cu, cu, SCALE, causal=True)
    out_v.backward(torch.from_numpy(do))
    out_f = pt_fa.mha_forward(*(x.transpose(0, 1) for x in b), causal=True,
                              scale=SCALE).transpose(0, 1)
    out_f.backward(torch.from_numpy(do))
    _close(out_v.detach().numpy(), out_f.detach().numpy(), 1e-6)
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy(), 1e-5)


def test_plain_path_counts_no_launch():
    before = dict(pt_fv.LAUNCHES)
    q, k, v, do, cu_q, cu_k = _case("equal")
    _port_run(q, k, v, do, cu_q, cu_k, causal=True)
    assert pt_fv.LAUNCHES == before


def test_int64_cu_seqlens_give_the_same_result():
    q, k, v, _, cu_q, cu_k = _case("cross")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    a = pt_fv.flash_attn_varlen(*args, torch.from_numpy(cu_q),
                                torch.from_numpy(cu_k), SCALE, True)
    b = pt_fv.flash_attn_varlen(*args, torch.from_numpy(cu_q).long(),
                                torch.from_numpy(cu_k).long(), SCALE, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float_cu", "segments", "rank", "heads",
                                 "empty", "plan"])
def test_varlen_rejects_bad_inputs(bad):
    q, k, v, _, cu_q, cu_k = _case("cross")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    if bad == "plan":
        # a plan made for other lengths than q's and k's is refused before
        # a launch (the kernels would index past its arrays)
        long_q = torch.cat([q] * 7)
        plan = pt_fv.varlen_plan(cq, ck, q.shape[0], k.shape[0], True)
        with pytest.raises(ValueError, match="does not fit"):
            pt_fv._plan_tensors("varlen_fwd", long_q, k, plan, plan.qlo,
                                plan.qhi, -(-long_q.shape[0] // 64))
        return
    err = ValueError
    if bad == "float_cu":
        cq, err = cq.float(), TypeError
    elif bad == "segments":
        ck = torch.cat([ck, ck[-1:]])
    elif bad == "rank":
        q = q[None]
    elif bad == "heads":
        k, v = k[:, :1], v[:, :1]
    else:
        q = q[:0]
    with pytest.raises(err):
        pt_fv.flash_attn_varlen(q, k, v, cq, ck, SCALE, True)
