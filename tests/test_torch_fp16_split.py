"""The fp16 backward kernels' hi/lo split of P and dS, emulated in plain
PyTorch on the CPU and held against the fp32 plain version.

``csrc/flash_bwd_dkv.cu`` feeds P^T and dS^T to fp16 ``wgmma`` products as
two fp16 parts each, hi = fp16(x) and lo = fp16(x - hi), summed in fp32.
fp16 keeps 11 bits but turns subnormal below 2^-14, where hi + lo keeps
only an absolute 2^-25; so the kernel splits P at 2^14 times itself and
each key row of dS at a power of two of its own, kept over the query
tiles and only lowered, that puts the row's largest |dS| in [2^14, 2^15),
and divides both out in fp32 at the end. This file repeats that
arithmetic tile by tile (64 queries a tile) on P and dS from the plain
version (``_p_ds``, fp32) at [2, 256, 64], causal, with dO at unit scale,
2^-12 and 2^8, and holds dK and dV, written in fp16, against the plain
version's with the card tests' fp16 limit: 2^-10 |x| + 1e-4 max |x|
(``chip_smoke.limit``). Seen, as a share of that limit: the kernel's
scheme 0.44 / 0.51 (dk / dv) at unit scale, 0.82 / 0.57 at 2^-12 and
0.44 / 0.51 at 2^8 (at 2^-12 many dK elements are fp16 subnormals, whose
one-ulp straddles of the output rounding sit near 0.85 of the limit);
one fp16 rounding of P and dS 1.63 / 0.92 at [4, 1024, 64], unit scale;
hi + lo without the scaling 14.1 for dk at 2^-12. The last two are why
the kernel splits and scales.

``csrc/flash_bwd_dq.cu`` feeds dS to its fp16 ``wgmma`` product dQ += dS K
the same way, split at a power of two per query row (dS's rows are query
rows there), kept over the 64-key tiles and only lowered, the dQ rows
summed so far rescaled when it falls; no P enters dQ. Seen, as a share of
the limit at [2, 256, 64]: the kernel's scheme 0.29 at unit scale, 0.86 at
2^-12 (fp16 subnormals in dq, as in dk) and 0.29 at 2^8; one fp16
rounding of dS 1.74 at unit scale; hi + lo without the scaling 18.9 at
2^-12. Rows whose largest |dS| grows by 2^21.4 or more from their first
key tile to their last (v's rows growing along the keys) hold at 0.37
with the power lowered tile by tile; kept at its first tile's power, such
a row overflows fp16. At 2^-12 dq is small enough that many of its elements
are fp16 subnormals, spaced 2^-24 apart, wider than the limit's floor:
the exact dq rounded once then misses the rounded plain version (1.26x
the limit) while it sits within 0.67x of the plain version's unrounded
fp32 result, which is what the card holds fp16 dq against at a scaled
dO.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as pt_fa

P_EXP = 14  # P is split at 2^14 times itself
TILE = 64   # query rows a tile


def _limit(want):
    want = want.float().abs()
    return 2.0 ** -10 * want + 1e-4 * want.max()


def _ratio(got, want):
    return ((got.float() - want.float()).abs() / _limit(want)).max().item()


def _hi_lo(x):
    """x as fp16 hi + lo, summed back in fp32."""
    hi = x.half()
    return hi.float() + (x - hi.float()).half().float()


def _row_power(m):
    """2^(14 - floor(log2 m)) per element of m >= 0, from the float bits
    as the kernel computes it, at most 2^100."""
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.clamp(14 - e, max=100).float().exp2()


def _kernel_dkv(p, ds, q, do):
    """dK, dV in fp16 as the fp16 kernel computes them from fp32 P and dS
    ``[bh, sq, sk]``: per query tile, P^T * 2^14 and dS^T * M (M per key
    row, the running power) split into hi + lo, products summed in fp32,
    the dK rows rescaled when M falls; the powers divided out at the end."""
    bh, sq, sk = p.shape
    dv = torch.zeros(bh, sk, do.shape[-1])
    dk = torch.zeros_like(dv)
    mul = torch.full((bh, sk, 1), 2.0 ** 100)
    for i in range(0, sq, TILE):
        pt = p[:, i:i + TILE].transpose(1, 2)
        st = ds[:, i:i + TILE].transpose(1, 2)
        dv += _hi_lo(pt * 2.0 ** P_EXP) @ do[:, i:i + TILE].float()
        want = _row_power(st.abs().amax(-1, keepdim=True))
        dk *= torch.where(want < mul, want / mul, torch.ones_like(mul))
        mul = torch.minimum(mul, want)
        dk += _hi_lo(st * mul) @ q[:, i:i + TILE].float()
    return (dk / mul).half(), (dv * 2.0 ** -P_EXP).half()


def _case(do_scale, seed=1, shape=(2, 256, 64)):
    """q, k, v, dO (dO times ``do_scale``) in fp16 from a numpy seed; the
    plain version's fp32 P and dS, and its dK, dV."""
    bh, s, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                   .half() for _ in range(4))
    do = (do.float() * do_scale).half()
    scale = 1.0 / math.sqrt(d)
    mask = pt_fa._mask(s, s, True, s, 0, "cpu")
    out, lse = pt_fa.flash_fwd_plain(q, k, v, True, scale, s, 0)
    delta = pt_fa.attention_delta(do, out)
    p, ds = pt_fa._p_ds(q, k, v, do, lse, delta, mask, scale)
    dk, dv = pt_fa.masked_bwd_dkv_plain(q, k, v, do, lse, delta, mask, scale)
    return q, do, p, ds, dk, dv


@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** -12, 2.0 ** 8],
                         ids=["unit", "2^-12", "2^8"])
def test_the_kernels_scaled_split_holds_the_fp16_limit(do_scale):
    q, do, p, ds, want_dk, want_dv = _case(do_scale)
    dk, dv = _kernel_dkv(p, ds, q, do)
    assert bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())
    assert _ratio(dk, want_dk) <= 1.0
    assert _ratio(dv, want_dv) <= 1.0


def test_one_fp16_rounding_misses_the_limit():
    """P and dS rounded once to fp16 (no lo part): over a thousand queries
    dK misses the limit at unit scale, as one bf16 rounding misses
    bf16's."""
    q, do, p, ds, want_dk, _ = _case(1.0, shape=(4, 1024, 64))
    dk = torch.einsum("bqk,bqd->bkd", ds.half().float(), q.float()).half()
    assert _ratio(dk, want_dk) > 1.0


def test_an_unscaled_split_misses_the_limit_at_small_do():
    """hi + lo of dS as it is: at dO x 2^-12 dS lies below fp16's normal
    range, lo adds nothing, and dK misses the limit many times over."""
    q, do, p, ds, want_dk, _ = _case(2.0 ** -12)
    dk = torch.einsum("bqk,bqd->bkd", _hi_lo(ds), q.float()).half()
    assert _ratio(dk, want_dk) > 4.0


def test_row_powers_put_each_rows_largest_value_in_range():
    m = torch.tensor([1.0, 0.75, 3e-5, 200.0, 0.0, 2.0 ** -30])
    scaled = m * _row_power(m)
    assert bool(((scaled[:4] >= 2 ** 14) & (scaled[:4] < 2 ** 15)).all())
    assert _row_power(m)[4].item() == 2.0 ** 100  # a row of zeros
    assert scaled[5].item() == 2.0 ** 14


# ---------------------------------------------------------------- dQ


def _kernel_dq(ds, k, lower=True):
    """dQ in fp16 as the fp16 kernel computes it from fp32 dS ``[bh, sq,
    sk]``: per 64-key tile, dS * M (M per query row, the running power)
    split into hi + lo, products summed in fp32, the dQ rows rescaled when
    M falls; the power divided out at the end. ``lower=False`` keeps each
    row at the power of its first nonzero tile (no rescale)."""
    bh, sq, sk = ds.shape
    dq = torch.zeros(bh, sq, k.shape[-1])
    mul = torch.full((bh, sq, 1), 2.0 ** 100)
    for j in range(0, sk, TILE):
        s = ds[:, :, j:j + TILE]
        want = _row_power(s.abs().amax(-1, keepdim=True))
        if not lower:
            want = torch.where(mul < 2.0 ** 100, mul, want)
        dq *= torch.where(want < mul, want / mul, torch.ones_like(mul))
        mul = torch.minimum(mul, want)
        dq += _hi_lo(s * mul) @ k[:, j:j + TILE].float()
    return (dq / mul).half()


def _dq_case(do_scale, seed=1, shape=(2, 256, 64)):
    """k, the plain version's fp32 dS and its dQ, on ``_case``'s inputs
    (causal, dO times ``do_scale``)."""
    bh, s, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                   .half() for _ in range(4))
    do = (do.float() * do_scale).half()
    scale = 1.0 / math.sqrt(d)
    mask = pt_fa._mask(s, s, True, s, 0, "cpu")
    out, lse = pt_fa.flash_fwd_plain(q, k, v, True, scale, s, 0)
    delta = pt_fa.attention_delta(do, out)
    _, ds = pt_fa._p_ds(q, k, v, do, lse, delta, mask, scale)
    dq = pt_fa.masked_bwd_dq_plain(q, k, v, do, lse, delta, mask, scale)
    return k, ds, dq


# the span, in powers of two, over which the growth case's rows of v grow
# along the keys: every row's largest |dS| grows by more than 2^20 over its
# key tiles
GROWTH_BITS = 26


def _growth_inputs(seed, bh, sq, sk, d):
    """fp16 q, k, v, dO: q = 0, so that every key gets the same p; v's
    rows in +- pairs (their sum, and with it O and delta = rowsum(dO O),
    near 0) growing by 2^GROWTH_BITS along the keys, so that
    dS = p (dP - delta) scale grows with them."""
    rng = np.random.RandomState(seed)
    k, v, do = (rng.randn(bh, n, d).astype(np.float32)
                for n in (sk, sk, sq))
    v[:, 1::2] = -v[:, 0::2]
    pos = np.arange(sk) // 2 * 2 / sk
    v *= 2.0 ** (GROWTH_BITS * (pos - 0.5))[None, :, None]
    q = np.zeros((bh, sq, d), np.float32)
    return tuple(torch.from_numpy(x).half() for x in (q, k, v, do))


def _growth_case(seed=2, bh=2, sq=64, sk=512, d=64):
    """Not causal, ``_growth_inputs``. Returns k, the plain version's fp32
    dS and its dQ."""
    q, k, v, do = _growth_inputs(seed, bh, sq, sk, d)
    scale = 1.0 / math.sqrt(d)
    mask = pt_fa._mask(sq, sk, False, sk, 0, "cpu")
    out, lse = pt_fa.flash_fwd_plain(q, k, v, False, scale, sk, 0)
    delta = pt_fa.attention_delta(do, out)
    _, ds = pt_fa._p_ds(q, k, v, do, lse, delta, mask, scale)
    dq = pt_fa.masked_bwd_dq_plain(q, k, v, do, lse, delta, mask, scale)
    return k, ds, dq


@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** -12, 2.0 ** 8],
                         ids=["unit", "2^-12", "2^8"])
def test_the_dq_kernels_scaled_split_holds_the_fp16_limit(do_scale):
    k, ds, want = _dq_case(do_scale)
    dq = _kernel_dq(ds, k)
    assert bool(torch.isfinite(dq).all())
    assert _ratio(dq, want) <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape, offset", [((2, 256, 256, 64), 0),
                                           ((4, 320, 256, 32), -64)],
                         ids=["square", "sq>sk"])
def test_the_dq_kernels_split_sits_within_the_limit_of_the_fp32_plain(
        shape, offset, seed):
    """At dO x 2^-12 many dq elements are fp16 subnormals (spaced 2^-24),
    and the limit's floor, 1e-4 of the largest |dq|, lies below that
    spacing: the exact dq rounded once to fp16 can sit a subnormal away
    from the rounded plain version, beyond the limit (1.26x it at the
    square shape, seed 0). Against the plain version's unrounded fp32
    result the same exact dq sits within 0.67x of the limit, and the
    kernel's scheme with it: the card holds fp16 dq at a scaled dO against
    that fp32 result."""
    bh, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32))
                   .half() for n in (sq, sk, sk, sq))
    do = do * 2.0 ** -12
    scale = 1.0 / math.sqrt(d)
    args = (True, scale, sk, offset)
    mask = pt_fa._mask(sq, sk, True, sk, offset, "cpu")
    out, lse = pt_fa.flash_fwd_plain(q, k, v, *args)
    delta = pt_fa.attention_delta(do, out)
    _, ds = pt_fa._p_ds(q, k, v, do, lse, delta, mask, scale)
    want = pt_fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, *args)
    want32 = pt_fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(),
                                      do.float(), lse, delta, *args)
    assert want32.dtype == torch.float32 and torch.equal(want32.half(), want)
    exact = torch.einsum("bqk,bkd->bqd", ds.double(), k.double()).half()
    lim = _limit(want)
    assert ((exact.float() - want32).abs() / lim).max().item() <= 0.7
    assert ((_kernel_dq(ds, k).float() - want32).abs() / lim).max() <= 0.7
    if (shape, seed) == ((2, 256, 256, 64), 0):
        assert _ratio(exact, want) > 1.0


def test_one_fp16_rounding_of_ds_misses_the_dq_limit():
    """dS rounded once to fp16 (no lo part): dQ misses the limit at unit
    scale."""
    k, ds, want = _dq_case(1.0)
    dq = torch.einsum("bqk,bkd->bqd", ds.half().float(), k.float()).half()
    assert _ratio(dq, want) > 1.0


def test_an_unscaled_ds_split_misses_the_dq_limit_at_small_do():
    """hi + lo of dS as it is: at dO x 2^-12 dS lies below fp16's normal
    range and dQ misses the limit many times over."""
    k, ds, want = _dq_case(2.0 ** -12)
    dq = torch.einsum("bqk,bkd->bqd", _hi_lo(ds), k.float()).half()
    assert _ratio(dq, want) > 4.0


def test_a_row_whose_ds_grows_mid_row_is_rescaled():
    """Each row's largest |dS| grows by more than 2^20 from its first key
    tile to its last: the running power falls tile by tile and the dQ
    rows summed so far fall with it, within the limit; a row kept at its
    first tile's power overflows fp16 (2^14 x 2^20 > 65504)."""
    k, ds, want = _growth_case()
    bh, sq, sk = ds.shape
    tile_max = ds.abs().reshape(bh, sq, sk // TILE, TILE).amax(-1)
    assert (tile_max[..., -1] / tile_max[..., 0]).min().item() > 2.0 ** 20
    dq = _kernel_dq(ds, k)
    assert bool(torch.isfinite(dq).all())
    assert _ratio(dq, want) <= 1.0
    assert not bool(torch.isfinite(_kernel_dq(ds, k, lower=False)).all())


def test_recomputed_scores_move_dq_under_a_logit_ramp():
    """Why the growth case grows v and not the scores: with every row's
    scores rising by 19 nats along the keys (q's column 0 at 8, k's a ramp
    up to 38 at head_dim 256, raw scores near 300), S summed over the
    head_dim in another fp32 order (16-column chunks, as the card's
    products) and p = 2^(S scale log2(e) - lse log2(e)) move p by up to
    4e-5 of itself, and dq's ramp column (dS summed against a large,
    smooth k) by more than the fp16 limit, though the split fed the plain
    version's own p sits near 0.4 of it. The same would hold of any
    kernel that recomputes S."""
    bh, sq, sk, d = 2, 128, 1024, 256
    rng = np.random.RandomState(74)
    q, k, v, do = (rng.randn(bh, n, d).astype(np.float32)
                   for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    q, k = q * 0.1, k * 0.1
    q[..., 0] = 8.0
    k[..., 0] = 19.0 / (8 * scale) * np.arange(sk) / sk
    q, k, v, do = (torch.from_numpy(x).half() for x in (q, k, v, do))
    args = (False, scale, sk, 0)
    out, lse = pt_fa.flash_fwd_plain(q, k, v, *args)
    delta = pt_fa.attention_delta(do, out)
    want32 = pt_fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(),
                                      do.float(), lse, delta, *args)
    lim = _limit(want32.half())
    qf, kf = q.float(), k.float()
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    s_plain = torch.einsum("bqd,bkd->bqk", qf, kf)
    s_chunks = sum(torch.einsum("bqd,bkd->bqk", qf[..., c:c + 16],
                                kf[..., c:c + 16]) for c in range(0, d, 16))
    log2e = 1.4426950408889634
    x = (s_chunks.double() * (scale * log2e)
         - (lse * log2e).float().double()).float()
    ds_card = torch.exp2(x) * (dp - delta) * scale
    ds_plain = torch.exp(s_plain * scale - lse) * (dp - delta) * scale
    ratio = lambda ds: ((_kernel_dq(ds, k).float() - want32).abs()
                        / lim).max().item()
    assert ratio(ds_plain) <= 0.5
    assert ratio(ds_card) > 1.0
