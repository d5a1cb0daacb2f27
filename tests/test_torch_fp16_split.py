"""The fp16 dK/dV kernel's hi/lo split of P and dS, emulated in plain
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
