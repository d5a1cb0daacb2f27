"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
there is no CUDA device (decided at run time, never at import). Imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: the kernels and the plain versions both compute in fp32 from
io-typed inputs and differ in summation order and, in the forward, in the
running-max rescaling of the online softmax. fp32 io: 1e-5 absolute on
unit-scale inputs; lse (fp32) 1e-4 in bf16. bf16 outputs are held per
element (``_limit``): one bf16 ulp of the element itself plus fp32
summation noise and, for the forward's output, the rounding of P against
a running rather than the final max.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _limit(dtype, key, want, abs_v_out):
    """Per-element bound on |kernel - plain|. bf16: one ulp of the element
    (2^-7 |x|) plus summation noise (1e-4 of the largest element); the
    forward's output adds 2^-8 of |out| and of sum_j p_j |v_j| / l
    (``abs_v_out``), as P is rounded to bf16 against a running max."""
    if key == "lse" or dtype == torch.float32:
        return 1e-4 if key == "lse" and dtype == torch.bfloat16 else 1e-5
    want = want.float().abs()
    lim = 2 ** -7 * want + 1e-4 * want.max()
    if key == "out":
        lim = lim + 2 ** -8 * (want + abs_v_out.float())
    return lim


def _inputs(device, bh, sq, sk, d, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn(bh, s, d, generator=gen, device=device).to(dtype)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("shape", [(3, 200, 200, True), (3, 200, 200, False),
                                   (2, 128, 256, True), (2, 256, 128, False)],
                         ids=["ragged-causal", "ragged-full", "cross-causal",
                              "cross-full"])
def test_kernels_match_plain(cuda, shape, d, dtype):
    bh, sq, sk, causal = shape
    q, k, v, do = _inputs(cuda, bh, sq, sk, d, dtype)
    args = (causal, 1.0 / math.sqrt(d), sk, sk - sq)
    out, lse = fa.flash_fwd(q, k, v, *args)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    abs_v_out = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
    delta = fa.attention_delta(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    p_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse),
                           ("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want, abs_v_out)).all()), \
            (key, err.max().item())


def test_kv_len_masks_ragged_keys(cuda):
    q, k, v, _ = _inputs(cuda, 2, 128, 256, 64, torch.float32, seed=1)
    args = (False, 0.125, 200, 128)
    out, lse = fa.flash_fwd(q, k, v, *args)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert _err(out, p_out) <= 1e-5 and _err(lse, p_lse) <= 1e-5


def test_autograd_counts_one_launch_each(cuda):
    q, k, v, do = _inputs(cuda, 4, 256, 256, 64, torch.bfloat16, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    fa.mha_forward(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                           "flash_bwd_dq": 1}


@pytest.mark.parametrize("bad", ["fp16", "head_dim_80", "noncontiguous"])
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v, _ = _inputs(cuda, 2, 128, 128, 64, torch.float32)
    if bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim_80":
        q, k, v = (torch.cat([t, t[..., :16]], -1) for t in (q, k, v))
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_fwd(q, k, v, True, 0.125, 128, 0)
