"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The fixed-length kernels (``flash_attention.py``) and their varlen and
flashmask instantiations (``flash_varlen.py``); the RMSNorm and SwiGLU
kernels (``fused.py``). Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
there is no CUDA device (decided at run time, never at import). Imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: the kernels and the plain versions both compute in fp32 from
io-typed inputs and differ in summation order and, in the forward, in the
running-max rescaling of the online softmax. fp32 io: 1e-5 absolute on
unit-scale inputs; lse (fp32) 1e-4 in bf16. bf16 and fp16 outputs are held
per element (``_limit``): one ulp of the element itself plus fp32
summation noise and, for the forward's output, the rounding of P against
a running rather than the final max. RMSNorm and SwiGLU (``_fused_limit``):
bf16 and fp16 within one ulp of each element plus 1e-6 of the largest, fp32
4e-6 relative; both sides compute in fp32 and round once.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_varlen as fv
from paddle_tpu_torch.ops.cuda import fused as fu

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _limit(dtype, key, want, abs_v_out, d=256):
    """Per-element bound on |kernel - plain|. bf16: one ulp of the element
    (2^-7 |x|) plus summation noise (1e-4 of the largest element); the
    forward's output adds 2^-8 of |out| and of sum_j p_j |v_j| / l
    (``abs_v_out``), as P is rounded to bf16 against a running max. fp16:
    the same at fp16's ulp, 2^-10 |x| and 2^-11 for P's rounding. fp32:
    1e-5 up to head_dim 256; a head_dim ``d`` above it sums its logits over
    ``kernel_head_dim(d)`` columns (512 for 288 and 512), in chunks, so
    the fp32 summation noise bound grows in proportion: 1e-5 per 256."""
    if key == "lse" or dtype == torch.float32:
        if key == "lse" and dtype == torch.bfloat16:
            return 1e-4
        return 1e-5 * max(1, fa.kernel_head_dim(d) // 256)
    ulp, p_round = (2 ** -7, 2 ** -8) if dtype == torch.bfloat16 \
        else (2 ** -10, 2 ** -11)
    want = want.float().abs()
    lim = ulp * want + 1e-4 * want.max()
    if key == "out":
        lim = lim + p_round * (want + abs_v_out.float())
    return lim


def _inputs(device, bh, sq, sk, d, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn(bh, s, d, generator=gen, device=device).to(dtype)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


DTYPES = dict(argvalues=[torch.float32, torch.bfloat16, torch.float16],
              ids=["fp32", "bf16", "fp16"])
# the kernels' head_dims and three that run padded to the next of them
# (256, and 160 padded to it, run the bf16 kernels' two-warpgroup forms and
# the FMA kernels otherwise); 512, and 288 padded to it, run the same 256
# forms split over two 256-column chunks
HEAD_DIMS = [32, 48, 64, 80, 128, 160, 256, 288, 512]
# the bf16 tensor-core kernels' edge checks, forward and backward: the
# one-warpgroup forms at 32, 64 and 128, the two-warpgroup forms at 256 and
# their SPLIT forms at 512
BF16_FWD_DIMS = [32, 64, 128, 256, 512]


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
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
        assert bool((err <= _limit(dtype, key, want, abs_v_out, d)).all()), \
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


@pytest.mark.parametrize("bad", ["integer", "noncontiguous"])
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v, _ = _inputs(cuda, 2, 128, 128, 64, torch.float32)
    if bad == "integer":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_fwd(q, k, v, True, 0.125, 128, 0)


# The bf16 forward runs a tensor-core kernel of its own (TMA ring of K/V
# tiles, wgmma products): edge shapes for it alone. (bh, sq, sk, kv_len,
# causal): query tiles that visit more key tiles than the ring has stages
# (1000 and 1024), sq != sk both ways with the bottom-right causal offset
# (sq > sk leaves rows that see no key), and kv_len cutting a key tile.
BF16_FWD_SHAPES = {
    "long_1000": (2, 1000, 1000, 1000, True),
    "long_1024": (2, 1024, 1024, 1024, True),
    "sq_lt_sk": (2, 100, 300, 300, True),
    "sq_gt_sk": (2, 300, 100, 100, True),
    "kv_len_cut": (2, 128, 256, 150, True),
    "kv_len_cut_full": (2, 128, 256, 150, False),
}


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("shape", sorted(BF16_FWD_SHAPES))
def test_bf16_forward_edges_match_plain(cuda, shape, d):
    _forward_edge_matches_plain(cuda, shape, d, torch.bfloat16)


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("shape", sorted(BF16_FWD_SHAPES))
def test_fp16_forward_edges_match_plain(cuda, shape, d):
    """fp16 runs the same tensor-core forward (its fp16 instantiation) at
    the same edge shapes."""
    _forward_edge_matches_plain(cuda, shape, d, torch.float16)


def _forward_edge_matches_plain(cuda, shape, d, dtype):
    bh, sq, sk, kv_len, causal = BF16_FWD_SHAPES[shape]
    q, k, v, _ = _inputs(cuda, bh, sq, sk, d, dtype, seed=3)
    args = (causal, 1.0 / math.sqrt(d), kv_len, sk - sq)
    out, lse = fa.flash_fwd(q, k, v, *args)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    abs_v_out = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want,
                                   abs_v_out)).all()), (key, err.max().item())
    if sq > sk:  # rows q < sq - sk see no key: out 0 and lse -1e30
        blind = sq - sk
        assert not out[:, :blind].any()
        assert bool((lse[:, :blind] == fa.NEG_INF).all())


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("shape", sorted(BF16_FWD_SHAPES))
def test_bf16_backward_edges_match_plain(cuda, shape, d):
    """The bf16 backward kernels (tensor cores, a TMA ring of (Q, dO) or
    (K, V) tiles; two warpgroups a block at 256 and above) at the
    forward's edge shapes; keys past kv_len (no query sees them) get dK
    and dV of exactly 0, rows that see no key dQ of 0."""
    _backward_edge_matches_plain(cuda, shape, d, torch.bfloat16)


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("shape", sorted(BF16_FWD_SHAPES))
def test_fp16_backward_edges_match_plain(cuda, shape, d):
    """fp16 at the same edge shapes: dK/dV and dQ on the tensor-core
    kernels (their fp16 instantiations; dK/dV scales P and dS, dQ scales
    dS, before their hi/lo split); unseen keys give dK = dV = 0 exactly,
    rows that see no key dQ = 0."""
    _backward_edge_matches_plain(cuda, shape, d, torch.float16)


def _backward_edge_matches_plain(cuda, shape, d, dtype):
    bh, sq, sk, kv_len, causal = BF16_FWD_SHAPES[shape]
    q, k, v, do = _inputs(cuda, bh, sq, sk, d, dtype, seed=4)
    args = (causal, 1.0 / math.sqrt(d), kv_len, sk - sq)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    p_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    for key, got, want in (("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want, None)).all()), \
            (key, err.max().item())
    assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()
    if causal and sq > sk:
        assert not dq[:, :sq - sk].any()


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary (a view at an odd offset of a flat buffer)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("entry", ["flash_fwd", "varlen_fwd",
                                   "flashmask_fwd"])
def test_bf16_misaligned_base_matches_plain(cuda, entry):
    """A bf16 input whose base is not 16-byte aligned (TMA refuses it)
    reaches the same kernels as a fresh aligned copy: the forward and both
    backward kernels launch once each and match their plain versions."""
    _misaligned_matches_plain(cuda, entry, 64)


@pytest.mark.parametrize("entry", ["flash_fwd", "varlen_fwd",
                                   "flashmask_fwd"])
def test_bf16_misaligned_base_at_head_dim_256_matches_plain(cuda, entry):
    """The same at head_dim 256, where the bf16 forward and backward run
    their two-warpgroup forms."""
    _misaligned_matches_plain(cuda, entry, 256)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("entry", ["flash_fwd", "varlen_fwd",
                                   "flashmask_fwd"])
def test_fp16_misaligned_base_matches_plain(cuda, entry, d):
    """An fp16 input on a misaligned base reaches the fp16 tensor-core
    forward, dK/dV and dQ as a fresh aligned copy: one launch each, each
    within the plain version's limit."""
    _misaligned_matches_plain(cuda, entry, d, torch.float16)


def _misaligned_matches_plain(cuda, entry, d, dtype=torch.bfloat16):
    q, k, v, do = _inputs(cuda, 2, 128, 128, d, dtype)
    fa.reset_launches()
    fv.reset_launches()
    if entry == "flash_fwd":
        args = (True, 0.125, 128, 0)
        fwd = lambda q, k, v: fa.flash_fwd(q, k, v, *args)
        fwd_plain = lambda q, k, v: fa.flash_fwd_plain(q, k, v, *args)
        dkv = lambda *t: fa.flash_bwd_dkv(*t, *args)
        dkv_plain = lambda *t: fa.flash_bwd_dkv_plain(*t, *args)
        dq = lambda *t: fa.flash_bwd_dq(*t, *args)
        dq_plain = lambda *t: fa.flash_bwd_dq_plain(*t, *args)
        delta_of = fa.attention_delta
        mis = [_misaligned(q), k, v, _misaligned(do)]
    elif entry == "varlen_fwd":
        cu = torch.tensor([0, 100, 256], device=cuda).int()
        plan = fv.varlen_plan(cu, cu, 256, 256, True)
        q, k, v, do = (t.reshape(256, 1, d) for t in (q, k, v, do))
        fwd = lambda q, k, v: fv.varlen_fwd(q, k, v, plan, 0.125)
        fwd_plain = lambda q, k, v: fv.varlen_fwd_plain(q, k, v, plan, 0.125)
        dkv = lambda *t: fv.varlen_bwd_dkv(*t, plan, 0.125)
        dkv_plain = lambda *t: fv.varlen_bwd_dkv_plain(*t, plan, 0.125)
        dq = lambda *t: fv.varlen_bwd_dq(*t, plan, 0.125)
        dq_plain = lambda *t: fv.varlen_bwd_dq_plain(*t, plan, 0.125)
        delta_of = fv.varlen_delta
        mis = [q, _misaligned(k), v, _misaligned(do)]
    else:
        startend = torch.full((2, 1, 128, 1), 100, dtype=torch.int32,
                              device=cuda)
        plan = fv.flashmask_plan(startend, 1, True)
        fwd = lambda q, k, v: fv.flashmask_fwd(q, k, v, plan, 0.125)
        fwd_plain = lambda q, k, v: fv.flashmask_fwd_plain(q, k, v, plan,
                                                           0.125)
        dkv = lambda *t: fv.flashmask_bwd_dkv(*t, plan, 0.125)
        dkv_plain = lambda *t: fv.flashmask_bwd_dkv_plain(*t, plan, 0.125)
        dq = lambda *t: fv.flashmask_bwd_dq(*t, plan, 0.125)
        dq_plain = lambda *t: fv.flashmask_bwd_dq_plain(*t, plan, 0.125)
        delta_of = fa.attention_delta
        mis = [q, k, _misaligned(v), _misaligned(do)]
    assert any(t.data_ptr() % 16 for t in mis)
    out, lse = fwd(*mis[:3])
    p_out, p_lse = fwd_plain(q, k, v)
    abs_v_out = fwd_plain(q, k, v.abs())[0]
    delta = delta_of(do, out)
    g_dk, g_dv = dkv(*mis, lse, delta)
    g_dq = dq(*mis, lse, delta)
    p_dk, p_dv = dkv_plain(q, k, v, do, lse, delta)
    p_dq = dq_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse),
                           ("dq", g_dq, p_dq), ("dk", g_dk, p_dk),
                           ("dv", g_dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want,
                                   abs_v_out)).all()), (key, err.max().item())
    counts = dict(fa.LAUNCHES) if entry == "flash_fwd" else {
        n: c for n, c in fv.LAUNCHES.items()
        if n.startswith(entry.split("_")[0])}
    assert sorted(counts.values()) == [1, 1, 1], counts


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("mask", ["fixed", "varlen", "flashmask"])
def test_bf16_forward_at_256_and_above_runs_the_tensor_core_kernel(cuda, mask,
                                                                   d):
    """bf16 at head_dim 256 and 512 takes the tensor-core forward for each
    mask: one ``torch.profiler`` pass names ``flash_fwd_hopper`` and no
    ``flash_fwd_kernel`` (the FMA kernel), and the result matches the
    plain version."""
    from torch.profiler import ProfilerActivity, profile
    scale = 1.0 / math.sqrt(d)
    q, k, v, _ = _inputs(cuda, 2, 256, 256, d, torch.bfloat16, seed=9)
    if mask == "fixed":
        args = (True, scale, 256, 0)
        run = lambda v: fa.flash_fwd(q, k, v, *args)
        plain = lambda v: fa.flash_fwd_plain(q, k, v, *args)
    elif mask == "varlen":
        cu = torch.tensor([0, 100, 300, 512], device=cuda).int()
        plan = fv.varlen_plan(cu, cu, 512, 512, True)
        q, k, v = (t.reshape(512, 1, d) for t in (q, k, v))
        run = lambda v: fv.varlen_fwd(q, k, v, plan, scale)
        plain = lambda v: fv.varlen_fwd_plain(q, k, v, plan, scale)
    else:
        plan = fv.flashmask_plan(torch.full((2, 1, 256, 1), 200,
                                            dtype=torch.int32, device=cuda),
                                 1, True)
        run = lambda v: fv.flashmask_fwd(q, k, v, plan, scale)
        plain = lambda v: fv.flashmask_fwd_plain(q, k, v, plan, scale)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = run(v)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("flash_fwd_hopper" in n for n in names), names
    assert not any("flash_fwd_kernel" in n for n in names), names
    p_out, p_lse = plain(v)
    abs_v_out = plain(v.abs())[0]
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want,
                                   abs_v_out)).all()), (key, err.max().item())


@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("mask", ["fixed", "varlen", "flashmask"])
def test_bf16_backward_at_256_and_above_runs_the_tensor_core_kernels(cuda,
                                                                     mask, d):
    """bf16 at head_dim 256 and 512 takes the tensor-core backward for each
    mask: one ``torch.profiler`` pass names ``flash_bwd_dq_hopper`` and
    ``flash_bwd_dkv_hopper`` and no ``flash_bwd_dq_kernel`` or
    ``flash_bwd_dkv_kernel`` (the FMA kernels), and dq, dk and dv match
    the plain versions."""
    from torch.profiler import ProfilerActivity, profile
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _inputs(cuda, 2, 256, 256, d, torch.bfloat16, seed=10)
    if mask == "fixed":
        args = (True, scale, 256, 0)
        fwd = lambda: fa.flash_fwd(q, k, v, *args)
        delta_of = fa.attention_delta
        bwd = lambda *t: (fa.flash_bwd_dq(*t, *args),
                          *fa.flash_bwd_dkv(*t, *args))
        plain = lambda *t: (fa.flash_bwd_dq_plain(*t, *args),
                            *fa.flash_bwd_dkv_plain(*t, *args))
    elif mask == "varlen":
        cu = torch.tensor([0, 100, 300, 512], device=cuda).int()
        plan = fv.varlen_plan(cu, cu, 512, 512, True)
        q, k, v, do = (t.reshape(512, 1, d) for t in (q, k, v, do))
        fwd = lambda: fv.varlen_fwd(q, k, v, plan, scale)
        delta_of = fv.varlen_delta
        bwd = lambda *t: (fv.varlen_bwd_dq(*t, plan, scale),
                          *fv.varlen_bwd_dkv(*t, plan, scale))
        plain = lambda *t: (fv.varlen_bwd_dq_plain(*t, plan, scale),
                            *fv.varlen_bwd_dkv_plain(*t, plan, scale))
    else:
        plan = fv.flashmask_plan(torch.full((2, 1, 256, 1), 200,
                                            dtype=torch.int32, device=cuda),
                                 1, True)
        fwd = lambda: fv.flashmask_fwd(q, k, v, plan, scale)
        delta_of = fa.attention_delta
        bwd = lambda *t: (fv.flashmask_bwd_dq(*t, plan, scale),
                          *fv.flashmask_bwd_dkv(*t, plan, scale))
        plain = lambda *t: (fv.flashmask_bwd_dq_plain(*t, plan, scale),
                            *fv.flashmask_bwd_dkv_plain(*t, plan, scale))
    out, lse = fwd()
    ins = (q, k, v, do, lse, delta_of(do, out))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = bwd(*ins)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert any(f"{kernel}_hopper" in n for n in names), names
        assert not any(f"{kernel}_kernel" in n for n in names), names
    for key, g, want in zip(("dq", "dk", "dv"), got, plain(*ins)):
        err = (g.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want, None)).all()), \
            (key, err.max().item())


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("mask", ["fixed", "varlen", "flashmask"])
def test_fp16_runs_the_tensor_core_forward_and_dkv(cuda, mask, d):
    """fp16 at every head_dim takes the tensor-core forward, dK/dV and dQ
    (their ``__half`` instantiations) for each mask: the profiler names
    ``flash_fwd_hopper``, ``flash_bwd_dkv_hopper`` and
    ``flash_bwd_dq_hopper`` at ``__half`` and no ``flash_fwd_kernel``,
    ``flash_bwd_dkv_kernel`` or ``flash_bwd_dq_kernel``; out, lse, dq, dk
    and dv match the plain versions with the fp16 limit."""
    from torch.profiler import ProfilerActivity, profile
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _inputs(cuda, 2, 256, 256, d, torch.float16, seed=11)
    if mask == "fixed":
        args = (True, scale, 256, 0)
        fwd = lambda v: fa.flash_fwd(q, k, v, *args)
        fwd_plain = lambda v: fa.flash_fwd_plain(q, k, v, *args)
        delta_of = fa.attention_delta
        bwd = lambda *t: (fa.flash_bwd_dq(*t, *args),
                          *fa.flash_bwd_dkv(*t, *args))
        plain = lambda *t: (fa.flash_bwd_dq_plain(*t, *args),
                            *fa.flash_bwd_dkv_plain(*t, *args))
    elif mask == "varlen":
        cu = torch.tensor([0, 100, 300, 512], device=cuda).int()
        plan = fv.varlen_plan(cu, cu, 512, 512, True)
        q, k, v, do = (t.reshape(512, 1, d) for t in (q, k, v, do))
        fwd = lambda v: fv.varlen_fwd(q, k, v, plan, scale)
        fwd_plain = lambda v: fv.varlen_fwd_plain(q, k, v, plan, scale)
        delta_of = fv.varlen_delta
        bwd = lambda *t: (fv.varlen_bwd_dq(*t, plan, scale),
                          *fv.varlen_bwd_dkv(*t, plan, scale))
        plain = lambda *t: (fv.varlen_bwd_dq_plain(*t, plan, scale),
                            *fv.varlen_bwd_dkv_plain(*t, plan, scale))
    else:
        plan = fv.flashmask_plan(torch.full((2, 1, 256, 1), 200,
                                            dtype=torch.int32, device=cuda),
                                 1, True)
        fwd = lambda v: fv.flashmask_fwd(q, k, v, plan, scale)
        fwd_plain = lambda v: fv.flashmask_fwd_plain(q, k, v, plan, scale)
        delta_of = fa.attention_delta
        bwd = lambda *t: (fv.flashmask_bwd_dq(*t, plan, scale),
                          *fv.flashmask_bwd_dkv(*t, plan, scale))
        plain = lambda *t: (fv.flashmask_bwd_dq_plain(*t, plan, scale),
                            *fv.flashmask_bwd_dkv_plain(*t, plan, scale))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = fwd(v)
        ins = (q, k, v, do, lse, delta_of(do, out))
        got = bwd(*ins)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert any(f"{kernel}_hopper" in n and "__half" in n
                   for n in names), names
        assert not any(f"{kernel}_kernel" in n for n in names), names
    p_out, p_lse = fwd_plain(v)
    abs_v_out = fwd_plain(v.abs())[0]
    for key, g, want in (("out", out, p_out), ("lse", lse, p_lse),
                         *zip(("dq", "dk", "dv"), got, plain(*ins))):
        err = (g.float() - want.float()).abs()
        assert bool((err <= _limit(torch.float16, key, want, abs_v_out,
                                   d)).all()), (key, err.max().item())


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("do_scale", [2.0 ** -12, 2.0 ** 8],
                         ids=["2^-12", "2^8"])
def test_fp16_dkv_holds_scaled_do(cuda, do_scale, d):
    """fp16 dK/dV with dO far from unit scale (a loss scaler's range): the
    kernel scales each key row of dS into fp16's normal range before its
    hi/lo split, so dk and dv stay within the fp16 limit at either end."""
    q, k, v, do = _inputs(cuda, 4, 512, 512, d, torch.float16, seed=12)
    do = do * do_scale
    args = (True, 1.0 / math.sqrt(d), 512, 0)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    for key, got, want in (("dk", dk, p_dk), ("dv", dv, p_dv)):
        assert bool(torch.isfinite(got).all()), key
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.float16, key, want, None)).all()), \
            (key, err.max().item())


@pytest.mark.parametrize("d", BF16_FWD_DIMS)
@pytest.mark.parametrize("do_scale", [2.0 ** -12, 2.0 ** 8],
                         ids=["2^-12", "2^8"])
def test_fp16_dq_holds_scaled_do(cuda, do_scale, d):
    """fp16 dQ with dO far from unit scale (a loss scaler's range), at
    every head_dim form (32, 64, 128: one warpgroup; 256; 512: SPLIT): the
    kernel scales each query row of dS into fp16's normal range before its
    hi/lo split, so dq stays within the fp16 limit at either end. Held
    against the plain version's unrounded fp32 result (its arithmetic on
    fp32 copies of the inputs): at 2^-12 many dq elements are fp16
    subnormals, spaced more widely than the limit's floor, so the exact
    dq rounded once can sit a subnormal away from the rounded plain
    version (``tests/test_torch_fp16_split.py``)."""
    q, k, v, do = _inputs(cuda, 4, 512, 512, d, torch.float16, seed=13)
    do = do * do_scale
    args = (True, 1.0 / math.sqrt(d), 512, 0)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(do, out)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    p_dq = fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(), do.float(),
                                 lse, delta, *args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dq).all())
    err = (dq.float() - p_dq.float()).abs()
    assert bool((err <= _limit(torch.float16, "dq", p_dq, None)).all()), \
        err.max().item()


@pytest.mark.parametrize("d", [64, 256, 512])
@pytest.mark.parametrize("mask", ["fixed", "varlen", "flashmask"])
def test_an_fp16_backward_launches_no_fma_dq_kernel(cuda, mask, d):
    """The public entries' fp16 backward, under ``torch.profiler``: dQ runs
    ``flash_bwd_dq_hopper`` at ``__half`` and no ``flash_bwd_dq_kernel``
    (the FMA kernel, fp32 alone) is launched."""
    import paddle_tpu_torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda).manual_seed(14)
    b, s, h = 2, 256, 2
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=cuda)
                   .half() for _ in range(4))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    if mask == "fixed":
        out = F.flash_attention(ql, kl, vl, causal=True)[0]
    elif mask == "varlen":
        cu = torch.tensor([0, 100, 300, 512], device=cuda).int()
        out = F.flash_attn_unpadded(
            *(t.reshape(b * s, h, d) for t in (ql, kl, vl)), cu, cu, 300,
            300, 1.0 / math.sqrt(d), causal=True)[0].reshape(b, s, h, d)
    else:
        startend = torch.full((b, 1, s, 1), 200, dtype=torch.int32,
                              device=cuda)
        out = F.flashmask_attention(ql, kl, vl, startend, causal=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out.backward(do)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("flash_bwd_dq_hopper" in n and "__half" in n
               for n in names), names
    assert not any("flash_bwd_dq_kernel" in n for n in names), names
    assert all(bool(torch.isfinite(t.grad).all()) for t in (ql, kl, vl))


# ------------------------------------------------------------------ varlen

# (query segment lengths, key segment lengths, padding query rows, padding
# key rows): segments straddling 64-row tiles; cross lengths with an empty
# segment on each side and padding rows; a causal key-tile bound that ends
# one past a key tile's first row, and a query-tile bound that starts on a
# query tile's last row
VARLEN_SHAPES = {
    "straddle": ([100, 37, 150, 2], [100, 37, 150, 2], 0, 0),
    "cross_empty_pad": ([70, 0, 45, 130, 20], [90, 33, 60, 2, 0], 15, 5),
    "tile_edge": ([3, 1], [64, 65], 0, 0),
    "tile_edge_k": ([3, 100], [4, 100], 0, 0),
}


def _varlen_inputs(device, shape, d, dtype, causal, seed=0):
    lq, lk, pad_q, pad_k = VARLEN_SHAPES[shape]
    tq, tk, h = sum(lq) + pad_q, sum(lk) + pad_k, 3
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(t):
        return torch.randn(t, h, d, generator=gen, device=device).to(dtype)

    cu_q = torch.tensor([0] + lq, device=device).cumsum(0).int()
    cu_k = torch.tensor([0] + lk, device=device).cumsum(0).int()
    plan = fv.varlen_plan(cu_q, cu_k, tq, tk, causal)
    return rnd(tq), rnd(tk), rnd(tk), rnd(tq), cu_q, cu_k, plan


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("shape", sorted(VARLEN_SHAPES))
def test_varlen_kernels_match_plain(cuda, shape, d, dtype, causal):
    q, k, v, do, cu_q, _, plan = _varlen_inputs(cuda, shape, d, dtype, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    p_out, p_lse = fv.varlen_fwd_plain(q, k, v, plan, scale)
    abs_v_out = fv.varlen_fwd_plain(q, k, v.abs(), plan, scale)[0]
    delta = fv.varlen_delta(do, out)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    p_dk, p_dv = fv.varlen_bwd_dkv_plain(q, k, v, do, lse, delta, plan, scale)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    p_dq = fv.varlen_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse),
                           ("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want, abs_v_out, d)).all()), \
            (key, err.max().item())
    # rows past cu_q[-1] see no key: out, lse and dq exactly 0
    pad = int(cu_q[-1])
    for t in (out, dq):
        assert not t[pad:].any()
    assert not lse[:, pad:].any()


# bf16 forward only: a plan with an empty segment and segments of one token
# (query tiles whose key-tile range is empty under a causal mask, and
# tiles holding several segments)
VARLEN_BF16_EDGE = ([1, 0, 130, 64, 1, 1], [1, 0, 130, 64, 1, 1], 0, 0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", BF16_FWD_DIMS)
def test_varlen_bf16_forward_empty_and_one_token_segments(cuda, d, causal):
    lq, lk, _, _ = VARLEN_BF16_EDGE
    tq, h = sum(lq), 3
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(tq, h, d, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    cu = torch.tensor([0] + lq, device=cuda).cumsum(0).int()
    plan = fv.varlen_plan(cu, cu, tq, tq, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    p_out, p_lse = fv.varlen_fwd_plain(q, k, v, plan, scale)
    abs_v_out = fv.varlen_fwd_plain(q, k, v.abs(), plan, scale)[0]
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want,
                                   abs_v_out)).all()), (key, err.max().item())
    # a one-token segment sees only itself: its output is its own v
    assert torch.equal(out[0], v[0]) and torch.equal(out[-1], v[-1])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", BF16_FWD_DIMS)
def test_varlen_bf16_backward_empty_and_one_token_segments(cuda, d, causal):
    """The bf16 backward kernels on the plan with an empty segment and
    one-token segments: a one-token segment's key is seen by its query
    alone, so its dV is that query's dO, as the plain version gives it."""
    lq, lk, _, _ = VARLEN_BF16_EDGE
    tq, h = sum(lq), 3
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(tq, h, d, generator=gen, device=cuda)
                   .bfloat16() for _ in range(4))
    cu = torch.tensor([0] + lq, device=cuda).cumsum(0).int()
    plan = fv.varlen_plan(cu, cu, tq, tq, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    delta = fv.varlen_delta(do, out)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    p_dk, p_dv = fv.varlen_bwd_dkv_plain(q, k, v, do, lse, delta, plan, scale)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    p_dq = fv.varlen_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()
    for key, got, want in (("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want, None)).all()), \
            (key, err.max().item())
    assert torch.equal(dv[0], do[0]) and torch.equal(dv[-1], do[-1])


def test_varlen_autograd_counts_one_launch_each(cuda):
    q, k, v, do, cu_q, cu_k, _ = _varlen_inputs(
        cuda, "cross_empty_pad", 64, torch.bfloat16, True, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fv.reset_launches()
    fv.flash_attn_varlen(q, k, v, cu_q, cu_k, causal=True).backward(do)
    torch.cuda.synchronize()
    assert fv.LAUNCHES == {"varlen_fwd": 1, "varlen_bwd_dkv": 1,
                           "varlen_bwd_dq": 1, "flashmask_fwd": 0,
                           "flashmask_bwd_dkv": 0, "flashmask_bwd_dq": 0}


@pytest.mark.parametrize("bad", ["integer", "cu_on_cpu", "plan_on_cpu"])
def test_varlen_wrappers_raise_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v, _, cu_q, cu_k, plan = _varlen_inputs(
        cuda, "straddle", 64, torch.float32, True)
    if bad == "integer":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    if bad == "cu_on_cpu":
        with pytest.raises(ValueError):
            fv.flash_attn_varlen(q, k, v, cu_q.cpu(), cu_k, causal=True)
        return
    if bad == "plan_on_cpu":
        plan = fv.varlen_plan(cu_q.cpu(), cu_k.cpu(), q.shape[0], k.shape[0],
                              True)
    with pytest.raises((TypeError, ValueError)):
        fv.varlen_fwd(q, k, v, plan, 0.125)


# --------------------------------------------------------------- flashmask

def _flashmask_inputs(device, b, h, sq, sk, d, dtype, cols, hs, seed=0):
    """[B*H, S, D] q, k, v, dO and a startend [b, hs, sk, cols] from a
    seed: random two-column bans, plus rows [40, 50) banned by every
    column (rows that see no key)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(s):
        return torch.randn(b * h, s, d, generator=gen, device=device).to(dtype)

    def ints(lo, hi):
        return torch.randint(lo, hi, (b, hs, sk, 1), generator=gen,
                             device=device)

    if cols == 2:
        startend = torch.cat([ints(0, 41), ints(50, sq + 30)], -1)
    else:
        startend = ints(1, sq + 2)
    return rnd(sq), rnd(sk), rnd(sk), rnd(sq), startend.int()


# (batch, heads, sq, sk, start/end rows per batch row, columns): per-head
# two columns with sq != sk both ways (rows 40..49 see no key); shared
# one-column (open-ended) bans with sq > sk
FLASHMASK_SHAPES = {
    "per_head_sq_gt_sk": (2, 3, 200, 136, 3, 2),
    "per_head_sq_lt_sk": (1, 3, 100, 200, 3, 2),
    "shared_start_only": (2, 3, 200, 72, 1, 1),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("shape", sorted(FLASHMASK_SHAPES))
def test_flashmask_kernels_match_plain(cuda, shape, d, dtype, causal):
    b, h, sq, sk, hs, cols = FLASHMASK_SHAPES[shape]
    q, k, v, do, startend = _flashmask_inputs(cuda, b, h, sq, sk, d, dtype,
                                              cols, hs)
    plan = fv.flashmask_plan(startend, h, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    p_out, p_lse = fv.flashmask_fwd_plain(q, k, v, plan, scale)
    abs_v_out = fv.flashmask_fwd_plain(q, k, v.abs(), plan, scale)[0]
    delta = fa.attention_delta(do, out)
    dk, dv = fv.flashmask_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    p_dk, p_dv = fv.flashmask_bwd_dkv_plain(q, k, v, do, lse, delta, plan,
                                            scale)
    dq = fv.flashmask_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    p_dq = fv.flashmask_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse),
                           ("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want, abs_v_out, d)).all()), \
            (key, err.max().item())
    # rows that see no key: out, lse and dq exactly 0
    blind = ~fv.flashmask_mask(plan, b * h, sq, sk).any(-1)
    if cols == 2:
        assert blind[:, 40:50].all()
    assert not out[blind].any() and not dq[blind].any()
    assert not lse[blind].any()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", BF16_FWD_DIMS)
def test_flashmask_bf16_forward_one_open_key_tile(cuda, d, causal):
    """A start/end row that bans every query row from every key tile but
    tile 3: each query tile visits that tile alone (none before it under a
    causal mask, whose rows then see no key: out 0 and lse 0)."""
    b, h, s = 1, 2, 512
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(b * h, s, d, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    st = torch.zeros(s, dtype=torch.int32, device=cuda)
    en = torch.full((s,), s, dtype=torch.int32, device=cuda)
    st[192:256] = s  # tile 3 bans nothing
    startend = torch.stack([st, en], -1).view(1, 1, s, 2)
    plan = fv.flashmask_plan(startend, h, causal)
    tiles = fv.flashmask_tiles(plan, s)[0]
    assert tiles.sum(1).max().item() == 1 and tiles[:, 3].sum() > 0
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    p_out, p_lse = fv.flashmask_fwd_plain(q, k, v, plan, scale)
    abs_v_out = fv.flashmask_fwd_plain(q, k, v.abs(), plan, scale)[0]
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want,
                                   abs_v_out)).all()), (key, err.max().item())
    if causal:
        assert not out[:, :192].any() and not lse[:, :192].any()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", BF16_FWD_DIMS)
def test_flashmask_bf16_backward_one_open_key_tile(cuda, d, causal):
    """The bf16 backward kernels on the start/end row that leaves one key
    tile open: every key outside tile 3 is banned from every row, so its
    dK and dV are exactly 0, and under a causal mask the rows before the
    tile (which see no key) get dQ of 0."""
    b, h, s = 1, 2, 512
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device=cuda)
                   .bfloat16() for _ in range(4))
    st = torch.zeros(s, dtype=torch.int32, device=cuda)
    en = torch.full((s,), s, dtype=torch.int32, device=cuda)
    st[192:256] = s  # tile 3 bans nothing
    startend = torch.stack([st, en], -1).view(1, 1, s, 2)
    plan = fv.flashmask_plan(startend, h, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    delta = fa.attention_delta(do, out)
    dk, dv = fv.flashmask_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    p_dk, p_dv = fv.flashmask_bwd_dkv_plain(q, k, v, do, lse, delta, plan,
                                            scale)
    dq = fv.flashmask_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    p_dq = fv.flashmask_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()
    for key, got, want in (("dq", dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(torch.bfloat16, key, want, None)).all()), \
            (key, err.max().item())
    for t in (dk, dv):
        assert not t[:, :192].any() and not t[:, 256:].any()
    if causal:
        assert not dq[:, :192].any()


def test_flashmask_autograd_counts_one_launch_each(cuda):
    q, k, v, do, startend = _flashmask_inputs(cuda, 2, 3, 200, 200, 64,
                                              torch.bfloat16, 1, 1, seed=2)
    q, k, v, do = (t.view(2, 3, 200, 64).transpose(1, 2) for t in (q, k, v, do))
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fv.reset_launches()
    fv.flashmask_attention_kernel(q, k, v, startend).backward(do)
    torch.cuda.synchronize()
    assert fv.LAUNCHES == {"varlen_fwd": 0, "varlen_bwd_dkv": 0,
                           "varlen_bwd_dq": 0, "flashmask_fwd": 1,
                           "flashmask_bwd_dkv": 1, "flashmask_bwd_dq": 1}


@pytest.mark.parametrize("bad", ["integer", "startend_on_cpu",
                                 "plan_on_cpu"])
def test_flashmask_wrappers_raise_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v, _, startend = _flashmask_inputs(cuda, 1, 2, 128, 128, 64,
                                             torch.float32, 2, 2)
    if bad == "startend_on_cpu":
        x = q.view(1, 2, 128, 64).transpose(1, 2)
        with pytest.raises(ValueError):
            fv.flashmask_attention_kernel(x, x, x, startend.cpu())
        return
    plan = fv.flashmask_plan(startend.cpu() if bad == "plan_on_cpu"
                             else startend, 2, True)
    if bad == "integer":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        fv.flashmask_fwd(q, k, v, plan, 0.125)


# more than 65535 heads (batch*heads): the C entries launch them in slices
# of at most 65535, each with its pointers (and, for flashmask, its mask
# rows) moved to its first head. Short rows and head_dim 32, so that the
# plain versions' [heads, S, S] scores fit.
MANY_HEADS = 65535 + 65


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mask", ["fixed", "varlen", "flashmask"])
def test_more_than_65535_heads_match_plain(cuda, mask, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    scale = 0.2
    if mask == "varlen":
        def rnd(t):
            return torch.randn(t, MANY_HEADS, 32, generator=gen,
                               device=cuda).to(dtype)
        q, k, v, do = rnd(70), rnd(70), rnd(70), rnd(70)
        cu = torch.tensor([0, 30, 70], device=cuda, dtype=torch.int32)
        plan = fv.varlen_plan(cu, cu, 70, 70, True)
        fwd, dkv, dq = fv.varlen_fwd, fv.varlen_bwd_dkv, fv.varlen_bwd_dq
        plain = (fv.varlen_fwd_plain, fv.varlen_bwd_dkv_plain,
                 fv.varlen_bwd_dq_plain)
        delta_of = fv.varlen_delta
        extra = (plan, scale)
    else:
        q, k, v, do = _inputs(cuda, MANY_HEADS, 70, 70, 32, dtype, seed=7)
        delta_of = fa.attention_delta
        if mask == "fixed":
            fwd, dkv, dq = fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq
            plain = (fa.flash_fwd_plain, fa.flash_bwd_dkv_plain,
                     fa.flash_bwd_dq_plain)
            extra = (True, scale, 70, 0)
        else:
            # two batch rows of per-head rows: the second slice starts
            # inside batch row 1, so its mask rows are offset too
            b, h = 2, MANY_HEADS // 2
            st = torch.randint(0, 71, (b, h, 70, 1), generator=gen,
                               device=cuda)
            en = st + torch.randint(0, 36, (b, h, 70, 1), generator=gen,
                                    device=cuda)
            plan = fv.flashmask_plan(torch.cat([st, en], -1).int(), h, True)
            fwd, dkv, dq = (fv.flashmask_fwd, fv.flashmask_bwd_dkv,
                            fv.flashmask_bwd_dq)
            plain = (fv.flashmask_fwd_plain, fv.flashmask_bwd_dkv_plain,
                     fv.flashmask_bwd_dq_plain)
            extra = (plan, scale)
    out, lse = fwd(q, k, v, *extra)
    p_out, p_lse = plain[0](q, k, v, *extra)
    abs_v_out = plain[0](q, k, v.abs(), *extra)[0]
    delta = delta_of(do, out)
    dk, dv = dkv(q, k, v, do, lse, delta, *extra)
    p_dk, p_dv = plain[1](q, k, v, do, lse, delta, *extra)
    g_dq = dq(q, k, v, do, lse, delta, *extra)
    p_dq = plain[2](q, k, v, do, lse, delta, *extra)
    torch.cuda.synchronize()
    for key, got, want in (("out", out, p_out), ("lse", lse, p_lse),
                           ("dq", g_dq, p_dq), ("dk", dk, p_dk),
                           ("dv", dv, p_dv)):
        err = (got.float() - want.float()).abs()
        assert bool((err <= _limit(dtype, key, want, abs_v_out)).all()), \
            (key, err.max().item())


# more than 65535 query tiles of 64 rows in one head: the varlen and
# flashmask bf16 kernels put the tiles on the grid's x axis past 65535 (y
# holds at most 65535 blocks). One head, head_dim 64, causal documents of
# 4000 tokens (flashmask: each key's start row is its document's end); the
# last document straddles tile 65535. The first, a middle and the last
# document are held against the plain versions one at a time.
LONG_TOKENS = (65535 + 2) * 64
LONG_DOC = 4000


@pytest.mark.parametrize("mask", ["varlen", "flashmask"])
def test_more_than_65535_query_tiles_match_plain(cuda, mask):
    t, scale = LONG_TOKENS, 0.125
    cu = list(range(0, t, LONG_DOC)) + [t]
    assert cu[-2] // 64 <= 65535 < (t - 1) // 64
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do = (torch.randn(t, 1, 64, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    cu_t = torch.tensor(cu, device=cuda, dtype=torch.int32)
    if mask == "varlen":
        plan = fv.varlen_plan(cu_t, cu_t, t, t, True)
        fwd, dkv, dq_fn = fv.varlen_fwd, fv.varlen_bwd_dkv, fv.varlen_bwd_dq
        plain = (fv.varlen_fwd_plain, fv.varlen_bwd_dkv_plain,
                 fv.varlen_bwd_dq_plain)
        delta_of = fv.varlen_delta

        def doc(x, a, b):
            return x[a:b] if x.shape[0] == t else x[:, a:b]

        def doc_plan(n):
            one = torch.tensor([0, n], device=cuda, dtype=torch.int32)
            return fv.varlen_plan(one, one, n, n, True)
    else:
        q, k, v, do = (x.view(1, t, 64) for x in (q, k, v, do))
        start = cu_t[1:].repeat_interleave(torch.diff(cu_t))
        plan = fv.flashmask_plan(start.view(1, 1, t, 1), 1, True)
        fwd, dkv, dq_fn = (fv.flashmask_fwd, fv.flashmask_bwd_dkv,
                           fv.flashmask_bwd_dq)
        plain = (fv.flashmask_fwd_plain, fv.flashmask_bwd_dkv_plain,
                 fv.flashmask_bwd_dq_plain)
        delta_of = fa.attention_delta

        def doc(x, a, b):
            return x[:, a:b]

        def doc_plan(n):
            return fv.flashmask_plan(torch.full(
                (1, 1, n, 1), n, device=cuda, dtype=torch.int32), 1, True)
    out, lse = fwd(q, k, v, plan, scale)
    delta = delta_of(do, out)
    dk, dv = dkv(q, k, v, do, lse, delta, plan, scale)
    dq = dq_fn(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()
    for i in (0, (len(cu) - 1) // 2, len(cu) - 2):
        a, b = cu[i], cu[i + 1]
        sub = doc_plan(b - a)
        qs, ks, vs, dos = (doc(x, a, b) for x in (q, k, v, do))
        p_out, p_lse = plain[0](qs, ks, vs, sub, scale)
        abs_v_out = plain[0](qs, ks, vs.abs(), sub, scale)[0]
        bw = (dos, doc(lse, a, b), doc(delta, a, b), sub, scale)
        p_dk, p_dv = plain[1](qs, ks, vs, *bw)
        p_dq = plain[2](qs, ks, vs, *bw)
        for key, got, want in (("out", doc(out, a, b), p_out),
                               ("lse", doc(lse, a, b), p_lse),
                               ("dq", doc(dq, a, b), p_dq),
                               ("dk", doc(dk, a, b), p_dk),
                               ("dv", doc(dv, a, b), p_dv)):
            err = (got.float() - want.float()).abs()
            lim = _limit(torch.bfloat16, key, want, abs_v_out, 64)
            assert bool((err <= lim).all()), (i, key, err.max().item())


# ------------------------------------------------------------ rms / swiglu

_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _fused_limit(want):
    """Per-element bound on |kernel - plain| for the fused kernels: one ulp
    of the element in bf16 and fp16 plus 1e-6 of the largest; fp32 4e-6
    relative (the sums' order and ``expf`` against ``sigmoid``)."""
    w = want.float().abs()
    if want.dtype == torch.float32:
        return 4e-6 * w + 1e-6 * w.max()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), torch.clamp(
        e - 1 - _MANTISSA[want.dtype], min=-14 - _MANTISSA[want.dtype]))
    return ulp + 1e-6 * w.max()


def _rand(device, shape, dtype, seed, scale=1.0, shift=0.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale
            + shift).to(dtype)


# (rows, H, x type, w type): the path shape, a row not a multiple of the
# 16-byte vector (1003), one that is (1000 = 8 * 125) with the block's
# threads not all busy, and each weight type
RMS_SHAPES = [
    (64, 4096, torch.bfloat16, torch.bfloat16),
    (37, 1000, torch.float32, torch.float32),
    (37, 1000, torch.float16, torch.float16),
    (37, 1000, torch.bfloat16, torch.float32),
    (37, 1003, torch.bfloat16, torch.bfloat16),
    (37, 1003, torch.float16, torch.float32),
    (5, 1, torch.float32, torch.float32),
]


@pytest.mark.parametrize("n,h,xt,wt", RMS_SHAPES,
                         ids=[f"{n}x{h}-{str(x)[6:]}-w{str(w)[6:]}"
                              for n, h, x, w in RMS_SHAPES])
def test_rms_norm_kernel_matches_plain(cuda, n, h, xt, wt):
    x = _rand(cuda, (n, h), xt, 0, 2.0, 0.3)
    w = _rand(cuda, (h,), wt, 1, 0.2, 1.0)
    got = fu.rms_norm_fwd(x, w, 1e-6)
    want = fu.rms_norm_fwd_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == xt and got.shape == (n, h)
    err = (got.float() - want.float()).abs()
    assert bool((err <= _fused_limit(want)).all()), err.max().item()


# (rows, F, x type, g type, split): the path shape (split, 11008), odd F
# (split halves unaligned), mixed types, fp32 and fp16
SWIGLU_SHAPES = [
    (64, 11008, torch.bfloat16, torch.bfloat16, True),
    (37, 1001, torch.bfloat16, torch.bfloat16, True),
    (37, 1000, torch.bfloat16, torch.float32, False),
    (37, 1000, torch.float32, torch.bfloat16, False),
    (37, 1001, torch.float32, torch.float32, False),
    (37, 2000, torch.float16, torch.float16, True),
]


@pytest.mark.parametrize("n,f,xt,gt,split", SWIGLU_SHAPES,
                         ids=[f"{n}x{f}-{str(x)[6:]}-g{str(g)[6:]}"
                              f"{'-split' if s else ''}"
                              for n, f, x, g, s in SWIGLU_SHAPES])
def test_swiglu_kernel_matches_plain(cuda, n, f, xt, gt, split):
    if split:
        xg = _rand(cuda, (n, 2 * f), xt, 2, 3.0)
        x, g = xg[:, :f], xg[:, f:]
    else:
        x, g = _rand(cuda, (n, f), xt, 2, 3.0), _rand(cuda, (n, f), gt, 3)
    got = fu.swiglu_fwd(x, g)
    want = fu.swiglu_fwd_plain(x, g)
    torch.cuda.synchronize()
    assert got.dtype == xt and got.shape == (n, f) and got.is_contiguous()
    err = (got.float() - want.float()).abs()
    assert bool((err <= _fused_limit(want)).all()), err.max().item()


def test_fused_autograd_counts_one_launch_each(cuda):
    x = _rand(cuda, (4, 16, 256), torch.bfloat16, 4).requires_grad_()
    w = _rand(cuda, (256,), torch.bfloat16, 5, 0.1, 1.0).requires_grad_()
    fu.reset_launches()
    h = fu.rms_norm(x, w)
    a = fu.swiglu(h)
    assert fu.LAUNCHES == {"rms_norm": 1, "swiglu": 1}
    a.float().sum().backward()
    torch.cuda.synchronize()
    assert fu.LAUNCHES == {"rms_norm": 1, "swiglu": 1}
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


@pytest.mark.parametrize("bad", ["float64", "w_bf16_x_fp16",
                                 "noncontiguous", "w_on_cpu"])
def test_rms_norm_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    x = _rand(cuda, (8, 64), torch.float16, 6)
    w = _rand(cuda, (64,), torch.float16, 7)
    if bad == "float64":
        x, w = x.double(), w.double()
    elif bad == "w_bf16_x_fp16":
        w = w.bfloat16()
    elif bad == "noncontiguous":
        x = _rand(cuda, (64, 8), torch.float16, 6).t()
    else:
        w = w.cpu()
    with pytest.raises((TypeError, ValueError)):
        fu.rms_norm_fwd(x, w, 1e-6)


@pytest.mark.parametrize("bad", ["float64", "column_stride", "shape",
                                 "g_on_cpu"])
def test_swiglu_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    x = _rand(cuda, (8, 64), torch.bfloat16, 8)
    g = _rand(cuda, (8, 64), torch.bfloat16, 9)
    if bad == "float64":
        x = x.double()
    elif bad == "column_stride":
        x = _rand(cuda, (64, 8), torch.bfloat16, 8).t()
    elif bad == "shape":
        g = g[:, :32]
    else:
        g = g.cpu()
    with pytest.raises((TypeError, ValueError)):
        fu.swiglu_fwd(x, g)
