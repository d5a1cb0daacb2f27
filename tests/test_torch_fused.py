"""The port's fused-op surface against the JAX package's, on the CPU.

Kernels #4 and #5 (``_rms_kernel``, ``_swiglu_kernel``) run in Pallas
interpret mode, as they do off the TPU; the port's wrappers run their
plain versions, which is what they do with CPU tensors. Inputs are made
with numpy from a seed and handed to both.

Tolerances:

- fp32 forward, 1e-6 relative (plus 1e-6 absolute): both sides compute in
  fp32 and differ in the order of the row sum and in how silu is spelled
  (``x * sigmoid(x)`` against ``x / (1 + exp(-x))``), a few ulp;
- bf16 and fp16 forward, one ulp of each element: both round once from
  fp32 values that agree to a few fp32 ulp, so they may land on
  neighbouring values and no further;
- fp32 gradients, 1e-5: the same closed forms, summed in another order;
- the plain-jnp functionals (LayerNorm, RMSNorm, RoPE, MoE), fp32 2e-6.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as ref_inc
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.nn.functional import norm as ref_norm
from paddle_tpu.ops.pallas import fused as ref_fused
from paddle_tpu_torch.incubate.nn import functional as pt_inc
from paddle_tpu_torch.nn import functional as pt_F
from paddle_tpu_torch.ops.cuda import fused as pt_fused

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16}
_MANTISSA = {"bfloat16": 7, "float16": 10}


def _arr(rng, shape, dtype="float32", scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32).astype(
        _NP[dtype])


def _t(a):
    """numpy (bf16 included) -> CPU tensor of the same type."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def _f32(a):
    if torch.is_tensor(a):
        return _np(a)
    return np.asarray(a).astype(np.float32)


def assert_within_ulp(got, want, dtype):
    """Each element within one ulp (of ``dtype``) of the reference's."""
    want = _f32(want)
    _, e = np.frexp(want)
    ulp = np.ldexp(1.0, np.maximum(e - 1 - _MANTISSA[dtype],
                                   -14 - _MANTISSA[dtype]))
    err = np.abs(_f32(got) - want)
    assert (err <= ulp).all(), (err.max(), (err / ulp).max())


def assert_fwd(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert_within_ulp(got, want, dtype)


# ----------------------------------------------------------------- rms_norm

RMS_CASES = [  # (rows, H, x type, w type)
    (64, 128, "float32", "float32"),
    (64, 128, "bfloat16", "bfloat16"),
    (64, 128, "float16", "float16"),
    (37, 1000, "bfloat16", "float32"),
    (37, 1003, "bfloat16", "bfloat16"),
    (37, 1003, "float32", "float32"),
]


@pytest.mark.parametrize("n,h,xt,wt", RMS_CASES,
                         ids=[f"{n}x{h}-{xt}-w{wt}" for n, h, xt, wt
                              in RMS_CASES])
def test_rms_norm_fwd_matches_kernel(n, h, xt, wt):
    rng = np.random.RandomState(0)
    x = _arr(rng, (n, h), xt, scale=2.0, shift=0.3)
    w = (rng.rand(h) + 0.5).astype(np.float32).astype(_NP[wt])
    ref = ref_fused._rms_fwd_pallas(jnp.asarray(x), jnp.asarray(w), 1e-6)
    pt_fused.reset_launches()
    out = pt_fused.rms_norm_fwd(_t(x), _t(w), 1e-6)
    assert pt_fused.LAUNCHES == {"rms_norm": 0, "swiglu": 0}
    assert out.dtype == _t(x).dtype and tuple(out.shape) == (n, h)
    assert_fwd(out, ref, xt)


@pytest.mark.parametrize("xt,wt", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")])
def test_rms_norm_grads_match_reference_vjp(xt, wt):
    rng = np.random.RandomState(1)
    x = _arr(rng, (3, 11, 96), xt, shift=0.2)
    w = (rng.rand(96) + 0.5).astype(np.float32).astype(_NP[wt])
    dy = _arr(rng, (3, 11, 96), xt)
    y_ref, vjp = jax.vjp(lambda a, b: ref_fused.rms_norm(a, b, 1e-5),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    xt_, wt_ = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = pt_fused.rms_norm(xt_, wt_, 1e-5)
    y.backward(_t(dy))
    assert xt_.grad.dtype == xt_.dtype and wt_.grad.dtype == wt_.dtype
    assert_fwd(y, y_ref, xt)
    if xt == "float32":
        np.testing.assert_allclose(_np(xt_.grad), _f32(dx_ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(wt_.grad), _f32(dw_ref), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert_within_ulp(xt_.grad, dx_ref, xt)
        if wt == "float32":
            np.testing.assert_allclose(_np(wt_.grad), _f32(dw_ref),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert_within_ulp(wt_.grad, dw_ref, wt)


# ------------------------------------------------------------------- swiglu

SWIGLU_CASES = [  # (rows, F, x type, g type)
    (32, 256, "float32", "float32"),
    (32, 256, "bfloat16", "bfloat16"),
    (37, 1001, "float32", "float32"),
    (37, 1001, "bfloat16", "bfloat16"),
    (37, 1000, "bfloat16", "float32"),
    (16, 64, "float16", "float16"),
]


# the split form has one type for x and g
SWIGLU_FORMS = [(form, *case) for case in SWIGLU_CASES
                for form in ("two_args", "split")
                if form == "two_args" or case[2] == case[3]]


@pytest.mark.parametrize("form,n,f,xt,gt", SWIGLU_FORMS,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-{c[3]}-g{c[4]}"
                              for c in SWIGLU_FORMS])
def test_swiglu_fwd_matches_kernel(form, n, f, xt, gt):
    rng = np.random.RandomState(2)
    x = _arr(rng, (n, f), xt, scale=3.0)
    g = _arr(rng, (n, f), gt)
    if form == "split":
        xg = np.concatenate([x, g], -1)
        ref = ref_fused.swiglu(jnp.asarray(xg))
        out = pt_fused.swiglu(_t(xg))
    else:
        ref = ref_fused.swiglu(jnp.asarray(x), jnp.asarray(g))
        out = pt_fused.swiglu(_t(x), _t(g))
    assert out.dtype == _t(x).dtype and tuple(out.shape) == (n, f)
    assert_fwd(out, ref, xt)


def test_swiglu_wrapper_reads_the_halves_in_place():
    """The split form hands the wrapper two strided views of one tensor;
    the plain version gives what two separate tensors give (to an fp32
    ulp: PyTorch vectorises contiguous and strided rows differently)."""
    rng = np.random.RandomState(3)
    xg = _t(_arr(rng, (5, 2, 14)))
    x2 = xg.reshape(-1, 14)
    a, b = x2[:, :7], x2[:, 7:]
    assert a.stride() == (14, 1) and b.data_ptr() == a.data_ptr() + 7 * 4
    torch.testing.assert_close(pt_fused.swiglu_fwd(a, b),
                               pt_fused.swiglu_fwd(a.contiguous(),
                                                   b.contiguous()),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("form", ["two_args", "split"])
@pytest.mark.parametrize("f", [64, 1001])
def test_swiglu_grads_match_reference_vjp(form, f):
    rng = np.random.RandomState(4)
    x = _arr(rng, (3, 5, f), scale=2.0)
    g = _arr(rng, (3, 5, f))
    dy = _arr(rng, (3, 5, f))
    if form == "split":
        xg = np.concatenate([x, g], -1)
        _, vjp = jax.vjp(lambda a: ref_fused.swiglu(a), jnp.asarray(xg))
        (dxg_ref,) = vjp(jnp.asarray(dy))
        xg_t = _t(xg).requires_grad_()
        pt_fused.swiglu(xg_t).backward(_t(dy))
        assert xg_t.grad.shape == xg_t.shape
        np.testing.assert_allclose(_np(xg_t.grad), _f32(dxg_ref),
                                   rtol=1e-5, atol=1e-5)
        return
    _, vjp = jax.vjp(lambda a, b: ref_fused.swiglu(a, b), jnp.asarray(x),
                     jnp.asarray(g))
    dx_ref, dg_ref = vjp(jnp.asarray(dy))
    xt_, gt_ = _t(x).requires_grad_(), _t(g).requires_grad_()
    pt_fused.swiglu(xt_, gt_).backward(_t(dy))
    np.testing.assert_allclose(_np(xt_.grad), _f32(dx_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(gt_.grad), _f32(dg_ref), rtol=1e-5,
                               atol=1e-5)


def test_swiglu_mixed_types_give_grads_in_their_own_types():
    rng = np.random.RandomState(5)
    x = _t(_arr(rng, (4, 40), "bfloat16")).requires_grad_()
    g = _t(_arr(rng, (4, 40))).requires_grad_()
    y = pt_fused.swiglu(x, g)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and g.grad.dtype == torch.float32


# ----------------------------------------------------- incubate functionals

@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("with_norm_bias", [False, True])
def test_fused_rms_norm_matches_reference(with_bias, with_residual,
                                          with_norm_bias):
    rng = np.random.RandomState(6)
    x = _arr(rng, (2, 9, 64))
    w = (rng.rand(64) + 0.5).astype(np.float32)
    extra = {}
    if with_bias:
        extra["bias"] = _arr(rng, (64,))
    if with_residual:
        extra["residual"] = _arr(rng, (2, 9, 64))
    if with_norm_bias:
        extra["norm_bias"] = _arr(rng, (64,))
    out_ref, res_ref = ref_inc.fused_rms_norm(
        jnp.asarray(x), jnp.asarray(w), epsilon=1e-5,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    out, res = pt_inc.fused_rms_norm(_t(x), _t(w), epsilon=1e-5,
                                     **{k: _t(v) for k, v in extra.items()})
    np.testing.assert_allclose(_np(out), _f32(out_ref), rtol=1e-6, atol=1e-6)
    if with_residual:
        np.testing.assert_allclose(_np(res), _f32(res_ref), rtol=0, atol=0)
    else:
        assert res is None and res_ref is None


def test_fused_rms_norm_grads_flow_to_x_residual_and_weight():
    rng = np.random.RandomState(7)
    x, r, dy = (_arr(rng, (4, 32)) for _ in range(3))
    w = (rng.rand(32) + 0.5).astype(np.float32)

    def ref_fn(a, b, c):
        return ref_inc.fused_rms_norm(a, c, residual=b)[0]

    _, vjp = jax.vjp(ref_fn, jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
    grads_ref = vjp(jnp.asarray(dy))
    ts = [_t(a).requires_grad_() for a in (x, r, w)]
    pt_inc.fused_rms_norm(ts[0], ts[2], residual=ts[1])[0].backward(_t(dy))
    for t, g_ref in zip(ts, grads_ref):
        np.testing.assert_allclose(_np(t.grad), _f32(g_ref), rtol=1e-5,
                                   atol=1e-5)


def _pd(a):
    return paddle.to_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("begin_norm_axis", [-1, 1])
def test_fused_layer_norm_matches_reference(begin_norm_axis):
    rng = np.random.RandomState(8)
    x = _arr(rng, (3, 4, 16), scale=2.0, shift=1.0)
    r = _arr(rng, (3, 4, 16))
    b = _arr(rng, (16,))
    shape = (16,) if begin_norm_axis == -1 else (4, 16)
    w = (rng.rand(*shape) + 0.5).astype(np.float32)
    nb = _arr(rng, shape)
    out_ref, res_ref = ref_inc.fused_layer_norm(
        _pd(x), _pd(w), _pd(nb), epsilon=1e-5,
        begin_norm_axis=begin_norm_axis, bias=_pd(b), residual=_pd(r))
    out, res = pt_inc.fused_layer_norm(
        _t(x), _t(w), _t(nb), epsilon=1e-5, begin_norm_axis=begin_norm_axis,
        bias=_t(b), residual=_t(r))
    np.testing.assert_allclose(_np(out), out_ref.numpy(), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(_np(res), res_ref.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("norm_shape", [16, (4, 16)])
@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_matches_reference(norm_shape, affine):
    rng = np.random.RandomState(9)
    x = _arr(rng, (3, 4, 16), scale=3.0, shift=-1.0)
    wshape = (16,) if norm_shape == 16 else norm_shape
    w = (rng.rand(*wshape) + 0.5).astype(np.float32) if affine else None
    b = _arr(rng, wshape) if affine else None
    ref = ref_F.layer_norm(_pd(x), norm_shape,
                           None if w is None else _pd(w),
                           None if b is None else _pd(b), 1e-5)
    out = pt_F.layer_norm(_t(x), norm_shape, None if w is None else _t(w),
                          None if b is None else _t(b), 1e-5)
    np.testing.assert_allclose(_np(out), ref.numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_rms_norm_matches_reference(dtype):
    """The functional RMSNorm rounds before the weight: in bf16 it gives
    another answer than the kernel, as in the reference."""
    rng = np.random.RandomState(10)
    x = _arr(rng, (5, 48), dtype, scale=2.0)
    w = (rng.rand(48) + 0.5).astype(np.float32).astype(_NP[dtype])
    b = _arr(rng, (48,), dtype)
    ref = ref_norm._rms_norm_kernel(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), 1e-6)
    out = pt_F.rms_norm(_t(x), _t(w), _t(b), 1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _f32(ref), rtol=2e-6, atol=2e-6)
    else:
        # one rounding before the weight on both sides, then a bf16
        # product and sum each rounded once: at most one ulp apart
        assert_within_ulp(out, ref, dtype)
        kern = pt_fused.rms_norm_fwd(_t(x), _t(w), 1e-6)
        assert not torch.equal(kern, pt_F.rms_norm(_t(x), _t(w),
                                                   epsilon=1e-6))


def test_incubate_surface_matches_reference():
    assert pt_inc.__all__ == ref_inc.__all__


# --------------------------------------------------------------------- rope

def _rope_inputs(seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    q = _arr(rng, (2, 12, 3, 16), dtype)
    k = _arr(rng, (2, 12, 3, 16), dtype)
    v = _arr(rng, (2, 12, 3, 16), dtype)
    return q, k, v


@pytest.mark.parametrize("case", ["default", "cos_sin", "position_ids",
                                  "q_only"])
def test_rope_matches_reference(case):
    q, k, v = _rope_inputs(11)
    kw_ref, kw_pt = {}, {}
    if case in ("cos_sin", "position_ids"):
        rng = np.random.RandomState(12)
        ang = rng.rand(12, 8).astype(np.float32) * 6
        ang = np.concatenate([ang, ang], -1)
        cos, sin = np.cos(ang), np.sin(ang)
        kw_ref.update(cos=jnp.asarray(cos), sin=jnp.asarray(sin))
        kw_pt.update(cos=_t(cos), sin=_t(sin))
    if case == "position_ids":
        pid = np.tile(np.array([5, 0, 1, 11, 2, 3, 3, 7, 4, 6, 8, 9]),
                      (2, 1)).astype(np.int64)
        kw_ref["position_ids"] = jnp.asarray(pid)
        kw_pt["position_ids"] = torch.from_numpy(pid)
    kk = None if case == "q_only" else k
    ref = ref_fused.fused_rotary_position_embedding(
        jnp.asarray(q), None if kk is None else jnp.asarray(kk),
        jnp.asarray(v), **kw_ref)
    out = pt_inc.fused_rotary_position_embedding(
        _t(q), None if kk is None else _t(kk), _t(v), **kw_pt)
    np.testing.assert_allclose(_np(out[0]), _f32(ref[0]), rtol=2e-6,
                               atol=2e-6)
    if kk is None:
        assert out[1] is None and ref[1] is None
    else:
        np.testing.assert_allclose(_np(out[1]), _f32(ref[1]), rtol=2e-6,
                                   atol=2e-6)
    np.testing.assert_array_equal(_np(out[2]), v)


def test_rope_bf16_matches_reference_within_one_ulp():
    q, k, v = _rope_inputs(13, "bfloat16")
    ref = ref_fused.fused_rotary_position_embedding(jnp.asarray(q),
                                                    jnp.asarray(k))
    out = pt_inc.fused_rotary_position_embedding(_t(q), _t(k))
    assert out[0].dtype == torch.bfloat16 and out[2] is None
    assert_within_ulp(out[0], ref[0], "bfloat16")
    assert_within_ulp(out[1], ref[1], "bfloat16")


# ---------------------------------------------------------------- refusals

def test_rope_refuses_position_ids_whose_rows_differ():
    q, k, _ = _rope_inputs(14)
    pid = np.stack([np.arange(12), np.arange(12)[::-1]])
    with pytest.raises(ValueError, match="rows differ"):
        pt_inc.fused_rotary_position_embedding(
            _t(q), _t(k), position_ids=torch.from_numpy(pid))
    with pytest.raises(ValueError, match=r"\[batch, seq\]"):
        pt_inc.fused_rotary_position_embedding(
            _t(q), _t(k), position_ids=torch.arange(12))


def test_rope_refuses_the_non_neox_style():
    q, k, _ = _rope_inputs(15)
    with pytest.raises(NotImplementedError, match="neox"):
        pt_inc.fused_rotary_position_embedding(_t(q), _t(k),
                                               use_neox_rotary_style=False)


@pytest.mark.parametrize("kwargs", [{"begin_norm_axis": 0},
                                    {"begin_norm_axis": 1},
                                    {"quant_scale": 0.5}],
                         ids=["axis0", "axis1", "quant"])
def test_fused_rms_norm_refuses_what_the_reference_ignores(kwargs):
    x = torch.ones(2, 3, 8)
    with pytest.raises(NotImplementedError):
        pt_inc.fused_rms_norm(x, torch.ones(8), **kwargs)
    out, _ = pt_inc.fused_rms_norm(x, torch.ones(8), begin_norm_axis=2)
    assert out.shape == x.shape


def test_swiglu_split_refuses_an_odd_width_and_mismatched_gate():
    with pytest.raises(ValueError, match="even"):
        pt_fused.swiglu(torch.ones(3, 7))
    with pytest.raises(ValueError, match="shape"):
        pt_fused.swiglu(torch.ones(3, 8), torch.ones(3, 4))


def test_wrappers_refuse_bad_shapes_and_mixed_devices():
    with pytest.raises(ValueError, match=r"\[N, H\]"):
        pt_fused.rms_norm_fwd(torch.ones(4, 8), torch.ones(7), 1e-6)
    with pytest.raises(ValueError, match=r"\[N, F\]"):
        pt_fused.swiglu_fwd(torch.ones(4, 8), torch.ones(4, 7))
    meta = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="tensors on"):
        pt_fused.rms_norm_fwd(torch.ones(4, 8), meta, 1e-6)
    with pytest.raises(ValueError, match="no kernel for device"):
        pt_fused.swiglu_fwd(torch.ones(4, 8, device="meta"),
                            torch.ones(4, 8, device="meta"))


# ------------------------------------------------------------------- build

def test_each_source_hashes_the_headers_it_includes(tmp_path, monkeypatch):
    """``_build.SOURCES`` names each source's own headers (its
    ``#include "..."`` lines), so an edit of the flash header rebuilds the
    flash libraries and leaves the fused one as it is."""
    import re
    import shutil

    from paddle_tpu_torch.ops.cuda import _build
    for name, (source, headers) in _build.SOURCES.items():
        text = (_build.CSRC / source).read_text()
        assert tuple(re.findall(r'#include "([^"]+)"', text)) == headers, name
    for f in _build.CSRC.iterdir():
        if f.is_file():
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._target(name) for name in _build.SOURCES}
    with open(tmp_path / "flash_common.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert after["fused"] == before["fused"]
    assert all(after[n] != before[n] for n in _build.SOURCES if n != "fused")
