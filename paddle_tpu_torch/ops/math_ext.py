"""Long-tail math and tensor ops: the counterpart of
``paddle_tpu/ops/math_ext.py`` (``addmm``, ``baddbmm``, ``cummax`` /
``cummin``, the Bessel and gamma functions, ``dist``, ``cholesky_solve``,
``svdvals``, ``householder_product``, ``diag_embed``, ``fill_diagonal``,
``multiplex``, ``slice`` / ``strided_slice``, ``crop``, bit shifts,
``reduce_as``, ``clip_by_norm``, the l1 / squared l2 norms; the random
distributions live in ``creation.py``).

``gammainc`` and ``gammaincc`` come from ``torch.special``, which has no
gradient for their first argument; the reference has one, so the port
writes it (:class:`_GammaInc`).
"""
from __future__ import annotations

import builtins

import torch

from .._core.dispatch import apply, unwrap
from .._core.op_registry import register_op
from .._core.tensor import Tensor
from ._helper import def_binary, def_unary, inexact, promoted, \
    tensor_method
from .creation import (binomial, dirichlet, exponential_,  # noqa: F401
                       poisson, standard_gamma)
from .linalg import _householder_product, householder_product  # noqa: F401
from .linalg import lapack, lowp, promote


# --------------------------------------------------- blas-style composites
@register_op("addmm_")
def _addmm(inp, x, y, beta, alpha):
    x, y = promote(x, y)
    return beta * inp + alpha * (x @ y)


@register_op("baddbmm_")
def _baddbmm(inp, x, y, beta, alpha):
    x, y = promote(x, y)
    return beta * inp + alpha * torch.matmul(x, y)


@tensor_method("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm_", _addmm, input, x, y, beta=float(beta),
                 alpha=float(alpha))


def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("baddbmm_", _baddbmm, input, x, y, beta=float(beta),
                 alpha=float(alpha))


# ----------------------------------------------------- cumulative min/max
def _cum_extreme(x, axis, fn):
    """The running extremum and the index of its LAST occurrence so far
    (the reference's ``cummax`` of the positions equal to it); the values
    are gathered at those indices, so the gradient goes to the same
    element on every device (torch's own pick among ties varies)."""
    axis %= x.dim()
    val = fn(x.detach(), axis).values
    shape = [-1 if i == axis else 1 for i in range(x.dim())]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.cummax(torch.where(x.detach() == val, pos, -1), axis).values
    if x.dtype in (torch.bfloat16, torch.float16):
        # the gradient's repeated indices summed in float32, rounded once
        return torch.take_along_dim(x.float(), idx, axis).to(x.dtype), idx
    return torch.take_along_dim(x, idx, axis), idx


@register_op("cummax_", multi_output=True)
def _cummax(x, axis):
    return _cum_extreme(x, axis, torch.cummax)


@register_op("cummin_", multi_output=True)
def _cummin(x, axis):
    return _cum_extreme(x, axis, torch.cummin)


@tensor_method("cummax")
def cummax(x, axis=-1, dtype="int64", name=None):
    return tuple(apply("cummax_", _cummax, x, axis=int(axis)))


@tensor_method("cummin")
def cummin(x, axis=-1, dtype="int64", name=None):
    return tuple(apply("cummin_", _cummin, x, axis=int(axis)))


# ------------------------------------------------------ special functions
def _in_f32(fn):
    """``fn`` in float32 for bf16/fp16 inputs, rounded once (torch has no
    low-precision backward for the Bessel functions; JAX computes them in
    float32 too)."""
    def run(x):
        return fn(x.float()).to(x.dtype) if x.dtype in (
            torch.bfloat16, torch.float16) else fn(x)
    return run


i0 = def_unary("i0", _in_f32(torch.i0), True)
i0e = def_unary("i0e", _in_f32(torch.special.i0e), True)
i1 = def_unary("i1", _in_f32(torch.special.i1), True)
i1e = def_unary("i1e", _in_f32(torch.special.i1e), True)
gammaln = def_unary("gammaln", torch.lgamma, True)


@register_op("polygamma_")
def _polygamma(x, n):
    return torch.polygamma(n, x.to(inexact(x.dtype)))


@tensor_method("polygamma")
def polygamma(x, n, name=None):
    return apply("polygamma_", _polygamma, x, n=int(n))


# terms of the series for d/da P(a, x): enough for x up to about 200
_SERIES = 400


def _dgammainc_da(a, x):
    """d/da of the regularized lower incomplete gamma P(a, x), from its
    series P = sum_k exp((a+k) log x - x - lgamma(a+k+1)), whose terms'
    derivative in a is (log x - digamma(a+k+1)) times each term; float64
    throughout, one term at a time."""
    a, x = torch.broadcast_tensors(a.double(), x.double())
    lx = torch.log(x)
    out = torch.zeros_like(a)
    for k in range(_SERIES):
        ak = a + (k + 1)
        out = out + torch.exp((ak - 1) * lx - x - torch.lgamma(ak)) * (
            lx - torch.digamma(ak))
    return out


class _GammaInc(torch.autograd.Function):
    """``torch.special.gammainc`` (``upper``: ``gammaincc``) with the
    gradient in its first argument that torch lacks."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        fn = torch.special.gammaincc if upper else torch.special.gammainc
        return fn(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        da = dx = None
        if ctx.needs_input_grad[0]:
            da = (sign * g.double() * _dgammainc_da(a, x)).to(a.dtype)
            da = _unbroadcast(da, a.shape)
        if ctx.needs_input_grad[1]:
            # dP/dx = x^(a-1) e^-x / Gamma(a)
            d = torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))
            dx = _unbroadcast(sign * g * d, x.shape)
        return da, dx, None


def _unbroadcast(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


@register_op("gammainc_")
def _gammainc(a, x):
    a, x = promoted(a, x, to_inexact=True, scalars=False)
    return _GammaInc.apply(a, x, False)


@register_op("gammaincc_")
def _gammaincc(a, x):
    a, x = promoted(a, x, to_inexact=True, scalars=False)
    return _GammaInc.apply(a, x, True)


def gammainc(x, y, name=None):
    return apply("gammainc_", _gammainc, x, y)


def gammaincc(x, y, name=None):
    return apply("gammaincc_", _gammaincc, x, y)


# ------------------------------------------------------------- distances
@register_op("dist_")
def _dist(x, y, p):
    d = (x - y).reshape(-1)
    return torch.linalg.vector_norm(d.to(inexact(d.dtype)), ord=p)


def dist(x, y, p=2.0, name=None):
    return apply("dist_", _dist, x, y, p=float(p))


# ---------------------------------------------------------------- linalg
@register_op("cholesky_solve_")
@lowp
def _cholesky_solve(x, y, upper):
    return torch.cholesky_solve(x, y, upper=upper)


@register_op("svdvals_")
@lapack
def _svdvals(x):
    return torch.linalg.svdvals(x, driver="gesvd" if x.is_cuda else None)


def cholesky_solve(x, y, upper=False, name=None):
    """Solves A X = B given the Cholesky factor ``y`` of A (B is ``x``)."""
    return apply("cholesky_solve_", _cholesky_solve, x, y, upper=bool(upper))


def svdvals(x, name=None):
    return apply("svdvals_", _svdvals, x)


# -------------------------------------------------------- diagonal tools
@register_op("diag_embed_")
def _diag_embed(x, offset, dim1, dim2):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply("diag_embed_", _diag_embed, x, offset=int(offset),
                 dim1=int(dim1), dim2=int(dim2))


@register_op("fill_diagonal_")
def _fill_diagonal(x, value, offset, wrap):
    val = torch.full((), value, dtype=x.dtype, device=x.device)
    if x.dim() > 2:  # the space diagonal x[i, i, ..., i]
        idx = torch.arange(builtins.min(x.shape), device=x.device)
        out = x.clone()
        out[(idx,) * x.dim()] = val
        return out
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    if wrap and h > w:  # numpy's wrap: the diagonal restarts every w+1 rows
        mask = (rows % (w + 1)) == cols
    else:
        mask = (cols - rows) == offset
    return torch.where(mask, val, x)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    return apply("fill_diagonal_", _fill_diagonal, x, value=float(value),
                 offset=int(offset), wrap=bool(wrap))


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    return x._adopt(fill_diagonal(x, value, offset, wrap))


# ------------------------------------------------------- select / slicing
@register_op("multiplex_")
def _multiplex(index, *ins):
    stacked = torch.stack(ins, 0)  # [k, N, ...]
    idx = index.reshape(-1).to(torch.int64)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def multiplex(inputs, index, name=None):
    """Row-wise select: out[i] = inputs[index[i]][i]."""
    return apply("multiplex_", _multiplex, index, *inputs)


@register_op("strided_slice_")
def _strided_slice(x, spec):
    from .indexing import _getitem
    return _getitem(x, spec=tuple(("slice",) + tuple(s) for s in spec))


def slice(input, axes, starts, ends, name=None):
    return strided_slice(input, axes, starts, ends, [1] * len(list(axes)))


def strided_slice(x, axes, starts, ends, strides, name=None):
    spec = [(None, None, None)] * unwrap(x).dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        spec[ax] = (int(st), int(en), int(sd))
    return apply("strided_slice_", _strided_slice, x, spec=tuple(spec))


@register_op("crop_")
def _crop(x, offsets, shape):
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


def crop(x, shape=None, offsets=None, name=None):
    xs = unwrap(x).shape
    offsets = list(offsets) if offsets is not None else [0] * len(xs)
    shape = list(shape) if shape is not None else [-1] * len(xs)
    # -1 or None: to the end from the offset
    shape = [xs[i] - offsets[i] if s in (-1, None) else int(s)
             for i, s in enumerate(shape)]
    return apply("crop_", _crop, x, offsets=tuple(int(o) for o in offsets),
                 shape=tuple(shape))


def unstack(x, axis=0, num=None, name=None):
    from .manipulation import unbind
    return unbind(x, axis=axis)


def reverse(x, axis, name=None):
    from .manipulation import flip
    return flip(x, axis)


def is_empty(x, name=None):
    t = unwrap(x)
    return Tensor(torch.full((), t.numel() == 0, dtype=torch.bool,
                             device=t.device))


# ------------------------------------------------------------ bit shifts
bitwise_left_shift = def_binary("bitwise_left_shift",
                                torch.bitwise_left_shift,
                                bool_as=torch.int32)
bitwise_right_shift = def_binary("bitwise_right_shift",
                                 torch.bitwise_right_shift,
                                 bool_as=torch.int32)


# ----------------------------------------------------------- norm family
@register_op("reduce_as_")
def _reduce_as(x, tshape):
    off = x.dim() - len(tshape)
    axes = [i for i in range(x.dim()) if i < off or (
        tshape[i - off] == 1 and x.shape[i] != 1)]
    out = x.sum(axes, keepdim=True) if axes else x
    return out.reshape(tshape)


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s shape."""
    return apply("reduce_as_", _reduce_as, x,
                 tshape=tuple(unwrap(target).shape))


@register_op("clip_by_norm_")
def _clip_by_norm(x, max_norm):
    n = torch.sqrt(torch.sum(torch.square(x.reshape(-1))))
    return x * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


@register_op("squared_l2_norm_")
def _squared_l2_norm(x):
    return torch.sum(x * x).reshape(1)


@register_op("l1_norm_")
def _l1_norm(x):
    return torch.sum(torch.abs(x))


def clip_by_norm(x, max_norm, name=None):
    return apply("clip_by_norm_", _clip_by_norm, x, max_norm=float(max_norm))


def squared_l2_norm(x, name=None):
    return apply("squared_l2_norm_", _squared_l2_norm, x)


def l1_norm(x, name=None):
    return apply("l1_norm_", _l1_norm, x)
