"""Linear algebra: the counterpart of ``paddle_tpu/ops/linalg.py``.

Products promote their operands to one type (torch's refuse mixed types).
The decompositions and solves refuse bf16 and fp16 as the reference does
(its LAPACK calls raise ``NotImplementedError`` for them; cuSOLVER takes
neither): ``lapack`` raises the same. The triangular solves (and
``cholesky_solve``, two of them) and the Householder product, which the
reference computes in those types, run in float32 and round once
(``lowp``). Eigenvectors, singular vectors and
QR factors are defined up to sign or phase, and may differ from the
reference's by it; their products do not.
"""
from __future__ import annotations

import functools

import torch

from .._core.dispatch import apply
from .._core.op_registry import register_op
from ._helper import inexact, tensor_method

_LOW = (torch.bfloat16, torch.float16)


def promote(x: torch.Tensor, y: torch.Tensor):
    """Both operands at ``promote_types`` of their types."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def lapack(fn):
    """``fn``, refusing bf16 and fp16 tensor arguments."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        for a in args:
            if isinstance(a, torch.Tensor) and a.dtype in _LOW:
                raise NotImplementedError(
                    f"{getattr(fn, '__name__', 'linalg')}: unsupported "
                    f"dtype {a.dtype} (the reference's LAPACK path takes "
                    f"float32 and float64)")
        return fn(*args, **kwargs)
    return run


def lowp(fn):
    """``fn`` on float32 copies of bf16/fp16 tensor arguments, its real
    float outputs back in the first argument's type (complex ones stay
    complex64)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        low = next((a.dtype for a in args if isinstance(a, torch.Tensor)),
                   None)
        if low not in _LOW:
            return fn(*args, **kwargs)
        out = fn(*[a.float() if isinstance(a, torch.Tensor)
                   and a.dtype in _LOW else a for a in args], **kwargs)

        def back(o):
            return o.to(low) if isinstance(o, torch.Tensor) and \
                o.dtype == torch.float32 else o
        return tuple(back(o) for o in out) if isinstance(out, tuple) \
            else back(out)
    return run


@register_op("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = promote(x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@tensor_method("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return apply("matmul", _matmul, x, y, transpose_x=bool(transpose_x),
                 transpose_y=bool(transpose_y))


@tensor_method("mm")
def mm(x, y, name=None):
    return matmul(x, y)


@tensor_method("bmm")
def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


@register_op("dot_")
def _dot(x, y):
    x, y = promote(x, y)
    return (x * y).sum(-1)


@tensor_method("dot")
def dot(x, y, name=None):
    return apply("dot_", _dot, x, y)


@register_op("outer_")
def _outer(x, y):
    return torch.outer(*promote(x.reshape(-1), y.reshape(-1)))


def outer(x, y, name=None):
    return apply("outer_", _outer, x, y)


@register_op("einsum_")
def _einsum(*xs, equation):
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return torch.einsum(equation, *[x.to(dt) for x in xs])


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply("einsum_", _einsum, *operands, equation=equation)


@register_op("p_norm_")
def _p_norm(x, p, axis, keepdim):
    x = x.to(inexact(x.dtype))
    dims = axis if axis is None or isinstance(axis, tuple) else (axis,)
    if dims is None:
        dims = tuple(range(x.dim()))

    def red(t, fn):
        return fn(t, dims, keepdim=keepdim) if x.dim() else t
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(red(torch.square(x), torch.sum))
    if p == float("inf"):
        return red(torch.abs(x), torch.amax)
    if p == float("-inf"):
        return red(torch.abs(x), torch.amin)
    if p == 0:
        return red((x != 0).to(x.dtype), torch.sum)
    if p == 1:
        return red(torch.abs(x), torch.sum)
    return torch.pow(red(torch.pow(torch.abs(x), p), torch.sum), 1.0 / p)


@tensor_method("norm")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None else 2
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = int(axis)
    return apply("p_norm_", _p_norm, x, p=p, axis=axis,
                 keepdim=bool(keepdim))


vector_norm = norm


@register_op("trace_")
def _trace(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@tensor_method("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace_", _trace, x, offset=int(offset), axis1=int(axis1),
                 axis2=int(axis2))


@register_op("cholesky_")
@lapack
def _cholesky(x, upper):
    # the _ex forms leave the info check (a host read) out, as the
    # reference's JAX calls do: a failed factorisation gives NaN
    return torch.linalg.cholesky_ex(x, upper=upper)[0]


@tensor_method("cholesky")
def cholesky(x, upper=False, name=None):
    return apply("cholesky_", _cholesky, x, upper=bool(upper))


_inv = register_op("inverse_", lapack(lambda a: torch.linalg.inv_ex(a)[0]))
_solve = register_op("solve_", lapack(
    lambda a, b: torch.linalg.solve_ex(a, b)[0]))
_det = register_op("det_", lapack(torch.linalg.det))


@tensor_method("inverse")
def inv(x, name=None):
    return apply("inverse_", _inv, x)


inverse = inv


def solve(x, y, name=None):
    return apply("solve_", _solve, x, y)


def det(x, name=None):
    return apply("det_", _det, x)


@register_op("triangular_solve_")
@lowp
def _triangular_solve(x, y, upper, transpose, unitriangular):
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return apply("triangular_solve_", _triangular_solve, x, y,
                 upper=bool(upper), transpose=bool(transpose),
                 unitriangular=bool(unitriangular))


@register_op("cross_")
def _cross(x, y, axis):
    return torch.linalg.cross(*promote(x, y), dim=axis)


@tensor_method("cross")
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return apply("cross_", _cross, x, y, axis=int(axis))


@register_op("svd_", multi_output=True)
@lapack
def _svd(x, full_matrices):
    # cuSOLVER's QR-based gesvd: torch's default Jacobi driver stops short
    # of float32 accuracy on a 1024 x 1024 matrix
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices,
                                  driver="gesvd" if x.is_cuda else None))


def svd(x, full_matrices=False, name=None):
    return apply("svd_", _svd, x, full_matrices=bool(full_matrices))


@register_op("qr_", multi_output=True)
@lapack
def _qr(x, mode):
    return tuple(torch.linalg.qr(x, mode=mode))


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return apply("qr_", _qr, x, mode="reduced")[1]
    return apply("qr_", _qr, x, mode=mode)


@register_op("slogdet_", multi_output=True)
@lapack
def _slogdet(x):
    return tuple(torch.linalg.slogdet(x))


def slogdet(x, name=None):
    from .manipulation import stack
    sign, logdet = apply("slogdet_", _slogdet, x)
    return stack([sign, logdet], axis=0)


@register_op("eigh_", multi_output=True)
@lapack
def _eigh(x, UPLO):
    # the reference symmetrizes its input and so reads both triangles
    return tuple(torch.linalg.eigh((x + x.mT.conj()) * 0.5))


def eigh(x, UPLO="L", name=None):
    return apply("eigh_", _eigh, x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return eigh(x, UPLO)[0]


@register_op("pinv_")
@lapack
def _pinv(x, rcond):
    return torch.linalg.pinv(x, rtol=rcond)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv_", _pinv, x, rcond=float(rcond))


@register_op("matrix_power_")
def _matrix_power(x, n):
    if n >= 0:
        return torch.linalg.matrix_power(x, n)
    return torch.linalg.matrix_power(_inv(x), -n)


def matrix_power(x, n, name=None):
    return apply("matrix_power_", _matrix_power, x, n=int(n))


def multi_dot(tensors, name=None):
    out = tensors[0]
    for t in tensors[1:]:
        out = matmul(out, t)
    return out


def matrix_transpose(x, name=None):
    from .manipulation import transpose
    perm = list(range(len(x.shape)))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    return transpose(x, perm)


def cdist(x, y, p=2.0, name=None):
    """The reference's composition: the norm of all pairwise differences
    (not torch.cdist's matrix-product form, which rounds otherwise)."""
    from .manipulation import unsqueeze
    from .math import subtract
    return norm(subtract(unsqueeze(x, -2), unsqueeze(y, -3)), p=p, axis=-1)


@register_op("householder_product_")
@lowp
def _householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


def householder_product(x, tau, name=None):
    """Q from Householder reflectors in geqrf's layout."""
    return apply("householder_product_", _householder_product, x, tau)


def _cov(t, ddof):
    """Rows are variables: the centred product over columns / (n - ddof)
    (torch.cov reads its divisor back to check it)."""
    c = t - t.mean(-1, keepdim=True)
    return c @ c.mT.conj() / (t.shape[-1] - ddof)


def corrcoef(x, rowvar=True, name=None):
    def body(t):
        c = _cov(t if rowvar else t.mT, 1)
        d = torch.sqrt(torch.diagonal(c, 0, -2, -1))
        return torch.clamp(c / d.unsqueeze(-1) / d.unsqueeze(-2), -1, 1)
    return apply("corrcoef", body, x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply("cov", lambda t: _cov(t if rowvar else t.mT,
                                       1 if ddof else 0), x)
