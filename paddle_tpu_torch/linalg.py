"""``paddle.linalg``: the counterpart of ``paddle_tpu/linalg.py``. The
linear-algebra ops of ``ops.linalg`` plus the decompositions that are not
in the tensor namespace (each registered under the reference's name)."""
from __future__ import annotations

import torch

from ._core.dispatch import apply
from ._core.op_registry import register_op
from .ops._helper import inexact
from .ops.linalg import (bmm, cdist, cholesky, corrcoef, cov, cross,  # noqa: F401
                         det, dot, eigh, eigvalsh, householder_product,
                         inv, lapack, matmul, matrix_power, matrix_transpose,
                         multi_dot, mv, norm, outer, pinv, qr, slogdet,
                         solve, svd, trace, triangular_solve)


def _def(name, body, multi_output=False):
    register_op(name, body, multi_output=multi_output)

    def wrapper(x, *args, **kwargs):
        kwargs.pop("name", None)
        return apply(name, body, x, *args, **kwargs)
    wrapper.__name__ = name
    return wrapper


eig = _def("linalg_eig", lapack(lambda x: tuple(torch.linalg.eig(x))),
           multi_output=True)
eigvals = _def("linalg_eigvals", lapack(lambda a: torch.linalg.eigvals(a)))


@lapack
def _matrix_rank(x, tol=None, hermitian=False):
    if tol is None:  # the largest singular value * max(m, n) * eps
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return (torch.linalg.svdvals(x) > tol).sum(-1)


matrix_rank = _def("linalg_matrix_rank", _matrix_rank)
cond = _def("linalg_cond",
            lapack(lambda x, p=None: torch.linalg.cond(x, p)))


@lapack
def _lu(x, pivot=True):
    lu_mat, piv, _ = torch.linalg.lu_factor_ex(x, pivot=pivot)
    return lu_mat, (piv - 1).to(torch.int32)  # LAPACK's 1-based rows


lu = _def("linalg_lu", _lu, multi_output=True)


@lapack
def _lstsq(x, y, rcond=None, driver=None):
    """``jnp.linalg.lstsq``: the least-squares solution through the SVD,
    the squared residual norms, the rank and the singular values."""
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(x.shape[-2:])
    keep = s > rcond * s.amax(-1, keepdim=True)
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    vec = y.dim() == x.dim() - 1
    b = y.unsqueeze(-1) if vec else y
    sol = vh.mT @ (inv_s.unsqueeze(-1) * (u.mT @ b))
    resid = ((b - x @ sol) ** 2).sum(-2)
    if vec:
        sol, resid = sol.squeeze(-1), resid.squeeze(-1)
    return sol, resid, keep.sum(-1), s


lstsq = _def("linalg_lstsq", _lstsq, multi_output=True)
vector_norm = _def("linalg_vector_norm",
                   lambda x, p=2.0, axis=None, keepdim=False:
                   torch.linalg.norm(x.to(inexact(x.dtype)), p, axis,
                                     keepdim))


def _matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    if p in ("fro", 1, -1, float("inf"), float("-inf")):  # sums, no LAPACK
        return torch.linalg.matrix_norm(x.float() if x.dtype in (
            torch.bfloat16, torch.float16) else x, p, tuple(axis),
            keepdim).to(x.dtype)
    return lapack(torch.linalg.matrix_norm)(x, p, tuple(axis), keepdim)


matrix_norm = _def("linalg_matrix_norm", _matrix_norm)
