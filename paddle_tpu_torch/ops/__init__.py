"""The eager op surface: the counterpart of ``paddle_tpu/ops``, re-exported
at the top level of the package as the reference's is. Importing it
registers every op (``_core/op_registry.py``) and attaches the ops to
``Tensor`` as methods, ``op_`` in-place variants and operators, as the
reference patches its Tensor. The kernels of the port live in
``ops/cuda``."""
import torch

from .._core.dispatch import unwrap
from .._core.tensor import Tensor, to_tensor
from . import moe, segment  # noqa: F401
from . import _helper, creation, extra, indexing, linalg, manipulation, \
    math, math_ext, parity, reduction, search  # noqa: F401
from .creation import *  # noqa: F401,F403
from .extra import (angle, bincount, copysign, diff, frexp,  # noqa: F401
                    histogram, kron, ldexp, nanmedian, polar, renorm, rot90,
                    select_scatter, take, tensordot, trapezoid, unfold,
                    vander)
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .math_ext import (addmm, baddbmm, binomial, bitwise_left_shift,  # noqa: F401
                       bitwise_right_shift, cholesky_solve, clip_by_norm,
                       crop, cummax, cummin, diag_embed, dirichlet, dist,
                       exponential_, fill_diagonal, fill_diagonal_, gammainc,
                       gammaincc, gammaln, i0, i0e, i1, i1e, is_empty,
                       l1_norm, multiplex, poisson, polygamma, reduce_as,
                       reverse, slice, squared_l2_norm, standard_gamma,
                       strided_slice, svdvals, unstack)
from .parity import (as_strided, fill_diagonal_tensor,  # noqa: F401
                     fused_bias_act, fused_bias_dropout_residual_layer_norm,
                     fused_dropout_add, fused_gemm_epilogue,
                     fused_linear_param_grad_add, fused_softmax_mask,
                     fused_softmax_mask_upper_triangle, index_select_strided,
                     skip_layernorm, trans_layout, view_dtype, view_slice)
from .reduction import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from ._helper import def_binary, def_unary, tensor_method  # noqa: F401
from .math import (abs, add, bitwise_and, bitwise_not, bitwise_or,  # noqa: F401
                   bitwise_xor, divide, equal, floor_divide, greater_equal,
                   greater_than, less_equal, less_than, logical_and,
                   logical_not, logical_or, logical_xor, mod, multiply, neg,
                   not_equal, pow, subtract)
from .linalg import matmul  # noqa: F401
from .creation import to_tensor  # noqa: F401,F811 (canonical)
from .reduction import sum, max, min, all, any  # noqa: F401,F811


def _adopt(self, out):
    """The result of a functional op takes the place of this tensor's
    payload (the reference's in-place ops). The old payload is not
    written: what autograd saved of it, and any view of it, keeps its
    values."""
    self._t = unwrap(out)
    return self


Tensor._adopt = _adopt


def _reflected(fn):
    """``other op self``. As the reference's reflected operators turn the
    Python scalar into a tensor first, a Python float there is a float32
    0-d tensor, which takes part in type promotion (``1.5 / x`` of a bf16
    ``x`` is float32) where ``x / 1.5`` keeps x's type."""
    def op(self, other):
        if isinstance(other, float):  # a fill on the device, no copy
            other = torch.full((), other, dtype=torch.float32,
                               device=self._t.device)
        return fn(other, self)
    return op


def _bitwise_or_logical(logical, bitwise, reflected=False):
    """``&``, ``|``, ``^``: logical on bool tensors, bitwise otherwise
    (the reference's operators); ``reflected``: ``other op self``."""
    def op(self, other):
        fn = logical if self._t.dtype == torch.bool else bitwise
        return fn(other, self) if reflected else fn(self, other)
    return op


for _dunder, _fn in (("add", add), ("sub", subtract), ("mul", multiply),
                     ("truediv", divide), ("floordiv", floor_divide),
                     ("mod", mod), ("pow", pow), ("matmul", matmul),
                     ("lshift", bitwise_left_shift),
                     ("rshift", bitwise_right_shift)):
    setattr(Tensor, f"__{_dunder}__", _fn)
    setattr(Tensor, f"__r{_dunder}__", _reflected(_fn))
for _dunder, _log, _bit in (("and", logical_and, bitwise_and),
                            ("or", logical_or, bitwise_or),
                            ("xor", logical_xor, bitwise_xor)):
    setattr(Tensor, f"__{_dunder}__", _bitwise_or_logical(_log, _bit))
    setattr(Tensor, f"__r{_dunder}__",
            _bitwise_or_logical(_log, _bit, reflected=True))
# commutative: the scalar stays a Python scalar, as in the reference
Tensor.__radd__ = add
Tensor.__rmul__ = multiply
for _dunder, _fn in (("eq", equal), ("ne", not_equal), ("lt", less_than),
                     ("le", less_equal), ("gt", greater_than),
                     ("ge", greater_equal)):
    setattr(Tensor, f"__{_dunder}__", _fn)
Tensor.__neg__ = neg
Tensor.__abs__ = abs
Tensor.__invert__ = lambda s: (logical_not if s._t.dtype == torch.bool
                               else bitwise_not)(s)
Tensor.__hash__ = lambda s: id(s)

# in-place arithmetic (paddle's add_ / subtract_ / scale_ family)
for _name, _fn in [("add_", add), ("subtract_", subtract),
                   ("multiply_", multiply), ("divide_", divide),
                   ("clip_", math.clip), ("scale_", math.scale),
                   ("exp_", math.exp), ("sqrt_", math.sqrt),
                   ("rsqrt_", math.rsqrt), ("floor_", math.floor),
                   ("ceil_", math.ceil), ("reciprocal_", math.reciprocal),
                   ("round_", math.round), ("abs_", math.abs),
                   ("tanh_", math.tanh),
                   ("squeeze_", manipulation.squeeze),
                   ("unsqueeze_", manipulation.unsqueeze),
                   ("reshape_", manipulation.reshape),
                   ("flatten_", manipulation.flatten)]:
    _helper.make_inplace(_fn, _name)


def _fill_(self, value):
    """Every element set to ``value``; the tensor keeps its place in the
    graph's leaves (a parameter stays one)."""
    new = torch.full_like(self._t, value)
    if self._t.requires_grad and self._t.grad_fn is None:
        new.requires_grad_(True)
    self._t = new
    return self


def _zero_(self):
    return _fill_(self, 0)


Tensor.fill_ = _fill_
Tensor.zero_ = _zero_
_helper.attach_tensor_methods()
indexing.install()

Tensor.mean = reduction.mean
Tensor.cpu = lambda s: Tensor(s._t.cpu(), stop_gradient=s.stop_gradient)
Tensor.cuda = lambda s, *a, **k: Tensor(s._t.cuda(*a, **k),
                                        stop_gradient=s.stop_gradient)
Tensor.pin_memory = lambda s: Tensor(s._t.pin_memory())
