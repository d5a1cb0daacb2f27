"""The eager op surface: the counterpart of ``paddle_tpu/ops`` (the subset
the eager GPT and a plain MLP call). Importing it attaches the ops to
``Tensor`` as methods and operators, as the reference patches its Tensor.
The kernels of the port live in ``ops/cuda``."""
import torch

from .._core.tensor import Tensor
from .creation import arange, full, ones, to_tensor, zeros  # noqa: F401
from .linalg import matmul
from .manipulation import (astype, cast, concat, flatten,  # noqa: F401
                           reshape, split, squeeze, transpose, unbind,
                           unsqueeze)
from .math import (abs, add, divide, equal, exp, floor_divide,  # noqa: F401
                   greater_equal, greater_than, less_equal, less_than, log,
                   mod, multiply, neg, not_equal, pow, remainder, subtract,
                   tanh)
from .reduction import max, mean, sum  # noqa: F401

__all__ = [
    "arange", "full", "ones", "to_tensor", "zeros", "matmul", "astype",
    "cast", "concat", "flatten", "reshape", "split", "squeeze", "transpose",
    "unbind", "unsqueeze", "abs",
    "add", "divide", "equal", "exp", "floor_divide", "greater_equal",
    "greater_than", "less_equal", "less_than", "log", "mod", "multiply",
    "neg", "not_equal", "pow", "remainder", "subtract", "tanh", "max",
    "mean", "sum",
]


def _reflected(fn):
    """``other op self``. As the reference's reflected operators turn the
    Python scalar into a tensor first, a Python float there is a float32
    0-d tensor, which takes part in type promotion (``1.5 / x`` of a bf16
    ``x`` is float32) where ``x / 1.5`` keeps x's type."""
    def op(self, other):
        if isinstance(other, float):
            other = torch.tensor(other, dtype=torch.float32,
                                 device=self._t.device)
        return fn(other, self)
    return op


for _name in ("reshape", "astype", "cast", "transpose", "split", "unbind",
              "flatten", "squeeze", "unsqueeze",
              "matmul", "sum", "mean", "max", "exp", "log", "tanh", "abs",
              "add", "subtract", "multiply", "divide", "pow"):
    setattr(Tensor, _name, globals()[_name])

for _dunder, _fn in (("add", add), ("sub", subtract), ("mul", multiply),
                     ("truediv", divide), ("floordiv", floor_divide),
                     ("mod", mod), ("pow", pow), ("matmul", matmul)):
    setattr(Tensor, f"__{_dunder}__", _fn)
    setattr(Tensor, f"__r{_dunder}__", _reflected(_fn))
# commutative: the scalar stays a Python scalar, as in the reference
Tensor.__radd__ = add
Tensor.__rmul__ = multiply
for _dunder, _fn in (("eq", equal), ("ne", not_equal), ("lt", less_than),
                     ("le", less_equal), ("gt", greater_than),
                     ("ge", greater_equal)):
    setattr(Tensor, f"__{_dunder}__", _fn)
Tensor.__neg__ = neg
Tensor.__abs__ = abs
Tensor.__getitem__ = lambda self, idx: Tensor(self._t[
    idx._t if isinstance(idx, Tensor) else idx])
