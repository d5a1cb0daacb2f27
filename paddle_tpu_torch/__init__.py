"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (the JAX reference). Plain tensor
code is PyTorch; every Pallas kernel of the reference becomes a kernel
written by hand for Hopper (``sm_90a``), built from ``csrc/`` at first use.
This package never imports JAX or ``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the eager (dygraph) API:
``Tensor``, ``to_tensor``, the ops, ``nn``, ``optimizer``, ``amp``, ``io``
and ``vision``.
Tensors are created on the card unless ``set_device('cpu')`` was called;
with no card and no ``set_device('cpu')`` creation raises (see
:func:`resolve_device`). Nothing imported here needs a card or ``nvcc``.
"""
from ._core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                             no_grad, set_grad_enabled)
from ._core.device import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                           resolve_device, set_device)
from ._core.dtype import (DType, bfloat16, bool_, complex64,  # noqa: F401
                          complex128, float16, float32, float64, int8, int16,
                          int32, int64, uint8)
from ._core.random import get_seed, seed  # noqa: F401
from ._core.tensor import Tensor, to_tensor  # noqa: F401
from .ops import *  # noqa: F401,F403
from . import amp, io, nn, optimizer, vision  # noqa: F401,E402
from .nn.layer import create_parameter  # noqa: F401,E402

bool = bool_  # paddle.bool
