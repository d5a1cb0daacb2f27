"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (the JAX reference). Plain tensor
code is PyTorch; every Pallas kernel of the reference becomes a kernel
written by hand for Hopper (``sm_90a``), built from ``csrc/`` at first use.
This package never imports JAX or ``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the eager (dygraph) API:
``Tensor``, ``to_tensor``, the ops (registered by name in
``_core/op_registry.py`` against the schema ``ops/yaml/ops.yaml``),
``linalg``, ``nn``, ``autograd``, ``optimizer``, ``amp``, ``io``,
``vision``, ``incubate`` and ``base``; and the compile path: ``jit``
(``to_static``, ``save``, ``load``), ``static`` with the passes of ``ir``,
``inference``, ``onnx`` and ``framework`` (``save``, ``load``).
Tensors are created on the card unless ``set_device('cpu')`` was called;
with no card and no ``set_device('cpu')`` creation raises (see
:func:`resolve_device`). Nothing imported here needs a card or ``nvcc``.
"""
__version__ = "0.1.0"

from ._core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                             no_grad, set_grad_enabled)
from ._core.device import (CPUPlace, CUDAPlace, device_count,  # noqa: F401
                           get_device, in_dynamic_mode,
                           is_compiled_with_cuda, is_compiled_with_tpu,
                           is_compiled_with_xpu, resolve_device, set_device)
from ._core.dtype import (DType, bfloat16, bool_, complex64,  # noqa: F401
                          complex128, float16, float32, float64, int8, int16,
                          int32, int64, uint8)
from ._core.random import get_seed, seed  # noqa: F401
from ._core.tensor import Tensor, to_tensor  # noqa: F401
from .ops import *  # noqa: F401,F403
from . import amp, autograd, io, nn, optimizer, vision  # noqa: F401,E402
from . import base, incubate  # noqa: F401,E402
from . import framework, inference, ir, jit, onnx, static  # noqa: F401,E402
from . import profiler, observability  # noqa: F401,E402
from ._core.flags import get_flags, set_flags  # noqa: F401,E402
from .framework import load, save  # noqa: F401,E402
from .static import disable_static, enable_static  # noqa: F401,E402
# "from . import linalg" would find the ops.linalg module that the star
# import above bound to this name
import importlib as _importlib  # noqa: E402
linalg = _importlib.import_module(".linalg", __name__)
from ._core.op_registry import call as apply, register_op  # noqa: F401,E402
from .nn.layer import create_parameter  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402
from .ops import _helper as _ops_helper  # noqa: E402

_ops_helper.attach_tensor_methods()  # with the activations nn registered
is_grad_enabled_ = is_grad_enabled

bool = bool_  # paddle.bool
