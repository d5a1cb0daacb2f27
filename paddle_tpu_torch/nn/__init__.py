"""Counterpart of ``paddle_tpu/nn``: ``Layer``, the core, vision,
activation and loss layers, gradient clipping, their initializers and the
functionals."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import Layer, Parameter, create_parameter  # noqa: F401
from .layers_activation import *  # noqa: F401,F403
from .layers_common import *  # noqa: F401,F403
from .param_attr import ParamAttr  # noqa: F401
