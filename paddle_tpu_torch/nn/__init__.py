"""Counterpart of ``paddle_tpu/nn``: ``Layer``, the core layers, their
initializers and the functionals."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import Layer, Parameter, create_parameter  # noqa: F401
from .layers_common import (Dropout, Embedding, LayerList,  # noqa: F401
                            LayerNorm, Linear, Sequential)
from .param_attr import ParamAttr  # noqa: F401
