"""Counterpart of ``paddle_tpu/amp``: auto-cast by op name and the loss
scaler."""
from .auto_cast import (auto_cast, black_list, decorate,  # noqa: F401
                        white_list)
from .grad_scaler import GradScaler  # noqa: F401
