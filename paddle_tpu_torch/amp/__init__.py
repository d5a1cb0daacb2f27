"""Counterpart of ``paddle_tpu/amp``: auto-cast by op name and the loss
scaler, with the reference's aliases (``amp_guard`` and ``autocast`` for
``auto_cast``, ``AmpScaler`` for ``GradScaler``)."""
from .auto_cast import (amp_guard, auto_cast, black_list,  # noqa: F401
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

autocast = auto_cast
