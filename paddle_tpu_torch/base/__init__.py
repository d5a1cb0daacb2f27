"""``paddle.base``: the framework's typed errors and enforce helpers.

Counterpart of ``paddle_tpu/base``: ``EnforceNotMet`` and its typed
subclasses, which a script catches around an op, and the ``enforce``
helpers that raise them. ``base.core`` holds them, as Paddle's
``paddle.base.core`` does.
"""
from . import core  # noqa: F401
from .core import (  # noqa: F401
    EnforceNotMet,
    InvalidArgumentError,
    NotFoundError,
    OutOfRangeError,
    PreconditionNotMetError,
    ResourceExhaustedError,
    UnavailableError,
    UnimplementedError,
    enforce,
    enforce_eq,
    enforce_gt,
    enforce_shape_match,
)

__all__ = ["core", "EnforceNotMet", "InvalidArgumentError",
           "NotFoundError", "OutOfRangeError", "PreconditionNotMetError",
           "ResourceExhaustedError", "UnavailableError",
           "UnimplementedError", "enforce", "enforce_eq", "enforce_gt",
           "enforce_shape_match"]
