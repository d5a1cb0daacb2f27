"""Typed framework errors and the enforce helpers: the counterpart of
``paddle_tpu/base/core.py`` (Paddle's ``enforce.h`` / ``errors.h``).

The names and the hierarchy are the reference's, so that code catching
``paddle.base.core.<Error>`` runs unchanged; each typed error is also the
Python error of its kind (``InvalidArgumentError`` is a ``ValueError``,
``NotFoundError`` a ``KeyError``, ...). The message carries the hint
(``context``) and the innermost frame outside this package, the
``call_stack_level=1`` summary. The reference also hands the error to its
flight recorder when that is armed; the port has no flight recorder yet.
"""
from __future__ import annotations

import os
import traceback
from typing import Any, Sequence

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "PreconditionNotMetError",
           "ResourceExhaustedError", "UnavailableError",
           "UnimplementedError", "enforce", "enforce_eq", "enforce_gt",
           "enforce_shape_match"]

# frames under this directory are the framework's, not the user's
_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class EnforceNotMet(RuntimeError):
    """The base framework error: the message, the hint (``context``) and
    the user-code frame that raised it."""

    def __init__(self, message: str, context: str = ""):
        frame = _user_frame()
        parts = [message]
        if context:
            parts.append(f"  [Hint: {context}]")
        if frame:
            parts.append(f"  [operator < {frame} > error]")
        super().__init__("\n".join(parts))
        self.message = message
        self.context = context


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


def _user_frame() -> str:
    """The innermost stack frame outside this package: what the user
    called (found by file, since a direct raise and ``enforce`` sit at
    different depths)."""
    for f in reversed(traceback.extract_stack()[:-1]):
        path = os.path.abspath(f.filename or "")
        if not path.startswith(_PACKAGE_DIR + os.sep):
            return f"{f.filename}:{f.lineno} {f.name}"
    return ""


def enforce(cond: Any, message: str, context: str = "",
            error_cls=None):
    """``PADDLE_ENFORCE``: raises a typed framework error
    (``PreconditionNotMetError`` unless ``error_cls``) when ``cond`` is
    false."""
    if not cond:
        raise (error_cls or PreconditionNotMetError)(message, context)


def enforce_eq(a, b, message: str = "", context: str = ""):
    if a != b:
        raise InvalidArgumentError(
            message or f"expected equality, got {a!r} != {b!r}", context)


def enforce_gt(a, b, message: str = "", context: str = ""):
    if not a > b:
        raise InvalidArgumentError(
            message or f"expected {a!r} > {b!r}", context)


def enforce_shape_match(shape_a: Sequence, shape_b: Sequence,
                        message: str = "", context: str = ""):
    """An exact shape check (no broadcasting) with the shapes in the
    message."""
    if list(shape_a) != list(shape_b):
        raise InvalidArgumentError(
            message or (f"shape mismatch: {list(shape_a)} vs "
                        f"{list(shape_b)}"), context)
