"""Counterpart of ``paddle_tpu/distributed``: so far the fleet layers at
model-parallel degree 1 and ``recompute``."""
from . import fleet  # noqa: F401
