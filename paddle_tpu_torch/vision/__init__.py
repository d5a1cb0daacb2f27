"""Counterpart of ``paddle_tpu/vision``: the datasets and the models
(``transforms`` and ``ops`` are not ported yet)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
