"""Counterpart of ``paddle_tpu/vision``: the datasets, the models, the
transforms and the detection ops."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
