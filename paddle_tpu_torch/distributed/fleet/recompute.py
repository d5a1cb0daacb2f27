"""``recompute``: the counterpart of
``paddle_tpu/distributed/fleet/recompute.py``, as
``torch.utils.checkpoint`` (not reentrant): the function's activations are
dropped after the forward and computed again in the backward."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def recompute(function, *args, **kwargs):
    kwargs.pop("preserve_rng_state", None)
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
