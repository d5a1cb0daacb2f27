"""``recompute`` and ``recompute_sequential``: the counterpart of
``paddle_tpu/distributed/fleet/recompute.py``, as
``torch.utils.checkpoint`` (not reentrant): the function's activations are
dropped after the forward and computed again in the backward."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def recompute(function, *args, **kwargs):
    kwargs.pop("preserve_rng_state", None)
    return checkpoint(function, *args, use_reentrant=False, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """recompute.py:630 — apply recompute over chunks of a Sequential:
    chunks of ``n // ctx["segments"]`` layers (at least one), any
    remainder in one more, shorter chunk (5 layers in 2 segments run as
    chunks of 2, 2 and 1), each recomputed as one function of the previous
    chunk's output."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    per = max(n // segments, 1)

    def run_chunk(chunk):
        def fn(x):
            for l in chunk:
                x = l(x)
            return x
        return fn

    x = args[0]
    for i in range(0, n, per):
        chunk = layers[i:i + per]
        x = recompute(run_chunk(chunk), x)
    return x
