"""``cross_entropy``: the counterpart of
``paddle_tpu/nn/functional/loss.py`` (op ``softmax_ce``, on AMP's black
list)."""
from __future__ import annotations

import torch

from ..._core.dispatch import apply


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _softmax_ce(logits, label, weight=None, *, ignore_index, axis,
                reduction):
    logp = torch.log_softmax(logits, axis)
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    keep = label != ignore_index
    idx = torch.where(keep, label, torch.zeros_like(label)).long()
    loss = -torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
    w = torch.ones_like(loss) if weight is None else weight[idx].to(
        loss.dtype)
    loss = torch.where(keep, loss * w, torch.zeros((), dtype=loss.dtype,
                                                   device=loss.device))
    if reduction == "mean":
        denom = torch.where(keep, w, torch.zeros_like(w)).sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis`` against integer labels; labels
    equal to ``ignore_index`` add nothing (and leave the mean's count)."""
    if soft_label or not use_softmax or label_smoothing:
        raise NotImplementedError("cross_entropy: soft labels, "
                                  "use_softmax=False and label smoothing "
                                  "are not ported yet")
    extra = () if weight is None else (weight,)
    return apply("softmax_ce", _softmax_ce, input, label, *extra,
                 ignore_index=int(ignore_index), axis=int(axis),
                 reduction=reduction)
