"""Losses: the counterpart of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` as op ``softmax_ce``, ``nll_loss``, ``mse_loss``,
``l1_loss`` and ``binary_cross_entropy_with_logits``, under the
reference's op names: all but ``l1_loss_k`` are on AMP's black list)."""
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


def _nll(logp, label, weight=None, *, ignore_index, reduction):
    """logp ``[N, C, ...]``, label ``[N, ...]``."""
    keep = label != ignore_index
    idx = torch.where(keep, label, torch.zeros_like(label)).long()
    loss = -torch.gather(logp, 1, idx.unsqueeze(1)).squeeze(1)
    w = torch.ones_like(loss) if weight is None else weight[idx].to(
        loss.dtype)
    loss = torch.where(keep, loss * w, torch.zeros((), dtype=loss.dtype,
                                                   device=loss.device))
    if reduction == "mean":
        denom = torch.where(keep, w, torch.zeros_like(w)).sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log likelihood of log-probabilities ``[N, C, ...]``."""
    extra = () if weight is None else (weight,)
    return apply("nll_loss_k", _nll, input, label, *extra,
                 ignore_index=int(ignore_index), reduction=reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return apply("mse_loss_k", lambda x, y, reduction: _reduce(
        torch.square(x - y), reduction), input, label, reduction=reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return apply("l1_loss_k", lambda x, y, reduction: _reduce(
        torch.abs(x - y), reduction), input, label, reduction=reduction)


def _bce_logits(x, y, weight=None, pos_weight=None, *, reduction):
    """The stable form: ``max(x, 0) - x y + log(1 + exp(-|x|))``, and with
    ``pos_weight`` the reference's ``(1 - y) x + (1 + (pw - 1) y)
    (log(1 + exp(-|x|)) + max(-x, 0))``."""
    soft = torch.logaddexp(torch.zeros_like(x), -torch.abs(x))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_w * (soft + torch.clamp(-x, min=0.0))
    else:
        loss = torch.clamp(x, min=0.0) - x * y + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return apply("bce_logits_k", _bce_logits, logit, label, weight,
                 pos_weight, reduction=reduction)
