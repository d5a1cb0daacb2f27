"""Losses: the counterpart of ``paddle_tpu/nn/functional/loss.py``, each
a registered body under the reference's op name (``softmax_ce``,
``nll_loss_k``, ``mse_loss_k``, ``bce_k``, ``bce_logits_k`` and
``kl_div_k`` are on AMP's black list, so under O1 they run in float32;
the rest are on neither list)."""
from __future__ import annotations

import torch

from ..._core.dispatch import apply
from ..._core.op_registry import register_op
from ...ops.creation import zeros_like
from ...ops.manipulation import unsqueeze
from ...ops.math import log, maximum
from ...ops.search import where


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


@register_op("softmax_ce")
def _softmax_ce(logits, label, weight=None, *, soft_label, ignore_index,
                axis, reduction, label_smoothing, use_weight):
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        return _reduce(-(label * logp).sum(axis), reduction)
    n_class = logits.shape[axis]
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    keep = label != ignore_index
    inside = (label >= 0) & (label < n_class)
    idx = torch.where(inside, label, torch.zeros_like(label)).long()
    picked = torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
    # the reference's one-hot of a label outside [0, n_class) is all zeros
    picked = torch.where(inside, picked, _zero(picked))
    if label_smoothing > 0.0:
        loss = -(1 - label_smoothing) * picked \
            - label_smoothing / n_class * logp.sum(axis)
    else:
        loss = -picked
    w = weight[torch.clamp(label, min=0).long()].to(loss.dtype) \
        if use_weight else torch.ones_like(loss)
    loss = torch.where(keep, loss * w, _zero(loss))
    if reduction == "mean":
        denom = torch.where(keep, w, torch.zeros_like(w)).sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis``: against integer labels (those
    equal to ``ignore_index`` add nothing and leave the mean's count),
    with ``label_smoothing`` mixing ``label_smoothing / C`` into the
    one-hot; against a distribution with ``soft_label``; on
    probabilities (their log, then ``nll_loss``) with
    ``use_softmax=False``."""
    if not use_softmax:
        return nll_loss(log(input), label, weight=weight,
                        ignore_index=ignore_index, reduction=reduction)
    if soft_label and weight is not None:
        raise NotImplementedError(
            "cross_entropy: the reference ignores weight with soft labels")
    extra = () if weight is None else (weight,)
    return apply("softmax_ce", _softmax_ce, input, label, *extra,
                 soft_label=bool(soft_label),
                 ignore_index=int(ignore_index), axis=int(axis),
                 reduction=reduction, label_smoothing=float(label_smoothing),
                 use_weight=weight is not None)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced loss with ``axis`` kept (size 1), and the softmax
    when ``return_softmax``."""
    from .activation import softmax
    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    return (loss, softmax(logits, axis=axis)) if return_softmax else loss


@register_op("nll_loss_k")
def _nll(logp, label, weight=None, *, use_weight, ignore_index, reduction):
    """logp ``[N, C, ...]``, label ``[N, ...]``."""
    keep = label != ignore_index
    idx = torch.where(keep, label, torch.zeros_like(label)).long()
    loss = -torch.gather(logp, 1, idx.unsqueeze(1)).squeeze(1)
    w = weight[idx].to(loss.dtype) if use_weight else torch.ones_like(loss)
    loss = torch.where(keep, loss * w, _zero(loss))
    if reduction == "mean":
        denom = torch.where(keep, w, torch.zeros_like(w)).sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log likelihood of log-probabilities ``[N, C, ...]``."""
    extra = () if weight is None else (weight,)
    return apply("nll_loss_k", _nll, input, label, *extra,
                 use_weight=weight is not None,
                 ignore_index=int(ignore_index), reduction=reduction)


@register_op("mse_loss_k")
def _mse(x, y, reduction):
    return _reduce(torch.square(x - y), reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return apply("mse_loss_k", _mse, input, label, reduction=reduction)


@register_op("l1_loss_k")
def _l1(x, y, reduction):
    return _reduce(torch.abs(x - y), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return apply("l1_loss_k", _l1, input, label, reduction=reduction)


@register_op("smooth_l1_k")
def _smooth_l1(x, y, reduction, delta):
    d = x - y
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` below ``delta``, ``|d| - delta / 2`` above."""
    return apply("smooth_l1_k", _smooth_l1, input, label,
                 reduction=reduction, delta=float(delta))


@register_op("bce_k")
def _bce(x, y, weight=None, *, use_weight, reduction):
    loss = -(y * torch.log(torch.clamp(x, min=1e-12))
             + (1 - y) * torch.log(torch.clamp(1 - x, min=1e-12)))
    if use_weight:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """Cross entropy of probabilities, each log clamped at 1e-12."""
    extra = () if weight is None else (weight,)
    return apply("bce_k", _bce, input, label, *extra,
                 use_weight=weight is not None, reduction=reduction)


@register_op("bce_logits_k")
def _bce_logits(x, y, weight=None, pos_weight=None, *, use_weight, use_pos,
                reduction):
    """The stable form: ``max(x, 0) - x y + log(1 + exp(-|x|))``, and with
    ``pos_weight`` the reference's ``(1 - y) x + (1 + (pw - 1) y)
    (log(1 + exp(-|x|)) + max(-x, 0))``."""
    soft = torch.logaddexp(torch.zeros_like(x), -torch.abs(x))
    if use_pos:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_w * (soft + torch.clamp(-x, min=0.0))
    else:
        loss = torch.clamp(x, min=0.0) - x * y + soft
    if use_weight:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return apply("bce_logits_k", _bce_logits, logit, label, weight,
                 pos_weight, use_weight=weight is not None,
                 use_pos=pos_weight is not None, reduction=reduction)


@register_op("kl_div_k")
def _kl_div(x, y, reduction, log_target):
    if log_target:
        loss = torch.exp(y) * (y - x)
    else:
        loss = torch.where(y > 0, y * (torch.log(y) - x), _zero(x))
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``label (log label - input)`` (``input`` log-probabilities), summed
    over the batch for ``batchmean`` and divided by its size."""
    return apply("kl_div_k", _kl_div, input, label, reduction=reduction,
                 log_target=bool(log_target))


@register_op("sigmoid_focal_k")
def _sigmoid_focal(x, y, norm, *, alpha, gamma, use_norm):
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * y + torch.logaddexp(
        torch.zeros_like(x), -torch.abs(x))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    return loss / norm if use_norm else loss


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    out = apply("sigmoid_focal_k", _sigmoid_focal, logit, label, normalizer,
                alpha=float(alpha), gamma=float(gamma),
                use_norm=normalizer is not None)
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    """``max(0, -label (input - other) + margin)``."""
    out = maximum(zeros_like(input), -label * (input - other) + margin)
    return _reduce(out, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` where label is 1, ``max(0, cos - margin)`` elsewhere."""
    from .common import cosine_similarity
    sim = cosine_similarity(input1, input2, axis=-1)
    out = where(label == 1, 1 - sim, maximum(zeros_like(sim), sim - margin))
    return _reduce(out, reduction)


@register_op("margin_cross_entropy", multi_output=True)
def _margin_ce(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
               scale=64.0):
    """ArcFace-family margin softmax: ``cos(m1 theta + m2) - m3`` on the
    target class, scaled, softmax cross entropy; (loss ``[N, 1]``,
    softmax)."""
    theta = torch.acos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.nn.functional.one_hot(
        label.long(), logits.shape[1]).bool()
    adj = torch.cos(margin1 * theta + margin2) - margin3
    out = torch.where(target, adj, logits) * scale
    logp = torch.log_softmax(out, -1)
    loss = -torch.gather(logp, 1, label.long().unsqueeze(1))
    return loss, torch.softmax(out, -1)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean",
                         name=None):
    if group is not None and group is not False:
        raise NotImplementedError(
            "margin_cross_entropy: model-parallel group support requires "
            "the vocab-parallel CE path; shard logits there instead")
    loss, softmax = apply("margin_cross_entropy", _margin_ce, logits, label,
                          margin1=float(margin1), margin2=float(margin2),
                          margin3=float(margin3), scale=float(scale))
    loss = _reduce(loss, reduction)
    return (loss, softmax) if return_softmax else loss


@register_op("gather_tree")
def _gather_tree(ids, parents):
    """Beam-search backtrack: ``ids`` / ``parents`` ``[T, B, W]`` to the
    full sequences, walking the parent pointers from the last step."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(torch.gather(ids[t], 1, beam.long()))
        beam = torch.gather(parents[t], 1, beam.long())
    return torch.stack(out[::-1])


def gather_tree(ids, parents):
    return apply("gather_tree", _gather_tree, ids, parents)
