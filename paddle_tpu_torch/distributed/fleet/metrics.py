"""Fleet's distributed metrics: the counterpart of
``paddle_tpu/distributed/fleet/metrics.py`` (upstream
``fleet/metrics/metric.py``). Each rank's piece is reduced over the
default group (or ``group``), so every worker reports the global value:
``sum``, ``max``, ``min``, ``mean`` of a scalar or an array, ``acc`` from
(correct, total) counts and ``auc`` from score histograms. Values are
reduced in float64: a ``Tensor`` on its device, anything else as a host
tensor (gloo); the results are numpy, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..._core.tensor import Tensor

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _group(group=None):
    if group is not None:
        return group
    from ..process_group import default_group
    return default_group()


def _reduce(value, op, group=None):
    g = _group(group)
    if isinstance(value, Tensor):
        t = value._t.detach().to(torch.float64).clone()
    else:
        t = torch.from_numpy(np.array(value, np.float64))
    if g.pg is not None and g.nranks > 1:
        dist.all_reduce(t, op=_OPS[op], group=g.pg)
        if op == "avg":
            t = t / g.nranks
    return t.cpu().numpy()


def sum(value, group=None):  # noqa: A001 (the reference's names)
    """The sum of every rank's ``value``."""
    return _reduce(value, "sum", group)


def max(value, group=None):  # noqa: A001
    return _reduce(value, "max", group)


def min(value, group=None):  # noqa: A001
    return _reduce(value, "min", group)


def mean(value, group=None):
    return _reduce(value, "avg", group)


def acc(correct, total, group=None):
    """The global accuracy from every rank's (correct, total) counts."""
    c = _reduce(np.asarray([correct], np.float64), "sum", group)
    t = _reduce(np.asarray([total], np.float64), "sum", group)
    return float(c[0] / np.maximum(t[0], 1.0))


def auc(stat_pos, stat_neg, group=None):
    """The AUC of the summed positive and negative score histograms
    (buckets of ascending score, as ``paddle.metric.Auc`` keeps them), by
    the trapezoid rule from the highest bucket down; 0.5 when a class is
    empty."""
    pos = _reduce(np.asarray(stat_pos, np.float64), "sum", group)
    neg = _reduce(np.asarray(stat_neg, np.float64), "sum", group)
    tot_pos = tot_neg = area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))


__all__ = ["sum", "max", "min", "mean", "acc", "auc"]
