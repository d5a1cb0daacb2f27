"""distributed.utils: the MoE all-to-all primitives, the counterpart of
``paddle_tpu/distributed/utils.py``.

``global_scatter`` / ``global_gather`` are the reference's MoE dispatch
collectives (upstream ``distributed/utils/moe_utils.py``): rank r sends
``local_count[e]`` rows to the rank owning expert e and receives its own.
The reference runs them where every expert is held by the one process
(the identity); so does the port where the group is None or has one rank.
Above one rank they raise: the row exchange by counts comes with the MoE
layer that calls it (``ROADMAP.md`` §1 item 10).
``all_to_all_on_axis`` is the dispatch over a mesh axis: the process
group of that axis of the current mesh (as ``context_parallel`` resolves
its axes) and ``_collectives.resplit``.
"""
from __future__ import annotations

from .._core.tensor import Tensor


def _nranks(group) -> int:
    if group is None:
        return 1
    n = getattr(group, "nranks", None)
    if n is not None:
        return int(n)
    import torch.distributed as dist
    return dist.get_world_size(group)


def _one_rank_only(name, group) -> None:
    n = _nranks(group)
    if n > 1:
        raise NotImplementedError(
            f"{name} over {n} ranks: the MoE row exchange comes with the "
            f"MoE layer (ROADMAP.md §1 item 10); one rank is the identity")


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """The identity on one rank (see the module docstring)."""
    _one_rank_only("global_scatter", group)
    return x


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The identity on one rank (see the module docstring)."""
    _one_rank_only("global_gather", group)
    return x


def all_to_all_on_axis(x, axis_name: str, split_axis: int, concat_axis: int):
    """The pieces of ``x`` split along ``concat_axis`` over ``axis_name``
    made split along ``split_axis``: one all-to-all over the axis's group
    (the identity where the axis has one rank)."""
    from . import _collectives as C
    from .context_parallel import _axis_group
    group = _axis_group(axis_name)
    raw = x._t if isinstance(x, Tensor) else x
    out = raw if group is None else C.resplit(raw, split_axis, concat_axis,
                                              group)
    return Tensor(out) if isinstance(x, Tensor) else out
