"""``DataParallel`` with a bucketed gradient reducer: the counterpart of
``paddle_tpu/distributed/parallel.py`` (the reference's ``paddle.
DataParallel`` and its C++ ``Reducer``).

Each rank holds a replica and trains it on its share of the batch. At
construction the parameters are broadcast from rank 0, so the replicas
start equal (``FLAGS_dp_broadcast_params``). After every ``backward()``
(plain or the lazy window's fused one) the reducer averages the gradients
over the group: the parameters are taken in order, grouped by gradient
type and cut into buckets of ``comm_buffer_size`` MB
(``FLAGS_fuse_buffer_size_mb`` by default); each bucket is flattened into
one tensor, summed over the group by one collective and divided by the
group size, and copied back into each gradient in place. Which parameters
take part is agreed first, by one gloo collective over host flags: those
with a gradient new since the last sync on any rank (a rank without one
sends zeros), so a backward of another model does not reduce this one
again, and ranks whose graphs used different parameters
(``find_unused_parameters``) issue the same collectives. Inside
``no_sync()`` nothing is reduced and gradients accumulate locally; the
next synced backward averages the accumulated sums.

The reducer runs whenever the group has a process group, one rank
included (the reference's runs from two ranks up): on one card its buckets
are summed by NCCL over one rank and divided by 1, which leaves every
gradient bit for bit as it was. ``state_dict`` is the wrapped layer's,
under its own keys.

Each bucket's reduction is one attempt under the communication API's
retry policy that fires ``comm::all_reduce`` first (``communication.
_resilient``), so the collective fault drills reach the reducer; the
reference's reducer calls its process group directly, with no site.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist

from .._core.autograd import register_post_backward_callback
from .._core.flags import flag_value
from ..nn.layer import Layer
from ._collectives import average_
from .communication import _resilient
from .process_group import Group, default_group


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=None,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group: Group = None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group if group is not None else default_group()
        self._grad_sync_enabled = True
        if comm_buffer_size is None:
            comm_buffer_size = flag_value("FLAGS_fuse_buffer_size_mb")
        self._bucket_bytes = max(1, int(float(comm_buffer_size) * 2**20))
        # id(parameter) -> (id, version) of the gradient last synced
        self._synced: Dict[int, Tuple[int, int]] = {}
        self.last_buckets = 0       # buckets of the last sync
        self.last_collectives = 0   # collectives of the last sync
        self._unregister = None
        if self._group.pg is not None:
            if self._group.nranks > 1 \
                    and flag_value("FLAGS_dp_broadcast_params"):
                self._sync_params_from_rank0()
            ref = weakref.ref(self)

            def _cb():
                dp = ref()
                if dp is None:
                    unregister()
                    return
                dp._reduce_gradients()

            self._unregister = unregister = \
                register_post_backward_callback(_cb)

    # ------------------------------------------------------------ reducer
    def _sync_params_from_rank0(self) -> None:
        src = self._group.ranks[0]
        with torch.no_grad():
            for p in self._layers.parameters():
                dist.broadcast(p._t, src=src, group=self._group.pg)

    def _fresh(self, p, g) -> bool:
        """A gradient is new unless it is the tensor, at the version, that
        the last sync wrote."""
        return self._synced.get(id(p)) != (id(g), g._version)

    def _buckets(self, params) -> Iterator[List]:
        """Size-capped buckets of (parameter, gradient or None), one
        gradient type each, in parameter order."""
        by_dtype: Dict[torch.dtype, List] = {}
        for p in params:
            g = p._t.grad
            by_dtype.setdefault((p._t if g is None else g).dtype,
                                []).append((p, g))
        for group in by_dtype.values():
            bucket, size = [], 0
            for p, g in group:
                bucket.append((p, g))
                t = p._t if g is None else g
                size += t.numel() * t.element_size()
                if size >= self._bucket_bytes:
                    yield bucket
                    bucket, size = [], 0
            if bucket:
                yield bucket

    def _reduce_gradients(self) -> None:
        if not self._grad_sync_enabled or self._group.pg is None:
            return
        pg, n = self._group.pg, self._group.nranks
        trainable = [p for p in self._layers.parameters()
                     if not p.stop_gradient]
        grads = [p._t.grad for p in trainable]
        mask = torch.tensor([1 if g is not None and self._fresh(p, g) else 0
                             for p, g in zip(trainable, grads)],
                            dtype=torch.int32)
        if "gloo" not in str(dist.get_backend(pg)):
            # a group without gloo: the flags go through the card
            mask = mask.to(trainable[0]._t.device)
        dist.all_reduce(mask, op=dist.ReduceOp.MAX, group=pg)
        params = [p for p, u in zip(trainable, mask.tolist()) if u]
        self.last_buckets, self.last_collectives = 0, 1
        with torch.no_grad():
            for bucket in self._buckets(params):
                payloads = [p._t for p, _ in bucket]
                for (p, g), t in zip(bucket, payloads):
                    if g is None:   # taking part, unused here: zeros
                        t.grad = torch.zeros_like(t)
                grads = [t.grad for t in payloads]
                _resilient("all_reduce", average_, grads, pg, n, _of=grads)
                self.last_buckets += 1
                self.last_collectives += 1
                for (p, _), g in zip(bucket, grads):
                    self._synced[id(p)] = (id(g), g._version)

    # --------------------------------------------------------------- API
    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        """The identity: the reducer averages (the reference's scales only
        where its reducer sums)."""
        return loss

    def no_sync(self):
        """Gradients accumulate locally inside the block (gradient
        accumulation); the first synced backward after it averages them."""
        dp = self

        class _NoSync:
            def __enter__(self):
                self._prev = dp._grad_sync_enabled
                dp._grad_sync_enabled = False
                return self

            def __exit__(self, *exc):
                dp._grad_sync_enabled = self._prev
                return False
        return _NoSync()
