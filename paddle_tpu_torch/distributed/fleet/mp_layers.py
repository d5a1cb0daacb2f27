"""Tensor-parallel (mp) layers: the counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py`` (upstream
``fleet/layers/mpu/mp_layers.py``): ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear``, ``ParallelCrossEntropy``
and the ``TensorParallel`` wrapper.

The port's ranks are processes, so each layer runs the reference's eager
multi-process regime, chosen once at construction:

- at mp degree 1 (no hybrid group, or an mp axis of one rank) each layer
  holds the whole parameters under the reference's names and initializers
  and computes the plain embedding, linear or cross entropy;
- above degree 1 it holds this rank's shard (``[V/mp, H]`` rows of the
  embedding, ``[in, out/mp]`` columns of a column linear, ``[in/mp, out]``
  rows of a row linear) and its forward runs the collectives of
  ``mp_ops.py`` over the mp group.

Where the reference, inside one process, would annotate whole weights for
GSPMD over a global mesh's ``mp`` axis, the port takes the multi-process
regime: there is no single-controller mesh. A layer built above degree 1
without a process group raises, as the reference does: it would run
un-sharded and un-synced.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, create_parameter
from .mp_ops import (mp_allreduce, mp_concat, mp_identity, mp_lookup_table,
                     mp_softmax_cross_entropy, mp_split)
from .topology import get_hybrid_communicate_group


def _mp_info(mp_group=None):
    """(mp degree, this rank's index on mp): of ``mp_group`` when given,
    else of the hybrid group."""
    if mp_group is not None:
        return mp_group.nranks, getattr(mp_group, "rank", 0)
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return 1, 0
    return hcg.get_model_parallel_world_size(), \
        hcg.get_model_parallel_rank()


def _regime(mp_group=None):
    """("single", None) at degree 1, ("eager", group) above it; raises
    above degree 1 without a process group."""
    world, _ = _mp_info(mp_group)
    if world <= 1:
        return "single", None
    group = mp_group
    if group is None:
        hcg = get_hybrid_communicate_group()
        group = hcg.get_model_parallel_group() if hcg else None
    if group is None or getattr(group, "pg", None) is None:
        raise RuntimeError(
            "tensor-parallel layer built with mp degree "
            f"{world} but no initialized process group: the layer would "
            "silently run un-sharded. Call "
            "distributed.init_parallel_env() before fleet.init.")
    return "eager", group


def _shard_size(total, world, what):
    if total % world:
        raise ValueError(
            f"{what} ({total}) must divide by mp degree ({world})")
    return total // world


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim split over mp; weight ``[V/mp, H]``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._mode, self._group = _regime(mp_group)
        world, rank = _mp_info(mp_group)
        per = _shard_size(num_embeddings, world, "num_embeddings")
        self.vocab_start_index = rank * per
        self.weight = create_parameter(
            [per, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True

    def forward(self, x):
        if self._mode == "eager":
            return mp_lookup_table(self.weight, x, self.vocab_start_index,
                                   self._group)
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """Linear with the output dim split over mp; weight ``[in, out/mp]``.
    ``gather_output`` joins the ranks' outputs (else each keeps its
    block)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.gather_output = gather_output
        self._mp_group = mp_group
        self._mode, self._group = _regime(mp_group)
        world, _ = _mp_info(mp_group)
        out_local = _shard_size(out_features, world, "out_features")
        self.weight = create_parameter(
            [in_features, out_local], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = None
        if has_bias is None or has_bias:
            self.bias = create_parameter([out_local], is_bias=True)
            self.bias.is_distributed = True

    def forward(self, x):
        if self._mode != "eager":
            return F.linear(x, self.weight, self.bias)
        world, rank = _mp_info(self._mp_group)
        # identity forward, the ranks' input gradients summed backward
        x = mp_identity(x, self._group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_concat(out, self._group, rank, world)
        return out


class RowParallelLinear(Layer):
    """Linear with the input dim split over mp; weight ``[in/mp, out]``;
    the partial products summed over mp, then the (replicated) bias.
    Without ``input_is_parallel`` the input is cut into the ranks'
    blocks first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self._mp_group = mp_group
        self._mode, self._group = _regime(mp_group)
        world, _ = _mp_info(mp_group)
        in_local = _shard_size(in_features, world, "in_features")
        self.weight = create_parameter(
            [in_local, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        if self._mode != "eager":
            return F.linear(x, self.weight, self.bias)
        world, rank = _mp_info(self._mp_group)
        if not self.input_is_parallel:
            x = mp_split(x, self._group, rank, world)
        out = mp_allreduce(F.linear(x, self.weight, None), self._group)
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy over vocab-split logits (``reduction``
    none): above degree 1 ``mp_softmax_cross_entropy``, else
    ``F.cross_entropy``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._mp_group = mp_group
        self._mode, self._group = _regime(mp_group)

    def forward(self, input, label):
        if self._mode == "eager":
            _, rank = _mp_info(self._mp_group)
            return mp_softmax_cross_entropy(
                input, label, rank * input.shape[-1], self._group,
                ignore_index=self.ignore_index)
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)


class TensorParallel(Layer):
    """The eager tensor-parallel wrapper (upstream
    ``meta_parallel/tensor_parallel.py``): the parameters that are not
    split over mp are broadcast from the mp group's first rank, so the
    replicas start equal. Their gradients are averaged over mp by
    ``HybridParallelOptimizer``, as in the reference."""

    def __init__(self, layers, hcg, **kwargs):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        group = hcg.get_model_parallel_group()
        if group is not None and group.pg is not None and group.nranks > 1:
            from .. import communication as comm
            src = group.ranks[0]
            for p in layers.parameters():
                if not p.is_distributed:
                    comm.broadcast(p, src=src, group=group)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
