"""Megatron-style sequence-parallel utilities: the counterpart of
``paddle_tpu/distributed/fleet/sequence_parallel_utils.py`` (upstream
``fleet/utils/sequence_parallel_utils.py``).

In the reference's eager regime, the one the port runs, every op here is
the identity on the whole sequence and the hooks do nothing (the
reference's scatter and gather are sharding constraints, which are the
identity outside a compiled mesh program): ``ScatterOp``, ``GatherOp``,
``AllGatherOp``, ``ReduceScatterOp`` and their functions return their
input, ``register_sequence_parallel_allreduce_hooks`` returns the model,
and the two sequence-parallel linears compute what
``ColumnParallelLinear`` and ``RowParallelLinear`` compute. The port
computes the same results. The real sequence split, an all-gather before a
column product and a reduce-scatter after a row product, is the mesh
trainers' (``mp_ops.tp_enter`` / ``tp_leave``).
"""
from __future__ import annotations

from .mp_layers import ColumnParallelLinear, RowParallelLinear

_SEQ_DIM = 0  # the reference keeps [s, b, h] in the SP region


class ScatterOp:
    """Split along the sequence dim over mp (here: the identity)."""

    @staticmethod
    def apply(input, seq_dim: int = _SEQ_DIM):
        return input


class GatherOp:
    """All-gather along the sequence dim (here: the identity)."""

    @staticmethod
    def apply(input, seq_dim: int = _SEQ_DIM):
        return input


class AllGatherOp:
    """All-gather whose backward is a reduce-scatter (here: the
    identity)."""

    @staticmethod
    def apply(input):
        return input


class ReduceScatterOp:
    """Reduce-scatter whose backward is an all-gather (here: the
    identity)."""

    @staticmethod
    def apply(input):
        return input


def scatter(input, seq_dim: int = _SEQ_DIM):
    return ScatterOp.apply(input, seq_dim)


def all_gather(input):
    return AllGatherOp.apply(input)


def reduce_scatter(input):
    return ReduceScatterOp.apply(input)


def mark_as_sequence_parallel_parameter(parameter):
    """Tags a parameter as living in the SP region (its gradient would
    need a sum over mp)."""
    parameter.sequence_parallel = True
    return parameter


def is_sequence_parallel_parameter(parameter):
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Registers nothing: the eager regime's SP parameters get whole
    gradients."""
    return model


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """``ColumnParallelLinear`` whose input arrives sequence-split: the
    sequence gathered, then the column product (``gather_output`` False
    by default)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, gather_output=gather_output,
                         fuse_matmul_bias=fuse_matmul_bias,
                         mp_group=mp_group, name=name)

    def forward(self, x):
        return super().forward(GatherOp.apply(x))


class RowSequenceParallelLinear(RowParallelLinear):
    """``RowParallelLinear`` whose output is split back onto the sequence
    (``input_is_parallel`` True by default)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias,
                         input_is_parallel=input_is_parallel,
                         fuse_matmul_bias=fuse_matmul_bias,
                         mp_group=mp_group, name=name)

    def forward(self, x):
        return ScatterOp.apply(super().forward(x))
