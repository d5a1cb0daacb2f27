"""Tensor-parallel layers at model-parallel degree 1: the counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py``.

At degree 1 each layer holds the same parameters, under the same names
and initializers, as the reference's layer outside a mesh, and computes
the plain embedding or linear. A mesh or an ``mp_group`` of more than one
rank is not ported yet and raises ``NotImplementedError``.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, create_parameter


def _degree_one(mp_group) -> None:
    n = 1 if mp_group is None else getattr(
        mp_group, "nranks", len(getattr(mp_group, "ranks", ())))
    if n > 1:
        raise NotImplementedError(
            f"tensor-parallel layers above degree 1 (mp_group of {n} "
            f"ranks) are not ported yet")


class VocabParallelEmbedding(Layer):
    """Embedding with the vocab dim sharded over mp (here: one shard)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.vocab_start_index = 0
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """Linear with the output dim sharded over mp; weight ``[in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group)
        self.gather_output = gather_output
        self.weight = create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = None
        if has_bias is None or has_bias:
            self.bias = create_parameter([out_features], is_bias=True)
            self.bias.is_distributed = True

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """Linear with the input dim sharded over mp; weight ``[in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        _degree_one(mp_group)
        self.input_is_parallel = input_is_parallel
        self.weight = create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
