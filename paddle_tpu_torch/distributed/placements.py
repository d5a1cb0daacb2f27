"""Placement types: ``Shard``, ``Replicate`` and ``Partial``, the
counterpart of ``paddle_tpu/distributed/placements.py`` (upstream
``placement_types.h`` and ``placement_type.py``).

A list of placements has one entry per mesh axis: ``Shard(d)`` splits
tensor dim ``d`` over that axis, ``Replicate()`` leaves it whole on every
coordinate, ``Partial()`` marks values whose sum over the axis is the
tensor (a pending reduction). Equality, hash and repr are the reference's.
"""
from __future__ import annotations


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"

    def is_replicate(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")


class Shard(Placement):
    def __init__(self, dim):
        self.dim = int(dim)

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def __repr__(self):
        return f"Partial(reduce_type={self.reduce_type})"

    def is_partial(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))
