"""Search algorithms over parallel configs, the counterpart of
``paddle_tpu/distributed/auto_tuner/search.py`` (upstream
``auto_tuner/search.py``)."""
from __future__ import annotations

import itertools
from typing import Dict, List

from .prune import prune_candidates


def degree_space(world_size: int) -> List[int]:
    """Every parallel degree that tiles `world_size` exactly — the
    candidate axis for a survivor-count re-plan (the default
    powers-of-two ladder misses worlds like 6 or 12, exactly the sizes
    rank loss produces)."""
    n = max(int(world_size), 1)
    return [d for d in range(1, n + 1) if n % d == 0]


def factorizations(world_size: int):
    """Every ordered (dp, mp, pp) triple whose product is exactly
    `world_size` — the planner's full mesh-shape space (10 triples for
    world 8, 18 for world 12), where the cartesian divisor grid plus
    the product-prune visits the same set with cubic waste."""
    n = max(int(world_size), 1)
    out = []
    for dp in degree_space(n):
        rem = n // dp
        for mp in degree_space(rem):
            out.append((dp, mp, rem // mp))
    return out


class GridSearch:
    """Cartesian product of the tunable axes, pruned by feasibility."""

    def __init__(self, space: Dict[str, List], base: Dict = None):
        self.space = space
        self.base = base or {}

    def candidates(self) -> List[Dict]:
        keys = list(self.space)
        out = []
        for combo in itertools.product(*(self.space[k] for k in keys)):
            c = dict(self.base)
            c.update(zip(keys, combo))
            out.append(c)
        return prune_candidates(out)
