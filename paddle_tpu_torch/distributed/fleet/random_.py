"""Named random streams for tensor-parallel dropout: the counterpart of
``paddle_tpu/distributed/fleet/random_.py`` (upstream
``fleet/layers/mpu/random.py``).

A stream is a seed and, per device, an explicit ``torch.Generator`` made
from it on first use. Inside ``rng_state(name)`` the stream's generators
stand in for the eager API's (``_core/random.py``), so dropout and the
initializers draw from the stream, and the stream advances only there.
``model_parallel_random_seed`` seeds the eager API's generators with the
base seed (the same on every rank) and adds the stream
``model_parallel_rng`` from ``base + 1024 + mp rank`` (distinct on each
mp rank), as the reference. The reference draws from ``jax.random`` keys:
the numbers differ between the two packages, the seeds and the rules do
not.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..._core import random as rnd
from .topology import get_hybrid_communicate_group

MODEL_PARALLEL_RNG = "model_parallel_rng"


class _Stream:
    __slots__ = ("seed", "generators")

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.generators: Dict[torch.device, torch.Generator] = {}


class RNGStatesTracker:
    def __init__(self):
        self.states: Dict[str, _Stream] = {}
        self.seeds = set()

    def reset(self):
        self.states = {}
        self.seeds = set()

    def add(self, name, seed):
        if seed in self.seeds:
            raise ValueError(f"seed {seed} already added")
        if name in self.states:
            raise ValueError(f"state {name} already added")
        self.seeds.add(seed)
        self.states[name] = _Stream(seed)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        """The eager API draws from stream ``name`` inside the block."""
        if name not in self.states:
            raise ValueError(f"state {name} not added")
        stream = self.states[name]
        with rnd._LOCK:
            saved = rnd._generators, rnd._seed
            rnd._generators, rnd._seed = stream.generators, stream.seed
        try:
            yield
        finally:
            with rnd._LOCK:
                rnd._generators, rnd._seed = saved

    def get_states_tracker(self):
        """A copy of every stream: its seed and its generators' states."""
        return {name: (s.seed, {dev: g.get_state()
                                for dev, g in s.generators.items()})
                for name, s in self.states.items()}

    def set_states_tracker(self, states):
        """The streams as ``get_states_tracker`` copied them."""
        self.states = {}
        for name, (seed, gens) in states.items():
            s = _Stream(seed)
            for dev, state in gens.items():
                g = torch.Generator(device=dev)
                g.set_state(state)
                s.generators[dev] = g
            self.states[name] = s


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seeds the eager API with ``seed`` (the global seed, random when
    None) and makes the tracker's one stream ``model_parallel_rng`` from
    ``seed + 1024 + mp rank``; returns (local seed, global seed)."""
    import random as pyrand
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg else 0
    base = seed if seed is not None else pyrand.randint(0, 2 ** 31 - 1)
    local_seed = base + 1024 + mp_rank
    global_seed = base
    _tracker.reset()
    rnd.seed(global_seed)
    _tracker.add(MODEL_PARALLEL_RNG, local_seed)
    return local_seed, global_seed
