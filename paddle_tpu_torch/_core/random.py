"""The eager API's random state: the counterpart of
``paddle_tpu/_core/random.py``.

One explicit ``torch.Generator`` per device, made on first use from the
seed; initializers and dropout draw from the generator of the device they
fill. ``seed(n)`` reseeds them all. The reference splits a global
``jax.random`` key instead: the two give different numbers from one seed,
so tests hand both the same weights and inputs through numpy.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

DEFAULT_SEED = 0  # the reference's FLAGS_seed
_LOCK = threading.Lock()
_seed: Optional[int] = None
_generators: Dict[torch.device, torch.Generator] = {}


def seed(s: int) -> int:
    """Reseed every device's generator (``paddle.seed``)."""
    global _seed
    with _LOCK:
        _seed = int(s)
        for dev, gen in _generators.items():
            gen.manual_seed(_seed)
    return s


def get_seed() -> Optional[int]:
    return _seed


def generator(device: torch.device) -> torch.Generator:
    """The generator of ``device``, seeded with the last ``seed`` (or the
    default seed) when first made."""
    device = torch.device(device)
    with _LOCK:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(DEFAULT_SEED if _seed is None else _seed)
            _generators[device] = gen
        return gen
