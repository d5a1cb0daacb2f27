"""Candidate pruning rules, the counterpart of
``paddle_tpu/distributed/auto_tuner/prune.py`` (upstream
``distributed/auto_tuner/prune.py``)."""
from __future__ import annotations

from typing import Dict, List

from .cost_model import _DEFAULTS, estimate_memory


def _divisible(config: Dict) -> bool:
    world = config.get("world_size", 1)
    dp = config.get("dp_degree", 1)
    mp = config.get("mp_degree", 1)
    pp = config.get("pp_degree", 1)
    if dp * mp * pp != world:
        return False
    if config.get("num_layers", 1) % pp:
        return False
    if config.get("num_heads", mp) % mp:
        return False
    if config.get("hidden_size", mp) % mp:
        return False
    # unspecified batch: assume at least one micro-batch per dp replica
    gb = config.get("global_batch_size") or dp
    if gb % dp:
        return False
    return True


def _fits_memory(config: Dict) -> bool:
    cap = config.get("hbm_bytes", _DEFAULTS["hbm_bytes"]) * 0.9
    return estimate_memory(config) <= cap


RULES = [_divisible, _fits_memory]


def prune_candidates(candidates: List[Dict]) -> List[Dict]:
    return [c for c in candidates if all(r(c) for r in RULES)]
