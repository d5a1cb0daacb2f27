"""Analytic cost and memory models for the parallel-config search, the
counterpart of ``paddle_tpu/distributed/auto_tuner/cost_model.py``
(upstream ``distributed/auto_tuner/cost_model.py``,
``memory_cost_model.py``): compute at a fraction of the card's peak,
collectives at its link rate, memory against its HBM."""
from __future__ import annotations

from typing import Dict


# default hardware model, tunable through the config dict: the NVIDIA H100
# 80GB HBM3's data-sheet figures (SXM part, 700 W power limit, as
# ``nvidia-smi`` names the card the port runs on). Spec figures, not
# measurements. ``ici_bandwidth`` keeps the reference's key and carries
# NVLink's rate each way (900e9 bytes/s both ways).
_DEFAULTS = dict(
    chip_flops=989e12,          # dense bf16 FLOP/s per card
    hbm_bytes=80e9,             # per card
    ici_bandwidth=450e9,        # bytes/s each way, NVLink
    mfu=0.4,
)


def _cfg(config: Dict):
    c = dict(_DEFAULTS)
    c.update({k: v for k, v in config.items() if k in c})
    return c


def estimate_memory(config: Dict) -> float:
    """Per-chip training memory (bytes) for a decoder LLM under the given
    parallel config: params/grads/optimizer-state split over mp*pp(*ZeRO),
    activations split over dp/mp with remat reducing to layer boundaries."""
    h = config.get("hidden_size", 1024)
    L = config.get("num_layers", 24)
    v = config.get("vocab_size", 50304)
    s = config.get("seq_len", 1024)
    b = config.get("micro_batch_size", 1)
    dp = config.get("dp_degree", 1)
    mp = config.get("mp_degree", 1)
    pp = config.get("pp_degree", 1)
    zero = config.get("sharding_stage", 0)
    recompute = config.get("recompute", True)

    # a measured parameter count beats the decoder-LLM formula
    n_params = config.get("n_params") or (12 * L * h * h + 2 * v * h)
    shard = mp * pp * (dp if zero >= 1 else 1)
    # bf16 params + fp32 master/m/v (16 bytes/param when ZeRO shards all)
    param_bytes = n_params * 2 / (mp * pp)
    opt_bytes = n_params * 14 / shard
    act_per_layer = s * b * h * (2 if recompute else 34)
    act_bytes = act_per_layer * (L / pp) / max(mp, 1)
    return param_bytes + opt_bytes + act_bytes


def estimate_step_cost(config: Dict) -> float:
    """Predicted seconds/step: max(compute, comm) per pipeline stage plus
    bubble overhead."""
    c = _cfg(config)
    h = config.get("hidden_size", 1024)
    L = config.get("num_layers", 24)
    v = config.get("vocab_size", 50304)
    s = config.get("seq_len", 1024)
    gb = config.get("global_batch_size", 8)
    dp = config.get("dp_degree", 1)
    mp = config.get("mp_degree", 1)
    pp = config.get("pp_degree", 1)
    micro = config.get("pp_microbatches", 2 * pp)

    n_params = config.get("n_params") or (12 * L * h * h + 2 * v * h)
    flops = 6 * gb * s * n_params    # fwd+bwd matmul FLOPs (6N rule)
    compute_t = flops / (dp * mp * pp) / (c["chip_flops"] * c["mfu"])
    # dp grad allreduce (ring) + mp per-layer allreduce volumes
    dp_comm = 2 * n_params * 2 * (dp - 1) / dp / c["ici_bandwidth"] \
        if dp > 1 else 0.0
    mp_comm = (4 * L * gb / dp * s * h * 2 * (mp - 1) / mp
               / c["ici_bandwidth"]) if mp > 1 else 0.0
    bubble = (pp - 1) / max(micro, 1)
    return (max(compute_t, mp_comm) * (1 + bubble)) + dp_comm
