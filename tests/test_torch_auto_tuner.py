"""The port's auto tuner against the JAX package's, on the CPU.

- The analytic cost and memory models with the hardware keys given
  (``chip_flops``, ``hbm_bytes``, ``ici_bandwidth``, ``mfu``), so both
  packages compute on the same inputs: equal to the reference's to 1e-12
  relative over configurations of the dp/mp/pp/ZeRO/remat space.
- Pruning, ``degree_space``, ``factorizations``, ``GridSearch`` and the
  tuner's pick and history (with and without a trial function) equal the
  reference's; ``Engine.tune``'s ranking too.
- The port's default hardware model is the H100's (a decision: the
  reference's is a TPU v5e's), so with no keys given the two differ.
- Trials: one CPU trial at 1 rank and one 2-rank trial through the
  launcher (gloo) measure a finite time; a config with more ranks than
  the host has cores gives +inf without starting a job.
"""
import subprocess

import numpy as np
import pytest

from paddle_tpu.distributed import auto_tuner as ref_at
from paddle_tpu.distributed.auto_tuner import cost_model as ref_cm
from paddle_tpu.distributed.auto_tuner import search as ref_search
from paddle_tpu_torch.distributed import auto_tuner as pt_at
from paddle_tpu_torch.distributed.auto_tuner import cost_model as pt_cm
from paddle_tpu_torch.distributed.auto_tuner import search as pt_search
from paddle_tpu_torch.distributed.auto_tuner import trial_runner

HW = dict(chip_flops=197e12, hbm_bytes=16e9, ici_bandwidth=4.5e10, mfu=0.4)
MODEL = dict(hidden_size=2048, num_layers=24, num_heads=16,
             vocab_size=50304, seq_len=1024, global_batch_size=64)
# a tiny GPT for the measured trials (fp32 on the CPU)
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
            seq_len=32, global_batch_size=4, recompute=False)


def _configs():
    out = []
    for dp, mp, pp in ((1, 1, 1), (8, 1, 1), (2, 2, 2), (1, 4, 2),
                       (4, 2, 1), (2, 1, 4)):
        for extra in ({}, {"sharding_stage": 1, "recompute": False},
                      {"pp_microbatches": 8, "micro_batch_size": 2},
                      {"n_params": 354_871_296, "global_batch_size": 8}):
            out.append(dict(MODEL, **HW, dp_degree=dp, mp_degree=mp,
                            pp_degree=pp, world_size=dp * mp * pp, **extra))
    return out


def test_cost_model_matches_reference_with_the_hardware_given():
    for c in _configs():
        assert pt_cm.estimate_step_cost(c) == pytest.approx(
            ref_cm.estimate_step_cost(c), rel=1e-12, abs=0)
        assert pt_cm.estimate_memory(c) == pytest.approx(
            ref_cm.estimate_memory(c), rel=1e-12, abs=0)


def test_the_port_defaults_are_the_h100s():
    """Spec figures of the NVIDIA H100 80GB HBM3 (bf16 dense FLOP/s, HBM
    bytes, NVLink bytes/s each way); the reference's are a TPU v5e's."""
    assert pt_cm._DEFAULTS == dict(chip_flops=989e12, hbm_bytes=80e9,
                                   ici_bandwidth=450e9, mfu=0.4)
    assert ref_cm._DEFAULTS == dict(chip_flops=197e12, hbm_bytes=16e9,
                                    ici_bandwidth=4.5e10, mfu=0.4)
    c = dict(MODEL, dp_degree=2, mp_degree=2, pp_degree=1)
    assert pt_cm.estimate_step_cost(c) < ref_cm.estimate_step_cost(c)
    # 2.6 B parameters need ~42 GB: within a card's 80 GB, not 16 GB
    big = [dict(MODEL, world_size=1, dp_degree=1, mp_degree=1, pp_degree=1,
                global_batch_size=1, num_layers=48)]
    assert ref_at.prune_candidates(big) == []
    assert pt_at.prune_candidates(big) == big


def test_pruning_and_search_match_reference():
    cands = [dict(c, hbm_bytes=16e9) for c in _configs()] + [
        dict(MODEL, world_size=1, dp_degree=1, mp_degree=1, pp_degree=1,
             hidden_size=12288, num_layers=96, num_heads=96,
             global_batch_size=1, hbm_bytes=16e9),
        dict(MODEL, world_size=8, dp_degree=3, mp_degree=1, pp_degree=1),
        dict(MODEL, world_size=8, dp_degree=2, mp_degree=3, pp_degree=1)]
    assert pt_at.prune_candidates(cands) == ref_at.prune_candidates(cands)
    for n in (1, 6, 8, 12, 16):
        assert pt_search.degree_space(n) == ref_search.degree_space(n)
        assert pt_search.factorizations(n) == ref_search.factorizations(n)
    space = {"dp_degree": [1, 2, 4], "mp_degree": [1, 2],
             "pp_degree": [1, 2]}
    base = dict(MODEL, world_size=4, hbm_bytes=16e9)
    assert pt_at.GridSearch(space, base).candidates() == \
        ref_at.GridSearch(space, base).candidates()


@pytest.mark.parametrize("world", [4, 6, 8])
def test_tuner_pick_matches_reference(world):
    cfg = dict(MODEL, **HW)
    got, want = pt_at.AutoTuner(cfg, world), ref_at.AutoTuner(cfg, world)
    assert got.tune() == want.tune()
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        assert g["config"] == w["config"]
        assert g["predicted_cost"] == pytest.approx(w["predicted_cost"],
                                                    rel=1e-12)
        assert g["predicted_memory"] == pytest.approx(
            w["predicted_memory"], rel=1e-12)


def test_tuner_trial_fn_reranks_as_reference():
    cfg = dict(hidden_size=512, num_layers=8, num_heads=8, vocab_size=1024,
               seq_len=256, global_batch_size=16, **HW)

    def trial(c):
        return 1.0 / c["mp_degree"]
    got = pt_at.AutoTuner(cfg, 4, trial_fn=trial, max_trials=8).tune()
    want = ref_at.AutoTuner(cfg, 4, trial_fn=trial, max_trials=8).tune()
    assert got == want
    assert pt_at.AutoTuner(cfg, 4).max_trials == 0


def test_engine_tune_ranks_as_reference():
    import paddle_tpu as ref
    import paddle_tpu_torch as pt
    from paddle_tpu_torch._core import device as pt_device
    pt_device._current, saved = "cpu", pt_device._current
    try:
        picks = []
        for pkg in (ref, pt):
            net = pkg.nn.Linear(64, 64)
            eng = pkg.distributed.auto_parallel.Engine(model=net)
            space = {"dp_degree": [1, 2, 4], "mp_degree": [1, 2],
                     "pp_degree": [1], **{k: [v] for k, v in HW.items()}}
            picks.append(eng.tune(world_size=4, tune_space=space))
        assert picks[0] == picks[1]
        assert picks[1]["n_params"] == 64 * 64 + 64
    finally:
        pt_device._current = saved


def test_one_rank_trial_on_the_cpu_is_finite():
    t = trial_runner.measure_step_time(
        dict(TINY, dp_degree=1, mp_degree=1, pp_degree=1), steps=2,
        warmup=1, timeout=240)
    assert np.isfinite(t) and t > 0


def test_two_rank_trial_through_the_launcher_is_finite():
    t = trial_runner.measure_step_time(
        dict(TINY, dp_degree=2, mp_degree=1, pp_degree=1), steps=2,
        warmup=1, timeout=240)
    assert np.isfinite(t) and t > 0


def test_infeasible_config_gives_inf_without_a_job(monkeypatch):
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    t = trial_runner.measure_step_time(dict(TINY, dp_degree=64,
                                            mp_degree=4, pp_degree=4))
    assert t == float("inf") and started == []


def test_a_failing_trial_gives_inf():
    # 3 heads do not divide a hidden of 64: the trainer's qkv reshape
    # fails in the job, and the trial reads +inf
    t = trial_runner.measure_step_time(
        dict(TINY, num_heads=3, dp_degree=1, mp_degree=1, pp_degree=1),
        steps=1, warmup=0, timeout=240)
    assert t == float("inf")
