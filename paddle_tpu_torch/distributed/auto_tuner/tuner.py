"""AutoTuner, the counterpart of ``paddle_tpu/distributed/auto_tuner/tuner.py``
(upstream ``distributed/auto_tuner/tuner.py``): search dp/mp/pp/micro-batch
configs by cost model, optionally refined with measured trial runs."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .cost_model import estimate_memory, estimate_step_cost
from .search import GridSearch, degree_space


class AutoTuner:
    def __init__(self, model_config: Dict, world_size: int,
                 tune_space: Optional[Dict] = None,
                 trial_fn: Optional[Callable[[Dict], float]] = None,
                 max_trials: int = None):
        """trial_fn(config) -> measured seconds/step; when given, the top
        `max_trials` cost-model candidates are measured and re-ranked."""
        base = dict(model_config)
        base["world_size"] = world_size
        # every divisor of the world, not a powers-of-two ladder: a
        # world of 6 or 12 (what rank loss actually produces) must
        # admit 2x3-shaped configs instead of pruning to nothing
        degrees = degree_space(world_size)
        self.search = GridSearch(
            tune_space or {"dp_degree": degrees, "mp_degree": degrees,
                           "pp_degree": degrees},
            base=base)
        self.trial_fn = trial_fn
        if max_trials is None:
            from ..._core.flags import flag_value
            max_trials = flag_value("FLAGS_auto_tuner_max_trials")
        self.max_trials = max_trials
        self.history: List[Dict] = []

    def tune(self) -> Dict:
        ranked = []
        for c in self.search.candidates():
            cost = estimate_step_cost(c)
            ranked.append((cost, c))
        if not ranked:
            raise RuntimeError("no feasible parallel config for this "
                               "model/world size")
        # deterministic tie-break: prefer less model parallelism
        ranked.sort(key=lambda t: (t[0], t[1].get("mp_degree", 1),
                                   t[1].get("pp_degree", 1)))
        self.history = [
            {"config": c, "predicted_cost": cost,
             "predicted_memory": estimate_memory(c)}
            for cost, c in ranked]
        if self.trial_fn and self.max_trials > 0:
            measured = []
            for cost, c in ranked[:self.max_trials]:
                measured.append((self.trial_fn(c), c))
            measured.sort(key=lambda t: t[0])
            return measured[0][1]
        return ranked[0][1]
