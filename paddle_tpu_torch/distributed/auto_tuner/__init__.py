from .cost_model import estimate_memory, estimate_step_cost  # noqa: F401
from .prune import prune_candidates  # noqa: F401
from .search import GridSearch  # noqa: F401
from .tuner import AutoTuner  # noqa: F401
from .trial_runner import measure_step_time  # noqa: F401
