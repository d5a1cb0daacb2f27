"""AMP auto-cast: the counterpart of ``paddle_tpu/amp/auto_cast.py``.

O1 casts by op name at dispatch (``_core/dispatch.py``): an op of the white
list gets its floating inputs in the low type, an op of the black list its
bf16 and fp16 inputs in float32, and any other op takes its inputs as they
come. O2 does the same and ``decorate`` casts the model to the low type.
The lists are the reference's, op name for op name (the port's ops carry
the reference's names), so an op's output type under ``auto_cast`` is the
reference's. A scope's custom lists extend the lists inside it.
"""
from __future__ import annotations

import threading

import torch

from .._core import dispatch
from .._core import dtype as dtypes

# ops that run in the low type (the matrix products)
WHITE_LIST = {"matmul", "linear", "conv2d", "conv3d", "conv2d_transpose",
              "einsum_", "bmm_", "sdpa", "dot_"}
# ops that need float32
BLACK_LIST = {"exp", "log", "log2", "log10", "log1p", "softmax",
              "log_softmax", "softmax_ce", "nll_loss_k", "bce_k",
              "bce_logits_k", "mse_loss_k", "p_norm_", "std_", "var_",
              "layer_norm", "rms_norm", "group_norm", "bn_apply",
              "bn_stats", "cumsum_", "logsumexp", "mean", "sum_",
              "kl_div_k", "erfinv", "pow", "reciprocal", "rsqrt"}
DEFAULT_LEVEL = "O1"           # the reference's FLAGS_amp_level
DEFAULT_DTYPE = "bfloat16"     # the reference's FLAGS_amp_dtype
_LOW = (torch.bfloat16, torch.float16)


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


_STATE = threading.local()  # .amp: (level, torch dtype, white, black)
_LIVE = [0]                 # scopes live in any thread
_LOCK = threading.Lock()


def _cast(name, args):
    state = getattr(_STATE, "amp", None)
    if state is None or state[0] == "O0":
        return args
    _, low, white, black = state
    if name in white:
        return [a.to(low) if isinstance(a, torch.Tensor)
                and a.is_floating_point() and a.dtype != low else a
                for a in args]
    if name in black:
        return [a.float() if isinstance(a, torch.Tensor)
                and a.dtype in _LOW else a for a in args]
    return args


def state_key():
    """The live scope's casting rule as a hashable value (None outside a
    scope): what a trace taken under it bakes in."""
    state = getattr(_STATE, "amp", None)
    if state is None or state[0] == "O0":
        return None
    level, low, white, black = state
    return level, low, frozenset(white), frozenset(black)


class auto_cast:
    """``with paddle.amp.auto_cast(level='O1', dtype='bfloat16'):``"""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level=None, dtype=None,
                 use_promote=True):
        self.enable = enable
        self.level = (level or DEFAULT_LEVEL) if enable else "O0"
        self.dtype = dtype or DEFAULT_DTYPE
        self.white = WHITE_LIST | set(custom_white_list or ())
        self.black = BLACK_LIST | set(custom_black_list or ())

    def __enter__(self):
        self._prev = getattr(_STATE, "amp", None)
        _STATE.amp = (self.level, dtypes.to_torch(self.dtype), self.white,
                      self.black) if self.enable else None
        if self.enable:
            with _LOCK:
                _LIVE[0] += 1
                dispatch.AMP_HOOK = _cast
        return self

    def __exit__(self, *exc):
        _STATE.amp = self._prev
        if self.enable:
            with _LOCK:
                _LIVE[0] -= 1
                if not _LIVE[0]:
                    dispatch.AMP_HOOK = None
        return False


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: the models' floating parameters cast to ``dtype``; the
    optimizers keep float32 master weights (``multi_precision``)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.astype(dtype)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        o._multi_precision = True
    return (models if single else model_list), \
        (optimizers if opt_single else opt_list)


amp_guard = auto_cast
