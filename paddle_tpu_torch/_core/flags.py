"""The flag registry: the counterpart of ``paddle_tpu/_core/flags.py``.

A flag is a name, a typed default and a help line; an environment variable
of the flag's name overrides the default when the flag is defined.
``get_flags`` / ``set_flags`` read and write them from Python
(``paddle.get_flags`` / ``paddle.set_flags``), and ``watch_flag`` lets a
module keep a cached copy in step with ``set_flags``. The flags defined
here are those the compile path reads (``jit``, ``static``, ``ir``,
``inference``, ``onnx``); the runtime's own flags come with
``_core/lazy.py``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Union

_LOCK = threading.RLock()
_REGISTRY: Dict[str, "Flag"] = {}
_WATCHERS: Dict[str, List[Callable]] = {}


class Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name: str, default: Any, help: str = ""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        env = os.environ.get(name)
        self.value = _parse(env, self.type) if env is not None else default


def _parse(text: str, ty: type):
    if ty is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return ty(text)


def define_flag(name: str, default: Any, help: str = "") -> Flag:
    """Defines ``name`` (once: a second definition returns the first)."""
    with _LOCK:
        if name not in _REGISTRY:
            _REGISTRY[name] = Flag(name, default, help)
        return _REGISTRY[name]


def _known(name: str) -> "Flag":
    if name not in _REGISTRY:
        raise ValueError(f"unknown flag: {name}")
    return _REGISTRY[name]


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    with _LOCK:
        return {name: _known(name).value for name in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """Sets each flag, its value parsed to the flag's type; every name and
    value is checked before any flag changes. Watchers run after."""
    with _LOCK:
        updates = []
        for name, value in flags.items():
            flag = _known(name)
            parsed = _parse(value, flag.type) \
                if isinstance(value, str) and flag.type is not str \
                else flag.type(value)
            updates.append((flag, parsed))
        fire = []
        for flag, parsed in updates:
            flag.value = parsed
            fire += [(cb, parsed) for cb in _WATCHERS.get(flag.name, ())]
    for cb, value in fire:
        cb(value)


def watch_flag(name: str, callback: Callable) -> None:
    """Calls ``callback(value)`` now and after every ``set_flags`` of
    ``name``."""
    with _LOCK:
        value = _known(name).value
        _WATCHERS.setdefault(name, []).append(callback)
    callback(value)


def flag_value(name: str):
    return _REGISTRY[name].value


define_flag("FLAGS_dy2static_cache_limit", 64,
            "Max cached (signature -> executable) entries per "
            "to_static function before oldest eviction.")
define_flag("FLAGS_apply_ir_passes", True,
            "run the IR pass pipeline when compiling static Programs")
define_flag("FLAGS_ir_pass_disable", "",
            "Comma-separated IR pass names to skip in the pipeline.")
define_flag("FLAGS_enable_auto_layout", False,
            "Run the NHWC auto-layout pass in the static pipeline "
            "(transpose-sunk NHWC convs, auto_layout_pass.cc role).")
define_flag("FLAGS_jit_save_meta", True,
            "jit.save writes the .pdmeta named-IO sidecar used by the "
            "inference AnalysisPredictor.")
define_flag("FLAGS_allow_pickle_load", False,
            "Permit loading legacy pickle parameter files (pickle can "
            "execute code; PT_ALLOW_PICKLE_LOAD=1 is the env spelling).")
define_flag("FLAGS_inference_opt_level", 2,
            "Default inference Config optimization level.")
define_flag("FLAGS_inference_donate_inputs", False,
            "Default inference Config input-donation setting.")
define_flag("FLAGS_onnx_opset", 13,
            "Minimum default-domain opset version for ONNX export "
            "(raised per-op when an emitted op needs newer).")
