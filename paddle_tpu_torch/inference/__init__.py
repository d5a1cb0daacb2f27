"""paddle.inference: the counterpart of ``paddle_tpu/inference`` (the
AnalysisPredictor, analysis_predictor.h:101).

Deployment of a ``jit.save`` artifact with an analysis/config layer:

- named multi-IO from the artifact's ``.pdmeta`` (the role of the
  reference's serialized feed/fetch op info); an artifact without one gets
  one "x" input and one "out" output;
- Config knobs that change what runs: ``disable_gpu`` is the caller asking
  for the CPU (otherwise the predictor runs on the current device, the
  card unless ``set_device('cpu')``); ``switch_ir_optim(False)`` runs the
  exported graph module as it is, op by op, where the default compiles it
  through the compile path of ``jit.to_static`` (inductor on the card,
  ``aot_eager`` on the CPU), once per input signature;
  ``enable_memory_optim`` makes each input handle keep one device buffer
  that every run copies its host array into (reallocated only when the
  shape or type changes), where the default places a fresh device tensor
  per run: the port's counterpart of the reference's input donation, a
  memory reuse that leaves the numerics as they are; ``enable_profile``
  runs each call inside a ``torch.profiler`` range ``inference::run``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .._core.tensor import Tensor


class Config:
    """inference.Config analog (api/paddle_analysis_config.h surface).
    Every knob below changes how the predictor runs."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # jit.save writes one artifact; prog_file is the path prefix
        from .._core.flags import flag_value
        self.model_path = prog_file
        self._use_device = True       # the card vs the host CPU
        self._memory_pool_mb = 0
        self._device_id = 0
        self._enable_profile = False
        # defaults come from the flag surface so deployments can flip
        # them fleet-wide without code changes
        self._ir_optim = flag_value("FLAGS_inference_opt_level") > 0
        self._memory_optim = bool(
            flag_value("FLAGS_inference_donate_inputs"))

    def set_model(self, prog_file, params_file=None):
        self.model_path = prog_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on card ``device_id``."""
        self._use_device = True
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device_id = device_id

    def disable_gpu(self):
        """Run on the host CPU."""
        self._use_device = False

    def use_gpu(self):
        return self._use_device

    def switch_ir_optim(self, flag=True):
        """False runs the exported graph module uncompiled."""
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_profile(self):
        self._enable_profile = True

    def enable_memory_optim(self, x=True):
        """Reuse one device buffer per input across runs."""
        self._memory_optim = bool(x)

    def memory_optim(self):
        return self._memory_optim


class _IOHandle:
    """Zero-copy tensor handle (ZeroCopyTensor analog)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)

    def reshape(self, shape):
        if self._value is None:
            self._value = np.zeros(shape, np.float32)
        else:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self) -> np.ndarray:
        return self._value

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


class Predictor:
    """AnalysisPredictor analog: the analysis happens once at build, and
    the loaded program runs with the Config's execution options."""

    def __init__(self, config: Config):
        from .._core.device import default_device, resolve_device
        from ..jit.api import load as jit_load

        self.config = config
        if not config.use_gpu():
            self._device = torch.device("cpu")
        elif config._device_id:
            self._device = resolve_device(f"cuda:{config._device_id}")
        else:
            self._device = default_device()
        self._layer = jit_load(config.model_path, device=self._device)

        # ----- named IO from the artifact's metadata
        meta = None
        meta_path = str(config.model_path) + ".pdmeta"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        if meta:
            in_names = [m["name"] for m in meta["inputs"]]
            out_names = list(meta["outputs"])
        else:  # an artifact without metadata: one input
            in_names, out_names = ["x"], ["out"]
        self._inputs: Dict[str, _IOHandle] = {
            n: _IOHandle(n) for n in in_names}
        self._outputs: Dict[str, _IOHandle] = {
            n: _IOHandle(n) for n in out_names}

        self._profiler_events: List[str] = []
        self._buffers: Dict[str, torch.Tensor] = {}
        module = self._layer._program.module()
        svals = self._layer._svals
        self._module = lambda *arrays: module(*svals, *arrays)
        # one compiled program per input signature when ir_optim is on
        self._compiled: Optional[Dict] = {} if config.ir_optim() else None

    # ------------------------------------------------------------- handles
    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_input_handle(self, name: str) -> _IOHandle:
        return self._inputs[name]

    def get_output_handle(self, name: str) -> _IOHandle:
        return self._outputs[name]

    # ----------------------------------------------------------------- run
    def _place(self, name, arr) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if not self.config.memory_optim():
            return src.to(self._device)
        buf = self._buffers.get(name)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self._buffers[name] = torch.empty_like(
                src, device=self._device)
        return buf.copy_(src)

    def _execute(self, arrays):
        from ..jit.api import _signature, compile_traced
        tensors = [self._place(n, a) for n, a in zip(self._inputs, arrays)]
        with torch.no_grad():
            if self._compiled is None:
                outs = self._module(*tensors)
            else:
                sig = _signature(tensors)
                if sig not in self._compiled:
                    self._compiled[sig] = compile_traced(
                        self._module, tensors, None, device=self._device)
                outs = self._compiled[sig](*tensors)
        return [Tensor(o).numpy() for o in outs]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Execute; with `inputs` given returns outputs directly (new-style
        predictor.run(list) API), else uses the bound handles."""
        if inputs is not None:
            for h, a in zip(self._inputs.values(), inputs):
                h.copy_from_cpu(np.asarray(a))
        arrays = [h.copy_to_cpu() for h in self._inputs.values()]
        if self.config._enable_profile:
            with torch.profiler.record_function("inference::run"):
                outs = self._execute(arrays)
            self._profiler_events.append("inference::run")
        else:
            outs = self._execute(arrays)
        for h, o in zip(self._outputs.values(), outs):
            h.copy_from_cpu(o)
        return [h.copy_to_cpu() for h in self._outputs.values()]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    def __init__(self, config: Config, size: int = 1):
        self._predictors = [Predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._predictors[idx]


def get_version() -> str:
    from .. import __version__
    return __version__
