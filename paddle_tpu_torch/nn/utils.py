"""``paddle.nn.utils``: the counterpart of ``paddle_tpu/nn/utils.py``
(weight reparameterisations and parameter flattening).

``weight_norm`` and ``spectral_norm`` keep the reference's parameter
names (``weight_v`` / ``weight_g``; ``weight_orig``) and recompute the
effective weight in a forward pre-hook. ``spectral_norm``'s power
iteration starts from the reference's vector (``RandomState(0)``, so the
two agree without crossing it) and divides by a sigma that carries no
gradient, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from .._core.tensor import Tensor
from .layer import Layer, Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    axes = tuple(d for d in range(v.dim()) if d != dim)
    return torch.sqrt((v * v).sum(axes, keepdim=True))


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0):
    """``name`` as ``g * v / ||v||`` (the norm over every axis but
    ``dim``): ``{name}_v`` and ``{name}_g`` become the parameters."""
    dim = 0 if dim is None else dim
    w = getattr(layer, name)._t.detach()
    v = Parameter(w.clone())
    g = Parameter(_norm_except(w, dim).reshape(-1))
    layer.add_parameter(f"{name}_v", v)
    layer.add_parameter(f"{name}_g", g)
    layer._parameters.pop(name, None)

    def recompute(lyr, inputs):
        shape = [1] * v._t.dim()
        shape[dim] = -1
        eff = v._t / _norm_except(v._t, dim) * g._t.reshape(shape)
        object.__setattr__(lyr, name, Tensor(eff))

    handle = layer.register_forward_pre_hook(recompute)
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = \
        (handle, v, g, dim)
    recompute(layer, None)
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight"):
    """Folds ``g * v / ||v||`` back into one parameter ``name`` and
    removes the hook."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        return layer
    handle, v, g, dim = hooks.pop(name)
    handle.remove()
    shape = [1] * v._t.dim()
    shape[dim] = -1
    with torch.no_grad():
        eff = v._t / torch.clamp(_norm_except(v._t, dim), min=1e-12) \
            * g._t.reshape(shape)
    for pname in (f"{name}_v", f"{name}_g"):
        layer._parameters.pop(pname, None)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(eff))
    return layer


def spectral_norm(layer: Layer, name: str = "weight", n_power_iterations=1,
                  eps: float = 1e-12, dim: int = 0):
    """``name`` divided by its largest singular value, estimated by power
    iteration on the original weight (kept as ``{name}_orig``)."""
    w = getattr(layer, name)
    rows = w._t.shape[dim]
    u = np.random.RandomState(0).randn(rows).astype(np.float32)
    u /= np.linalg.norm(u) + eps
    state = {"u": torch.from_numpy(u).to(w._t.device)}

    def hook(lyr, inputs):
        base = lyr._parameters[f"{name}_orig"]
        m = base._t.detach().movedim(dim, 0).reshape(rows, -1)
        u_ = state["u"].to(m.dtype)
        v_ = m.T @ u_
        v_ = v_ / (torch.linalg.vector_norm(v_) + eps)
        for _ in range(n_power_iterations):
            u_ = m @ v_
            u_ = u_ / (torch.linalg.vector_norm(u_) + eps)
            v_ = m.T @ u_
            v_ = v_ / (torch.linalg.vector_norm(v_) + eps)
        state["u"] = u_
        sigma = u_ @ m @ v_
        object.__setattr__(lyr, name, Tensor(base._t / sigma))

    layer.add_parameter(f"{name}_orig", w)
    layer._parameters.pop(name, None)
    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def parameters_to_vector(parameters, name=None) -> Tensor:
    """The parameters flattened into one 1-D tensor."""
    return Tensor(torch.cat([p._t.reshape(-1) for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    """Slices of ``vec`` written back into the parameters."""
    off = 0
    v = vec._t if isinstance(vec, Tensor) else vec
    for p in parameters:
        n = p._t.numel()
        p.set_value(Tensor(v[off:off + n].reshape(p._t.shape)))
        off += n
    return parameters
