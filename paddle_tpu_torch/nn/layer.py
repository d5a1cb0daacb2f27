"""nn.Layer: the counterpart of ``paddle_tpu/nn/layer.py``.

Parameters are ``Tensor``s whose payload is a leaf that requires grad;
buffers are non-trainable state. ``state_dict`` keys are the reference's
(attribute paths joined by dots), so a reference model's state dict, as
numpy arrays, loads into the port's model of the same class with
``set_state_dict``.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from .._core import dtype as dtypes
from .._core.tensor import Tensor, to_tensor

__all__ = ["Layer", "Parameter", "create_parameter", "functional_call"]


class Parameter(Tensor):
    """A trainable tensor (the reference's ``EagerParamBase``)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, value: torch.Tensor, trainable: bool = True,
                 name: Optional[str] = None):
        value = value.detach()
        super().__init__(value.requires_grad_(
            trainable and value.is_floating_point()), name=name)
        self.trainable = trainable
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False


_param_counter = [0]


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None) -> Parameter:
    """A parameter of ``shape`` drawn by ``attr``'s initializer, else
    ``default_initializer``, else Constant(0) for a bias and XavierNormal
    for a weight; named ``param_N`` unless ``attr`` names it."""
    from . import initializer as I
    from .param_attr import ParamAttr
    init, learning_rate, trainable = default_initializer, 1.0, True
    if isinstance(attr, ParamAttr):
        init = attr.initializer or init
        learning_rate, trainable = attr.learning_rate, attr.trainable
        name = attr.name or name
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    _param_counter[0] += 1
    p = Parameter(init(shape, dtype), trainable=trainable,
                  name=name or f"param_{_param_counter[0]}")
    p.optimize_attr["learning_rate"] = learning_rate
    return p


def _as_torch(value, like: torch.Tensor) -> torch.Tensor:
    """A state-dict value (``Tensor``, torch tensor or array-like, bf16
    arrays too) as a tensor of ``like``'s type on its device."""
    return to_tensor(value, dtype=like.dtype, place=like.device)._t


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        object.__setattr__(self, "_parameters", collections.OrderedDict())
        object.__setattr__(self, "_buffers", collections.OrderedDict())
        object.__setattr__(self, "_sub_layers", collections.OrderedDict())
        object.__setattr__(self, "_non_persistable_buffer_names", set())
        object.__setattr__(self, "_forward_pre_hooks",
                           collections.OrderedDict())
        object.__setattr__(self, "_forward_post_hooks",
                           collections.OrderedDict())
        self.training = True

    # ---------------------------------------------------------- attributes
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if params is None:
            raise RuntimeError("call super().__init__() first")
        if isinstance(value, Parameter):
            params[name] = value
            self._buffers.pop(name, None)
        elif isinstance(value, Layer):
            self._sub_layers[name] = value
        elif value is None and name in params:
            params[name] = None
        elif name in self._buffers and (value is None
                                        or isinstance(value, Tensor)):
            self._buffers[name] = value
        elif name in self._sub_layers and value is None:
            del self._sub_layers[name]
        object.__setattr__(self, name, value)

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        if tensor is not None:
            tensor.persistable = persistable
        object.__setattr__(self, name, tensor)

    def register_parameter(self, name, param):
        self._parameters[name] = param
        object.__setattr__(self, name, param)

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        object.__setattr__(self, str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def create_parameter(self, shape, attr=None, dtype="float32",
                         is_bias=False, default_initializer=None):
        return create_parameter(shape, dtype=dtype, attr=attr,
                                is_bias=is_bias,
                                default_initializer=default_initializer)

    # ---------------------------------------------------------- traversal
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None) -> Iterator[Tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is not None:
                yield from sub.named_sublayers(
                    prefix=f"{prefix}.{name}" if prefix else name,
                    include_self=True, layers_set=layers_set)

    def sublayers(self, include_self=False) -> List["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self):
        return iter(l for l in self._sub_layers.values() if l is not None)

    def named_children(self):
        return iter((n, l) for n, l in self._sub_layers.items()
                    if l is not None)

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def _named(self, kind, prefix):
        seen = set()
        for lname, layer in self.named_sublayers(prefix=prefix,
                                                 include_self=True):
            for name, t in getattr(layer, kind).items():
                if t is None or id(t) in seen:
                    continue
                seen.add(id(t))
                yield (f"{lname}.{name}" if lname else name), layer, name, t

    def named_parameters(self, prefix="", include_sublayers=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        for full, _, _, p in self._named("_parameters", prefix):
            yield full, p

    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters()]

    def named_buffers(self, prefix="", include_sublayers=True):
        for full, _, _, b in self._named("_buffers", prefix):
            yield full, b

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers()]

    # ---------------------------------------------------------- mode
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        return self

    # ---------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True
                   ) -> Dict[str, Tensor]:
        out = collections.OrderedDict(
            self.named_parameters(prefix=structured_name_prefix))
        for full, owner, name, b in self._named("_buffers",
                                                structured_name_prefix):
            if name not in owner._non_persistable_buffer_names:
                out[full] = b
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copies each value (numpy array, ``Tensor`` or torch tensor) into
        the tensor of the same key, cast to its type. Returns the keys
        missing from ``state_dict`` and those it has beyond the layer's."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, t in own.items():
                if name in state_dict:
                    src = _as_torch(state_dict[name], t._t)
                    if src.shape != t._t.shape:
                        raise ValueError(f"{name}: shape {tuple(src.shape)} "
                                         f"!= {tuple(t._t.shape)}")
                    t._t.copy_(src)
        return missing, unexpected

    # ---------------------------------------------------------- dtype
    def astype(self, dtype):
        """Casts the floating parameters and buffers in place (their
        payloads are replaced; optimizers hold the ``Parameter``s)."""
        dt = dtypes.to_torch(dtype)
        for t in self.parameters() + self.buffers():
            if t._t.is_floating_point() and t._t.dtype != dt:
                req = t._t.requires_grad
                t._t = t._t.detach().to(dt).requires_grad_(req)
        return self

    # ---------------------------------------------------------- hooks
    def register_forward_pre_hook(self, hook):
        return _HookHandle(self._forward_pre_hooks, hook)

    def register_forward_post_hook(self, hook):
        return _HookHandle(self._forward_post_hooks, hook)

    # ---------------------------------------------------------- call
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            res = hook(self, args)
            if res is not None:
                args = res if isinstance(res, tuple) else (res,)
        out = self.forward(*args, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = "\n  ".join(repr(sub).split("\n"))
            lines.append(f"  ({name}): {sub_repr}")
        main = f"{self.__class__.__name__}({self.extra_repr()}"
        return main + ("\n" + "\n".join(lines) + "\n)" if lines else ")")


class _HookHandle:
    _next_id = [0]

    def __init__(self, hooks: dict, hook):
        self.id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1
        self._hooks = hooks
        hooks[self.id] = hook

    def remove(self):
        self._hooks.pop(self.id, None)


def functional_call(layer: Layer, state: Dict[str, object], *args,
                    return_buffers=False, **kwargs):
    """Runs ``layer`` with the payloads of ``state`` (name -> ``Tensor``,
    torch tensor or array) in place of its own, and puts its own back
    after. With ``return_buffers``, also the buffers' payloads as the run
    left them (a batch norm's running statistics)."""
    own = layer.state_dict()
    originals = {}
    try:
        for name, t in own.items():
            if name in state:
                new = state[name]
                raw = new._t if isinstance(new, Tensor) else new \
                    if isinstance(new, torch.Tensor) else \
                    to_tensor(new, place=t._t.device)._t
                originals[name] = (t, t._t)
                t._t = raw
        out = layer(*args, **kwargs)
        if return_buffers:
            return out, {name: t._t for name, t in layer.state_dict().items()
                         if not isinstance(t, Parameter)}
        return out
    finally:
        for name, (t, old) in originals.items():
            t._t = old
