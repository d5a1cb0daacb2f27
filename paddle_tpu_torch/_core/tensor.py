"""The eager Tensor: the counterpart of ``paddle_tpu/_core/tensor.py``.

A ``Tensor`` wraps a ``torch.Tensor`` payload on an explicit device. ``_t``
is the materializing accessor: while the payload is still a pending value
of the lazy window (``_core/lazy.py`` ``LazyRef``, or an async flush's
``PendingValue``) reading ``_t`` lands it first; ``shape``, ``ndim``,
``dtype``, ``place``, ``len()`` and ``stop_gradient`` answer from the
recorded metadata (``_payload``) without landing anything. Writing ``_t``
swaps the payload and evicts the tensor from every open capture context
(``lazy.note_inplace``). It is a wrapper and not a ``torch.Tensor``
subclass: paddle's methods (``transpose(perm)``, ``sum(axis=)``, ``shape``
as a list, ``stop_gradient``) clash with torch's of the same names.
Autograd is torch's: ``stop_gradient`` is the payload's ``requires_grad``
turned round, ``grad`` the payload's ``.grad`` (accumulating across
``backward`` calls until ``clear_grad``). Operator methods are attached by
``paddle_tpu_torch.ops``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import dtype as dtypes
from . import lazy as _lazy
from ..observability import _state as _OBS
from .device import place_of, to_device


# classes of the deferred payloads (lazy.LazyRef, async_flush.PendingValue):
# each has the metadata of a torch.Tensor and materialize(tensor)
DEFERRED = _lazy.DEFERRED


class Tensor:
    # _dist: the DistAttr of a DistTensor (distributed/api.py), unset on
    # every other tensor (read through _dist_attr)
    __slots__ = ("_payload", "name", "persistable", "_dist", "__weakref__")

    def __init__(self, value, stop_gradient: Optional[bool] = None,
                 name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value._payload
        if value.__class__ in DEFERRED:
            value.add_tref(self)
        elif not isinstance(value, torch.Tensor):
            raise TypeError(f"Tensor wraps a torch.Tensor, got "
                            f"{type(value).__name__}; use paddle.to_tensor")
        self._payload = value
        self.name = name
        self.persistable = False
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient
        if _OBS.MEM:
            # the memory plane's census: the birth site is the thread's
            # hint (eager:<op>, io:h2d) or tensor.create
            from ..observability import memory as _memtel
            _memtel.note_buffer(value)

    @property
    def _t(self) -> torch.Tensor:
        p = self._payload
        if p.__class__ in DEFERRED:
            p = p.materialize(self)
        return p

    @_t.setter
    def _t(self, value) -> None:
        if value.__class__ in DEFERRED:
            value.add_tref(self)
        if _lazy._ALL_CTXS:
            _lazy.note_inplace(self)
        self._payload = value
        if _OBS.MEM:
            # a swapped-in payload is a buffer born here
            from ..observability import memory as _memtel
            _memtel.note_buffer(value)

    # ------------------------------------------------------------ metadata
    @property
    def shape(self):
        return list(self._payload.shape)

    @property
    def ndim(self) -> int:
        return self._payload.dim()

    @property
    def size(self) -> int:
        return self._payload.numel()

    @property
    def dtype(self) -> dtypes.DType:
        return dtypes.from_torch(self._payload.dtype)

    @property
    def place(self):
        return place_of(self._payload.device)

    @property
    def rank(self) -> int:
        return self._payload.dim()

    @property
    def _dist_attr(self):
        """The ``DistAttr`` of a DistTensor (``distributed.api``): its mesh,
        placements and global shape; None for any other tensor."""
        try:
            return self._dist
        except AttributeError:
            return None

    @_dist_attr.setter
    def _dist_attr(self, attr) -> None:
        self._dist = attr

    @property
    def is_leaf(self) -> bool:
        return self._payload.grad_fn is None

    # ------------------------------------------------------------ autograd
    @property
    def stop_gradient(self) -> bool:
        return not self._payload.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        p = self._payload
        if bool(value) == (not p.requires_grad):
            return
        if p.__class__ in DEFERRED and value:
            self._t = self.detach()._payload   # recorded in the window
        elif p.grad_fn is not None:  # an op's output: cut it off
            self._t = self._t.detach()
        else:
            self._t.requires_grad_(not value)

    @property
    def grad(self) -> Optional["Tensor"]:
        p = self._payload
        if p.__class__ in DEFERRED and p.grad_fn is not None:
            return None  # a pending op output: no leaf, no .grad
        g = self._t.grad
        return None if g is None else Tensor(g)

    @grad.setter
    def grad(self, g) -> None:
        self._t.grad = None if g is None else \
            (g._t if isinstance(g, Tensor) else g)

    def backward(self, grad_tensor=None, retain_graph: bool = False) -> None:
        if not self._payload.requires_grad:
            raise RuntimeError("backward() on a tensor with "
                               "stop_gradient=True: nothing to differentiate")
        from .autograd import backward
        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph=retain_graph)

    def clear_grad(self) -> None:
        self._t.grad = None

    def detach(self) -> "Tensor":
        if self._payload.__class__ in DEFERRED:
            from .dispatch import apply
            out = apply("detach", _detach, self)
            out.name = self.name
            return out
        return Tensor(self._t.detach(), name=self.name)

    def detach_(self) -> "Tensor":
        """Cut from the graph in place (``stop_gradient`` set)."""
        self._t = self._t.detach()
        return self

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """Calls ``hook(grad)`` with this tensor's gradient when backward
        reaches it; a ``Tensor`` it returns replaces the gradient. Returns
        a handle whose ``remove()`` takes the hook off."""
        def run(g):
            res = hook(Tensor(g))
            return None if res is None else \
                (res._t if isinstance(res, Tensor) else res)
        return self._t.register_hook(run)

    # ------------------------------------------------------------ transfer
    def numpy(self) -> np.ndarray:
        t = self._t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bfloat16
        return t.numpy()

    def item(self):
        return self._t.detach().item()

    def tolist(self):
        return self._t.tolist()

    def __array__(self, dtype=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def set_value(self, value) -> "Tensor":
        """Takes ``value``'s contents as a fresh payload (shape kept, dtype
        and device this tensor's), as the reference replaces its buffer:
        the old payload is not written, so a reshape, slice or view taken
        before keeps its values. A leaf keeps its ``stop_gradient`` and its
        ``grad``, and a parameter stays the same object (optimizers hold
        the wrapper, not the payload)."""
        src = value._t if isinstance(value, Tensor) else \
            to_tensor(value, place=self._t.device)._t
        if tuple(src.shape) != tuple(self._t.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} "
                             f"vs {tuple(self._t.shape)}")
        old = self._t
        new = src.detach().to(device=old.device, dtype=old.dtype, copy=True)
        if old.requires_grad:
            new.requires_grad_()
            if old.grad_fn is None:
                new.grad = old.grad
        self._t = new
        return self

    def copy_(self, other) -> "Tensor":
        return self.set_value(other)

    def get_tensor(self) -> "Tensor":
        return self

    def to(self, *args, **kwargs) -> "Tensor":
        """``.to(dtype)`` casts, ``.to(device)`` (``'cpu'``, ``'gpu'``,
        ``'gpu:N'``, a place) moves; the first argument that reads as a
        dtype wins, as in the reference."""
        for a in list(args) + list(kwargs.values()):
            try:
                d = dtypes.to_dtype(a)
            except (TypeError, KeyError):
                d = None
            if d is not None:
                return Tensor(self._t.to(d.torch_dtype),
                              stop_gradient=self.stop_gradient)
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (str, torch.device)) or hasattr(a, "device_type"):
                return Tensor(self._t.to(to_device(a)),
                              stop_gradient=self.stop_gradient)
        return self

    def block_until_ready(self) -> "Tensor":
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()
        return self

    # ------------------------------------------------------------ misc
    def __len__(self):
        p = self._payload
        if p.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return p.shape[0]

    def __bool__(self):
        return bool(self._t.detach())

    def __int__(self):
        return int(self._t.detach())

    def __float__(self):
        return float(self._t.detach())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad},\n       {self._t.detach()!r})")

    def __hash__(self):
        return id(self)


def _detach(t: torch.Tensor) -> torch.Tensor:
    return t.detach()


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True) \
        -> Tensor:
    """``paddle.to_tensor``: a copy of Python scalars and lists, numpy
    arrays, torch tensors or ``Tensor``s on ``place`` (default: the current
    device, the card unless ``set_device('cpu')``). Without ``dtype``,
    float64 data comes out float32 (paddle's float default) and the rest in
    its own type (Python ints int64)."""
    dev = to_device(place)
    if isinstance(data, (list, tuple)) and any(
            isinstance(x, Tensor) for x in data):
        data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
    if isinstance(data, (Tensor, torch.Tensor)):
        value = data._t.detach() if isinstance(data, Tensor) \
            else data.detach()
    elif isinstance(data, np.ndarray) and data.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy does not take: through
        # float32, which holds every bf16 value exactly
        value = torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
    else:
        value = torch.from_numpy(np.array(data))
    target = dtypes.to_torch(dtype) if dtype is not None else \
        torch.float32 if value.dtype == torch.float64 else value.dtype
    value = value.to(device=dev, dtype=target,
                     copy=isinstance(data, (Tensor, torch.Tensor)))
    return Tensor(value, stop_gradient=stop_gradient)
