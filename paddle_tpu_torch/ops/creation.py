"""Tensor creation: the counterpart of ``paddle_tpu/ops/creation.py`` (and
of the random samplers of ``math_ext.py``).

Every function creates on the current device (``set_device``; the card
unless the caller chose the CPU), a ``*_like`` on its input's device, and
uses the reference's default types: float32 for ``zeros``/``ones`` and
the float samplers, int64 for integer ``arange`` and ``full``, ``randint``
and ``randperm``.

Random ops draw from the port's explicit generators (``_core/random.py``):
the generator of the device the result lies on, the card's for the card.
They do not reproduce ``jax.random``'s numbers; ``seed`` makes a device's
draws repeat. Their output types are the reference's, float64 included
where its sampler takes JAX's default float under x64: ``uniform`` (with
no dtype or float32), ``normal``, ``standard_gamma`` and ``dirichlet``.
"""
from __future__ import annotations

import torch

from .._core import dtype as dtypes
from .._core import random as rnd
from .._core.device import default_device
from .._core.dispatch import apply, unwrap
from .._core.op_registry import register_op
from .._core.tensor import Tensor, to_tensor  # noqa: F401 (re-export)
from ._helper import tensor_method

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "diag", "diagflat", "meshgrid", "tril", "triu", "assign",
    "clone", "numel", "rand", "randn", "uniform", "normal",
    "standard_normal", "randint", "randint_like", "randperm", "bernoulli",
    "multinomial", "tril_indices", "triu_indices", "complex",
    "get_default_dtype", "set_default_dtype",
]

_default_dtype = "float32"


def get_default_dtype():
    """The reference's: float32 whatever ``set_default_dtype`` recorded."""
    return "float32"


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = str(d)


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32) -> torch.dtype:
    return default if dtype is None else dtypes.to_torch(dtype)


def _new(name, body, *args, **attrs) -> Tensor:
    """A creation op through the dispatch path (no ``Tensor`` among its
    inputs, so ``apply`` hands back the payload)."""
    return Tensor(apply(name, body, *args, **attrs))


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=default_device()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=default_device()))


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype)


def _scalar_dtype(value) -> torch.dtype:
    if isinstance(value, bool):
        return torch.bool
    return torch.int64 if isinstance(value, int) else torch.float32


@register_op("full_k")
def _full(shape, value, dtype):
    return torch.full(tuple(shape), value, dtype=dtypes.to_torch(dtype),
                      device=default_device())


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    dt = _dt(dtype, _scalar_dtype(fill_value))
    return _new("full_k", _full, shape=_shape(shape), value=fill_value,
                dtype=dtypes.from_torch(dt).name)


def _like(fn, x, dtype, *value):
    t = unwrap(x)
    return Tensor(fn(t, *value, dtype=t.dtype if dtype is None
                     else dtypes.to_torch(dtype)))


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None, name=None) -> Tensor:
    return _like(torch.ones_like, x, dtype)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype)


@register_op("full_like_k")
def _full_like(x, value):
    return torch.full_like(x, value)


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return _like(torch.full_like, x, dtype, fill_value)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    if end is None:
        start, end = 0, start
    bounds = (start, end, step)
    if any(isinstance(v, Tensor) for v in bounds):
        raise TypeError("arange with Tensor bounds: pass python scalars")
    default = torch.int64 if all(isinstance(v, int) for v in bounds) \
        else torch.float32
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype, default),
                               device=default_device()))


@register_op("linspace_k")
def _linspace(start, stop, num, dtype):
    return torch.linspace(start, stop, num, dtype=torch.float64,
                          device=default_device()).to(
        dtypes.to_torch(dtype))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    return _new("linspace_k", _linspace, start=float(start),
                stop=float(stop), num=int(num),
                dtype=dtypes.from_torch(_dt(dtype)).name)


@register_op("logspace_k")
def _logspace(start, stop, num, base, dtype):
    exps = torch.linspace(start, stop, num, dtype=torch.float64,
                          device=default_device())
    return torch.pow(base, exps).to(dtypes.to_torch(dtype))


def logspace(start, stop, num, base=10.0, dtype=None, name=None) -> Tensor:
    return _new("logspace_k", _logspace, start=float(start),
                stop=float(stop), num=int(num), base=float(base),
                dtype=dtypes.from_torch(_dt(dtype)).name)


@register_op("eye_k")
def _eye(n, m, dtype):
    return torch.eye(n, m, dtype=dtypes.to_torch(dtype),
                     device=default_device())


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    return _new("eye_k", _eye, n=int(num_rows),
                m=int(num_rows if num_columns is None else num_columns),
                dtype=dtypes.from_torch(_dt(dtype)).name)


@register_op("diag_")
def _diag(x, offset, padding_value):
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.full((), padding_value,
                                                dtype=out.dtype,
                                                device=out.device))
    return out


@register_op("diagflat_")
def _diagflat(x, offset):
    return torch.diagflat(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    return apply("diag_", _diag, x, offset=int(offset),
                 padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return apply("diagflat_", _diagflat, x, offset=int(offset))


def meshgrid(*args, **kwargs):
    arrays = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(apply("meshgrid", lambda *ts: torch.meshgrid(
        *ts, indexing="ij"), *arrays))


@register_op("tril")
def _tril(x, diagonal):
    return torch.tril(x, diagonal)


@register_op("triu")
def _triu(x, diagonal):
    return torch.triu(x, diagonal)


@tensor_method("tril")
def tril(x, diagonal=0, name=None):
    return apply("tril", _tril, x, diagonal=int(diagonal))


@tensor_method("triu")
def triu(x, diagonal=0, name=None):
    return apply("triu", _triu, x, diagonal=int(diagonal))


@register_op("tril_indices_k")
def _tril_indices(rows, cols, offset):
    return torch.tril_indices(rows, cols, offset, device=default_device())


@register_op("triu_indices_k")
def _triu_indices(rows, cols, offset):
    return torch.triu_indices(rows, cols, offset, device=default_device())


def tril_indices(row, col, offset=0, dtype="int64"):
    out = _new("tril_indices_k", _tril_indices, rows=int(row),
               cols=int(col), offset=int(offset))
    return out if dtype == "int64" else out.astype(dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    out = _new("triu_indices_k", _triu_indices, rows=int(row),
               cols=int(row if col is None else col), offset=int(offset))
    return out if dtype == "int64" else out.astype(dtype)


@register_op("assign")
def _assign(x):
    return x.clone()


@tensor_method("clone")
def assign(x, output=None, name=None):
    if not isinstance(x, (Tensor, torch.Tensor)):
        x = to_tensor(x)
    out = apply("assign", _assign, x)
    return out if output is None else output._adopt(out)


clone = assign


@register_op("numel_k")
def _numel(x):
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def numel(x, name=None):
    return apply("numel_k", _numel, x)


@register_op("complex_make")
def _complex(r, i):
    return torch.complex(r, i)


def complex(real, imag, name=None):
    return apply("complex_make", _complex, real, imag)


# ------------------------------------------------------------------ random

def _gen(device=None):
    return rnd.generator(default_device() if device is None else device)


@register_op("uniform_k")
def _uniform(key, shape, lo, hi):
    u = torch.rand(tuple(shape), generator=key, device=key.device,
                   dtype=torch.float64)
    return u * (hi - lo) + lo


@register_op("gaussian_k")
def _gaussian(key, shape, mean, std, dtype=torch.float64):
    return torch.randn(tuple(shape), generator=key, device=key.device,
                       dtype=dtype) * std + mean


def rand(shape, dtype=None, name=None) -> Tensor:
    gen = _gen()
    return Tensor(torch.rand(_shape(shape), generator=gen, device=gen.device,
                             dtype=_dt(dtype)))


def randn(shape, dtype=None, name=None) -> Tensor:
    return _new("gaussian_k", _gaussian, _gen(), shape=_shape(shape),
                mean=0.0, std=1.0, dtype=_dt(dtype))


standard_normal = randn


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,
            name=None) -> Tensor:
    """``seed`` 0: the device's generator; any other: a generator of its
    own, seeded with it (the same numbers every call)."""
    gen = _gen()
    if seed:
        gen = torch.Generator(device=gen.device).manual_seed(int(seed))
    out = _new("uniform_k", _uniform, gen, shape=_shape(shape),
               lo=float(min), hi=float(max))
    return out if _dt(dtype) == torch.float32 else out.astype(dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        out_shape = torch.broadcast_shapes(
            tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ()))
        ) if shape is None else _shape(shape)
        return Tensor(_gaussian(_gen(), out_shape, 0.0, 1.0) * s + m)
    return _new("gaussian_k", _gaussian, _gen(),
                shape=() if shape is None else _shape(shape),
                mean=float(mean), std=float(std))


@register_op("randint_k")
def _randint(key, low, high, shape):
    return torch.randint(low, high, tuple(shape), generator=key,
                         device=key.device, dtype=torch.int64)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    out = _new("randint_k", _randint, _gen(), low=int(low), high=int(high),
               shape=_shape(shape))
    dt = _dt(dtype, torch.int64)
    return out if dt == torch.int64 else out.astype(dtype)


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    return randint(low, high, x.shape, x.dtype if dtype is None else dtype)


@register_op("randperm_k")
def _randperm(key, n):
    return torch.randperm(n, generator=key, device=key.device)


def randperm(n, dtype="int64", name=None) -> Tensor:
    out = _new("randperm_k", _randperm, _gen(), n=int(n))
    return out if _dt(dtype) == torch.int64 else out.astype(dtype)


@register_op("bernoulli_k")
def _bernoulli(x, key):
    return torch.bernoulli(x.detach(), generator=key)


def bernoulli(x, name=None):
    return apply("bernoulli_k", _bernoulli, x, _gen(unwrap(x).device))


@register_op("multinomial_k")
def _multinomial(x, key, num, replacement):
    return torch.multinomial(x.detach().float(), num, replacement,
                             generator=key)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return apply("multinomial_k", _multinomial, x, _gen(unwrap(x).device),
                 num=int(num_samples), replacement=bool(replacement))


def poisson(x, name=None):
    t = unwrap(x)
    return Tensor(torch.poisson(t.detach(), generator=_gen(t.device)))


def binomial(count, prob, name=None):
    c, p = unwrap(count), unwrap(prob)
    c = c if isinstance(c, torch.Tensor) else torch.full(
        (), float(c), device=default_device())
    p = p if isinstance(p, torch.Tensor) else torch.full(
        (), float(p), device=c.device)
    c, p = torch.broadcast_tensors(c.float(), p.float())
    return Tensor(torch.binomial(c.contiguous(), p.contiguous(),
                                 generator=_gen(c.device)).to(torch.int64))


def standard_gamma(x, name=None):
    t = unwrap(x)
    return Tensor(torch._standard_gamma(t.detach().double(),
                                        generator=_gen(t.device)))


def dirichlet(concentration, name=None):
    t = unwrap(concentration)
    g = torch._standard_gamma(t.detach().double(), generator=_gen(t.device))
    return Tensor(g / g.sum(-1, keepdim=True))


def exponential_(x, lam=1.0, name=None):
    t = unwrap(x)
    sample = torch.empty_like(t, requires_grad=False).exponential_(
        1.0, generator=_gen(t.device)) / lam
    return x._adopt(Tensor(sample))
