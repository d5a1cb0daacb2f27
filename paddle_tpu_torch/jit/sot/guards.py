"""Value sources and guards: the counterpart of
``paddle_tpu/jit/sot/guards.py`` (the reference Paddle's
jit/sot/.../guard.py).

A Source describes HOW the captured execution obtained a Python value
from the call's roots (positional/keyword args, the function's globals,
its closure) so the value can be re-fetched and re-checked on a later
call. A Guard pairs a source with an expected observation; a capture's
fast path is valid only while every guard still holds.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as _np


class Source:
    __slots__ = ("kind", "parent", "key")

    def __init__(self, kind: str, parent: Optional["Source"], key):
        self.kind = kind        # arg|kwarg|global|closure|attr|item
        self.parent = parent
        self.key = key

    def evaluate(self, fn, args, kwargs):
        if self.kind == "arg":
            return args[self.key]
        if self.kind == "kwarg":
            return kwargs[self.key]
        if self.kind == "global":
            return _global_of(fn, self.key)
        if self.kind == "closure":
            idx = fn.__code__.co_freevars.index(self.key)
            return fn.__closure__[idx].cell_contents
        base = self.parent.evaluate(fn, args, kwargs)
        if self.kind == "attr":
            return getattr(base, self.key)
        if self.kind == "item":
            return base[self.key]
        if self.kind == "global2":     # global of an inlined function
            return _global_of(base, self.key)
        if self.kind == "closure2":    # closure cell of an inlined function
            idx = base.__code__.co_freevars.index(self.key)
            return base.__closure__[idx].cell_contents
        raise KeyError(self.kind)

    def __repr__(self):
        if self.parent is None:
            return f"{self.kind}[{self.key!r}]"
        return f"{self.parent!r}.{self.key}" if self.kind == "attr" \
            else f"{self.parent!r}[{self.key!r}]"


def _global_of(fn, name):
    import builtins
    g = fn.__globals__
    if name in g:
        return g[name]
    b = g.get("__builtins__", builtins)
    bd = b if isinstance(b, dict) else vars(b)
    return bd[name]


class Guard:
    __slots__ = ("source", "kind", "expected")

    def __init__(self, source: Source, kind: str, expected):
        self.source = source
        self.kind = kind        # value|id|tensor_meta|none
        self.expected = expected

    def key(self) -> Tuple[str, str]:
        """(source, kind) identity — two guards with the same key
        constrain the same observation, so differing `expected` values
        are mutually exclusive."""
        return (repr(self.source), self.kind)

    def same_constraint(self, other: "Guard") -> bool:
        """Byte-identical constraint (key + expected)."""
        if self.key() != other.key():
            return False
        return values_equal(self.expected, other.expected) \
            if type(self.expected) is type(other.expected) else False

    def check(self, fn, args, kwargs) -> bool:
        if self.kind == "sig":
            # call-binding shape: positional count + kwarg names. Params
            # filled from defaults are unguarded values, so a different
            # binding shape must force a recapture.
            return (len(args), tuple(sorted(kwargs))) == self.expected
        try:
            v = self.source.evaluate(fn, args, kwargs)
        except Exception:
            return False
        if self.kind == "value":
            return type(v) is self.expected[0] \
                and values_equal(v, self.expected[1])
        if self.kind == "id":
            return id(v) == self.expected
        if self.kind == "none":
            return (v is None) == self.expected
        if self.kind == "len":
            try:
                return len(v) == self.expected
            except TypeError:
                return False
        if self.kind == "tensor_meta":
            from ..._core.tensor import Tensor
            if not isinstance(v, Tensor):
                return False
            return (tuple(v.shape), str(v.dtype),
                    v.stop_gradient) == self.expected
        return False

    def __repr__(self):
        return f"Guard({self.source!r} {self.kind} {self.expected!r})"


class GuardSet:
    """Deduplicated guard list for one capture."""

    def __init__(self):
        self._guards: List[Guard] = []
        self._seen = set()

    def add(self, source: Source, kind: str, expected):
        try:
            key = (repr(source), kind, hash(expected), expected)
        except TypeError:
            key = (repr(source), kind, repr(expected))
        if key in self._seen:
            return
        self._seen.add(key)
        self._guards.append(Guard(source, kind, expected))

    def add_value(self, source: Source, value):
        if value is None:
            self.add(source, "none", True)
        else:
            self.add(source, "value", (type(value), _snapshot(value)))

    def check_all(self, fn, args, kwargs) -> bool:
        return all(g.check(fn, args, kwargs) for g in self._guards)

    # ------------------------------------------------------ introspection
    def by_key(self) -> dict:
        """{(source_repr, kind): [Guard, ...]} — more than one guard
        under a key means the set over-constrains one observation;
        differing expectations make the whole set unsatisfiable."""
        out: dict = {}
        for g in self._guards:
            out.setdefault(g.key(), []).append(g)
        return out

    def subsumes(self, other: "GuardSet") -> bool:
        """True when every guard in `self` also appears (same source,
        kind, AND expected) in `other`: any call that satisfies `other`
        satisfies `self`, so in a first-match-wins cache an earlier
        `self` makes a later `other` unreachable."""
        for g in self._guards:
            if not any(g.same_constraint(o) for o in other._guards):
                return False
        return True

    def __len__(self):
        return len(self._guards)

    def __iter__(self):
        return iter(self._guards)


GUARDABLE_VALUE_TYPES = (bool, int, float, str, bytes, type(None))

def _size_cap() -> int:
    # containers/arrays are value-guarded only up to this size; beyond
    # it the per-call compare cost outweighs the fast path
    from ..._core.flags import flag_value
    return flag_value("FLAGS_sot_guard_size_cap")


def is_guardable_value(v, _depth=0) -> bool:
    if isinstance(v, GUARDABLE_VALUE_TYPES):
        return True
    if _depth > 4:
        return False
    if isinstance(v, (tuple, list)):
        return len(v) <= _size_cap() and all(
            is_guardable_value(x, _depth + 1) for x in v)
    if isinstance(v, dict):
        return len(v) <= _size_cap() and all(
            isinstance(k, GUARDABLE_VALUE_TYPES)
            and is_guardable_value(x, _depth + 1) for k, x in v.items())
    if _np is not None and isinstance(v, _np.ndarray):
        return v.size <= 4 * _size_cap()
    return False


def _snapshot(v):
    """Copy mutable guardable values so later in-place mutation cannot
    make the guard compare a value against itself."""
    if isinstance(v, GUARDABLE_VALUE_TYPES):
        return v
    import copy
    return copy.deepcopy(v)


def values_equal(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if _np is not None and isinstance(a, _np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype \
            and bool(_np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            values_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            values_equal(a[k], b[k]) for k in a)
    return a == b
