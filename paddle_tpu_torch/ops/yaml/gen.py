"""The port's op schema and generator: the counterpart of
``paddle_tpu/ops/yaml/gen.py``, over the port's own copy of the schema
(``ops.yaml`` in this directory) and the port's registry.

- ``load_schema`` reads the schema (a list of flat mappings, each
  ``args:`` spec on one line; ``spmd_rule`` is read and kept);
- ``validate`` cross-checks entries against the live registry: the op is
  registered, its output arity matches ``multi_output``, its tensor args
  fit the body's parameters (a ``Tensor[]`` arg needs ``*args``) and every
  attr is a parameter of the body;
- ``unported`` lists the entries the port does not register yet;
- ``generate_wrappers`` emits the functional wrappers of the registered
  entries (``ops/generated.py``), each a by-name ``call``; an attr with no
  default in the schema is required, never given a made-up one.

Regenerate with ``python -m paddle_tpu_torch.ops.yaml.gen``.
"""
from __future__ import annotations

import inspect
import os
import re
from typing import Dict, List, Optional

_YAML = os.path.join(os.path.dirname(__file__), "ops.yaml")
_GENERATED = os.path.join(os.path.dirname(__file__), os.pardir,
                          "generated.py")

# Tensor: required tensor input; Tensor?: optional (default None);
# Tensor[]: variadic (*args; the last tensor arg); any: an opaque attr
_TYPES = {"Tensor", "Tensor?", "Tensor[]", "bool", "int", "float", "str",
          "int[]", "float[]", "any"}


class OpEntry:
    def __init__(self, name: str):
        self.name = name
        self.tensor_args: List[tuple] = []  # (name, kind: ''|'?'|'[]')
        self.attrs: List[tuple] = []        # (name, type, default or None)
        self.n_outputs = 1
        self.spmd_rule: Optional[str] = None
        self.backward = "auto"
        self.lazy = False

    def __repr__(self):
        return (f"OpEntry({self.name}, tensors={self.tensor_args}, "
                f"attrs={[a[0] for a in self.attrs]}, "
                f"out={self.n_outputs})")


def _split_args(inner: str):
    """Splits on top-level commas only (nested tuple defaults stay
    whole)."""
    pieces, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "," and depth == 0:
            pieces.append(inner[start:i])
            start = i + 1
    pieces.append(inner[start:])
    return pieces


def _parse_args(text: str, entry: OpEntry):
    inner = text.strip()
    if inner.startswith("("):
        inner = inner[1:-1]
    if not inner.strip():
        return
    for piece in _split_args(inner):
        piece = piece.strip()
        m = re.match(r"(\w+)\s*:\s*([\w\[\]\?]+)(?:\s*=\s*(.+))?$", piece)
        if not m:
            raise ValueError(f"ops.yaml: bad arg spec '{piece}' in op "
                             f"{entry.name}")
        arg, ty, default = m.group(1), m.group(2), m.group(3)
        if ty not in _TYPES:
            raise ValueError(f"ops.yaml: unknown type '{ty}' in op "
                             f"{entry.name}")
        if ty.startswith("Tensor"):
            if default is not None:
                raise ValueError(f"ops.yaml: Tensor arg '{arg}' cannot "
                                 f"default")
            if entry.attrs:
                raise ValueError(f"ops.yaml: tensor arg '{arg}' after attrs "
                                 f"in op {entry.name}")
            kind = ty[len("Tensor"):]
            if kind == "[]" and any(k == "[]" for _, k in entry.tensor_args):
                raise ValueError(f"ops.yaml: two variadic tensor args in op "
                                 f"{entry.name}")
            entry.tensor_args.append((arg, kind))
        else:
            entry.attrs.append((arg, ty, default))


def load_schema(path: str = _YAML) -> Dict[str, OpEntry]:
    """The schema's entries by op name, in file order."""
    entries: Dict[str, OpEntry] = {}
    cur: Optional[OpEntry] = None
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"-\s*op\s*:\s*(\w+)\s*(?:#.*)?$", line) \
                if line.startswith("-") else None
            if m:
                cur = OpEntry(m.group(1))
                entries[cur.name] = cur
                continue
            if cur is None:
                raise ValueError(f"ops.yaml:{ln}: key before first op")
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if key == "args":
                _parse_args(val, cur)
            elif key == "output":
                cur.n_outputs = 1 if val == "Tensor" else \
                    len(val.split(","))
            elif key == "spmd_rule":
                cur.spmd_rule = val
            elif key == "backward":
                cur.backward = val
            elif key == "lazy":
                cur.lazy = val.lower() == "true"
            else:
                raise ValueError(f"ops.yaml:{ln}: unknown key '{key}'")
    return entries


def _registry():
    import paddle_tpu_torch  # noqa: F401  (registers every op)
    from ..._core.op_registry import _OPS
    return _OPS


def validate(entries: Optional[Dict[str, OpEntry]] = None) -> List[str]:
    """Problems of ``entries`` (the whole schema's registered entries when
    None) against the live registry; empty when they agree."""
    ops = _registry()
    if entries is None:
        entries = {n: e for n, e in load_schema().items() if n in ops}
    problems = []
    for e in entries.values():
        op = ops.get(e.name)
        if op is None:
            problems.append(f"{e.name}: not in the port's registry")
            continue
        if bool(op.multi_output) != (e.n_outputs > 1):
            problems.append(f"{e.name}: multi_output mismatch (yaml "
                            f"{e.n_outputs} outputs, registry "
                            f"multi_output={op.multi_output})")
        try:
            params = inspect.signature(op.fn).parameters
        except (TypeError, ValueError):  # a builtin body: nothing to read
            continue
        names = [p for p in params if not p.startswith("_")]
        varargs = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                      for p in params.values())
        n_fixed = sum(1 for _, k in e.tensor_args if k != "[]")
        if n_fixed > len(names) and not varargs:
            problems.append(f"{e.name}: {n_fixed} tensor args but the body "
                            f"takes {len(names)} params")
        if any(k == "[]" for _, k in e.tensor_args) and not varargs:
            problems.append(f"{e.name}: variadic Tensor[] arg but the body "
                            f"has no *args")
        for a, _, _ in e.attrs:
            if a not in names:
                problems.append(f"{e.name}: attr '{a}' is not a parameter "
                                f"of the body ({names})")
    return problems


def unported(entries: Optional[Dict[str, OpEntry]] = None) -> List[str]:
    """The schema's entries the port does not register, in file order."""
    ops = _registry()
    entries = entries if entries is not None else load_schema()
    return [n for n in entries if n not in ops]


def generate_wrappers(entries: Optional[Dict[str, OpEntry]] = None) -> str:
    """Python source of the functional wrappers of the registered entries:
    the declared signature (attrs keyword-only), body ``call(op, ...)``."""
    ops = _registry()
    entries = entries if entries is not None else load_schema()
    lines = ['"""AUTO-GENERATED by paddle_tpu_torch.ops.yaml.gen from '
             'ops.yaml: do not',
             'edit. Regenerate with python -m paddle_tpu_torch.ops.yaml.gen.'
             '"""',
             "from .._core.op_registry import call",
             "",
             "# the default of a required tensor arg that follows an "
             "optional one",
             "_REQUIRED = object()",
             "", ""]

    def pydefault(ty, d):
        if d is None:
            return None
        if ty == "str":
            return repr(d.strip("'\""))
        return {"false": "False", "true": "True"}.get(d, d)

    for e in entries.values():
        if e.name not in ops:
            continue
        attr_params = []
        for a, ty, d in e.attrs:
            pd = pydefault(ty, d)
            attr_params.append(a if pd is None else f"{a}={pd}")
        params, call_args, required = [], [], []
        seen_opt = False
        for t, kind in e.tensor_args:
            if kind == "?":
                params.append(f"{t}=None")
                seen_opt = True
            elif kind == "[]":
                params.append(f"*{t}")
            elif seen_opt:
                params.append(f"{t}=_REQUIRED")
                required.append(t)
            else:
                params.append(t)
            call_args.append(f"*{t}" if kind == "[]" else t)
        variadic = any(k == "[]" for _, k in e.tensor_args)
        if attr_params:
            params += ([] if variadic else ["*"]) + attr_params
        params.append("name=None")
        kwargs = ", ".join(f"{a}={a}" for a, _, _ in e.attrs)
        inner = ", ".join(p for p in (", ".join(call_args), kwargs) if p)
        head = f"'{e.name}', {inner}" if inner else f"'{e.name}'"
        lines.append(f"def {e.name}({', '.join(params)}):")
        lines.append(f'    """Generated from ops.yaml (op: {e.name})."""')
        for t in required:
            lines.append(f"    if {t} is _REQUIRED:")
            lines.append(f"        raise TypeError(\"{e.name}() missing "
                         f"required argument: '{t}'\")")
        lines += [f"    return call({head})", "", ""]
    return "\n".join(lines).rstrip("\n") + "\n"


def write_generated(path: str = _GENERATED) -> str:
    problems = validate()
    if problems:
        raise ValueError("ops.yaml disagrees with the registry:\n  "
                         + "\n  ".join(problems))
    with open(path, "w") as f:
        f.write(generate_wrappers())
    return os.path.abspath(path)


if __name__ == "__main__":
    print(f"wrote {write_generated()}")
