"""Dynamic-to-static control-flow conversion (dy2static): the counterpart
of ``paddle_tpu/jit/dy2static.py``.

``ast_transform(fn)`` rewrites ``if``/``while`` statements into calls to
``convert_ifelse``/``convert_while_loop``; those decide at run time whether
the predicate is a traced tensor (a fake tensor of the ``to_static`` trace:
``torch.cond`` / the ``while_loop`` higher-order op, so both branches live
in the traced graph) or a plain Python value (run the branch directly), the
same always-rewrite / runtime-dispatch design the reference uses.

Supported surface: ``if``/``elif``/``else``, ``while``, ``for`` over
``range(...)`` / tensors / sequences (desugared to ``while``), and
``return`` / ``break`` / ``continue`` inside converted blocks via the
reference's flag-and-guard rewrites: the statement becomes a flag
assignment, every following statement is guarded on the flag, and loop
conditions are augmented with it.

The higher-order ops take their operands explicitly, where ``lax.cond``
takes closures: each branch, loop condition and loop body is first run
once on the fake tensors with tracing off (the ``jax.eval_shape`` role),
which gives its output types and the traced tensors it reads from outside
its operands; those are passed as operands too. A traced ``while`` is
forward-only, as the reference's ``lax.while_loop`` is.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Callable

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op
from torch._subclasses.fake_tensor import FakeTensor
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .._core.tensor import Tensor


# ------------------------------------------------------------- runtime ops
def _raw(x):
    return x._t if isinstance(x, Tensor) else x


def _is_traced(x) -> bool:
    return isinstance(_raw(x), FakeTensor)


def _is_tensor(x) -> bool:
    return isinstance(x, (Tensor, torch.Tensor))


class _Undefined:
    """Placeholder for names not yet bound before a converted block
    (the reference's UndefinedVar)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<dy2static undefined>"


UNDEF = _Undefined()


def _raw_tree(o):
    """Unwrap Tensors inside containers (tuple returns etc.)."""
    return pytree.tree_map(_raw, o, is_leaf=lambda v: isinstance(v, Tensor))


def _wrap_tree_out(o):
    return pytree.tree_map(
        lambda v: Tensor(v) if isinstance(v, torch.Tensor) else v, o)


class _Reads(TorchDispatchMode):
    """Records the tensors an op reads that no op under this mode made (a
    nested ``cond`` or ``while_loop`` reads its operands, which hold what
    its branches read)."""

    supports_higher_order_operators = True

    def __init__(self):
        super().__init__()
        self.made, self.read = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and id(t) not in self.made:
                self.read[id(t)] = t
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made[id(t)] = t
        return out


def _dry_run(fns, operands):
    """Runs each of ``fns`` on ``operands`` with tracing off (fake tensors
    in, fake tensors out, nothing recorded). Returns their outputs and the
    traced tensors they read besides the operands (in first-read order)."""
    own = {id(o) for o in operands}
    outs, free = [], {}
    for fn in fns:
        with disable_proxy_modes_tracing(), _Reads() as reads:
            out = fn(*operands)
        outs.append(out)
        # a tensor it returns as it found it is read too
        passed = {id(t): t for t in pytree.tree_leaves(out)
                  if isinstance(t, torch.Tensor) and id(t) not in reads.made}
        for i, t in {**reads.read, **passed}.items():
            if i not in own and isinstance(t, FakeTensor):
                free.setdefault(i, t)
    return outs, list(free.values())


def _fresh(outs, operands):
    """The higher-order ops take no output that aliases an operand: such an
    output (a value a branch or body passed through unchanged, or a view of
    one) is copied."""
    own = {id(o) for o in operands}
    return tuple(o.clone() if isinstance(o, torch.Tensor) and (
        id(o) in own or o._base is not None) else o for o in outs)


def _scalar_tensor(v, like=None, device=None):
    """A Python scalar as a tensor: ``like``'s shape and type where given,
    else a 0-d tensor of the scalar's own kind."""
    if like is not None:
        return torch.full(like.shape, v, dtype=like.dtype, device=like.device)
    dtype = torch.bool if isinstance(v, bool) else \
        torch.int64 if isinstance(v, int) else torch.float32
    # torch.full, not torch.tensor: a traced constant tensor would be a
    # buffer of the branch graph, and a branch may not return one
    return torch.full((), v, dtype=dtype, device=device)


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, vars_,
                   both_assigned=None, names=None):
    """Reference convert_operators.convert_ifelse: traced predicate ->
    ``torch.cond`` over functionalized branches; Python bool -> direct
    call. ``both_assigned[i]`` (from static analysis) marks vars bound by
    BOTH branches; vars unbound before the if and bound in only one branch
    are branch-local — they are dropped from the compiled conditional's
    outputs and stay undefined afterwards. ``names`` lets the output
    coercion distinguish synthesized guard slots (__dy2st_*) from user
    variables."""
    if not _is_traced(pred):
        return true_fn(vars_) if bool(_raw(pred)) else false_fn(vars_)

    n = len(vars_)
    both = both_assigned or (True,) * n
    names = names or ("",) * n
    device = _raw(pred).device
    # slots that survive the conditional: defined before it, or bound by
    # both branches
    keep = [i for i in range(n) if vars_[i] is not UNDEF or both[i]]
    slots = [i for i in range(n) if _is_tensor(vars_[i])]

    def _wrap(fn):
        def f(*ops):
            full = list(vars_)
            for i, o in zip(slots, ops):
                full[i] = Tensor(o)
            out = fn(tuple(full))
            res = []
            for i in keep:
                if out[i] is UNDEF:
                    raise RuntimeError(
                        "dy2static: a result of a tensor-dependent if "
                        "is bound in only one branch; both branches of "
                        "a compiled conditional must produce it")
                res.append(_raw_tree(out[i]))
            return res
        return f

    # non-tensor locals (None, lists, ...) pass through by closure; if a
    # branch rebinds them to tensors they become cond outputs
    operands = [_raw(vars_[i]) for i in slots]
    tf, ff = _wrap(true_fn), _wrap(false_fn)
    (t_out, f_out), free = _dry_run((tf, ff), operands)
    keep_names = [names[i] if i < len(names) else "" for i in keep]
    tf, ff, trees = _coerce_branch_outputs(tf, ff, t_out, f_out, keep_names,
                                           device)
    leaves = iter(_cond(_raw(pred), tf, ff, tuple(operands + free)))
    full = [UNDEF] * n
    for i, tree in zip(keep, trees):
        full[i] = _wrap_tree_out(pytree.tree_unflatten(
            [next(leaves) for _ in range(tree.num_leaves)], tree))
    return tuple(full)


def _cond(pred, tf, ff, operands):
    """``cond_op`` of branches returning flat tuples of tensors, as one
    conditional for the floating outputs and one for the others: the
    conditional's backward is built for one kind of output at a time."""
    (flat,), _ = _dry_run((tf,), operands)
    floating = [i for i, t in enumerate(flat) if t.is_floating_point()]
    kinds = [k for k in (floating, [i for i in range(len(flat))
                                    if i not in floating]) if k]

    def pick(fn, idx):
        return lambda *ops: tuple(fn(*ops)[i] for i in idx)

    out = [None] * len(flat)
    for idx in kinds:
        for i, o in zip(idx, cond_op(pred, pick(tf, idx), pick(ff, idx),
                                     operands)):
            out[i] = o
    return out


def _tensor_leaves(o):
    return [x for x in pytree.tree_leaves(o) if isinstance(x, torch.Tensor)]


def _coerce_branch_outputs(tf, ff, t_out, f_out, names, device):
    """``torch.cond`` needs both branches to yield tensors of the same
    types. A Python scalar becomes a tensor (of the other side's type where
    that side has a tensor). SYNTHESIZED guard slots (__dy2st_ret/
    __dy2st_val/...) may be bound to a tensor in only one branch — those
    slots are flag-guarded, their value in the untaken branch is never
    read, so a None there becomes zeros of the other side's type. A USER
    variable with that mismatch is a real semantic divergence and raises a
    clear error instead of silently changing None to zeros. Returns the
    fixed branches and each slot's tree."""
    specs, trees = [], []
    for i, (a, b) in enumerate(zip(t_out, f_out)):
        la, lb = _tensor_leaves(a), _tensor_leaves(b)
        side = b if lb and not la else a
        if bool(la) != bool(lb) and (a is None or b is None) \
                and not names[i].startswith("__dy2st_"):
            raise RuntimeError(
                f"dy2static: variable '{names[i]}' is bound to a tensor "
                "in only one branch of a tensor-dependent if; both "
                "branches of a compiled conditional must bind it to "
                "compatible values (bind a same-shaped tensor in the "
                "other branch, or branch on a Python condition)")
        specs.append(pytree.tree_leaves(side) if (la or lb) else None)
        trees.append(pytree.tree_structure(side))

    def fix(fn):
        def f(*ops):
            flat = []
            for o, spec in zip(fn(*ops), specs):
                if spec is not None and o is None:
                    flat += [torch.zeros(s.shape, dtype=s.dtype,
                                         device=s.device) for s in spec]
                    continue
                got = pytree.tree_leaves(o)
                like = spec or [None] * len(got)
                flat += [v if isinstance(v, torch.Tensor)
                         else _scalar_tensor(v, s, device)
                         for v, s in zip(got, like)]
            return _fresh(flat, ops)
        return f

    return fix(tf), fix(ff), trees


def convert_while_loop(cond_fn: Callable, body_fn: Callable, vars_):
    """Traced condition -> the ``while_loop`` higher-order op (forward-only,
    like the reference's while_op); Python condition -> plain loop. A loop
    may START Python (e.g. static trip count) and turn traced mid-flight
    when a break/return flag becomes a cond output — the eager loop
    re-checks and hands the current state to the traced loop."""
    while True:
        c = cond_fn(vars_)
        if _is_traced(c):
            break
        if not bool(_raw(c)):
            return vars_
        vars_ = body_fn(vars_)

    if any(v is UNDEF for v in vars_):
        raise RuntimeError(
            "dy2static: a variable mutated by a tensor-dependent while "
            "is not defined before the loop")
    device = _raw(c).device
    carry = [_raw(v) if _is_tensor(v) else _scalar_tensor(v, device=device)
             for v in vars_]
    n = len(carry)

    def _cond(*raw_vars):
        return _raw(cond_fn(tuple(Tensor(v) for v in raw_vars[:n])))

    def _body(*raw_vars):
        outs = body_fn(tuple(Tensor(v) for v in raw_vars[:n]))
        return _fresh([_raw(o) if _is_tensor(o) else _scalar_tensor(o, like)
                       for o, like in zip(outs, carry)], raw_vars)

    _, free = _dry_run((_cond, _body), carry)
    outs = while_loop_op(_cond, _body, tuple(carry), tuple(free))
    return tuple(Tensor(o) for o in outs)


def convert_not(x):
    """Boolean not over Tensor or Python value (the guard flags flow
    through here when traced)."""
    if _is_tensor(x):
        return Tensor(torch.logical_not(_raw(x)))
    return not x


def convert_materialize(x):
    """Iterables without len()/indexing (enumerate, zip, generators,
    dict views) are materialized to a list so the index-based desugar
    can drive them; sized+indexable objects and tensors pass through."""
    if _is_tensor(x):
        return x
    if hasattr(x, "__len__") and hasattr(x, "__getitem__"):
        return x
    return list(x)


def convert_len(x):
    """len() for the for-loop desugar: Tensor -> leading dim (a static
    Python int, so the loop unrolls under trace); sequences -> len()."""
    if _is_tensor(x):
        return x.shape[0]
    return len(x)


def convert_index(x, i):
    """x[i] with a possibly-traced index."""
    if _is_tensor(x):
        idx = _raw(i)
        if isinstance(idx, torch.Tensor):
            out = torch.index_select(_raw(x), 0, idx.reshape(1).long())[0]
        else:
            out = _raw(x)[int(idx)]
        return Tensor(out) if isinstance(x, Tensor) else out
    if _is_traced(i):
        raise NotImplementedError(
            "dy2static: tensor-dependent index into a Python sequence")
    return x[int(_raw(i))]


def convert_range_len(start, stop, step):
    """Trip count of range(start, stop, step) over Tensors or ints
    (tensor stop -> traced count -> while_loop)."""
    if any(_is_tensor(v) for v in (start, stop, step)):
        s0, s1, st = (_raw(v) for v in (start, stop, step))
        st_t = torch.as_tensor(st)
        n = (s1 - s0 + st + torch.where(st_t > 0, -1, 1)) // st
        return Tensor(torch.clamp(torch.as_tensor(n), min=0))
    return max((stop - start + step + (-1 if step > 0 else 1)) // step, 0)


def convert_range_item(start, step, i):
    out = _raw(start) + _raw(i) * _raw(step)
    return Tensor(out) if _is_traced(i) or isinstance(i, Tensor) else out


def _operand(b, a):
    """``b`` as a tensor beside the traced ``a``."""
    b = _raw(b)
    return b if isinstance(b, torch.Tensor) else \
        _scalar_tensor(b, device=_raw(a).device)


def convert_logical_and(a_fn, b_fn):
    a = a_fn()
    if _is_traced(a):
        return Tensor(torch.logical_and(_raw(a), _operand(b_fn(), a)))
    return b_fn() if bool(_raw(a)) else a


def convert_logical_or(a_fn, b_fn):
    a = a_fn()
    if _is_traced(a):
        return Tensor(torch.logical_or(_raw(a), _operand(b_fn(), a)))
    return a if bool(_raw(a)) else b_fn()


# ------------------------------------------------- flag/guard AST helpers

def _name_load(n):
    return ast.Name(id=n, ctx=ast.Load())


def _name_store(n):
    return ast.Name(id=n, ctx=ast.Store())


def _assign(name, value):
    return ast.Assign(targets=[_name_store(name)], value=value)


def _call(fn_name, *args):
    return ast.Call(func=_name_load(fn_name), args=list(args),
                    keywords=[])


def _lambda0(expr):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]),
        body=expr)


def _sets_any(stmt, names) -> bool:
    """Does stmt (recursively, skipping nested defs) bind any of names?"""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                and node.id in names:
            return True
    return False


def _guard_rest(stmts, flag_names, process=None):
    """The reference's guard rewrite: after any statement that may set
    an exit flag, wrap the remaining statements of the block in
    ``if __dy2st_not(flag_or): ...`` so they are skipped once the flag
    fires (return_transformer / break_continue_transformer)."""
    process = process or (lambda s: s)
    out = []
    for idx, s in enumerate(stmts):
        s2 = process(s)
        items = s2 if isinstance(s2, list) else [s2]
        out.extend(items)
        if any(_sets_any(it, flag_names) for it in items) \
                and idx + 1 < len(stmts):
            rest = _guard_rest(stmts[idx + 1:], flag_names, process)
            test = _flag_clear_test(flag_names)
            out.append(ast.If(test=test, body=rest, orelse=[]))
            break
    return out


def _flag_clear_test(flag_names):
    """__dy2st_not(f1) [and __dy2st_not(f2)] as a convert-aware expr."""
    names = sorted(flag_names)
    test = _call("__dy2st_not", _name_load(names[0]))
    for n in names[1:]:
        test = _call("__dy2st_convert_and", _lambda0(test),
                     _lambda0(_call("__dy2st_not", _name_load(n))))
    return test


class _ForToWhile(ast.NodeTransformer):
    """Desugar ``for`` into index-based ``while`` (the reference's loop
    transformer): range() iterates by start/step arithmetic, tensors and
    sequences by convert_index. A Python-int trip count unrolls under
    trace; a traced count becomes a while_loop via convert_while."""

    def __init__(self):
        self._n = 0

    def visit_FunctionDef(self, node):
        if getattr(node, "_dy2st_root", False):
            return self.generic_visit(node)
        return node  # don't descend into nested defs

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = lambda self, node: node  # noqa: E731

    def visit_For(self, node):
        node = self.generic_visit(node)
        if node.orelse:
            raise NotImplementedError("dy2static: for/else unsupported")
        self._n += 1
        k = self._n
        i_v, n_v, it_v = (f"__dy2st_i_{k}", f"__dy2st_n_{k}",
                          f"__dy2st_it_{k}")
        pre = []
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range")
        if is_range:
            rargs = node.iter.args
            start = rargs[0] if len(rargs) > 1 else ast.Constant(value=0)
            stop = rargs[1] if len(rargs) > 1 else rargs[0]
            step = rargs[2] if len(rargs) > 2 else ast.Constant(value=1)
            st_v, sp_v = f"__dy2st_start_{k}", f"__dy2st_step_{k}"
            pre += [_assign(st_v, start), _assign(sp_v, step),
                    _assign(n_v, _call("__dy2st_range_len",
                                       _name_load(st_v), stop,
                                       _name_load(sp_v)))]
            item = _call("__dy2st_range_item", _name_load(st_v),
                         _name_load(sp_v), _name_load(i_v))
        else:
            pre += [_assign(it_v, _call("__dy2st_materialize",
                                        node.iter)),
                    _assign(n_v, _call("__dy2st_len", _name_load(it_v)))]
            item = _call("__dy2st_index", _name_load(it_v),
                         _name_load(i_v))
        pre.append(_assign(i_v, ast.Constant(value=0)))
        bind = ast.Assign(targets=[node.target], value=item)
        bump = _assign(i_v, ast.BinOp(left=_name_load(i_v),
                                      op=ast.Add(),
                                      right=ast.Constant(value=1)))
        # bump BEFORE the user body: a `continue` guard must skip the
        # body's tail, never the index advance (else: infinite loop)
        loop = ast.While(
            test=ast.Compare(left=_name_load(i_v), ops=[ast.Lt()],
                             comparators=[_name_load(n_v)]),
            body=[bind, bump] + list(node.body),
            orelse=[])
        return pre + [loop]


def _always_returns(stmts) -> bool:
    """Conservative: every path through stmts ends in return."""
    for s in stmts:
        if isinstance(s, ast.Return):
            return True
        if isinstance(s, ast.If) and s.orelse \
                and _always_returns(s.body) \
                and _always_returns(s.orelse):
            return True
    return False


def _absorb_after_return(stmts):
    """Move the statements FOLLOWING an always-returning ``if`` into its
    ``else`` (the reference's early-return restructure): afterwards both
    branches bind the return value, so the flag transform produces a
    torch.cond whose branches agree."""
    out = []
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.If):
            s.body = _absorb_after_return(s.body)
            s.orelse = _absorb_after_return(s.orelse)
            rest = stmts[idx + 1:]
            if rest and _always_returns(s.body):
                s.orelse = _absorb_after_return(
                    list(s.orelse) + [r for r in rest])
                out.append(s)
                return out
        elif isinstance(s, ast.While):
            s.body = _absorb_after_return(s.body)
        out.append(s)
    return out


class _ReturnTransformer(ast.NodeTransformer):
    """``return X`` anywhere inside control flow becomes
    ``__dy2st_ret = True; __dy2st_val = X`` with every following
    statement guarded and loop conditions augmented — the reference's
    return_transformer."""

    FLAG, VAL = "__dy2st_ret", "__dy2st_val"

    def run(self, fdef):
        has_inner_return = any(
            isinstance(n, ast.Return)
            for stmt in fdef.body
            if isinstance(stmt, (ast.If, ast.While, ast.For))
            for n in ast.walk(stmt))
        if not has_inner_return:
            return fdef
        body = self._block(_absorb_after_return(fdef.body))
        fdef.body = [
            _assign(self.FLAG, ast.Constant(value=False)),
            _assign(self.VAL, ast.Constant(value=None)),
        ] + body + [ast.Return(value=_name_load(self.VAL))]
        return fdef

    def _block(self, stmts):
        return _guard_rest(stmts, {self.FLAG}, self._stmt)

    def _stmt(self, s):
        if isinstance(s, ast.Return):
            return [_assign(self.FLAG, ast.Constant(value=True)),
                    _assign(self.VAL, s.value or ast.Constant(value=None))]
        if isinstance(s, ast.If):
            s.body = self._block(s.body)
            s.orelse = self._block(s.orelse)
            return s
        if isinstance(s, ast.While):
            s.body = self._block(s.body)
            if any(_sets_any(b, {self.FLAG}) for b in s.body):
                s.test = _call("__dy2st_convert_and",
                               _lambda0(_call("__dy2st_not",
                                              _name_load(self.FLAG))),
                               _lambda0(s.test))
            return s
        return s


class _BreakContinueTransformer(ast.NodeTransformer):
    """``break``/``continue`` become per-loop flags with guarded tails;
    ``break`` also augments the loop condition — the reference's
    break_continue_transformer."""

    def __init__(self):
        self._n = 0

    def visit_FunctionDef(self, node):
        if getattr(node, "_dy2st_root", False):
            return self.generic_visit(node)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = lambda self, node: node  # noqa: E731

    def visit_While(self, node):
        # inner loops first so each break binds to ITS loop
        node = self.generic_visit(node)
        has_brk = self._has(node.body, ast.Break)
        has_cnt = self._has(node.body, ast.Continue)
        if not (has_brk or has_cnt):
            return node
        self._n += 1
        brk = f"__dy2st_brk_{self._n}"
        cnt = f"__dy2st_cnt_{self._n}"
        flags = set()
        if has_brk:
            flags.add(brk)
        if has_cnt:
            flags.add(cnt)

        def repl(s):
            if isinstance(s, ast.Break):
                return [_assign(brk, ast.Constant(value=True))]
            if isinstance(s, ast.Continue):
                return [_assign(cnt, ast.Constant(value=True))]
            if isinstance(s, ast.If):
                s.body = _guard_rest(s.body, flags, repl)
                s.orelse = _guard_rest(s.orelse, flags, repl)
                return s
            return s

        body = _guard_rest(node.body, flags, repl)
        pre = []
        if has_cnt:
            body = [_assign(cnt, ast.Constant(value=False))] + body
            # also bind before the loop: every name a tensor-dependent
            # while mutates must exist at loop entry
            pre.append(_assign(cnt, ast.Constant(value=False)))
        if has_brk:
            pre.append(_assign(brk, ast.Constant(value=False)))
            node.test = _call("__dy2st_convert_and",
                              _lambda0(_call("__dy2st_not",
                                             _name_load(brk))),
                              _lambda0(node.test))
        node.body = body
        return pre + [node] if pre else node

    @staticmethod
    def _has(stmts, kind):
        for s in stmts:
            for n in ast.walk(s):
                if isinstance(n, kind):
                    # don't count nested loops' breaks (generic_visit
                    # already rewrote them) or nested defs
                    return True
        return False


# --------------------------------------------------------- AST transformer
class _AssignedNames(ast.NodeVisitor):
    def __init__(self):
        self.names = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name):
            self.names.add(node.target.id)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        pass  # do not descend into nested defs


def _assigned(stmts) -> set:
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


class _Unsupported(ast.NodeVisitor):
    def __init__(self):
        self.found = None

    def visit_FunctionDef(self, node):
        pass  # synthetic branch fns from inner conversions contain Return

    def visit_AsyncFunctionDef(self, node):
        pass

    def generic_visit(self, node):
        if isinstance(node, (ast.Return, ast.Break, ast.Continue)):
            self.found = type(node).__name__
        super().generic_visit(node)


def _check_supported(stmts, kind):
    v = _Unsupported()
    for s in stmts:
        v.visit(s)
    if v.found:
        raise NotImplementedError(
            f"dy2static: '{v.found.lower()}' inside this converted "
            f"{kind} block could not be rewritten by the return/break/"
            "continue transformers (it sits in a nesting they do not "
            "reach, e.g. try/with); restructure so the block only "
            "assigns variables")


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrite if/while into convert_ifelse/convert_while_loop calls."""

    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    def _make_branch_fn(self, name, body, var_names):
        """def name(__dy2st_vars): (v1, ..) = __dy2st_vars; BODY;
        return (v1, ...)"""
        arg = ast.arg(arg="__dy2st_vars")
        unpack = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store())
                      for v in var_names],
                ctx=ast.Store())],
            value=ast.Name(id="__dy2st_vars", ctx=ast.Load()))
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=v, ctx=ast.Load()) for v in var_names],
            ctx=ast.Load()))
        return ast.FunctionDef(
            name=name,
            args=ast.arguments(posonlyargs=[], args=[arg], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=[unpack] + body + [ret],
            decorator_list=[])

    @staticmethod
    def _guard_inits(var_names):
        """try: v / except NameError: v = UNDEF — lets branch-local
        names flow through the functionalized call."""
        out = []
        for v in var_names:
            out.append(ast.Try(
                body=[ast.Expr(value=ast.Name(id=v, ctx=ast.Load()))],
                handlers=[ast.ExceptHandler(
                    type=ast.Name(id="NameError", ctx=ast.Load()),
                    name=None,
                    body=[ast.Assign(
                        targets=[ast.Name(id=v, ctx=ast.Store())],
                        value=ast.Name(id="__dy2st_UNDEF",
                                       ctx=ast.Load()))])],
                orelse=[], finalbody=[]))
        return out

    @staticmethod
    def _cleanup(var_names):
        """if v is UNDEF: del v — restore NameError semantics for names
        the taken branch did not bind."""
        out = []
        for v in var_names:
            out.append(ast.If(
                test=ast.Compare(
                    left=ast.Name(id=v, ctx=ast.Load()),
                    ops=[ast.Is()],
                    comparators=[ast.Name(id="__dy2st_UNDEF",
                                          ctx=ast.Load())]),
                body=[ast.Delete(targets=[
                    ast.Name(id=v, ctx=ast.Del())])],
                orelse=[]))
        return out

    def visit_If(self, node):
        node = self.generic_visit(node)
        _check_supported(node.body + node.orelse, "if")
        uid = self._uid()
        body_set = _assigned(node.body)
        else_set = _assigned(node.orelse)
        var_names = sorted(body_set | else_set)
        both_mask = [v in body_set and v in else_set for v in var_names]
        if not var_names:
            var_names = ["__dy2st_dummy"]
            init = [ast.Assign(
                targets=[ast.Name(id="__dy2st_dummy", ctx=ast.Store())],
                value=ast.Constant(value=0))]
        else:
            init = self._guard_inits(var_names)
        tname, fname = f"__dy2st_true_{uid}", f"__dy2st_false_{uid}"
        true_fn = self._make_branch_fn(tname, list(node.body), var_names)
        false_fn = self._make_branch_fn(
            fname, list(node.orelse) or [ast.Pass()], var_names)
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store())
                      for v in var_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__dy2st_convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=v, ctx=ast.Load())
                                      for v in var_names],
                                ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=b)
                                      for b in both_mask],
                                ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=v)
                                      for v in var_names],
                                ctx=ast.Load())],
                keywords=[]))
        cleanup = [] if var_names == ["__dy2st_dummy"] \
            else self._cleanup(var_names)
        return init + [true_fn, false_fn, call] + cleanup

    def visit_While(self, node):
        node = self.generic_visit(node)
        _check_supported(node.body, "while")
        if node.orelse:
            raise NotImplementedError("dy2static: while/else unsupported")
        uid = self._uid()
        var_names = sorted(_assigned(node.body))
        if not var_names:
            raise NotImplementedError(
                "dy2static: while body assigns no variables")
        init = self._guard_inits(var_names)
        cname, bname = f"__dy2st_cond_{uid}", f"__dy2st_body_{uid}"
        cond_fn = self._make_branch_fn(
            cname, [], var_names)
        # cond returns the test instead of the vars tuple
        cond_fn.body[-1] = ast.Return(value=node.test)
        body_fn = self._make_branch_fn(bname, list(node.body), var_names)
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=v, ctx=ast.Store())
                      for v in var_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__dy2st_convert_while",
                              ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Name(id=v, ctx=ast.Load())
                                      for v in var_names],
                                ctx=ast.Load())],
                keywords=[]))
        return init + [cond_fn, body_fn, call] + \
            self._cleanup(var_names)


def ast_transform(fn: Callable) -> Callable:
    """Rewrite fn's tensor control flow; returns the converted function
    (or fn unchanged when there is nothing to convert). Raises
    NotImplementedError for constructs the transformer cannot express
    (loud, never a silent specialization)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return fn
    tree = ast.parse(src)
    fdef = tree.body[0]
    # drop only to_static-ish decorators (avoid double-wrapping);
    # other decorators keep their behavior in the converted function
    def _is_to_static(d):
        target = d.func if isinstance(d, ast.Call) else d
        name = getattr(target, "attr", None) or getattr(target, "id", "")
        return "to_static" in str(name)

    if isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        fdef.decorator_list = [d for d in fdef.decorator_list
                               if not _is_to_static(d)]
    has_flow = any(isinstance(n, (ast.If, ast.While, ast.For))
                   for n in ast.walk(tree))
    if not has_flow:
        return fn
    # pass pipeline (program_translator.py transformer order): desugar
    # for -> while, then return-flags, then break/continue-flags, then
    # if/while -> torch.cond/while_loop
    fdef._dy2st_root = True
    tree = _ForToWhile().visit(tree)
    if isinstance(fdef, ast.FunctionDef):
        _ReturnTransformer().run(fdef)
    tree = _BreakContinueTransformer().visit(tree)
    new_tree = _ControlFlowTransformer().visit(tree)
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, filename=f"<dy2static {fn.__qualname__}>",
                   mode="exec")
    glb = dict(fn.__globals__)
    glb["__dy2st_convert_ifelse"] = convert_ifelse
    glb["__dy2st_convert_while"] = convert_while_loop
    glb["__dy2st_UNDEF"] = UNDEF
    glb["__dy2st_not"] = convert_not
    glb["__dy2st_convert_and"] = convert_logical_and
    glb["__dy2st_len"] = convert_len
    glb["__dy2st_materialize"] = convert_materialize
    glb["__dy2st_index"] = convert_index
    glb["__dy2st_range_len"] = convert_range_len
    glb["__dy2st_range_item"] = convert_range_item
    # rebind closure-free; closures are re-bound below if present
    if fn.__closure__:
        # rebuild free variables as globals snapshot (common case:
        # self via bound method is handled by the caller passing it)
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc = {}
    exec(code, glb, loc)
    new_fn = loc[fn.__name__]
    functools.update_wrapper(new_fn, fn)
    return new_fn
