"""Stock general passes (fluid/pir/transforms/general/ analogs): the
counterpart of ``paddle_tpu/ir/passes.py``, over torch tensors and types."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._core import dtype as dtypes
from .._core.op_registry import get_op
from .pass_base import Pass, Workspace, is_impure
from .pattern_rewrite import PatternRewriter, RewritePattern

# FLAGS_apply_ir_passes is defined with the core flags
# (_core/flags.py) so static mode works without importing this module.

_is_impure = is_impure


def _value_of_const(ws: Workspace, t) -> Any:
    """Concrete value of a non-Variable input, or _NOT_CONST."""
    from ..static import Variable
    t = ws.resolve(t) if isinstance(t, Variable) else t
    if isinstance(t, Variable):
        return ws.const_env.get(id(t), _NOT_CONST)
    if t is None:
        return None
    if hasattr(t, "_t"):  # eager Tensor captured by the graph
        return t._t
    return t  # raw tensor injected by an earlier fold, or a Python value


class _NotConst:
    def __repr__(self):
        return "<not-const>"


_NOT_CONST = _NotConst()


class ConstantFoldingPass(Pass):
    """Evaluate ops whose inputs are all compile-time constants
    (constant_folding_pass.cc)."""

    name = "constant_folding"

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        changed = False
        for node in list(ws.ops):
            if _is_impure(node.op_name):
                continue
            vals = [_value_of_const(ws, t) for t in node.inputs]
            if any(v is _NOT_CONST for v in vals):
                continue
            from ..static import run_node
            with torch.no_grad():
                outs = run_node(node, vals)
            for var, v in zip(node.outputs, outs):
                ws.replace_all_uses(var, v)
            ws.ops.remove(node)
            changed = True
        return changed


class DeadCodeEliminationPass(Pass):
    """Drop ops none of whose outputs reach a protected (fetched) value
    (dead_code_elimination_pass.cc)."""

    name = "dead_code_elimination"

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        from ..static import Variable
        live = set(protected)
        # a protected var may have been aliased to another op's output
        # (CSE): that output must stay computable
        for src_id in protected:
            if src_id in ws.aliases:
                tgt = ws.resolve(ws.aliases[src_id])
                if isinstance(tgt, Variable):
                    live.add(id(tgt))
        changed = False
        for node in reversed(list(ws.ops)):
            out_ids = {id(o) for o in node.outputs}
            if (out_ids & live) or _is_impure(node.op_name):
                for t in node.inputs:
                    if isinstance(t, Variable):
                        live.add(id(t))
                        tt = ws.resolve(t)
                        if isinstance(tt, Variable):
                            live.add(id(tt))
            else:
                ws.ops.remove(node)
                changed = True
        return changed


def _attr_key(attrs):
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, norm(x)) for k, x in v.items()))
        return v
    try:
        return tuple(sorted((k, norm(v)) for k, v in attrs.items()))
    except TypeError:
        return None  # unhashable attr: skip CSE for this node


class CommonSubexpressionEliminationPass(Pass):
    """Dedupe identical pure ops on identical inputs
    (common_subexpression_elimination_pass.cc)."""

    name = "cse"

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        from ..static import Variable

        def input_key(t):
            t2 = ws.resolve(t) if isinstance(t, Variable) else t
            if isinstance(t2, Variable) and id(t2) in ws.const_env:
                t2 = ws.const_env[id(t2)]
            if t2 is None:
                return None
            if isinstance(t2, Variable):
                return id(t2)
            # captured constants: structural equality for small payloads
            # and Python values
            v = t2._t if hasattr(t2, "_t") else t2
            if not isinstance(v, torch.Tensor):
                return ("py", type(v).__name__, repr(v))
            if v.numel() <= 4096:
                a = v.detach().cpu()
                if a.dtype == torch.bfloat16:
                    a = a.view(torch.int16)
                a = a.numpy()
                return ("const", str(v.dtype), a.shape, a.tobytes())
            return id(t2)

        seen = {}
        changed = False
        for node in list(ws.ops):
            if _is_impure(node.op_name):
                continue
            akey = _attr_key(node.attrs)
            if akey is None:
                continue
            key = (node.op_name, akey,
                   tuple(input_key(t) for t in node.inputs))
            first = seen.get(key)
            if first is None:
                seen[key] = node
                continue
            for old, new in zip(node.outputs, first.outputs):
                ws.replace_all_uses(old, new)
            ws.ops.remove(node)
            changed = True
        return changed


# --------------------------------------------------------------- AMP pass

_AMP_WHITELIST = ("matmul", "conv2d", "einsum", "bmm", "mm", "addmm",
                  "flash_attention")


class AutoMixedPrecisionPass(Pass):
    """Cast float32 inputs of the matrix-product ops to bfloat16
    (auto_mixed_precision_pass.cc; O1 semantics of amp/auto_cast.py)."""

    name = "auto_mixed_precision"

    def __init__(self, dtype="bfloat16"):
        self.dtype = dtype

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        from ..static import OpNode, Variable
        target = dtypes.to_torch(self.dtype)
        casted = {}
        changed = False
        for node in list(ws.ops):
            if node.op_name not in _AMP_WHITELIST:
                continue
            for i, t in enumerate(node.inputs):
                t_res = ws.resolve(t) if isinstance(t, Variable) else t
                if isinstance(t_res, Variable):
                    if id(t_res) in ws.const_env:
                        v = ws.const_env[id(t_res)]
                        if v.dtype == torch.float32:
                            node.inputs[i] = v.to(target)
                            changed = True
                        continue
                    if t_res.var_dtype != torch.float32:
                        continue
                    cv = casted.get(id(t_res))
                    if cv is None:
                        cast_node = OpNode(
                            "cast", {"dtype": self.dtype}, [t_res], [],
                            get_op("cast").fn)
                        cv = Variable(f"{t_res.name}.cast_{self.dtype}",
                                      t_res.var_shape, target,
                                      t_res.program, source=cast_node)
                        cast_node.outputs = [cv]
                        ws.ops.insert(ws.ops.index(node), cast_node)
                        casted[id(t_res)] = cv
                    node.inputs[i] = cv
                    changed = True
                elif t_res is not None:
                    v = t_res._t if hasattr(t_res, "_t") else t_res
                    if isinstance(v, torch.Tensor) \
                            and v.dtype == torch.float32:
                        node.inputs[i] = v.to(target)
                        changed = True
        return changed


# ------------------------------------------------------- cleanup patterns


def _dtype_of(t):
    from ..static import Variable
    if isinstance(t, Variable):
        return t.var_dtype
    v = t._t if hasattr(t, "_t") else t
    return v.dtype


def _lossless_cast(src_dtype, mid_dtype) -> bool:
    """True iff every value of src survives a round trip through mid —
    the condition under which cast(cast(x, mid), b) == cast(x, b)."""
    if src_dtype == mid_dtype:
        return True
    try:
        src, mid = (np.dtype(str(d).replace("torch.", ""))
                    for d in (src_dtype, mid_dtype))
        return np.can_cast(src, mid, casting="safe")
    except TypeError:
        return False  # bf16 & friends numpy can't rank: don't fold


class FoldDoubleCast(RewritePattern):
    """cast(cast(x, a), b) -> cast(x, b), only when the inner cast is
    lossless for x's dtype (a narrowing inner cast — f32->f16->f32,
    float->int truncation — changes values and must be kept)."""

    root_ops = ("cast",)

    def match_and_rewrite(self, node, rw) -> bool:
        from ..static import Variable
        src = node.inputs[0]
        if not isinstance(src, Variable):
            return False
        src = rw.ws.resolve(src)
        if not isinstance(src, Variable):
            return False
        producer = rw.producer_of(src)
        if producer is None or producer.op_name != "cast":
            return False
        inner_src = producer.inputs[0]
        if isinstance(inner_src, Variable):
            inner_src = rw.ws.resolve(inner_src)
            if not isinstance(inner_src, Variable) and not hasattr(
                    inner_src, "dtype"):
                return False
        if not _lossless_cast(_dtype_of(inner_src), _dtype_of(src)):
            return False
        node.inputs[0] = producer.inputs[0]
        rw.changed = True
        return True


class DropIdentityCast(RewritePattern):
    """cast(x, dtype_of_x) -> x."""

    root_ops = ("cast",)

    def match_and_rewrite(self, node, rw) -> bool:
        from ..static import Variable
        src = node.inputs[0]
        if src is None:
            return False
        if isinstance(src, Variable):
            resolved = rw.ws.resolve(src)
            if not isinstance(resolved, Variable):
                return False
        if dtypes.to_torch(node.attrs.get("dtype")) != _dtype_of(
                rw.ws.resolve(src) if isinstance(src, Variable) else src):
            return False
        rw.replace_op(node, [src])
        return True


class FuseScaleScale(RewritePattern):
    """scale(scale(x, s1), s2) with zero biases -> scale(x, s1*s2)."""

    root_ops = ("scale",)

    def match_and_rewrite(self, node, rw) -> bool:
        from ..static import Variable
        if node.attrs.get("bias", 0.0) != 0.0:
            return False
        src = node.inputs[0]
        if not isinstance(src, Variable):
            return False
        src = rw.ws.resolve(src)
        producer = rw.producer_of(src)
        if (producer is None or producer.op_name != "scale"
                or producer.attrs.get("bias", 0.0) != 0.0):
            return False
        node.inputs[0] = producer.inputs[0]
        node.attrs["scale"] = (node.attrs.get("scale", 1.0)
                               * producer.attrs.get("scale", 1.0))
        rw.changed = True
        return True


def default_pass_manager(amp: bool = False):
    """The standard static-compile pipeline (the role of
    executor.py _add_feed_fetch_ops + pir pass registry defaults)."""
    from .._core.flags import flag_value
    from .pass_base import PassManager
    passes = [
        ConstantFoldingPass(),
        PatternRewriter([FoldDoubleCast(), DropIdentityCast(),
                         FuseScaleScale()]),
        CommonSubexpressionEliminationPass(),
        DeadCodeEliminationPass(),
    ]
    if flag_value("FLAGS_enable_auto_layout"):
        passes.insert(0, AutoLayoutPass())
    if amp:
        passes.insert(0, AutoMixedPrecisionPass())
    return PassManager(passes, iterate_to_fixpoint=True, max_iters=4)


# ---------------------------------------------------------- auto layout

_LAYOUT_AGNOSTIC_UNARY = frozenset({
    "relu", "relu6", "gelu", "tanh", "sigmoid", "silu", "leaky_relu",
    "exp", "abs", "sqrt", "square", "hardswish", "elu", "softplus",
    "cast",   # AMP inserts these between convs; attrs carry no layout
})

_NCHW_TO_NHWC = [0, 2, 3, 1]
_NHWC_TO_NCHW = [0, 3, 1, 2]


def _permuted(shape, perm):
    return [shape[p] for p in perm] if shape and len(shape) == 4 else \
        list(shape)


class AutoLayoutPass(Pass):
    """NHWC auto-layout for conv stacks (the reference's
    auto_layout_pass.cc + auto_layout_insert_pass): every NCHW conv2d is
    rewritten to transpose -> conv(NHWC) -> transpose-back, then the
    restoring transposes are SUNK through layout-agnostic elementwise
    ops and cancelled against the next conv's pre-transpose — so a
    conv/act chain carries its activations in NHWC end to end with one
    transpose at each boundary."""

    name = "auto_layout"

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        from ..static import Variable
        changed = False
        for node in list(ws.ops):
            if node.op_name != "conv2d":
                continue
            if node.attrs.get("fmt") != "NCHW" \
                    or node.attrs.get("dims") != 2:
                continue
            x = node.inputs[0]
            xs = getattr(x, "var_shape", getattr(x, "shape", None))
            prog = getattr(x, "program", None)
            xdt = getattr(x, "var_dtype", None) or _dtype_of(x)
            xin = Variable(f"{getattr(x, 'name', 'x')}.nhwc",
                           _permuted(xs, _NCHW_TO_NHWC), xdt, prog)
            pre = _mk_op("transpose", {"perm": list(_NCHW_TO_NHWC)},
                         [x], [xin])
            ws.ops.insert(ws.ops.index(node), pre)
            node.inputs[0] = xin

            out = node.outputs[0]
            os_ = getattr(out, "var_shape", getattr(out, "shape", None))
            odt = getattr(out, "var_dtype", None) or torch.float32
            out_nhwc = Variable(f"{getattr(out, 'name', 'y')}.nhwc",
                                _permuted(os_, _NCHW_TO_NHWC), odt,
                                prog)
            post = _mk_op("transpose", {"perm": list(_NHWC_TO_NCHW)},
                          [out_nhwc], [out])
            ws.ops.insert(ws.ops.index(node) + 1, post)
            node.outputs = [out_nhwc]
            node.attrs["fmt"] = "NHWC"
            changed = True

        if changed:
            PatternRewriter([_SinkTransposePattern(),
                             _CancelTransposePattern()]).run(ws,
                                                             protected)
            # sinking re-homes consumers, orphaning the original
            # restoring transposes — sweep them out
            DeadCodeEliminationPass().run(ws, protected)
        return changed


def _mk_op(name, attrs, inputs, outputs, fn=None):
    from ..static import OpNode
    return OpNode(name, attrs, list(inputs), list(outputs),
                  fn or get_op(name).fn)


class _SinkTransposePattern(RewritePattern):
    """unary(transpose_back(x)) -> transpose_back(unary(x)): pushes the
    NCHW-restoring transpose past layout-agnostic ops so it can cancel
    against the next conv's pre-transpose."""

    root_ops = tuple(_LAYOUT_AGNOSTIC_UNARY)

    def match_and_rewrite(self, node, rewriter):
        from ..static import Variable
        if len(node.inputs) != 1:
            return False
        src = node.inputs[0]
        prod = rewriter.producer_of(src)
        if prod is None or prod.op_name != "transpose":
            return False
        if list(prod.attrs.get("perm", ())) != _NHWC_TO_NCHW:
            return False
        x_nhwc = prod.inputs[0]
        out = node.outputs[0]
        prog = getattr(out, "program", None)
        mid = Variable(f"{getattr(out, 'name', 'u')}.nhwc",
                       _permuted(getattr(out, "var_shape", None)
                                 or [0, 0, 0, 0], _NCHW_TO_NHWC),
                       getattr(out, "var_dtype", None) or torch.float32,
                       prog)
        new_unary = _mk_op(node.op_name, dict(node.attrs), [x_nhwc],
                           [mid], node.body)
        new_tr = _mk_op("transpose", {"perm": list(_NHWC_TO_NCHW)},
                        [mid], [out])
        rewriter.insert_before(node, new_unary)
        rewriter.insert_before(node, new_tr)
        # new_tr reuses `out` as its output: drop it from the old node
        # BEFORE erasing, or erase_op pops the producer entry new_tr
        # just registered and sinking stalls after one op per sweep
        node.outputs = []
        rewriter.erase_op(node)
        return True


class _CancelTransposePattern(RewritePattern):
    """transpose(transpose(x, p1), p2) with p2∘p1 == identity -> x."""

    root_ops = ("transpose",)

    def match_and_rewrite(self, node, rewriter):
        prod = rewriter.producer_of(node.inputs[0])
        if prod is None or prod.op_name != "transpose":
            return False
        p1 = list(prod.attrs.get("perm", ()))
        p2 = list(node.attrs.get("perm", ()))
        if len(p1) != len(p2):
            return False
        if [p1[p] for p in p2] != list(range(len(p1))):
            return False
        rewriter.replace_op(node, [prod.inputs[0]])
        return True
