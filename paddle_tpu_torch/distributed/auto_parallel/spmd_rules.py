"""Per-op SPMD sharding-propagation rules, the counterpart of
``paddle_tpu/distributed/auto_parallel/spmd_rules.py`` (upstream
``paddle/phi/infermeta/spmd_rules/``, registered by
``PD_REGISTER_SPMD_RULE`` in ``spmd_rules/rules.cc:37`` and bound to ops
through the ``spmd_rule:`` key of ``ops.yaml``).

Pure Python: the auto-parallel completion pass (``passes``) decides a
placement for every value of a recorded program from these per-op
answers, the partitioner (``partitioner.py``) then emits each rank's
program with its collectives. Partial (pending reduction) outputs are
modelled so the partitioner knows where an all-reduce goes.

Representation: ``TensorDistAttr`` = (dims_mapping, partial_status)
against a ``ProcessMesh``: ``dims_mapping[i]`` is the mesh-axis index
tensor dim i is sharded on, or -1 (upstream ``dist_attr.h``). Helpers map
to and from ``Placement`` lists and the port's ``mesh.PartitionSpec``.

Rules are einsum-notation driven like upstream's common infrastructure
(``matmul_spmd_rule.cc`` uses "mk,kn->mn" style axes merging):
per-letter shardings from all inputs are merged, conflicts resolved, each
mesh axis used at most once per tensor, contracted letters become Partial
on the output.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..placements import Partial, Placement, Replicate, Shard

# --------------------------------------------------------------------------
# dist attr
# --------------------------------------------------------------------------


class TensorDistAttr:
    """dims_mapping + partial status for one tensor (dist_attr.h analog)."""

    def __init__(self, dims_mapping: Sequence[int],
                 partial_status: Optional[Dict[int, str]] = None):
        self.dims_mapping = list(dims_mapping)
        # mesh axis -> reduce type ("sum"/"max"/...)
        self.partial_status = dict(partial_status or {})

    @property
    def ndim(self):
        return len(self.dims_mapping)

    def is_replicated(self):
        return (all(m == -1 for m in self.dims_mapping)
                and not self.partial_status)

    def sharded_axes(self):
        return [m for m in self.dims_mapping if m != -1]

    def copy(self):
        return TensorDistAttr(self.dims_mapping, self.partial_status)

    def __eq__(self, other):
        return (isinstance(other, TensorDistAttr)
                and self.dims_mapping == other.dims_mapping
                and self.partial_status == other.partial_status)

    def __repr__(self):
        p = f", partial={self.partial_status}" if self.partial_status else ""
        return f"DistAttr({self.dims_mapping}{p})"


def from_placements(placements: Sequence[Placement],
                    tensor_ndim: int) -> TensorDistAttr:
    """Placement list (one per mesh axis) -> dims_mapping."""
    dims = [-1] * tensor_ndim
    partial = {}
    for axis, p in enumerate(placements):
        if isinstance(p, Shard):
            if dims[p.dim] == -1:  # first mesh axis wins per tensor dim
                dims[p.dim] = axis
        elif isinstance(p, Partial):
            partial[axis] = p.reduce_type
    return TensorDistAttr(dims, partial)


def to_placements(attr: TensorDistAttr, mesh_ndim: int) -> List[Placement]:
    placements: List[Placement] = [Replicate()] * mesh_ndim
    for tdim, axis in enumerate(attr.dims_mapping):
        if axis != -1:
            placements[axis] = Shard(tdim)
    for axis, rt in attr.partial_status.items():
        placements[axis] = Partial(rt)
    return placements


def to_partition_spec(attr: TensorDistAttr, mesh_dim_names: Sequence[str]):
    """dims_mapping -> the port's ``mesh.PartitionSpec`` (partial axes drop
    out: the partitioner's all-reduce materializes the reduction)."""
    from ..mesh import PartitionSpec
    names = [mesh_dim_names[m] if m != -1 else None
             for m in attr.dims_mapping]
    while names and names[-1] is None:
        names.pop()
    return PartitionSpec(*names)


# --------------------------------------------------------------------------
# einsum-notation merge engine
# --------------------------------------------------------------------------


def _merge_letter_axes(notations: Sequence[str],
                       attrs: Sequence[TensorDistAttr]) -> Dict[str, int]:
    """Merge per-letter mesh axes across inputs. First non-(-1) wins;
    later conflicting inputs will be resharded to the merged mapping
    (same policy family as the reference's ShardingMergeForTensors)."""
    letter_axis: Dict[str, int] = {}
    for nota, attr in zip(notations, attrs):
        if len(nota) != attr.ndim:
            raise ValueError(
                f"notation '{nota}' rank {len(nota)} != tensor rank "
                f"{attr.ndim}")
        for letter, axis in zip(nota, attr.dims_mapping):
            if letter == "1":  # broadcast dim: never carries sharding
                continue
            if axis != -1 and letter_axis.get(letter, -1) == -1:
                letter_axis[letter] = axis
    return letter_axis


def _apply(nota: str, letter_axis: Dict[str, int]) -> List[int]:
    """letter map -> dims_mapping, enforcing one-use-per-mesh-axis."""
    used = set()
    dims = []
    for letter in nota:
        axis = -1 if letter == "1" else letter_axis.get(letter, -1)
        if axis != -1 and axis in used:
            axis = -1
        if axis != -1:
            used.add(axis)
        dims.append(axis)
    return dims


def infer_einsum(equation: str, *inputs: TensorDistAttr,
                 partial_reduce: str = "sum"
                 ) -> Tuple[List[TensorDistAttr], List[TensorDistAttr]]:
    """Propagate shardings through an einsum-like equation.

    `equation` like "mk,kn->mn" ("1" marks broadcast dims). Returns
    (inferred_input_attrs, output_attrs): inputs that disagreed with the
    merged mapping come back corrected (caller reshards them); contracted
    sharded letters mark outputs Partial on those mesh axes.
    """
    lhs, rhs = equation.split("->")
    in_notas = lhs.split(",")
    out_notas = rhs.split(",") if rhs else []
    if len(in_notas) != len(inputs):
        raise ValueError("equation arity mismatch")

    letter_axis = _merge_letter_axes(in_notas, inputs)
    inferred_in = [TensorDistAttr(_apply(n, letter_axis))
                   for n in in_notas]

    # Partial is per-output: an output lacking a sharded input letter holds
    # an unreduced piece on that mesh axis (e.g. the CE loss is partial on
    # the vocab axis even though the softmax output still carries it).
    outs = []
    for n in out_notas:
        dims = _apply(n, letter_axis)
        mine = set(n)
        partial = {axis: partial_reduce
                   for letter, axis in letter_axis.items()
                   if axis != -1 and letter not in mine
                   and axis not in dims}
        outs.append(TensorDistAttr(dims, partial))
    return inferred_in, outs


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_RULES: Dict[str, "SpmdRule"] = {}


class SpmdRule:
    """A rule maps input dist attrs (+ op attrs) to inferred input attrs and
    output attrs (process_group.h-era InferSpmd contract)."""

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn

    def infer(self, *inputs, **attrs):
        return self.fn(*inputs, **attrs)


def register_spmd_rule(names, fn=None):
    if isinstance(names, str):
        names = [names]

    def deco(f):
        for n in names:
            _RULES[n] = SpmdRule(n, f)
        return f

    return deco(fn) if fn is not None else deco


def get_spmd_rule(name: str) -> Optional[SpmdRule]:
    return _RULES.get(name)


def registered_rules() -> List[str]:
    return sorted(_RULES)


def resolve(op_name: str, inputs: Sequence[TensorDistAttr], **attrs):
    """Completion entry point: look up the rule (default: replicate)."""
    attrs.setdefault("op_name", op_name)
    rule = _RULES.get(op_name)
    if rule is None:
        return default_replicated(*inputs, **attrs)
    return rule.infer(*inputs, **attrs)


# --------------------------------------------------------------------------
# generic rules
# --------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def default_replicated(*inputs: TensorDistAttr, **attrs):
    """Fallback: everything replicated (reference default when no rule)."""
    inferred = [TensorDistAttr([-1] * a.ndim) for a in inputs]
    return inferred, [TensorDistAttr([-1] * (inputs[0].ndim if inputs
                                             else 0))]


def unary_rule(x: TensorDistAttr, **attrs):
    """Same-shape elementwise unary: mapping flows through unchanged
    (ref: elementwise_spmd_rule for the unary family)."""
    a = x.copy()
    a.partial_status = {}
    return [a], [TensorDistAttr(list(x.dims_mapping),
                                dict(x.partial_status))]


def elementwise_rule(*inputs: TensorDistAttr, **attrs):
    """Broadcast-aware binary/ternary elementwise
    (ref: elementwise_spmd_rule.cc with right-aligned broadcasting)."""
    out_ndim = max(a.ndim for a in inputs)
    notas = []
    for a in inputs:
        # right-align; leading broadcast dims get "1"
        offset = out_ndim - a.ndim
        notas.append("".join(
            _LETTERS[offset + i] for i in range(a.ndim)))
    out_nota = _LETTERS[:out_ndim]
    eq = ",".join(notas) + "->" + out_nota
    return infer_einsum(eq, *inputs)


def reduction_rule(x: TensorDistAttr, axis=None, keepdim=False, **attrs):
    """Reductions: sharded reduced dims become Partial on the output
    (ref: reduction_spmd_rule.cc)."""
    nd = x.ndim
    if axis is None:
        axes = list(range(nd))
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % nd for a in axes]
    reduce_type = attrs.get("reduce_type", "sum")
    partial = {}
    out_dims = []
    for d in range(nd):
        if d in axes:
            if x.dims_mapping[d] != -1:
                partial[x.dims_mapping[d]] = reduce_type
            if keepdim:
                out_dims.append(-1)
        else:
            out_dims.append(x.dims_mapping[d])
    inferred = x.copy()
    inferred.partial_status = {}
    return [inferred], [TensorDistAttr(out_dims, partial)]


# --------------------------------------------------------------------------
# op rules
# --------------------------------------------------------------------------


@register_spmd_rule("matmul")
def matmul_rule(x: TensorDistAttr, y: TensorDistAttr,
                transpose_x=False, transpose_y=False, **attrs):
    """matmul incl. batch broadcasting and transpose flags
    (ref: matmul_spmd_rule.cc). Contracted dim sharded -> Partial(sum)."""
    xn, yn = x.ndim, y.ndim
    batch_nd = max(xn, yn) - 2
    batch = _LETTERS[:max(batch_nd, 0)]
    m, k, n = "m", "k", "n"
    x_mat = (k + m) if transpose_x else (m + k)
    y_mat = (n + k) if transpose_y else (k + n)
    # batch letters right-aligned (broadcasting); rank-1 operands are pure
    # contraction vectors
    x_nota = (batch[batch_nd - (xn - 2):] + x_mat) if xn >= 2 else k
    y_nota = (batch[batch_nd - (yn - 2):] + y_mat) if yn >= 2 else k
    out_nota = batch
    if xn > 1:
        out_nota += m
    if yn > 1:
        out_nota += n
    eq = f"{x_nota},{y_nota}->{out_nota}"
    return infer_einsum(eq, x, y)


@register_spmd_rule("embedding")
def embedding_rule(w: TensorDistAttr, ids: TensorDistAttr, **attrs):
    """Vocab-parallel embedding: weight row-sharded (vocab dim on axis a)
    -> output Partial(sum) on a, masked-lookup semantics
    (ref: embedding_spmd_rule.cc + mpu/mp_ops.py:77 _c_lookup_table).
    Arg order matches the registered op: (weight, ids)."""
    nd = ids.ndim
    ids_nota = _LETTERS[:nd]
    eq = f"vh,{ids_nota}->{ids_nota}h"
    return infer_einsum(eq, w, ids)


@register_spmd_rule(["softmax_with_cross_entropy",
                     "cross_entropy_with_softmax"])
def softmax_ce_rule(logits: TensorDistAttr, label: TensorDistAttr,
                    **attrs):
    """Vocab-parallel softmax CE: class dim sharded -> loss Partial via the
    online max/sumexp reduction (ref: cross_entropy_with_softmax_spmd_rule.cc
    backing mp_ops.py:385 _c_softmax_with_cross_entropy)."""
    nd = logits.ndim
    batch = _LETTERS[:nd - 1]
    eq = f"{batch}v,{batch}1->{batch}1,{batch}v"
    (li, lb), (loss, softmax) = infer_einsum(eq, logits, label)
    return [li, lb], [loss, softmax]


@register_spmd_rule("reshape")
def reshape_rule(x: TensorDistAttr, shape=None, x_shape=None, **attrs):
    """Dim-grouping reshape propagation (ref: reshape_spmd_rule.cc):
    sharding survives when a sharded input dim maps to the leading dim of
    a contiguous output group; otherwise that dim falls back to -1."""
    if shape is None or x_shape is None:
        # without shapes, only rank-preserving identity is safe
        return [x.copy()], [TensorDistAttr(list(x.dims_mapping))]
    in_shape = list(x_shape)
    out_shape = list(shape)
    # resolve -1
    if -1 in out_shape:
        known = 1
        for s in out_shape:
            if s != -1:
                known *= s
        total = 1
        for s in in_shape:
            total *= s
        out_shape[out_shape.index(-1)] = total // max(known, 1)
    out_dims = [-1] * len(out_shape)
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        ip, jp = in_shape[i], out_shape[j]
        i0, j0 = i, j
        i += 1
        j += 1
        while ip != jp:
            if ip < jp:
                ip *= in_shape[i]
                i += 1
            else:
                jp *= out_shape[j]
                j += 1
        # group [i0,i) -> [j0,j): leading-dim sharding transfers when the
        # leading input dim of the group is the sharded one
        if x.dims_mapping[i0] != -1:
            out_dims[j0] = x.dims_mapping[i0]
    inferred = x.copy()
    inferred.partial_status = {}
    return [inferred], [TensorDistAttr(out_dims, dict(x.partial_status))]


@register_spmd_rule("transpose")
def transpose_rule(x: TensorDistAttr, perm=None, **attrs):
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    out = [x.dims_mapping[p] for p in perm]
    return [x.copy()], [TensorDistAttr(out, dict(x.partial_status))]


@register_spmd_rule("split")
def split_rule(x: TensorDistAttr, axis=0, num=2, **attrs):
    """Split dim cannot stay sharded (ref: split_spmd_rule.cc)."""
    axis = axis % x.ndim
    dims = list(x.dims_mapping)
    dims[axis] = -1
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims)) for _ in range(num)]


@register_spmd_rule("concat")
def concat_rule(*inputs: TensorDistAttr, axis=0, **attrs):
    nd = inputs[0].ndim
    axis = axis % nd
    nota = "".join(_LETTERS[i] if i != axis else "1" for i in range(nd))
    eq = ",".join([nota] * len(inputs)) + "->" + nota
    inferred, outs = infer_einsum(eq, *inputs)
    return inferred, outs


@register_spmd_rule("slice")
def slice_rule(x: TensorDistAttr, axes=(), **attrs):
    dims = list(x.dims_mapping)
    for a in axes:
        dims[a % x.ndim] = -1
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims))]


@register_spmd_rule(["layer_norm", "rms_norm"])
def layer_norm_rule(x: TensorDistAttr, *params: TensorDistAttr,
                    begin_norm_axis=-1, **attrs):
    """Normalized dims must be replicated; batch dims flow through
    (ref: layer_norm_spmd_rule.cc)."""
    nd = x.ndim
    if begin_norm_axis < 0:
        begin_norm_axis += nd
    dims = [m if i < begin_norm_axis else -1
            for i, m in enumerate(x.dims_mapping)]
    inferred_x = TensorDistAttr(dims)
    inferred_p = [TensorDistAttr([-1] * p.ndim) for p in params]
    return [inferred_x] + inferred_p, [TensorDistAttr(list(dims))]


@register_spmd_rule("softmax")
def softmax_rule(x: TensorDistAttr, axis=-1, **attrs):
    """Softmax axis replicated (ref: softmax_spmd_rule.cc)."""
    axis = axis % x.ndim
    dims = list(x.dims_mapping)
    dims[axis] = -1
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims))]


@register_spmd_rule("flash_attention")
def flash_attention_rule(q: TensorDistAttr, k: TensorDistAttr,
                         v: TensorDistAttr, causal=False, **attrs):
    """[b, s, h, d]: batch + heads shardable; q.seq sharding maps to
    ring/blockwise attention (context_parallel.py). Softmax is NOT
    sum-decomposable over kv-seq or head-dim, so those dims are forced
    replicated rather than emitted as Partial — a planner must gather
    them (ref: flash_attn rule file + flash_attention.py:562)."""
    eq = "bshd,bthd,bthd->bshd"
    inferred, (out,) = infer_einsum(eq, q, k, v)
    for attr, nota in zip(inferred, ("bshd", "bthd", "bthd")):
        for i, letter in enumerate(nota):
            if letter in ("t", "d"):
                attr.dims_mapping[i] = -1
    out.dims_mapping[3] = -1
    out.partial_status = {}
    return inferred, [out]


@register_spmd_rule("dropout")
def dropout_rule(x: TensorDistAttr, **attrs):
    return unary_rule(x)


@register_spmd_rule(["squeeze", "unsqueeze"])
def squeeze_rule(x: TensorDistAttr, axis=None, out_ndim=None, **attrs):
    # conservatively keep only rank-stable mapping knowledge
    return [x.copy()], [TensorDistAttr([-1] * (out_ndim or x.ndim))]


@register_spmd_rule(["gather", "index_select", "take_along_axis"])
def gather_rule(x: TensorDistAttr, index: TensorDistAttr, axis=0, **attrs):
    dims = list(x.dims_mapping)
    dims[axis % x.ndim] = -1
    out_nd = index.ndim + x.ndim - 1
    return ([TensorDistAttr(dims), TensorDistAttr([-1] * index.ndim)],
            [TensorDistAttr([-1] * out_nd)])


@register_spmd_rule(["tile", "expand"])
def tile_rule(x: TensorDistAttr, out_ndim=None, **attrs):
    nd = out_ndim or x.ndim
    pad = nd - x.ndim
    return ([x.copy()],
            [TensorDistAttr([-1] * pad + list(x.dims_mapping))])


@register_spmd_rule("stack")
def stack_rule(*inputs: TensorDistAttr, axis=0, **attrs):
    nd = inputs[0].ndim
    eq = ",".join([_LETTERS[:nd]] * len(inputs)) + "->" + _LETTERS[:nd]
    inferred, (merged,) = infer_einsum(eq, *inputs)
    axis = axis % (nd + 1)
    out = list(merged.dims_mapping)
    out.insert(axis, -1)
    return inferred, [TensorDistAttr(out)]


@register_spmd_rule("conv2d")
def conv2d_rule(x: TensorDistAttr, w: TensorDistAttr, **attrs):
    """NCHW conv: batch-shard x, out-channel-shard w, in-channel contraction
    -> Partial (ref: conv rule behavior via matmul-like notation)."""
    eq = "bc11,oc11->bo11"
    return infer_einsum(eq, x, w)


@register_spmd_rule(["pool2d", "max_pool2d", "avg_pool2d"])
def pool2d_rule(x: TensorDistAttr, **attrs):
    dims = [x.dims_mapping[0], x.dims_mapping[1], -1, -1]
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims))]


@register_spmd_rule(["argmax", "argmin", "max", "min", "sum", "mean",
                     "prod", "all", "any", "norm"])
def _reduction_ops(x: TensorDistAttr, axis=None, keepdim=False, **attrs):
    rt = {"max": "max", "min": "min", "prod": "prod",
          "all": "all", "any": "any"}.get(attrs.get("op_name", ""), "sum")
    return reduction_rule(x, axis=axis, keepdim=keepdim, reduce_type=rt,
                          **{k: v for k, v in attrs.items()
                             if k != "reduce_type"})


@register_spmd_rule("topk")
def topk_rule(x: TensorDistAttr, axis=-1, **attrs):
    axis = axis % x.ndim
    dims = list(x.dims_mapping)
    dims[axis] = -1
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims)),
                        TensorDistAttr(list(dims))]


@register_spmd_rule("cumsum")
def cumsum_rule(x: TensorDistAttr, axis=-1, **attrs):
    axis = axis % x.ndim
    dims = list(x.dims_mapping)
    dims[axis] = -1
    inferred = TensorDistAttr(dims)
    return [inferred], [TensorDistAttr(list(dims))]


@register_spmd_rule("one_hot")
def one_hot_rule(x: TensorDistAttr, **attrs):
    return [x.copy()], [TensorDistAttr(list(x.dims_mapping) + [-1])]


@register_spmd_rule(["scatter", "put_along_axis"])
def scatter_rule(x: TensorDistAttr, index: TensorDistAttr,
                 updates: TensorDistAttr = None, **attrs):
    inferred = [TensorDistAttr([-1] * x.ndim),
                TensorDistAttr([-1] * index.ndim)]
    if updates is not None:
        inferred.append(TensorDistAttr([-1] * updates.ndim))
    return inferred, [TensorDistAttr([-1] * x.ndim)]


# elementwise family registrations — each name is a distinct rule binding in
# the reference (ops.yaml `spmd_rule: ElementwiseBinaryInferSpmd` etc.)
for _name in ["add", "subtract", "multiply", "divide", "maximum", "minimum",
              "pow", "elementwise_pow", "floor_divide", "remainder", "fmax",
              "fmin", "logical_and", "logical_or", "logical_xor", "equal",
              "not_equal", "less_than", "less_equal", "greater_than",
              "greater_equal", "atan2", "where", "addmm_like", "hypot",
              "nextafter", "copysign", "heaviside", "ldexp", "logaddexp"]:
    register_spmd_rule(_name, elementwise_rule)

for _name in ["relu", "gelu", "silu", "sigmoid", "tanh", "exp", "log",
              "sqrt", "rsqrt", "abs", "neg", "floor", "ceil", "round",
              "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
              "erf", "erfinv", "log1p", "expm1", "reciprocal", "sign",
              "square", "softplus", "softsign", "hardswish", "hardsigmoid",
              "leaky_relu", "elu", "celu", "selu", "mish", "swish",
              "logit", "cast", "scale", "clip", "tril", "triu", "isnan",
              "isinf", "isfinite", "bitwise_not", "logical_not", "increment",
              "assign", "fill", "full_like", "bernoulli", "log_softmax",
              "relu6", "silu_grad_like", "stanh", "digamma", "lgamma",
              "trunc", "frac", "i0", "i1", "angle", "conj", "real", "imag"]:
    register_spmd_rule(_name, unary_rule)


__all__ = [
    "TensorDistAttr", "from_placements", "to_placements",
    "to_partition_spec", "infer_einsum", "register_spmd_rule",
    "get_spmd_rule", "registered_rules", "resolve", "default_replicated",
    "unary_rule", "elementwise_rule", "reduction_rule",
]
