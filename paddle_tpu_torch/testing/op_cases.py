"""The op surface's cases: one table of calls, inputs and comparison
families, shared by the CPU tests (which run each case through
``paddle_tpu`` and ``paddle_tpu_torch`` at ``SMALL``) and by
``chip_smoke.py`` (which runs it on the card and on the port's CPU path at
``FULL``, the eager gpt2-medium's activation shape ``[8, 1024, 1024]``).

A case calls the public API of the framework module it is given
(``fn(paddle, *tensors)``), so one line drives either package. Its inputs
are ``Spec``s made from ``np.random.RandomState``; ``grad`` names the
inputs whose gradient of ``sum(out * r)`` is held as well; ``family``
picks the comparison limit (``limit``); ``low`` says the case also runs
with its float inputs in bf16 (and fp16 where ``fp16``); ``sync`` marks
the ops whose output shape depends on the data (they read it on the
host); ``rows`` marks a slow family whose CPU side may read a leading
slice at ``FULL``. ``ops`` lists the registered op names the case drives.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Callable, Tuple

import numpy as np

# ------------------------------------------------------------------ sizes


@dataclasses.dataclass(frozen=True)
class Size:
    x: Tuple[int, ...]     # elementwise, reduction, search operands
    m: int                 # square matrices of decompositions and solves
    mg: int                # the same, where eigen- and singular-vector
    #                        gradients are held: their error grows as
    #                        n^2 eps over the relative gap
    bmm: Tuple[int, ...]   # batched square products
    n_idx: int             # indices of gathers and scatters
    kron: Tuple[int, int]  # each kron operand
    img: Tuple[int, ...]   # NCHW interpolation inputs
    seq: Tuple[int, int, int]  # (batch, steps, tags) of CRF decoding
    edit: Tuple[int, int]  # (pairs, length) of edit distance


SMALL = Size(x=(3, 4, 6), m=5, mg=5, bmm=(2, 4, 4), n_idx=5, kron=(3, 4),
             img=(2, 3, 4, 6), seq=(3, 5, 4), edit=(4, 6))
FULL = Size(x=(8, 1024, 1024), m=1024, mg=64, bmm=(8, 1024, 1024), n_idx=1024,
            kron=(64, 64), img=(8, 64, 128, 128), seq=(64, 128, 32),
            edit=(64, 24))


def _shape(S: Size, key):
    if callable(key):
        return tuple(key(S))
    if isinstance(key, tuple):
        return key
    return {"x": S.x, "x2": (S.x[0] * S.x[1], S.x[2]), "row": S.x[-1:],
            "col": S.x[:-1] + (1,), "m": (S.m, S.m), "mg": (S.mg, S.mg),
            "mv": (S.m,),
            "mk": (S.m, 3), "bmm": S.bmm, "kron": S.kron, "img": S.img,
            "seq": S.seq, "vec": (S.x[-1],), "last1": S.x[:-1] + (1,),
            "nidx": (S.n_idx,), "x0": S.x[1:]}[key]


# ------------------------------------------------------------------ inputs

@dataclasses.dataclass(frozen=True)
class Spec:
    """One input: ``kind`` (u uniform, n normal, i integers, b bool, t
    integer-valued floats: ties, h halves: round's ties, nan: normal with
    NaN and infinities, spd: symmetric positive definite, tri: well
    conditioned upper triangular, svdm / eigm: a matrix / a symmetric one
    with singular values / eigenvalues spread from 100 to 1, dd:
    diagonally dominant, sorted: sorted row, idx: indices with
    duplicates, perm: a permutation, box: shape[0] boxes [x1, y1, x2, y2]
    in an image of side shape[1], split: counts of shape[0] parts summing
    to shape[1]) over
    ``shape`` in [lo, hi)."""
    kind: str
    shape: object = "x"
    lo: float = -1.0
    hi: float = 1.0
    dtype: str = "float32"

    def make(self, rng: np.random.RandomState, S: Size) -> np.ndarray:
        shape = _shape(S, self.shape)
        k = self.kind
        if k == "u":
            a = rng.uniform(self.lo, self.hi, shape)
        elif k == "n":
            a = rng.standard_normal(shape)
        elif k in ("i", "idx"):
            a = rng.randint(int(self.lo), int(self.hi), shape)
        elif k == "b":
            a = rng.uniform(0, 1, shape) < 0.5
        elif k == "t":
            a = rng.randint(int(self.lo), int(self.hi), shape)
        elif k == "h":
            a = rng.randint(-8, 8, shape) * 0.5 + (
                rng.uniform(0, 1, shape) < 0.5) * rng.uniform(-0.2, 0.2,
                                                               shape)
        elif k == "nan":
            a = rng.standard_normal(shape)
            r = rng.uniform(0, 1, shape)
            a[r < 0.05] = np.nan
            a[(r >= 0.05) & (r < 0.08)] = np.inf
            a[(r >= 0.08) & (r < 0.1)] = -np.inf
        elif k == "spd":
            n = shape[-1]
            g = rng.standard_normal(shape)
            a = g @ np.swapaxes(g, -1, -2) / n + np.eye(n)
        elif k == "tri":
            n = shape[-1]
            a = np.triu(rng.uniform(-1, 1, shape) / math.sqrt(n)) + \
                np.eye(n) * 2.0
        elif k in ("svdm", "eigm"):
            # singular values / eigenvalues from 100 down to 1, evenly in
            # log (relative gaps of ln(100) / n): every vector, and so the
            # vectors' gradients, is determined to about eps / gap
            n = shape[-1]
            vals = np.geomspace(100.0, 1.0, n)
            q = np.linalg.qr(rng.standard_normal(shape))[0]
            if k == "eigm":
                a = (q * vals) @ q.T
            else:
                v = np.linalg.qr(rng.standard_normal(shape))[0]
                a = (q * vals) @ v.T
        elif k == "dd":
            n = shape[-1]
            a = rng.standard_normal(shape) / math.sqrt(n) + 3.0 * np.eye(n)
        elif k == "sorted":
            a = np.sort(rng.uniform(self.lo, self.hi, shape), -1)
        elif k == "perm":
            a = rng.permutation(int(self.hi))[:shape[0]]
        elif k == "box":
            # shape (R, side): [R, 4] boxes (x1, y1, x2, y2) in an image of
            # that side, the corner in its first 60%, the sides from 1 to
            # 35% of it (a side under 4: normalised boxes, from 0.01)
            side = shape[1]
            low = 1.0 if side >= 4 else 0.01
            corner = rng.uniform(0, 0.6 * side, (shape[0], 2))
            a = np.concatenate([corner, corner + rng.uniform(
                low, 0.35 * side, (shape[0], 2))], 1)
        elif k == "split":
            # shape (n, total): n counts summing to total
            cuts = np.sort(rng.randint(0, shape[1] + 1, shape[0] - 1))
            a = np.diff(np.concatenate([[0], cuts, [shape[1]]]))
        else:
            raise ValueError(k)
        return np.asarray(a).astype(self.dtype)


def U(lo=-1.0, hi=1.0, shape="x"):
    return Spec("u", shape, lo, hi)


N = Spec("n")


def I(lo, hi, shape="x", dtype="int64"):  # noqa: E743
    return Spec("i", shape, lo, hi, dtype)


B = Spec("b", "x", dtype="bool")


# ------------------------------------------------------------------ cases

@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    fn: Callable
    inputs: Tuple[Spec, ...]
    ops: Tuple[str, ...]
    grad: Tuple[int, ...] = ()
    family: str = "elementwise"
    low: bool = False
    fp16: bool = False
    sync: bool = False
    rows: bool = False
    group: str = "math"
    scan: bool = False  # each output element sums a whole input axis
    low_grad: bool = True  # the reference differentiates it in bf16/fp16


CASES = []
# the bf16/fp16 outputs that the reference computes in several steps, each
# rounded to the low type (the port rounds once): one ulp of the output's
# scale on top of the element's
COMPOSITE = {"hypot", "logaddexp", "stanh", "silu", "log2", "log10",
             "mish", "tanhshrink", "hardswish", "hardsigmoid", "logit",
             "lerp", "scale", "softsign", "scalar_promotion"}


_GROUP = ["math"]  # the group of the cases that follow


def case(name, fn, inputs, ops=None, grad=(), family="elementwise",
         low=False, fp16=False, sync=False, rows=False, group=None,
         scan=False, low_grad=True):
    group = group or _GROUP[0]
    if family == "elementwise" and name in COMPOSITE:
        family = "composite"
    CASES.append(Case(name, fn, tuple(inputs),
                      tuple(ops if ops is not None else (name,)),
                      tuple(grad), family, low, fp16, sync, rows, group,
                      scan, low_grad))


def gen(P):
    """The framework's generated wrappers (by-name calls)."""
    return importlib.import_module(P.__name__ + ".ops.generated")


def F(P):
    return importlib.import_module(P.__name__ + ".nn.functional")


# ---- unary elementwise (the _helper family): (name, input, grad, low)
_U = [
    ("abs", N, True), ("acos", U(-0.9, 0.9), True),
    ("acosh", U(1.1, 3.0), True), ("asin", U(-0.9, 0.9), True),
    ("asinh", N, True), ("atan", N, True), ("atanh", U(-0.9, 0.9), True),
    ("ceil", U(-3, 3), False), ("cos", U(-3, 3), True),
    ("cosh", U(-3, 3), True), ("digamma", U(0.5, 4.0), True),
    ("erf", N, True), ("erfinv", U(-0.9, 0.9), True),
    ("exp", U(-3, 3), True), ("expm1", U(-3, 3), True),
    ("floor", U(-3, 3), False), ("frac", U(-3, 3), True),
    ("gammaln", U(0.5, 4.0), True), ("i0", U(-3, 3), True),
    ("i0e", U(-3, 3), True), ("i1", U(-3, 3), True),
    ("i1e", U(-3, 3), True), ("lgamma", U(0.5, 4.0), True),
    ("log", U(0.1, 3.0), True), ("log10", U(0.1, 3.0), True),
    ("log1p", U(-0.5, 3.0), True), ("log2", U(0.1, 3.0), True),
    ("logit", U(0.05, 0.95), True), ("neg", N, True),
    ("reciprocal", U(0.5, 2.0), True), ("round", Spec("h"), False),
    ("rsqrt", U(0.1, 3.0), True), ("sigmoid", N, True),
    ("sign", U(-2, 2), False), ("sin", U(-3, 3), True),
    ("sinh", U(-3, 3), True), ("sqrt", U(0.1, 3.0), True),
    ("square", N, True), ("tan", U(-1.2, 1.2), True), ("tanh", N, True),
    ("trunc", U(-3, 3), False), ("angle", N, False),
]
for _n, _spec, _g in _U:
    case(_n, (lambda n: lambda P, x: getattr(P, n)(x))(_n), [_spec],
         grad=(0,) if _g else (), low=True,
         family="special" if _n in ("digamma", "erfinv", "gammaln", "i0",
                                    "i0e", "i1", "i1e", "lgamma") else
         "elementwise", rows=_n in ("i0", "i0e", "i1", "i1e"))
case("int_unary", lambda P, x: (P.abs(x), P.neg(x), P.sign(x),
                                P.square(x), P.floor(x), P.exp(x)),
     [I(-5, 5, dtype="int32")], ops=("abs", "neg", "sign", "square",
                                     "floor", "exp"), family="exact")
case("int64_float_unary", lambda P, x: (P.sqrt(x), P.sin(x), P.angle(x)),
     [I(0, 9)], ops=("sqrt", "sin", "angle"))
case("bool_unary", lambda P, x: (P.square(x), P.abs(x), P.logical_not(x),
                                 P.bitwise_not(x), P.exp(x)),
     [B], ops=("square", "abs", "logical_not", "bitwise_not", "exp"))
case("nonfinite", lambda P, x: (P.isnan(x), P.isinf(x), P.isfinite(x),
                                P.nan_to_num(x),
                                P.nan_to_num(x, 1.0, 9.0, -9.0)),
     [Spec("nan")], ops=("isnan", "isinf", "isfinite", "nan_to_num"),
     low=True)
case("complex_parts", lambda P, x, y: (
    P.real(P.complex(x, y)), P.imag(P.complex(x, y)),
    P.real(P.conj(P.complex(x, y))), P.imag(P.conj(P.complex(x, y))),
    P.angle(P.complex(x, y)), P.real(x), P.imag(x)), [N, N],
    ops=("real", "imag", "conj", "angle", "complex_make"))
case("as_real_complex", lambda P, x: P.as_real(P.as_complex(x)),
     [Spec("n", lambda S: S.x[:-1] + (2,))], ops=("as_real", "as_complex"),
     group="manip")
for _n in ("relu", "relu6", "silu", "softsign", "mish", "tanhshrink",
           "hardswish", "hardsigmoid"):
    case(_n, (lambda n: lambda P, x: getattr(F(P), n)(x * 4.0))(_n), [N],
         grad=(0,), low=True)
case("sigmoid_f", lambda P, x: F(P).sigmoid(x), [N], grad=(0,), low=True)
case("nn_registered", lambda P, x, w, b, ids: (
    F(P).gelu(x), F(P).gelu(x, approximate=True), F(P).softmax(x, -1),
    F(P).linear(x, w, b), F(P).embedding(ids, w)),
     [N, Spec("n", lambda S: (S.x[2], S.x[2])), Spec("n", "vec"),
      I(0, 6, (5,))], ops=("gelu", "softmax", "linear", "embedding"),
     grad=(0, 1, 2), family="composite", low=True)
case("tanh_f", lambda P, x: F(P).tanh(x), [N], grad=(0,), low=True)

# ---- binary elementwise: (name, x, y, grad)
_GROUP[0] = "binary"
_POS = U(0.5, 2.0)
_B = [
    ("add", N, N, (0, 1)), ("subtract", N, N, (0, 1)),
    ("multiply", N, N, (0, 1)), ("divide", N, _POS, (0, 1)),
    ("maximum", N, N, (0, 1)), ("minimum", N, N, (0, 1)),
    ("fmax", Spec("nan"), N, ()), ("fmin", Spec("nan"), N, ()),
    ("atan2", N, N, (0, 1)), ("hypot", N, N, (0, 1)),
    ("logaddexp", N, N, (0, 1)), ("copysign", N, N, (0,)),
    ("heaviside", Spec("t", "x", -1, 2), N, ()),
    ("pow", _POS, U(-2, 2), (0, 1)), ("mod", U(-5, 5), _POS, (0,)),
    ("floor_divide", U(-5, 5), _POS, ()),
    ("nextafter", N, N, ()),
]
for _n, _x, _y, _g in _B:
    case(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n), [_x, _y],
         grad=_g, low=_n != "nextafter")
for _n in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    case(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n),
         [Spec("t", "x", -2, 3), Spec("t", "x", -2, 3)], low=True)
for _n in ("logical_and", "logical_or", "logical_xor"):
    case(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n), [B, B])
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_n, (lambda n: lambda P, x, y: (getattr(P, n)(x, y),
                                         getattr(P, n)(x, 6)))(_n),
         [I(-50, 50, dtype="int32"), I(-50, 50, dtype="int32")],
         family="exact")
for _n in ("bitwise_left_shift", "bitwise_right_shift"):
    case(_n, (lambda n: lambda P, x, y: getattr(P, n)(x, y))(_n),
         [I(-50, 50, dtype="int32"), I(0, 5, dtype="int32")],
         family="exact")
case("gcd_lcm", lambda P, x, y: (P.gcd(x, y), P.lcm(x, y)),
     [I(1, 60), I(1, 60)], ops=("gcd", "lcm"), family="exact")
case("int_arith", lambda P, x, y: (P.mod(x, y), P.floor_divide(x, y),
                                   P.divide(x, y), P.pow(x, 2),
                                   P.maximum(x, y)),
     [I(-20, 20, dtype="int32"), I(1, 6, dtype="int32")],
     ops=("mod", "floor_divide", "divide", "pow", "maximum"))
case("scalar_promotion", lambda P, x, i: (
    P.add(x, 2), P.add(i, 2.5), P.multiply(i, 3), P.maximum(x, 0.5),
    P.atan2(i, 2), P.divide(i, 2), P.pow(x, 2.0)),
     [N, I(-5, 5, dtype="int32")],
     ops=("add", "multiply", "maximum", "atan2", "divide", "pow"),
     low=True)
case("ldexp", lambda P, x, e: P.ldexp(x, e), [N, I(-3, 4, dtype="int32")],
     grad=(0,), low=True)
case("polar", lambda P, a, t: P.polar(a, t), [_POS, U(-3, 3)])
case("kron", lambda P, x, y: P.kron(x, y),
     [Spec("n", "kron"), Spec("n", lambda S: (S.kron[1], S.kron[0]))],
     grad=(0, 1), low=True)
case("multiply_no_broadcast",
     lambda P, x, y: gen(P).multiply_no_broadcast(x, y), [N, N],
     grad=(0, 1))

# ---- math.py and math_ext.py composites
case("scale", lambda P, x: (P.scale(x, 2.0, 0.5),
                            P.scale(x, 2.0, 0.5, bias_after_scale=False)),
     [N], grad=(0,), low=True)
case("clip", lambda P, x: (P.clip(x, -0.5, 0.7), P.clip(x, None, 0.2),
                           P.clip(x, -0.3)), [N], grad=(0,), low=True)
case("lerp", lambda P, x, y, w: P.lerp(x, y, w), [N, N, U(0, 1)],
     grad=(0, 1, 2), low=True)
case("stanh", lambda P, x: P.stanh(x), [N], grad=(0,), low=True)
case("rsqrt_grad_friendly", lambda P, x: gen(P).rsqrt_grad_friendly(x),
     [U(0.1, 3.0)], grad=(0,))
case("cumsum", lambda P, x: (P.cumsum(x, axis=-1), P.cumsum(x, axis=0),
                             P.cumsum(x)), [N], ops=("cumsum_",),
     grad=(0,), family="reduce", scan=True, low=True)
case("cumsum_int", lambda P, x: (P.cumsum(x, axis=1),
                                 P.cumsum(x, axis=1, dtype="float64")),
     [I(-5, 5, dtype="int32")], ops=("cumsum_",), family="exact")
case("cumprod", lambda P, x: P.cumprod(x, dim=-1), [U(0.8, 1.25)],
     ops=("cumprod_",), grad=(0,), family="reduce", scan=True, low=True)
case("logcumsumexp", lambda P, x: (P.logcumsumexp(x, axis=-1),
                                   P.logcumsumexp(x)), [N],
     ops=("logcumsumexp_",), grad=(0,), family="reduce", scan=True, low=True)
case("cummax_cummin", lambda P, x: P.cummax(x, axis=-1) + P.cummin(
    x, axis=1), [N], ops=("cummax_", "cummin_"), grad=(0,), low=True)
# ties: the running extremum's index is its last occurrence (the
# reference splits a tie's gradient along its scan tree: not held)
case("cummax_ties", lambda P, x: P.cummax(x, axis=-1) + P.cummin(
    x, axis=1), [Spec("t", "x", -3, 4)], ops=("cummax_", "cummin_"),
     low=True)
case("addmm", lambda P, i, x, y: P.addmm(i, x, y, beta=0.5, alpha=2.0),
     [Spec("n", "m"), Spec("n", "m"), Spec("n", "m")], ops=("addmm_",),
     grad=(0, 1, 2), family="matmul", low=True)
case("baddbmm", lambda P, i, x, y: P.baddbmm(i, x, y, 0.5, 2.0),
     [Spec("n", "bmm"), Spec("n", "bmm"), Spec("n", "bmm")],
     ops=("baddbmm_",), grad=(0, 1, 2), family="matmul", low=True)
case("polygamma", lambda P, x: (P.polygamma(x, 1), P.polygamma(x, 2)),
     [U(0.5, 4.0)], ops=("polygamma_",), grad=(0,), family="special",
     rows=True)
case("gammainc", lambda P, a, x: (P.gammainc(a, x), P.gammaincc(a, x)),
     [U(0.5, 4.0), U(0.1, 6.0)], ops=("gammainc_", "gammaincc_"),
     grad=(0, 1), family="special", rows=True)
case("dist", lambda P, x, y: (P.dist(x, y), P.dist(x, y, 1.0),
                              P.dist(x, y, float("inf"))), [N, N],
     ops=("dist_",), grad=(0, 1), family="reduce", low=True)
case("diag_embed", lambda P, x: (P.diag_embed(x), P.diag_embed(x, 1),
                                 P.diag_embed(x, -1, 0, 2)),
     [Spec("n", lambda S: S.x[:-1] + (min(S.x[-1], 16),))],
     ops=("diag_embed_",), grad=(0,), low=True, group="manip")
case("fill_diagonal", lambda P, x: (P.fill_diagonal(x, 2.0),
                                    P.fill_diagonal(x, -1.0, offset=1),
                                    P.fill_diagonal(x, 3.0, wrap=True)),
     [Spec("n", lambda S: (S.m + 3, S.m - 1))], ops=("fill_diagonal_",),
     grad=(0,), low=True, group="manip")
case("fill_diagonal_3d", lambda P, x: P.fill_diagonal(x, 5.0),
     [Spec("n", lambda S: (4, 4, 4))], ops=("fill_diagonal_",),
     group="manip")
case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
     [Spec("n", "x2"), Spec("n", "x2"),
      Spec("i", lambda S: (S.x[0] * S.x[1], 1), 0, 2, "int32")],
     ops=("multiplex_",), grad=(0, 1), group="manip")
case("strided_slice", lambda P, x: (
    P.strided_slice(x, [0, 2], [0, 5], [2, -1], [1, 2]),
    P.strided_slice(x, [1, 2], [3, -1], [0, 0], [1, -2]),
    P.slice(x, [1], [1], [3])), [N], ops=("strided_slice_",), grad=(0,),
     low=True, group="manip")
case("crop", lambda P, x: (P.crop(x, [2, 3, 4], [1, 1, 2]),
                           P.crop(x, offsets=[0, 1, 1])), [N],
     ops=("crop_",), grad=(0,), group="manip")
case("reduce_as", lambda P, x, t: (P.reduce_as(x, t),), [N, Spec(
    "n", lambda S: (S.x[1], 1))], ops=("reduce_as_",), grad=(0,),
     family="reduce", group="reduce")
case("norm_family", lambda P, x: (P.clip_by_norm(x, 1.0),
                                  P.squared_l2_norm(x), P.l1_norm(x)),
     [N], ops=("clip_by_norm_", "squared_l2_norm_", "l1_norm_"),
     grad=(0,), family="reduce", low=True, group="reduce")
case("allclose", lambda P, x, y: (P.allclose(x, x + 1e-7),
                                  P.allclose(x, y), P.isclose(x, y),
                                  P.isclose(x, x * (1 + 1e-6)),
                                  P.equal_all(x, x), P.equal_all(x, y)),
     [N, N], ops=("allclose_k", "isclose_k", "equal_all_k"))
case("accuracy_check", lambda P, x, y: (gen(P).accuracy_check(x, x),
                                        gen(P).accuracy_check(x, y)),
     [N, N])

# ---- creation
_GROUP[0] = "math"
case("creation_like", lambda P, x: (
    P.zeros_like(x), P.ones_like(x, dtype="int32"), P.full_like(x, 2.5),
    P.empty_like(x).shape and P.zeros_like(x), gen(P).full_like_k(
        x, value=3.0)), [N], ops=("full_like_k",), low=True,
     group="creation")
case("creation_sized", lambda P, x: (
    P.full([3, 4], 1.5), P.full([2], 7), P.full([2], True),
    P.linspace(-1, 3, 17), P.logspace(0, 2, 9), P.logspace(0, 3, 4, 2.0),
    P.eye(4), P.eye(3, 5, dtype="int32"), P.tril_indices(5, 4, -1),
    P.triu_indices(4, 6, 1), P.arange(7), P.zeros([2, 3]),
    P.empty([2, 2]) * 0, P.numel(x)), [N],
     ops=("full_k", "linspace_k", "logspace_k", "eye_k", "tril_indices_k",
          "triu_indices_k", "numel_k"), group="creation")
case("diag", lambda P, v, m: (P.diag(v), P.diag(v, 1), P.diag(v, -2, 5),
                              P.diag(m), P.diag(m, 1), P.diagflat(m),
                              P.diagflat(v, -1)),
     [Spec("n", lambda S: (min(S.m, 64),)), Spec("n", lambda S: (6, 5))],
     ops=("diag_", "diagflat_"), grad=(0, 1), group="creation")
case("tril_triu", lambda P, x: (P.tril(x), P.triu(x, 1), P.tril(x, -2)),
     [N], ops=("tril", "triu"), grad=(0,), low=True, group="creation")
case("assign_clone", lambda P, x: (P.assign(x), x.clone()), [N],
     ops=("assign",), grad=(0,), low=True, group="creation")
case("meshgrid", lambda P, a, b: tuple(P.meshgrid(a, b)),
     [Spec("n", (4,)), Spec("n", (3,))], ops=(), group="creation")

# ---- manipulation
case("reshape_transpose", lambda P, x: (
    P.reshape(x, [-1, x.shape[-1]]), P.transpose(x, [2, 0, 1]),
    P.flatten(x, 1), P.flatten(x), P.moveaxis(x, 0, -1),
    P.t(P.flatten(x, 1))), [N],
     ops=("reshape", "transpose", "flatten_", "moveaxis_"), grad=(0,),
     low=True, group="manip")
case("squeeze_unsqueeze", lambda P, x: (
    P.squeeze(x), P.squeeze(x, 1), P.squeeze(x, [0, 2]),
    P.unsqueeze(x, [0, -1]), P.unsqueeze(x, 1)),
     [Spec("n", lambda S: (S.x[0], 1, S.x[2], 1))],
     ops=("squeeze", "unsqueeze"), grad=(0,), low=True, group="manip")
case("concat_stack_split", lambda P, x, y: (
    P.concat([x, y], axis=1), P.stack([x, y], axis=-1), P.stack([x, y]))
     + tuple(P.split(x, [1, -1], axis=2)) + tuple(P.split(x, 2, axis=-1))
     + tuple(P.chunk(y, 2, axis=-1)) + tuple(P.unbind(x, 1))
     + tuple(P.unstack(y, 0)), [N, N],
     ops=("concat_", "stack_", "split_", "unbind_"), grad=(0, 1), low=True,
     group="manip")
case("tile_expand", lambda P, x, y: (
    P.tile(x, [2, 1, 1]), P.expand(x, [2] + x.shape), P.expand_as(
        x[:, :1], y), P.broadcast_to(x[:1], y.shape))
     + tuple(P.broadcast_tensors([x[:1, :, :1], y])), [N, N],
     ops=("tile", "expand"), grad=(0,), low=True, group="manip")
case("flip_roll", lambda P, x: (
    P.flip(x, [0, 2]), P.flip(x, -1), P.roll(x, 2, 1), P.roll(x, -3),
    P.roll(x, [1, 2], [0, 2]), P.reverse(x, 1), P.rot90(x),
    P.rot90(x, 3, (1, 2))), [N], ops=("flip", "roll_", "rot90"),
     grad=(0,), low=True, group="manip")
case("repeat_interleave", lambda P, x: (
    P.repeat_interleave(x, 2, axis=1), P.repeat_interleave(x, 3)), [N],
     ops=("repeat_interleave_",), grad=(0,), low=True, group="manip")
case("pad", lambda P, x: (
    P.pad(x, [1, 2, 0, 1, 2, 0]), P.pad(x, [1, 2], value=0.5),
    P.pad(x, [2, 1, 1, 2], mode="reflect"),
    P.pad(x, [2, 1], mode="replicate"),
    P.pad(x, [1, 3, 2, 1], mode="circular")), [N], ops=("pad_",),
     grad=(0,), low=True, group="manip")
case("diagonal", lambda P, x: (P.diagonal(x), P.diagonal(x, 1, 1, 2),
                               P.diagonal(x, -1, 0, 2)), [N],
     ops=("diagonal_",), grad=(0,), low=True, group="manip")
case("masked_fill", lambda P, x, m: (
    P.masked_fill(x, m, 0.5), P.masked_fill(x, m[:1], -2.0)), [N, B],
     ops=("masked_fill_",), grad=(0,), low=True, group="manip")
case("cast", lambda P, x: (P.cast(x, "int32"), P.cast(x, "bfloat16"),
                           x.astype("float16"), P.cast(x, "bool"),
                           P.view(x, [x.shape[0], -1])), [U(-5, 5)],
     ops=("cast",), group="manip")
case("tensor_methods", lambda P, x: (
    x.abs(), x.exp(), x.sum(axis=-1), x.max(axis=0), x.flip([1]),
    x.clip(-0.2, 0.3),
    x.scale(2.0), x.topk(2)[0], x.sort(axis=1), x.argsort(axis=0),
    x.tile([1, 2, 1]), x.norm(), x.std(), x.median(axis=-1)), [N],
     ops=(), grad=(0,), low=True, group="manip")

# ---- reductions
_RED = [("sum", N), ("mean", N), ("max", N), ("min", N), ("amax", N),
        ("amin", N), ("prod", U(0.9, 1.1)), ("logsumexp", N),
        ("nansum", Spec("nan", "x")), ("nanmean", Spec("nan", "x"))]
for _n, _spec in _RED:
    _grad = (0,) if _n not in ("nansum", "nanmean") else ()
    case(_n, (lambda n: lambda P, x: (
        getattr(P, n)(x), getattr(P, n)(x, axis=-1),
        getattr(P, n)(x, axis=[0, 2], keepdim=True),
        getattr(P, n)(x, axis=1)))(_n), [_spec if _grad else Spec(
            "u", "x")],
         ops=(_n + "_" if _n == "sum" else _n,), grad=_grad,
         family="reduce", low=True, group="reduce")
case("nan_reductions", lambda P, x: (P.nansum(x, axis=-1),
                                     P.nanmean(x, axis=-1),
                                     P.nanmedian(x, axis=-1)),
     [Spec("u", "x")], ops=("nansum", "nanmean", "nanmedian"),
     family="reduce", group="reduce")
case("max_ties", lambda P, x: (P.max(x, axis=-1), P.amin(x, axis=1)),
     [Spec("t", "x", 0, 3)], ops=("max", "amin"), grad=(0,),
     family="reduce", low=True, group="reduce")
case("all_any", lambda P, b: (P.all(b), P.any(b, axis=-1),
                              P.all(b, axis=[0, 1], keepdim=True),
                              P.count_nonzero(b, axis=1)),
     [B], ops=("all", "any", "count_nonzero_"), group="reduce")
case("int_reductions", lambda P, x: (P.sum(x), P.sum(x, axis=1),
                                     P.prod(x[..., :3], axis=-1),
                                     P.mean(x), P.max(x, axis=0)),
     [I(-3, 4, dtype="int32")], ops=("sum_", "prod", "mean", "max"),
     group="reduce")
case("std_var", lambda P, x: (P.std(x), P.var(x, axis=-1),
                              P.std(x, axis=[0, 1], unbiased=False),
                              P.var(x, axis=1, keepdim=True)), [N],
     ops=("std_", "var_"), grad=(0,), family="reduce", low=True,
     group="reduce")
case("median", lambda P, x: (P.median(x), P.median(x, axis=-1),
                             P.median(x, axis=1, keepdim=True)), [N],
     ops=("median_",), grad=(0,), family="reduce", low=True,
     group="reduce")
case("median_nan_even", lambda P, x: (P.median(x, axis=-1),
                                      P.median(x, axis=0)),
     [Spec("nan", lambda S: (S.x[0], 2 * (S.x[1] // 2), S.x[2]))],
     ops=("median_",), family="reduce", group="reduce")
case("quantile", lambda P, x: (P.quantile(x, 0.3), P.quantile(x, 0.75,
                                                              axis=-1),
                               P.quantile(x, [0.1, 0.5], axis=1),
                               P.quantile(x, 0.5, axis=[0, 2],
                                          keepdim=True)),
     [N], ops=("quantile_",), grad=(0,), family="reduce", group="reduce")
case("count_nonzero", lambda P, x: (P.count_nonzero(x),
                                    P.count_nonzero(x, axis=-1,
                                                    keepdim=True)),
     [Spec("t", "x", -1, 2)], ops=("count_nonzero_",), group="reduce")

# ---- linear algebra
case("matmul", lambda P, x, y: (P.matmul(x, y), P.matmul(
    x, y, transpose_y=True), P.matmul(x, y, transpose_x=True), P.bmm(x, y)),
     [Spec("n", "bmm"), Spec("n", "bmm")], ops=("matmul",), grad=(0, 1),
     family="matmul", low=True, fp16=True, group="linalg")
case("mm_mv_dot", lambda P, a, v, w: (P.mm(a, a), P.mv(a, v), P.dot(v, w),
                                      P.outer(v, w), P.dot(a, a),
                                      P.multi_dot([a, a, v])),
     [Spec("n", "m"), Spec("n", "mv"), Spec("n", "mv")],
     ops=("matmul", "dot_", "outer_"), grad=(0, 1, 2), family="matmul",
     low=True, group="linalg")
case("einsum", lambda P, x, y: (P.einsum("bij,bjk->bik", x, y),
                                P.einsum("bii->b", x),
                                P.einsum("bij->j", y)),
     [Spec("n", "bmm"), Spec("n", "bmm")], ops=("einsum_",), grad=(0, 1),
     family="matmul", low=True, group="linalg")
case("bmm_mv_k", lambda P, x, y, v: (gen(P).bmm_k(x, y),
                                     gen(P).mv_k(x[0], v)),
     [Spec("n", "bmm"), Spec("n", "bmm"), Spec("n", lambda S: S.bmm[-1:])],
     ops=("bmm_k", "mv_k"), grad=(0, 1), family="matmul", group="linalg")
case("norm", lambda P, x: (
    P.norm(x), P.norm(x, p=1, axis=-1), P.norm(x, p=2, axis=1),
    P.norm(x, p=float("inf"), axis=-1), P.norm(x, p=float("-inf"), axis=0),
    P.norm(x, p=0, axis=-1), P.norm(x, p=3, axis=[0, 2], keepdim=True),
    P.linalg.vector_norm(x[0, 0]), P.linalg.vector_norm(x, p=1.0, axis=-1),
    gen(P).frobenius_norm_k(x, axis=(0, 1), keepdim=False)),
     [N], ops=("p_norm_", "linalg_vector_norm", "frobenius_norm_k"),
     grad=(0,), family="reduce", low=True, group="linalg")
case("matrix_norm", lambda P, a: (
    P.linalg.matrix_norm(a), P.linalg.matrix_norm(a, p=1),
    P.linalg.matrix_norm(a, p=float("inf"))), [Spec("n", "m")],
     ops=("linalg_matrix_norm",), grad=(0,), family="reduce",
     group="linalg")
case("svd_norms", lambda P, a, s: (
    P.linalg.matrix_norm(a, p="nuc"), P.linalg.cond(s),
    P.linalg.matrix_rank(a), P.linalg.matrix_rank(a, tol=0.5)),
     [Spec("svdm", "m"), Spec("spd", "m")],
     ops=("linalg_matrix_norm", "linalg_cond", "linalg_matrix_rank"),
     family="linalg", group="linalg")
case("trace_cross_cdist", lambda P, x, y, a, b: (
    P.trace(x), P.trace(x, 1, 1, 2), P.cross(a, b), P.cross(a, b, axis=0),
    P.linalg.cdist(y, y * 0.5), P.linalg.cdist(y, y * 2.0, 1.0)),
     [Spec("n", "bmm"), Spec("n", lambda S: (S.bmm[0], S.bmm[1] // 4 + 1,
                                             32)),
      Spec("n", (3, 7)), Spec("n", (3, 7))], ops=("trace_", "cross_"),
     grad=(0, 1, 2, 3),
     family="reduce", low=True, group="linalg",
     low_grad=False)


def _sign_fix(P, v):
    """Columns of ``v`` with the sign that makes the largest-magnitude
    entry positive (eigen- and singular vectors are defined up to it)."""
    idx = P.argmax(P.abs(v), axis=-2, keepdim=True)
    return v * P.sign(P.take_along_axis(v, idx, -2))


case("cholesky_solve", lambda P, a, b: (
    P.linalg.cholesky(a), P.linalg.cholesky(a, upper=True),
    P.linalg.inv(a), P.linalg.solve(a, b), P.linalg.det(a[:4, :4]),
    P.linalg.slogdet(a), P.cholesky_solve(b, P.linalg.cholesky(a)),
    P.linalg.matrix_power(a, 3), P.linalg.matrix_power(a, -1)),
     [Spec("spd", "m"), Spec("n", "mk")],
     ops=("cholesky_", "inverse_", "solve_", "det_", "slogdet_",
          "cholesky_solve_", "matrix_power_"), grad=(0, 1),
     family="linalg", group="linalg")
case("triangular_solve", lambda P, a, b: (
    P.linalg.triangular_solve(a, b),
    P.linalg.triangular_solve(a, b, transpose=True),
    P.linalg.triangular_solve(P.transpose(a, [1, 0]), b, upper=False),
    P.linalg.triangular_solve(a, b, unitriangular=True)),
     [Spec("tri", "m"), Spec("n", "mk")], ops=("triangular_solve_",),
     grad=(0, 1), family="linalg", low=True, group="linalg", low_grad=False)
# the reconstructions are held forward only: their gradient through the
# factors cancels terms in 1 / (s_i^2 - s_j^2), exactly in arithmetic but
# not in floating point. The values and eight vectors are held at 1024 x
# 1024; their gradient at ``mg`` x ``mg``: a vector's gradient sums over
# every other vector divided by the gap between their values, and at n =
# 1024 in float32 the vectors of the smaller values are known only to
# about n^2 eps / gap (a tenth of their size at the spectrum below)
case("svd", lambda P, a: (
    (lambda u, s, vh: (s, _sign_fix(P, u[:, :8])))(*P.linalg.svd(a)),
    P.svdvals(a)),
     [Spec("svdm", "m")], ops=("svd_", "svdvals_"), family="linalg",
     group="linalg")
case("svd_grad", lambda P, a: (
    (lambda u, s, vh: (s, _sign_fix(P, u[:, :8])))(*P.linalg.svd(a)),
    P.svdvals(a)),
     [Spec("svdm", "mg")], ops=("svd_", "svdvals_"), grad=(0,),
     family="linalg", group="linalg")
case("svd_recon", lambda P, a: (lambda u, s, vh: P.matmul(
    u * s.unsqueeze(-2), vh))(*P.linalg.svd(a)), [Spec("svdm", "m")],
     ops=("svd_",), family="linalg", group="linalg")
case("pinv", lambda P, a: P.linalg.pinv(a), [Spec("svdm", "m")],
     ops=("pinv_",), family="linalg", group="linalg")
case("qr", lambda P, a: (
    (lambda q, r: (P.matmul(q, r), P.abs(r)))(*P.linalg.qr(a)),
    P.linalg.qr(a, mode="r").abs()),
     [Spec("n", "m")], ops=("qr_",), grad=(0,), family="linalg",
     group="linalg")
case("eigh", lambda P, s: (
    (lambda w, v: (w, _sign_fix(P, v[:, -8:])))(*P.linalg.eigh(s)),
    P.linalg.eigvalsh(s), gen(P).eigvalsh_k(s)),
     [Spec("eigm", "m")], ops=("eigh_", "eigvalsh_k"), family="linalg",
     group="linalg")
case("eigh_grad", lambda P, s: (
    (lambda w, v: (w, _sign_fix(P, v[:, -8:])))(*P.linalg.eigh(s)),
    P.linalg.eigvalsh(s), gen(P).eigvalsh_k(s)),
     [Spec("eigm", "mg")], ops=("eigh_", "eigvalsh_k"), grad=(0,),
     family="linalg", group="linalg")
case("eigh_recon", lambda P, s: (lambda w, v: P.matmul(
    v * w.unsqueeze(-2), P.transpose(v, [1, 0])))(*P.linalg.eigh(s)),
     [Spec("eigm", "m")], ops=("eigh_",), family="linalg", group="linalg")
case("eig", lambda P, s: (
    (lambda w, v: (P.real(P.matmul(v * w.unsqueeze(-2), P.linalg.inv(v))),
                   P.sort(P.real(w)), P.sort(P.real(P.linalg.eigvals(
                       s)))))(*P.linalg.eig(s)),),
     [Spec("spd", "m")], ops=("linalg_eig", "linalg_eigvals"),
     family="linalg", group="linalg")
case("lu", lambda P, a: P.linalg.lu(a), [Spec("dd", "m")],
     ops=("linalg_lu",), family="linalg", group="linalg")
case("lstsq", lambda P, t, b: P.linalg.lstsq(t, b)[:3],
     [Spec("n", lambda S: (S.m + 4, S.m)), Spec("n", lambda S: (S.m + 4, 3))],
     ops=("linalg_lstsq",), family="linalg", group="linalg")
case("householder_product", lambda P, a, t: P.linalg.householder_product(
    a, t), [Spec("n", "m"), Spec("u", lambda S: (S.m // 2,), 0.5, 1.5)],
     ops=("householder_product_",), grad=(0, 1), family="linalg",
     group="linalg")
case("cov_corrcoef", lambda P, x: (P.linalg.cov(x), P.linalg.corrcoef(x),
                                   P.linalg.cov(x, rowvar=False,
                                                ddof=False)),
     [Spec("n", lambda S: (8, S.x[-1]))], ops=(),
     family="reduce", group="linalg")
case("matrix_transpose", lambda P, x: P.linalg.matrix_transpose(x), [N],
     ops=(), grad=(0,), group="linalg")
case("tensordot", lambda P, x, y, z: (P.tensordot(x, y, 1),
                                      P.tensordot(x, z, [[1, 2], [0, 1]])),
     [Spec("n", "x"), Spec("n", lambda S: (S.x[2], 2)),
      Spec("n", lambda S: S.x[1:] + (2,))],
     ops=("tensordot_op",), grad=(0, 1, 2), family="matmul",
     group="linalg")

# ---- search, sort, gather, scatter
case("argmax_argmin", lambda P, x: (
    P.argmax(x), P.argmax(x, axis=-1), P.argmin(x, axis=1, keepdim=True),
    P.argmin(x, axis=0, dtype="int32"), P.argmax(x, keepdim=True)),
     [Spec("t", "x", 0, 5)], ops=("argmax_", "argmin_"), low=True,
     group="search")
case("sort_ties_nan", lambda P, x: (
    P.sort(x, axis=-1), P.argsort(x, axis=-1),
    P.sort(x, axis=1, descending=True), P.argsort(x, 0, descending=True)),
     [Spec("nan", "x")], ops=("argsort_", "take_along_axis_"), grad=(),
     low=True, group="search")
case("sort_ties", lambda P, x: (
    P.sort(x, axis=-1), P.argsort(x, axis=-1, descending=True),
    P.argsort(x, axis=1), P.sort(x, axis=0, descending=True)),
     [Spec("t", "x", 0, 4)], ops=("argsort_",), grad=(0,), low=True,
     group="search")
case("sort_int", lambda P, x, u: (P.argsort(x, descending=True),
                                  P.sort(x, axis=1), P.argsort(u),
                                  P.argsort(u, descending=True)),
     [I(-4, 4), I(0, 4, dtype="uint8")], ops=("argsort_",), group="search")
case("topk", lambda P, x: (
    P.topk(x, 3), P.topk(x, 2, axis=0), P.topk(x, 3, largest=False),
    P.topk(x, 1, axis=1)), [Spec("t", "x", 0, 4)], ops=("arg_topk_",),
     grad=(0,), low=True, group="search")
case("kthvalue_mode", lambda P, x: (
    P.kthvalue(x, 2), P.kthvalue(x, 1, axis=0, keepdim=True),
    P.mode(x), P.mode(x, axis=1, keepdim=True)),
     [Spec("t", "x", 0, 3)], ops=("kthvalue_k", "mode_k"), low=True,
     group="search")
case("searchsorted", lambda P, s, v: (
    P.searchsorted(s, v), P.searchsorted(s, v, right=True),
    P.searchsorted(s, v, out_int32=True), P.bucketize(v, s)),
     [Spec("sorted", "vec", -2, 2), Spec("t", "x", -3, 3)],
     ops=("searchsorted_",), group="search")
case("where", lambda P, c, x, y: (P.where(c, x, y), P.where(c, x, 0.5),
                                  P.where(c, 1.0, y)), [B, N, N],
     ops=("where_",), grad=(1, 2), low=True, group="search")
case("nonzero_masked_select", lambda P, x, m: (
    P.nonzero(m), P.masked_select(x, m)) + P.nonzero(m, as_tuple=True)
     + P.where(m), [N, B], ops=(), grad=(0,), sync=True, group="search")
case("gather", lambda P, x, i, j: (
    P.gather(x, i), P.gather(x, j, axis=2), P.gather(x, j, axis=-2),
    P.index_select(x, j, axis=1), gen(P).index_select_strided(
        x, i, axis=-1)),
     [N, Spec("idx", (5,), 0, 3, "int64"),
      Spec("idx", lambda S: (S.n_idx,), 0, 4, "int64")],
     ops=("gather_", "index_select_", "index_select_strided"), grad=(0,),
     low=True, group="search")
case("gather_nd", lambda P, x, i: (P.gather_nd(x, i),
                                   P.gather_nd(x, i[:, :2])),
     [N, Spec("idx", lambda S: (S.n_idx, 3), 0, 3, "int64")],
     ops=("gather_nd_",), grad=(0,), low=True, group="search")
case("take_put_along_axis", lambda P, x, i, v: (
    P.take_along_axis(x, i, -1), P.put_along_axis(x, i, v, -1),
    P.put_along_axis(x, i, v, -1, reduce="add"),
    P.put_along_axis(x, i, 2.0, -1, reduce="multiply")),
     [N, Spec("idx", lambda S: S.x[:-1] + (5,), 0, 4, "int64"),
      Spec("n", lambda S: S.x[:-1] + (5,))],
     ops=("take_along_axis_", "put_along_axis_"), grad=(0, 2),
     group="search")
case("scatter", lambda P, x, i, u: (
    P.scatter(x, i, u), P.scatter(x, i, u, overwrite=False),
    P.scatter_nd_add(x, P.unsqueeze(i, -1), u),
    P.scatter_nd(P.unsqueeze(i, -1), u, x.shape)),
     [Spec("n", "x2"), Spec("idx", lambda S: (S.n_idx,), 0, 4, "int64"),
      Spec("n", lambda S: (S.n_idx, S.x[2]))],
     ops=("scatter_", "scatter_nd_add_"), grad=(0, 2), family="reduce",
     group="search")
case("index_add_put", lambda P, x, i, v, w: (
    P.index_add(x, i, 1, v), P.index_put(x, (i, i), w),
    P.index_put(x, (i, i), w, accumulate=True), P.index_sample(
        x[0], P.reshape(i, [1, -1]).tile([x.shape[1], 1]))),
     [N, Spec("idx", lambda S: (S.n_idx,), 0, 3, "int64"),
      Spec("n", lambda S: (S.x[0], S.n_idx, S.x[2])),
      Spec("n", lambda S: (S.n_idx, S.x[2]))],
     ops=("index_add_", "index_put_", "index_sample_"), grad=(0, 2, 3),
     family="reduce", group="search")
case("unique", lambda P, x: P.unique(
    x, return_index=True, return_inverse=True, return_counts=True)
     + (P.unique(x),) + P.unique_consecutive(
         x, return_inverse=True, return_counts=True),
     [I(0, 7, dtype="int64")], ops=(), sync=True, group="search")
case("getitem", lambda P, x, i, m: (
    x[1], x[:, 1:3], x[..., ::2], x[::-1, :, 1], x[None, 0, ..., -1],
    x[i], x[:, i], x[i, :, i], x[m], x[0][m[0]], x[[0, 1]],
    x[1:, ::-2, 3]),
     [N, Spec("idx", (4,), 0, 3, "int64"), B],
     ops=("getitem_",), grad=(0,), low=True, sync=True, group="search")


def _setitems(P, x, v, i, m):
    """One write into each copy of ``x`` (the reference refuses the
    backward of a tensor written twice)."""
    writes = [(0, 2.0), ((slice(None), slice(1, 3)), v[:, 1:3]),
              ((Ellipsis, slice(None, None, -2)), 0.5), (i, v[0]),
              (m, -1.0), ((0, slice(None), [1, 3]), v[0, :, :2].t())]
    out = []
    for idx, val in writes:
        y = x * 1.0
        y[idx] = val
        out.append(y)
    return tuple(out)


case("setitem", _setitems, [N, N, Spec("perm", lambda S: (2,), 0, 3,
                                       "int64"), B],
     ops=("setitem_",), grad=(0, 1), low=True, sync=True, group="search")

# ---- extra
case("extra_shapes", lambda P, x, t: (
    P.diff(x), P.diff(x, n=2, axis=0), P.unfold(x, -1, 3, 2),
    P.select_scatter(x, x[:, 0] * 2, 1, 0),
    P.take(x, t), P.take(x, t * 100, mode="clip"),
    P.renorm(x, 2.0, 0, 1.0)), [N, I(-3, 9, (4,))],
     ops=("diff", "unfold_op", "select_scatter_op", "take_op",
          "renorm_op"), grad=(0,), low=True, group="manip")
case("trapezoid", lambda P, x: (P.trapezoid(x), P.trapezoid(
    x, dx=0.5, axis=0), P.trapezoid(x, x[0, 0])), [N], grad=(0,),
     family="reduce", low=True, group="reduce")
case("vander_frexp", lambda P, v: (P.vander(v), P.vander(v, 4, True))
     + P.frexp(v * 10.0), [Spec("u", lambda S: (min(S.m, 64),), -2, 2)],
     ops=("vander", "frexp"), grad=(0,), group="manip")
case("bincount_histogram", lambda P, i, w, x: (
    P.bincount(i), P.bincount(i, w), P.bincount(i, minlength=20),
    P.histogram(x, bins=10), P.histogram(x, bins=7, min=-1, max=1)),
     [I(0, 9, "nidx"), Spec("u", "nidx", 0, 1), N],
     ops=("bincount", "histogram_op"), sync=True, group="reduce")

# ---- parity
case("fused_bias_act", lambda P, x, b: tuple(
    P.fused_bias_act(x, b, a) for a in ("gelu", "relu", "silu", "swiglu")),
     [N, Spec("n", "vec")], grad=(0, 1), family="composite", low=True,
     group="parity")
case("fused_softmax", lambda P, x, m: (
    P.fused_softmax_mask(x, m), P.fused_softmax_mask_upper_triangle(x)),
     [Spec("n", "bmm"), Spec("n", "bmm")],
     ops=("fused_softmax_mask", "fused_softmax_mask_upper_triangle"),
     grad=(0, 1), family="composite", scan=True, low=True, group="parity")
case("fused_gemm_epilogue", lambda P, x, y, b: (
    P.fused_gemm_epilogue(x, y, b),
    P.fused_gemm_epilogue(x, y, b, activation="relu"),
    P.fused_gemm_epilogue(x, y, b, trans_x=True, activation="gelu")),
     [Spec("n", "m"), Spec("n", "m"), Spec("n", "mv")], grad=(0, 1, 2),
     family="matmul", low=True, group="parity")
case("skip_layernorm", lambda P, x, s, w, b: (
    P.skip_layernorm(x, s, w, b),
    P.fused_bias_dropout_residual_layer_norm(x, s, b, w, b,
                                             training=False)),
     [N, N, Spec("n", "vec"), Spec("n", "vec")],
     ops=("skip_layernorm", "fused_bias_dropout_residual_layer_norm"),
     grad=(0, 1, 2, 3), family="reduce", low=True, group="parity")
case("fused_dropout_add_eval", lambda P, x, y: (
    P.fused_dropout_add(x, y, 0.3, training=False),
    P.fused_dropout_add(x, y, 0.3, training=False,
                        mode="downscale_in_infer"),
    P.fused_dropout_add(x, y, 0.0)), [N, N], ops=("fused_dropout_add",),
     grad=(0, 1), family="composite", low=True, group="parity")
case("fused_linear_param_grad_add", lambda P, x, d, w, b: (
    P.fused_linear_param_grad_add(x, d)
    + P.fused_linear_param_grad_add(x, d, w, b)
    + P.fused_linear_param_grad_add(x, d, has_bias=False)),
     [N, N, Spec("n", lambda S: (S.x[2], S.x[2])), Spec("n", "vec")],
     grad=(0, 1), family="matmul", low=True, group="parity")
case("fused_elementwise", lambda P, x, y: (
    gen(P).fused_elementwise_add(x, y, scale=2.0),
    gen(P).fused_elementwise_sub(x, y, scale=0.5),
    gen(P).fused_elementwise_mul(x, y, scale=3.0),
    gen(P).fused_elementwise_div(x, y, scale=1.0)), [N, _POS],
     ops=("fused_elementwise_add", "fused_elementwise_sub",
          "fused_elementwise_mul", "fused_elementwise_div"), grad=(0, 1),
     low=True, group="parity")
case("views", lambda P, x: (
    P.as_strided(x, [3, 4], [5, 2], 1), P.as_strided(x, [2, 2, 3], [7, 1, 2]),
    P.view_dtype(x, "int32"), P.view_dtype(x, "bfloat16"),
    P.view_slice(x, [0, 1, 2], [2, 3, 5]), P.trans_layout(x, [1, 2, 0])),
     [N], ops=("as_strided", "view_dtype", "view_slice", "trans_layout"),
     grad=(0,), group="parity")
case("fill_diagonal_tensor", lambda P, x, y, z: (
    P.fill_diagonal_tensor(x, y), P.fill_diagonal_tensor(x, y[:-1], 1),
    P.fill_diagonal_tensor(x, z, -1, 0, 1)),
     [Spec("n", lambda S: (6, 6)), Spec("n", (6,)), Spec("n", (6,))],
     grad=(0, 1, 2), group="parity")
case("compare_utils", lambda P, x, t, lens, ids: (
    P.ops.parity.kldiv_loss_pointwise(x, t),
    P.ops.parity.sigmoid_cross_entropy_with_logits(x, t),
    P.ops.parity.label_smooth(t), P.ops.parity.label_smooth(t, t[0, 0],
                                                            0.2),
    P.ops.parity.sequence_mask(lens, 9), P.ops.parity.shard_index(
        ids, 40, 4, 1), P.shard_index(ids, 40, 4, 2),
    P.ops.parity.shuffle_channel(x, 2), gen(P).increment_k(x, value=2.0),
    gen(P).shape_k(x)),
     [N, U(0, 1), I(0, 9, "nidx"), I(0, 40, "nidx")],
     ops=("kldiv_pointwise_k", "sigmoid_cross_entropy_with_logits_k",
          "label_smooth_k", "sequence_mask_k", "shard_index_k",
          "shuffle_channel_k", "increment_k", "shape_k"), grad=(0, 1),
     family="composite", low=True, group="parity")
case("interp", lambda P, x: (
    P.ops.parity.bilinear_interp(x, [8, 10]),
    P.ops.parity.nearest_interp(x, [8, 12]),
    P.ops.parity.bicubic_interp(x, [8, 9]),
    P.ops.parity.linear_interp(x[:, :, 0], [11]),
    P.ops.parity.trilinear_interp(P.unsqueeze(x, 2), [2, 8, 10])),
     [Spec("n", "img")], ops=tuple(
         "bilinear_interp nearest_interp bicubic_interp linear_interp "
         "trilinear_interp".split()), grad=(0,), group="parity")
case("gru_partial", lambda P, x, h, wu, wr, wc: (
    P.ops.parity.gru_unit(x, h, wu, wr, wc),
    P.ops.parity.partial_sum([x, h], 1, 2),
    P.ops.parity.partial_concat([x, h], 0, 3)),
     [Spec("n", lambda S: (S.x[0], 6)), Spec("n", lambda S: (S.x[0], 6)),
      Spec("n", (12, 6)), Spec("n", (12, 6)), Spec("n", (12, 6))],
     ops=("gru_unit_k", "partial_sum_k", "partial_concat_k"),
     grad=(0, 1, 2, 3, 4), family="matmul", group="parity")
case("moe_aux", lambda P, ids, cnt, cap: (
    P.ops.parity.number_count(ids, 8),
    P.ops.parity.limit_by_capacity(cnt, cap, 2),
    P.ops.parity.prune_gate_by_capacity(ids, cnt, 8)),
     [I(-1, 8, "nidx"), I(0, 5, (16,)), I(0, 5, (8,))],
     ops=("number_count_k", "limit_by_capacity_k",
          "prune_gate_by_capacity_k"), group="parity")
case("metrics", lambda P, idx, lab, pred, bl: (
    P.ops.parity.accuracy_op(idx, lab), P.ops.parity.auc_op(pred, bl),
    P.ops.parity.auc_op(pred, bl, 50)),
     [I(0, 5, lambda S: (S.n_idx, 3)), I(0, 5, lambda S: (S.n_idx, 1)),
      U(0, 1, lambda S: (S.n_idx, 2)), I(0, 2, lambda S: (S.n_idx, 1))],
     ops=("accuracy_k", "auc_k"), group="parity")
case("decode", lambda P, a, b, al, bl, pot, tr, ln: (
    P.ops.parity.edit_distance(a, b, al, bl),
    P.ops.parity.edit_distance(a, b, al, bl, normalized=True))
     + P.ops.parity.viterbi_decode(pot, tr, ln)
     + P.ops.parity.viterbi_decode(pot, tr),
     [I(0, 4, lambda S: S.edit),
      I(0, 4, lambda S: S.edit),
      I(0, 7, lambda S: (S.edit[0],)), I(1, 7, lambda S: (S.edit[0],)),
      Spec("n", "seq"), Spec("n", lambda S: (S.seq[2], S.seq[2])),
      I(1, 6, lambda S: (S.seq[0],))],
     ops=("edit_distance_k", "viterbi_decode_k"), group="parity")
case("boxes", lambda P, bx, hw, fm, im: (
    P.ops.parity.box_clip(bx, hw),
    P.ops.parity.prior_box(fm, im, [4.0, 8.0], [9.0], [2.0])),
     [U(-5, 40, lambda S: (S.n_idx, 4)), Spec("u", (2,), 20, 30),
      Spec("n", (1, 2, 5, 6)), Spec("n", (1, 3, 40, 48))],
     ops=("box_clip_k", "prior_box_k"), group="parity")
case("quant_linear_i8", lambda P, x, w, s: gen(P).quant_linear_i8(
    x, w, s, act_scale=0.05, qmax=127.0),
     [Spec("n", "x2"), I(-127, 128, lambda S: (S.x[2], 16), "int8"),
      U(0.01, 0.02, (16,))], family="matmul", group="parity")
case("top_p_sampling_seeded", lambda P, p, ps: P.top_p_sampling(
    p, ps, seed=7)[1].shape and (P.topk(p, 1)[1],),
     [Spec("u", lambda S: (S.x[0], S.x[-1]), 0, 1), U(0.0, 0.1, lambda S:
                                                        (S.x[0],))],
     ops=("top_p_sampling",), group="search")

# ---- nn.functional: the activations, attention, common, conv, pooling,
# norm, loss and extended ops (their shapes at FULL chosen for phase 12's
# CPU side, which runs each on the host)
_GROUP[0] = "nn"


def _by(small, full):
    """A shape: ``small`` at SMALL, ``full`` at any other size."""
    return lambda S: small if S == SMALL else full


_CHW = _by((2, 4, 6, 8), (8, 32, 64, 64))          # NCHW images
_VOL = _by((2, 2, 4, 5, 6), (4, 8, 16, 32, 32))    # NCDHW volumes
_ROWS = _by((6, 5), (4096, 1024))                  # [N, C] logits
_ATT = _by((2, 6, 2, 8), (8, 256, 8, 64))          # [B, S, H, D]
_PAIRS = _by((6, 8), (4096, 128))                  # [N, D] embeddings
_UNIT = U(0.05, 0.95)
_ACTS = [
    ("celu", lambda F, x: F.celu(x, 1.3), ("celu",)),
    ("elu", lambda F, x: F.elu(x, 0.7), ("elu",)),
    ("selu", lambda F, x: F.selu(x), ("selu",)),
    ("hardtanh", lambda F, x: F.hardtanh(x, -0.5, 0.7), ("hardtanh",)),
    ("hardshrink", lambda F, x: F.hardshrink(x, 0.3), ("hardshrink",)),
    ("softshrink", lambda F, x: F.softshrink(x, 0.3), ("softshrink",)),
    ("thresholded_relu", lambda F, x: F.thresholded_relu(x, 0.2, 0.1),
     ("thresholded_relu",)),
    ("leaky_relu", lambda F, x: F.leaky_relu(x, 0.05), ("leaky_relu",)),
    ("softplus", lambda F, x: (F.softplus(x), F.softplus(x, 2.0, 5.0)),
     ("softplus",)),
    ("log_sigmoid", lambda F, x: F.log_sigmoid(x), ("log_sigmoid",)),
    ("log_softmax", lambda F, x: F.log_softmax(x, -1), ("log_softmax",)),
    ("glu", lambda F, x: F.glu(x, -1), ("glu_k",)),
]
for _n, _f, _ops in _ACTS:
    case(f"nn_{_n}", (lambda f: lambda P, x: f(F(P), x))(_f), [U(-3, 3)],
         ops=_ops, grad=(0,), low=True,
         family="composite" if _n in ("log_softmax", "glu", "selu",
                                      "celu", "elu", "softplus",
                                      "log_sigmoid") else "exact")
case("nn_prelu", lambda P, x, w: (F(P).prelu(x, w),
                                  F(P).prelu(x, w[:1])),
     [U(-3, 3), U(0.0, 0.5, lambda S: (S.x[1],))], ops=("prelu_k",),
     grad=(0, 1))
case("nn_sdpa", lambda P, q, k, v, m: (
    F(P).scaled_dot_product_attention(q, k, v, is_causal=True),
    F(P).scaled_dot_product_attention(q, k, v, m)),
     [Spec("n", _ATT), Spec("n", _ATT), Spec("n", _ATT),
      Spec("n", lambda S: (1, _ATT(S)[2], _ATT(S)[1], _ATT(S)[1]))],
     ops=("sdpa",), grad=(0, 1, 2), family="matmul")
case("nn_common", lambda P, x, y: (
    F(P).cosine_similarity(x, y, axis=1), F(P).normalize(x, 2, 1),
    F(P).normalize(x, 1, -1), F(P).label_smooth(F(P).softmax(y, -1))),
     [N, N], ops=("cosine_similarity_k", "normalize_k", "softmax"),
     grad=(0, 1))
case("nn_bilinear", lambda P, a, b, w, bias: F(P).bilinear(a, b, w, bias),
     [Spec("n", _by((5, 4), (4096, 32))), Spec("n", _by((5, 3), (4096, 32))),
      Spec("n", _by((6, 4, 3), (64, 32, 32))),
      Spec("n", _by((1, 6), (1, 64)))],
     ops=("bilinear_k",), grad=(0, 1, 2, 3), family="matmul")
case("nn_interpolate", lambda P, x: tuple(
    F(P).interpolate(x, size=s, mode=m, align_corners=a)
    for m, a, s in (("nearest", False, (11, 5)),
                    ("bilinear", False, (11, 13)),
                    ("bilinear", False, (3, 5)),
                    ("bicubic", False, (9, 15)),
                    ("area", False, (3, 4)),
                    ("bilinear", True, (11, 13)),
                    ("bicubic", True, (4, 10)))),
     [Spec("n", _CHW)], ops=("interpolate_k",), grad=(0,), family="matmul")
case("nn_fold", lambda P, x, c: (
    F(P).unfold(x, 3, 1, 1), F(P).unfold(x, [2, 3], 2, 0, [1, 2]),
    F(P).fold(c, x.shape[2:], 3, 1, 1)),
     [Spec("n", _CHW), Spec("n", lambda S: (
         _CHW(S)[0], _CHW(S)[1] * 9, _CHW(S)[2] * _CHW(S)[3]))],
     ops=("unfold_k", "fold_k"), grad=(0, 1))
case("nn_conv", lambda P, x, w, b, wt: (
    F(P).conv2d(x, w, b, padding=1), F(P).conv2d(x, w, None, stride=2),
    F(P).conv2d(P.transpose(x, [0, 2, 3, 1]), w, b, padding="SAME",
                data_format="NHWC"),
    F(P).conv2d_transpose(x, wt, None, stride=2, padding=1)),
     [Spec("n", _CHW), Spec("n", lambda S: (6, _CHW(S)[1], 3, 3)),
      Spec("n", (6,)), Spec("n", lambda S: (_CHW(S)[1], 5, 3, 3))],
     ops=("conv2d", "conv2d_transpose"), grad=(0, 1, 2, 3),
     family="matmul")
case("nn_conv3d", lambda P, x, w, b, wt: (
    F(P).conv3d(x, w, b, padding=1), F(P).conv3d(x, w, None, stride=2),
    F(P).conv3d_transpose(x, wt, None, stride=2, padding=1)),
     [Spec("n", _VOL), Spec("n", lambda S: (4, _VOL(S)[1], 3, 3, 3)),
      Spec("n", (4,)), Spec("n", lambda S: (_VOL(S)[1], 3, 3, 3, 3))],
     ops=("conv3d", "conv3d_transpose_k"), grad=(0, 1, 2, 3),
     family="matmul")


def _pools(P, x):
    f = F(P)
    out, idx = f.max_pool2d(x, 2, return_mask=True)
    return (f.max_pool2d(x, 3, 2, 1), out, idx,
            f.avg_pool2d(x, 3, 2, 1, ceil_mode=True, exclusive=False),
            f.adaptive_avg_pool2d(x, (3, 5)), f.adaptive_max_pool2d(x, 3),
            f.max_unpool2d(out, idx, 2), f.lp_pool2d(P.abs(x) + 0.1, 2, 2),
            # the reference's op max_unpool2d (nn/functional/pooling.py)
            # raises NameError (it calls jax unimported): its extended
            # max_unpool2d_k, the same function, stands in on its side
            gen(P).max_unpool2d(out, idx, out_h=x.shape[2],
                                out_w=x.shape[3])
            if P.__name__ == "paddle_tpu_torch" else
            f.max_unpool2d(out, idx, 2))


case("nn_pool", _pools, [Spec("n", _CHW)],
     ops=("max_pool_nd", "max_pool_nd_index", "avg_pool_nd",
          "adaptive_avg_pool2d", "adaptive_max_pool2d", "max_unpool2d_k",
          "max_unpool2d"), grad=(0,))
case("nn_pool3d", lambda P, x: (
    F(P).max_pool3d(x, 2), F(P).max_pool3d(x, 2, return_mask=True),
    F(P).avg_pool3d(x, 3, 2, 1), F(P).avg_pool3d(x, 2, exclusive=False)),
     [Spec("n", _VOL)], ops=("max_pool_nd", "max_pool_nd_index",
                             "avg_pool_nd"), grad=(0,))


def _norms(P, x, w, b, rm, rv):
    f = F(P)
    c = x.shape[1]
    return (f.layer_norm(x, x.shape[-1], w, b), f.rms_norm(x, w, b),
            f.group_norm(x, 2, 1e-5, w[:c], b[:c]),
            # the running statistics normalise before the training call
            # updates them: the reference's update (a set_value under
            # no_grad in its fusion window) leaks the batch statistics'
            # gradient into a later call's, which the port does not
            f.batch_norm(x, rm, rv, w[:c], b[:c], training=False),
            f.batch_norm(x, rm, rv, w[:c], b[:c], training=True),
            f.instance_norm(x), f.local_response_norm(x, 3),
            f.local_response_norm(P.transpose(x, [0, 2, 3, 1]), 2,
                                  data_format="NHWC"))


case("nn_norm", _norms,
     [Spec("n", _CHW), Spec("n", lambda S: (_CHW(S)[3],)),
      Spec("n", lambda S: (_CHW(S)[3],)),
      Spec("n", lambda S: (_CHW(S)[1],)),
      Spec("u", lambda S: (_CHW(S)[1],), 0.5, 2.0)],
     ops=("layer_norm", "rms_norm", "group_norm", "bn_stats", "bn_apply",
          "local_response_norm_k"), grad=(0, 1, 2), family="reduce")


def _ce(P, x, lbl, soft, w):
    f = F(P)
    return (f.cross_entropy(x, lbl), f.cross_entropy(x, lbl, w),
            f.cross_entropy(x, lbl, label_smoothing=0.1),
            f.cross_entropy(x, lbl, ignore_index=1, reduction="sum"),
            f.cross_entropy(x, f.softmax(soft, -1), soft_label=True),
            f.cross_entropy(f.softmax(x, -1), lbl, use_softmax=False),
            f.softmax_with_cross_entropy(x, P.unsqueeze(lbl, -1)),
            f.nll_loss(f.log_softmax(x, -1), lbl, w, reduction="none"),
            f.one_hot(lbl, x.shape[-1]))


case("nn_cross_entropy", _ce,
     [Spec("n", _ROWS), I(0, 5, lambda S: _ROWS(S)[:1]), Spec("n", _ROWS),
      U(0.5, 2.0, lambda S: _ROWS(S)[1:])],
     ops=("softmax_ce", "nll_loss_k", "one_hot_k", "log"),
     grad=(0, 2, 3), family="reduce")


def _pointwise_losses(P, x, y, p, t):
    f = F(P)
    return (f.mse_loss(x, y), f.l1_loss(x, y, "sum"),
            f.smooth_l1_loss(x, y, delta=0.5),
            f.binary_cross_entropy(p, t), f.binary_cross_entropy(p, t, y * y),
            f.binary_cross_entropy_with_logits(x, t, pos_weight=y * y),
            f.kl_div(f.log_softmax(x, -1), f.softmax(y, -1), "batchmean"),
            f.kl_div(x, y, "sum", log_target=True),
            f.sigmoid_focal_loss(x, t),
            f.huber_loss(x, y, 0.5), f.hinge_loss(x, t),
            f.log_loss(p, t), f.square_error_cost(x, y),
            f.soft_margin_loss(x, 2 * t - 1),
            f.multi_label_soft_margin_loss(x, t),
            f.gaussian_nll_loss(x, y, p), f.poisson_nll_loss(x, y * y),
            f.poisson_nll_loss(p, t + 1.5, log_input=False, full=True),
            f.margin_ranking_loss(x, y, 2 * t - 1, 0.1),
            f.dice_loss(p, t))


case("nn_losses", _pointwise_losses,
     [N, N, _UNIT, Spec("t", "x", 0, 2)],
     ops=("mse_loss_k", "l1_loss_k", "smooth_l1_k", "bce_k", "bce_logits_k",
          "kl_div_k", "sigmoid_focal_k", "huber_loss_k", "hinge_loss_k",
          "log_loss_k", "square_error_cost_k", "soft_margin_loss_k",
          "multi_label_soft_margin_loss_k", "gaussian_nll_loss_k",
          "poisson_nll_loss_k", "dice_loss_k"),
     grad=(0, 1, 2), family="reduce")


def _pair_losses(P, a, p, n, lbl):
    f = F(P)
    return (f.npair_loss(a, p, lbl), f.pairwise_distance(a, p),
            f.pairwise_distance(a, p, 1.0, keepdim=True),
            f.triplet_margin_loss(a, p, n), f.triplet_margin_loss(
                a, p, n, swap=True, reduction="none"),
            f.triplet_margin_with_distance_loss(a, p, n),
            f.cosine_embedding_loss(a, p, 2 * lbl - 1),
            f.hsigmoid_loss(a, lbl, 5, n[:4], p[:4, 0]))


case("nn_pair_losses", _pair_losses,
     [Spec("n", _PAIRS), Spec("n", _PAIRS), Spec("n", _PAIRS),
      I(0, 2, lambda S: _PAIRS(S)[:1])],
     ops=("npair_loss_k", "pairwise_distance_k", "triplet_margin_loss_k",
          "cosine_similarity_k", "hsigmoid_loss_k"),
     grad=(0, 1, 2), family="reduce")
case("nn_margin_ce", lambda P, x, lbl: F(P).margin_cross_entropy(
    x, lbl, return_softmax=True, reduction=None),
     [U(-0.9, 0.9, _ROWS), I(0, 5, lambda S: _ROWS(S)[:1])],
     ops=("margin_cross_entropy",), grad=(0,), family="reduce")


def _ctc(P, logits, labels, in_off, lab_off):
    f = F(P)
    in_len = in_off * -1 + logits.shape[0]
    lab_len = lab_off * -1 + labels.shape[1]
    return (f.ctc_loss(logits, labels, in_len, lab_len),
            f.ctc_loss(logits, labels, in_len, lab_len, reduction="sum"),
            f.ctc_loss(logits, labels, in_len, lab_len, blank=2,
                       reduction="none"))


_CTC = _by((12, 3, 5, 4), (128, 64, 32, 24))  # T, N, C, S
case("nn_ctc", _ctc,
     [Spec("n", lambda S: _CTC(S)[:3]),
      I(1, 5, lambda S: (_CTC(S)[1], _CTC(S)[3])),
      I(0, 3, lambda S: (_CTC(S)[1],)), I(0, 3, lambda S: (_CTC(S)[1],))],
     ops=("ctc_loss_k",), grad=(0,), family="reduce")



def _sampling(P, x, grid, theta):
    f = F(P)
    out = [f.grid_sample(x, grid, m, pad, a)
           for m in ("bilinear", "nearest")
           for pad in ("zeros", "border", "reflection")
           for a in (True, False)]
    shape = [x.shape[0], x.shape[1], 5, 7]
    return out + [f.affine_grid(theta, shape), f.affine_grid(
        theta, shape, align_corners=False)]


case("nn_grid_sample", _sampling,
     [Spec("n", _CHW), U(-1.2, 1.2, lambda S: (_CHW(S)[0], 5, 7, 2)),
      Spec("n", lambda S: (_CHW(S)[0], 2, 3))],
     ops=("grid_sample_k", "affine_grid_k"), grad=(0, 1, 2),
     family="matmul")
case("nn_rearrange", lambda P, x, seq: (
    F(P).pixel_shuffle(x, 2), F(P).pixel_unshuffle(x, 2),
    F(P).channel_shuffle(x, 2), F(P).temporal_shift(x, 2, 0.25),
    F(P).maxout(x, 2), F(P).zeropad2d(x, [1, 2, 0, 1]),
    F(P).dropout2d(x, training=False), F(P).alpha_dropout(x, 0.5, False)),
     [Spec("n", _CHW), Spec("n", _CHW)],
     ops=("pixel_shuffle_k", "pixel_unshuffle_k", "channel_shuffle_k",
          "temporal_shift_k", "maxout_k", "pad_"), grad=(0,),
     family="exact")
case("nn_gather_tree", lambda P, ids, parents: F(P).gather_tree(
    ids, parents),
     [I(0, 9, _by((5, 3, 4), (64, 256, 8))),
      I(0, 4, _by((5, 3, 4), (64, 256, 8)))], ops=("gather_tree",),
     family="exact")

# ---- empty and 0-d tensors
_GROUP[0] = "edge"
case("empty", lambda P, x, i: (
    P.exp(x), P.add(x, x), P.maximum(x, x), P.sum(x), P.sum(x, axis=0),
    P.cumsum(x, axis=0), P.sort(x, axis=0), P.argsort(x, axis=-1),
    P.concat([x, x]), P.reshape(x, [-1]), P.transpose(x, [1, 0]),
    P.flip(x, 0), P.gather(x, i), P.where(x > 0, x, -x), P.clip(x, 0, 1),
    P.amax(x, axis=1), P.prod(x, axis=0), P.stack([x, x], 1),
    P.matmul(x, P.transpose(x, [1, 0]))),
     [Spec("n", (0, 4)), Spec("idx", (0,), 0, 1, "int64")],
     ops=("exp", "add", "maximum", "sum_", "cumsum_", "argsort_",
          "concat_", "reshape", "transpose", "flip", "gather_", "where_",
          "clip", "amax", "prod", "stack_", "matmul"), grad=(0,),
     low=True)
case("zero_d", lambda P, x: (
    P.exp(x), x * 2.0, P.sum(x), P.mean(x), P.max(x), P.argmax(x),
    P.cumsum(x), P.median(x), P.unsqueeze(x, 0), P.reshape(x, [1]),
    P.clip(x, -0.5, 0.5), P.scale(x, 3.0), P.isnan(x), P.norm(x),
    P.logsumexp(x), P.sign(x), P.abs(x),
    P.where(x > 0, x, 0.0), P.prod(x), P.quantile(x, 0.5),
    P.tanh(x) + P.sin(x)),
     [Spec("n", ())],
     ops=("exp", "multiply", "sum_", "mean", "max", "argmax_", "cumsum_",
          "median_", "unsqueeze", "reshape", "clip", "scale", "isnan",
          "p_norm_", "logsumexp", "sign", "abs", "where_", "prod",
          "quantile_", "tanh", "sin"), grad=(0,), low=True)

# ---- vision.ops: the detection operators
_GROUP[0] = "vision"
# (images, channels, height, width, RoIs) of the RoI ops; boxes in the
# input image's pixels, four times the feature map's side (scale 0.25)
_ROI = _by((2, 3, 12, 16, 7), (2, 64, 100, 168, 256))


def _roi(P, x, boxes, num):
    V = importlib.import_module(P.__name__ + ".vision.ops")
    return (V.roi_align(x, boxes, num, 3, spatial_scale=0.25,
                        sampling_ratio=2, aligned=True),
            V.roi_align(x, boxes, num, (2, 3), spatial_scale=0.25,
                        sampling_ratio=-1, aligned=False),
            V.roi_pool(x, boxes, num, 3, spatial_scale=0.25))


case("vision_roi", _roi,
     [Spec("n", lambda S: _ROI(S)[:4]),
      Spec("box", lambda S: (_ROI(S)[4], 4 * _ROI(S)[2])),
      Spec("split", lambda S: (_ROI(S)[0], _ROI(S)[4]), dtype="int32")],
     ops=("roi_align", "roi_pool"), grad=(0,))
_NMS = _by(12, 1000)
case("vision_nms_mask", lambda P, b, sc: gen(P).nms_mask(
    b, sc, iou_threshold=0.3),
     [Spec("box", lambda S: (_NMS(S), 64)),
      U(0.0, 1.0, lambda S: (_NMS(S),))], ops=("nms_mask",),
     family="exact")


def _nms(P, b, sc, cat):
    V = importlib.import_module(P.__name__ + ".vision.ops")
    return (V.nms(b, sc, 0.5), V.nms(b, sc, 0.7, top_k=5),
            V.nms(b, sc, 0.5, category_idxs=cat, categories=[0, 1, 2]),
            V.nms(b, None, 0.4))


case("vision_nms", _nms,
     [Spec("box", lambda S: (_NMS(S), 64)),
      U(0.0, 1.0, lambda S: (_NMS(S),)), I(0, 3, lambda S: (_NMS(S),))],
     ops=("nms_mask",), family="exact", sync=True)
_PRIOR = _by((2, 3, 5, 6, 40, 48), (8, 512, 38, 38, 300, 300))


def _boxes(P, prior, var, target, deltas, feat, image):
    V = importlib.import_module(P.__name__ + ".vision.ops")
    boxes, variances = V.prior_box(feat, image, [30.0], [60.0],
                                   aspect_ratios=(2.0,), flip=True,
                                   clip=True)
    return (V.box_coder(prior, var, target, "encode_center_size"),
            V.box_coder(prior, var, deltas, "decode_center_size",
                        box_normalized=False),
            V.box_coder(prior, None, target, "encode_center_size",
                        box_normalized=False), boxes, variances)


_NB = _by(9, 8732)  # SSD300's prior boxes
case("vision_box_coder", _boxes,
     [Spec("box", lambda S: (_NB(S), 1)),
      U(0.1, 0.3, lambda S: (_NB(S), 4)), Spec("box", lambda S: (_NB(S), 1)),
      Spec("n", lambda S: (_NB(S), 4)), Spec("n", lambda S: _PRIOR(S)[:4]),
      Spec("n", lambda S: _PRIOR(S)[:2] + _PRIOR(S)[4:])],
     ops=("box_coder",), grad=(2, 3))
_YOLO = _by((2, 3, 5, 7), (8, 80, 19, 19))  # N, classes, H, W (608 / 32)


def _yolo(P, x, size):
    V = importlib.import_module(P.__name__ + ".vision.ops")
    anchors = [116, 90, 156, 198, 373, 326]
    return (V.yolo_box(x, size, anchors, x.shape[1] // 3 - 5, 0.5, 32),
            V.yolo_box(x, size, anchors, x.shape[1] // 3 - 5, 0.01, 32,
                       clip_bbox=False, scale_x_y=1.05))


case("vision_yolo_box", _yolo,
     [Spec("n", lambda S: (_YOLO(S)[0], 3 * (5 + _YOLO(S)[1])) + _YOLO(S)[2:]),
      I(300, 700, lambda S: (_YOLO(S)[0], 2), dtype="int32")],
     ops=("yolo_box",), grad=(0,))

# ops whose numbers are random: held by their statistics (random cases)
RANDOM_OPS = ("dropout_k", "uniform_k", "gaussian_k", "randint_k",
              "randperm_k", "bernoulli_k", "multinomial_k", "gumbel_softmax_k",
              "random_routing_k", "fused_dropout_add",
              "fused_bias_dropout_residual_layer_norm", "top_p_sampling")


def covered_ops():
    """Every registered op name a case drives."""
    return {o for c in CASES for o in c.ops}


# ------------------------------------------------------------ comparisons

# fp32 relative limits by family, applied as |a - b| <= rel * |b| + rel *
# max|b| (the second term: values near 0 of a result of scale max|b|)
REL = {"exact": 1e-6, "elementwise": 1e-5, "composite": 1e-5,
       "special": 1e-5, "matmul": 1e-5, "reduce": 1e-5, "linalg": 1e-4}
MANTISSA = {"bfloat16": 7, "float16": 10, "float32": 23, "float64": 52}


def ulp(b, dtype: str):
    """One unit in the last place of each element of ``b`` (a numpy array
    or a float64 torch tensor; at least the spacing of the smallest
    normal)."""
    m = MANTISSA[dtype]
    if isinstance(b, np.ndarray) or np.isscalar(b):
        e = np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -14)))
        return 2.0 ** (e - m)
    import torch
    e = torch.floor(torch.log2(torch.clamp(b.abs(), min=2.0 ** -14)))
    return torch.pow(2.0, e - m)


def limit(family: str, dtype: str, want, terms: int = 1,
          grad: bool = False):
    """The per-element bound on |got - want| (``want`` a float64 numpy
    array or torch tensor, finite).

    fp32: ``REL[family]`` relative to the element and to the output's
    largest element, growing with the square root of ``terms`` (the
    values each output element sums) past 1024, and for a decomposition
    in proportion to its size (``terms``: n) past 256.
    bf16 / fp16: one unit in the last place of the element; plus, at the
    output's scale, one for a ``composite`` output and log2 of the terms
    for a sum (matmul, reduce, linalg: the reference's tree sums round in
    the low type at each level); a gradient, whose every step the
    reference rounds to the low type, two at its scale times log2 of the
    terms."""
    w = abs(want)
    n = w.size if isinstance(w, np.ndarray) else w.numel()
    scale = float(w.max()) if n else 0.0
    if dtype in ("bfloat16", "float16"):
        lim = ulp(want, dtype)
        at_scale = float(ulp(np.asarray(scale), dtype))
        if grad:
            lim = lim + 2.0 * max(1.0, math.log2(max(terms, 1))) * at_scale
        elif family in ("matmul", "reduce", "linalg", "composite"):
            lim = lim + max(1.0, math.log2(max(terms, 1))) * at_scale
        return lim
    # decompositions: backward-stable, errors ~ n eps |A| (``terms``: n)
    rel = REL[family] * (max(1.0, terms / 256.0) if family == "linalg"
                         else max(1.0, math.sqrt(terms) / 32.0))
    if dtype == "float64":
        rel = rel * 1e-6
    return rel * w + rel * scale
