"""Runs the op-surface cases (``paddle_tpu_torch/testing/op_cases.py``)
through the JAX package and the port on the CPU and compares them: the
forward outputs (shapes, types and values) and, for the inputs a case
names, the gradient of ``sum(out * r)`` over its float outputs, ``r``
fixed from a seed. Used by the ``test_torch_ops_*.py`` files, one
parametrised test per family of cases.

Limits (``op_cases.limit``): integer, bool and index outputs equal; fp32
1e-5 relative to each element plus 1e-5 of the output's largest element
(1e-6 for ops both sides compute exactly, 1e-4 for decompositions and
solves), the relative part growing with the square root of the reduced
length past 1024 terms; bf16 and fp16 one unit in the last place of each
element (of the larger of the two sides), plus units at the output's
scale for sums, composites and gradients (``op_cases.limit``).
"""
import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch.testing import op_cases as oc


def cases(*groups, low=False):
    """(case, dtype) params of the given groups: fp32, and bf16/fp16 where
    the case takes them."""
    out = []
    for c in oc.CASES:
        if c.group not in groups:
            continue
        out.append(pytest_param(c, "float32"))
        if low and c.low:
            out.append(pytest_param(c, "bfloat16"))
        if low and c.fp16:
            out.append(pytest_param(c, "float16"))
    return out


def pytest_param(c, dtype):
    import pytest
    return pytest.param(c, dtype, id=f"{c.name}-{dtype}")


def inputs(c, seed=0):
    rng = np.random.RandomState(seed)
    return [s.make(rng, oc.SMALL) for s in c.inputs]


def _tensors(P, arrays, c, dtype):
    out = []
    grads = c.grad if dtype == "float32" or c.low_grad else ()
    for i, a in enumerate(arrays):
        low = a.dtype == np.float32 and dtype != "float32"
        out.append(P.to_tensor(a, dtype=dtype if low else None,
                               stop_gradient=i not in grads))
    return out


def flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in flat(x)]
    return [out]


def _np(t):
    a = t.numpy()
    return np.array(a, dtype=np.float64) if a.dtype.kind == "f" or \
        str(a.dtype) == "bfloat16" else np.array(a)


def run(P, c, arrays, dtype):
    """(outputs, gradients, output type names) of case ``c``."""
    ts = _tensors(P, arrays, c, dtype)
    outs = flat(c.fn(P, *ts))
    grads = []
    if c.grad and (dtype == "float32" or c.low_grad):
        loss = None
        for k, o in enumerate(outs):
            if o.dtype.name not in ("float32", "bfloat16", "float16",
                                    "float64") or o.stop_gradient:
                continue
            r = np.random.RandomState(1000 + k).uniform(
                -1, 1, tuple(o.shape)).astype(np.float32)
            term = (o.astype("float32") * P.to_tensor(r)).sum()
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        grads = [None if ts[i].grad is None else ts[i].grad
                 for i in c.grad]
    return outs, grads


def _terms(c, arrays, out):
    n_in = max(int(np.prod(a.shape)) for a in arrays) if arrays else 1
    if c.scan:
        return n_in
    ratio = max(1, n_in // max(1, int(np.prod(out.shape))))
    if c.family in ("matmul", "linalg") and arrays and arrays[0].ndim:
        return max(ratio, arrays[0].shape[-1])  # the contraction length
    return ratio


def compare(what, got, want, family, dtype, terms=1, grad=False):
    """``got`` (port) against ``want`` (reference), one output."""
    assert list(got.shape) == list(want.shape), (what, got.shape,
                                                 want.shape)
    assert got.dtype.name == want.dtype.name, (what, got.dtype.name,
                                               want.dtype.name)
    g, w = _np(got), _np(want)
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    if g.dtype.kind == "c":
        for part in ("real", "imag"):
            compare_arrays(f"{what}.{part}", getattr(g, part),
                           getattr(w, part), family, "float32", terms, grad)
        return
    compare_arrays(what, g, w, family, got.dtype.name, terms, grad)


def compare_arrays(what, g, w, family, dtype, terms=1, grad=False):
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), (what, "NaN positions")
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf]), (what, "infinities")
    ok = ~(nan | inf)
    if not ok.any():
        return
    # one ulp of the larger of the two (they may straddle a binade)
    lim = oc.limit(family, dtype, np.maximum(np.abs(g[ok]), np.abs(w[ok])),
                   terms, grad)
    err = np.abs(g[ok] - w[ok])
    bad = err > lim
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond the limit, worst "
        f"{float(np.max(err / np.maximum(lim, 1e-300))):.3g}x "
        f"(got {g[ok][bad][:3]}, want {w[ok][bad][:3]})")


def check_case(c, dtype, seed=0):
    """The port against the reference on case ``c`` at ``dtype``."""
    arrays = inputs(c, seed)
    r_out, r_grad = run(ref, c, arrays, dtype)
    p_out, p_grad = run(pt, c, arrays, dtype)
    assert len(p_out) == len(r_out), (len(p_out), len(r_out))
    for k, (g, w) in enumerate(zip(p_out, r_out)):
        compare(f"{c.name} out {k}", g, w, c.family, dtype,
                _terms(c, arrays, w))
    for i, g, w in zip(c.grad, p_grad, r_grad):
        assert (g is None) == (w is None), (c.name, "grad", i)
        if w is not None:
            compare(f"{c.name} grad {i}", g, w, c.family, dtype,
                    _terms(c, arrays, w), grad=True)


def check_amp_types(c, level):
    """Output types of case ``c`` under ``auto_cast(level)`` (bf16) equal
    the reference's."""
    arrays = inputs(c)
    types = []
    for P in (ref, pt):
        ts = _tensors(P, arrays, c, "float32")
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            types.append([o.dtype.name for o in flat(c.fn(P, *ts))])
    assert types[1] == types[0], (c.name, level, types)

