"""Where a naive torch call would part from the reference, the port must
not: each test here holds the port against ``paddle_tpu`` on the CPU on
an input that shows the difference, and where it helps, shows that the
naive torch call gives another answer.

- sorting is stable and a descending sort keeps NaN last (the
  reference's ascending sort of ``-x``); unsigned inputs wrap under
  ``-x``, bool inputs refuse a descending sort;
- ``topk`` gives ties to the lower index, in bf16 at width;
- ``median`` is the mean of the two middle values, NaN over a NaN;
- ``mode`` takes the smallest of the most frequent values and the index
  of its last occurrence;
- ``scatter`` with duplicate indices gives the last update
  (``overwrite=True``) or the sum (``overwrite=False``);
- every index output is int64;
- ``as_strided``, ``view_dtype`` and ``view_slice`` are copies, and an
  in-place op, ``set_value`` and ``copy_`` replace their tensor's
  payload: no earlier result changes;
- ``register_op(..., bwd=...)`` runs ``bwd`` in place of autodiff; the
  port's ``register_op`` returns the body where the reference's returns
  the ``OpDef`` (a filed decision);
- the decompositions refuse bf16 and fp16 as the reference does;
- the in-place variants and the bitwise operators match.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _both(fn):
    return fn(ref), fn(pt)


def _eq(a, b):
    assert a.dtype.name == b.dtype.name, (a.dtype, b.dtype)
    np.testing.assert_array_equal(np.asarray(a.numpy(), np.float64),
                                  np.asarray(b.numpy(), np.float64))


NAN_TIES = np.array([[2., np.nan, 1., 2., np.nan, 3., 1., 2.],
                     [0., 0., -1., np.nan, 5., 5., -1., 0.]], np.float32)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_sort_is_stable_with_nan_last(descending, axis):
    r, t = _both(lambda P: P.argsort(P.to_tensor(NAN_TIES), axis=axis,
                                     descending=descending))
    _eq(t, r)
    rs, ts = _both(lambda P: P.sort(P.to_tensor(NAN_TIES), axis=axis,
                                    descending=descending))
    _eq(ts, rs)
    if descending and axis == -1:  # torch's own puts NaN first
        naive = torch.sort(torch.from_numpy(NAN_TIES), -1,
                           descending=True).indices.numpy()
        assert not np.array_equal(naive, r.numpy())


def test_unsigned_and_bool_sorts():
    u = np.array([0, 1, 2, 1, 255], np.uint8)
    r, t = _both(lambda P: P.argsort(P.to_tensor(u), descending=True))
    _eq(t, r)  # -x wraps on both sides: 0 first
    b = np.array([True, False, True, False])
    r, t = _both(lambda P: P.argsort(P.to_tensor(b)))
    _eq(t, r)
    for P in (ref, pt):
        with pytest.raises((TypeError, RuntimeError)):
            P.argsort(P.to_tensor(b), descending=True).numpy()


@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_go_to_the_lower_index_in_bf16(largest):
    """bf16 at width: [64, 1024] normal values fall on ~300 bf16 values a
    row, so most rows hold ties at the cut."""
    x = np.random.RandomState(3).randn(64, 1024).astype(np.float32)

    def topk(P):
        return P.topk(P.to_tensor(x, dtype="bfloat16"), 40,
                      largest=largest)
    (rv, ri), (tv, ti) = _both(topk)
    _eq(ti, ri)
    _eq(tv, rv)
    xb = torch.from_numpy(x).bfloat16()
    assert (xb.unsqueeze(-1) == xb.unsqueeze(-2)).sum() > 64 * 1024


def test_median_is_the_midpoint_and_nan_aware():
    x = np.array([[1., 4., 3., 2.], [4., np.nan, 2., 3.],
                  [5., 1., 9., 9.]], np.float32)
    r, t = _both(lambda P: P.median(P.to_tensor(x), axis=1))
    np.testing.assert_array_equal(t.numpy(), r.numpy())
    np.testing.assert_array_equal(r.numpy(), [2.5, np.nan, 7.0])
    naive = torch.median(torch.from_numpy(x), 1).values.numpy()
    assert naive[0] == 2.0  # torch's lower middle value


def test_mode_takes_the_smallest_value_and_its_last_index():
    x = np.array([[3., 1., 3., 2., 1.], [7., 7., 5., 5., 0.],
                  [1., 2., 3., 4., 5.]], np.float32)
    (rv, ri), (tv, ti) = _both(lambda P: P.mode(P.to_tensor(x)))
    _eq(tv, rv)
    _eq(ti, ri)
    np.testing.assert_array_equal(ri.numpy(), [4, 3, 0])


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_duplicates(overwrite):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([1, 3, 1, 1, 0], np.int64)
    upd = np.arange(15, dtype=np.float32).reshape(5, 3) * 10
    r, t = _both(lambda P: P.scatter(P.to_tensor(x), P.to_tensor(idx),
                                     P.to_tensor(upd), overwrite=overwrite))
    _eq(t, r)
    if overwrite:  # row 1: the last of its three updates
        np.testing.assert_array_equal(t.numpy()[1], upd[3])


def test_put_along_axis_and_index_put_duplicates():
    x = np.zeros((2, 5), np.float32)
    idx = np.array([[1, 1, 4], [0, 0, 0]], np.int64)
    v = np.array([[1., 2., 3.], [4., 5., 6.]], np.float32)
    r, t = _both(lambda P: P.put_along_axis(P.to_tensor(x), P.to_tensor(idx),
                                            P.to_tensor(v), 1))
    _eq(t, r)
    i = np.array([0, 1, 0], np.int64)
    j = np.array([2, 2, 2], np.int64)
    r, t = _both(lambda P: P.index_put(P.to_tensor(x), (P.to_tensor(i),
                                                        P.to_tensor(j)),
                                       P.to_tensor(np.array([7., 8., 9.],
                                                            np.float32))))
    _eq(t, r)


INDEX_OPS = {
    "argmax": lambda P, x: P.argmax(x, axis=-1),
    "argmin": lambda P, x: P.argmin(x),
    "topk": lambda P, x: P.topk(x, 2)[1],
    "argsort": lambda P, x: P.argsort(x),
    "kthvalue": lambda P, x: P.kthvalue(x, 2)[1],
    "mode": lambda P, x: P.mode(x)[1],
    "cummax": lambda P, x: P.cummax(x, axis=1)[1],
    "cummin": lambda P, x: P.cummin(x, axis=1)[1],
    "searchsorted": lambda P, x: P.searchsorted(
        P.to_tensor(np.array([-1., 0., 1.], np.float32)), x),
    "nonzero": lambda P, x: P.nonzero(x > 0),
    "unique_inverse": lambda P, x: P.unique(x > 0, return_inverse=True)[1],
    "unique_counts": lambda P, x: P.unique(x > 0, return_counts=True)[1],
    "unique_index": lambda P, x: P.unique(x > 0, return_index=True)[1],
    "count_nonzero": lambda P, x: P.count_nonzero(x),
    "numel": lambda P, x: P.numel(x),
    "randperm": lambda P, x: P.randperm(5),
    "tril_indices": lambda P, x: P.tril_indices(3, 3),
    "bincount": lambda P, x: P.bincount(P.to_tensor(np.array([0, 2, 2]))),
}


@pytest.mark.parametrize("name", sorted(INDEX_OPS))
def test_index_outputs_are_int64(name):
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    r, t = _both(lambda P: INDEX_OPS[name](P, P.to_tensor(x)))
    assert r.dtype.name == "int64" and t.dtype.name == "int64"
    if name != "randperm":
        _eq(t, r)


def test_view_ops_are_copies():
    """The decision filed in ROADMAP §3: as_strided, view_dtype and
    view_slice return copies, so a later write into their input leaves
    them as they were (a torch view would change)."""
    x = pt.to_tensor(np.arange(12, dtype=np.float32))
    outs = [pt.as_strided(x, [2, 3], [3, 1]), pt.view_dtype(x, "int32"),
            pt.view_slice(x, [2], [6])]
    before = [o.numpy().copy() for o in outs]
    x.set_value(np.zeros(12, np.float32))
    for o, b in zip(outs, before):
        np.testing.assert_array_equal(o.numpy(), b)
    view = torch.as_strided(x._t, (2, 3), (3, 1))
    x._t.fill_(1.0)  # torch code writing the payload in place
    assert view.sum().item() == 6.0  # the naive torch view sees the write


def test_inplace_ops_leave_earlier_results_alone():
    def run(P):
        x = P.to_tensor(np.array([1., 2., 3.], np.float32))
        y = P.reshape(x, [3])
        x.add_(P.to_tensor(np.ones(3, np.float32)))
        x.scale_(2.0)
        x.clip_(0.0, 7.0)
        z = x[0:2]
        x.exp_()
        x[1] = 0.5
        return x, y, z
    for a, b in zip(*_both(run)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)


@pytest.mark.parametrize("method", ["set_value", "copy_"])
def test_set_value_and_copy_leave_earlier_results_alone(method):
    """``set_value`` and ``copy_`` replace the payload as the in-place ops
    do: a reshape, a basic slice and an unsqueeze taken before the write
    keep the old values, as in the reference, and the tensor reads the
    new ones."""
    new = np.array([[5., 6., 7.], [8., 9., 10.]], np.float32)

    def run(P):
        x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        views = [P.reshape(x, [6]), x[0:1], P.unsqueeze(x, 0)]
        getattr(x, method)(P.to_tensor(new))
        return x, views
    (rx, rv), (tx, tv) = _both(run)
    np.testing.assert_array_equal(tx.numpy(), new)
    np.testing.assert_array_equal(rx.numpy(), new)
    for r, t in zip(rv, tv):
        np.testing.assert_array_equal(t.numpy(), r.numpy())
    np.testing.assert_array_equal(tv[0].numpy(), np.arange(6))


def test_set_value_keeps_a_leaf_parameter_and_its_grad():
    """A parameter written by ``set_value`` stays the optimizer's
    parameter, keeps ``stop_gradient=False`` and its gradient, and the
    optimizer's next step updates the new value."""
    lin = pt.nn.Linear(3, 2)
    opt = pt.optimizer.Momentum(0.5, parameters=lin.parameters())
    lin(pt.to_tensor(np.ones((1, 3), np.float32))).sum().backward()
    w = lin.weight
    grad = w.grad.numpy().copy()
    w.set_value(np.full((3, 2), 2.0, np.float32))
    assert lin.weight is w and not w.stop_gradient
    np.testing.assert_array_equal(w.grad.numpy(), grad)
    opt.step()
    np.testing.assert_allclose(w.numpy(), 2.0 - 0.5 * grad, rtol=1e-6)


def _twice_square_grad(saved, gouts, scale):
    """Twice the true gradient of ``scale * x * x``: a ``bwd`` that differs
    from autodiff, so the test sees which one ran."""
    (x,), (g,) = saved, gouts
    return (2 * (2 * scale * x * g),)


def test_register_op_bwd_replaces_autodiff():
    """``register_op(name, fn, bwd=...)`` runs ``bwd(saved_inputs, gouts,
    **attrs)`` for the gradient, as the reference does op by op (its
    ambient fusion window, on by default, differentiates the recorded
    segment and never reads ``bwd``: the reference runs with it off
    here), and stores the ``spmd_rule``."""
    from paddle_tpu._core import executor as ref_exec
    from paddle_tpu._core import op_registry as ref_reg
    from paddle_tpu_torch._core import op_registry as pt_reg
    x_np = np.array([0.5, -1.0, 2.0], np.float32)
    rule = object()
    name = "bwd_probe_square"
    ref_reg.register_op(name, lambda x, scale: scale * x * x,
                        bwd=lambda s, g, scale: (2 * (2 * scale * s[0] * g[0]),),
                        spmd_rule=rule, custom=True)
    pt_reg.register_op(name, lambda x, scale: scale * x * x,
                       bwd=_twice_square_grad, spmd_rule=rule, custom=True)
    try:
        assert pt_reg.get_op(name).spmd_rule is rule
        assert ref_reg.get_op(name).spmd_rule is rule
        fusion = ref.get_flags(["FLAGS_eager_fusion"])["FLAGS_eager_fusion"]
        ref.set_flags({"FLAGS_eager_fusion": False})
        grads = []
        for P, call in ((ref, ref_exec.apply), (pt, pt_reg.call)):
            x = P.to_tensor(x_np, stop_gradient=False)
            y = call(name, x, scale=3.0)
            np.testing.assert_allclose(y.numpy(), 3.0 * x_np * x_np,
                                       rtol=1e-6)
            y.sum().backward()
            grads.append(np.array(x.grad.numpy()))
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
        np.testing.assert_allclose(grads[1], 2 * 6.0 * x_np, rtol=1e-6)
    finally:
        ref.set_flags({"FLAGS_eager_fusion": fusion})
        ref_reg._OPS.pop(name, None)
        pt_reg._OPS.pop(name, None)


def test_register_op_returns_the_function_where_the_reference_returns_the_opdef():
    """A filed decision: the port's ``register_op`` returns the body, so
    that its ``@register_op`` uses stay plain functions; the reference
    returns the ``OpDef``, which the port's ``get_op`` gives."""
    from paddle_tpu._core import op_registry as ref_reg
    from paddle_tpu_torch._core import op_registry as pt_reg

    def body(x):
        return x + 1.0
    name = "return_probe_op"
    try:
        assert isinstance(ref_reg.register_op(name, body, custom=True),
                          ref_reg.OpDef)
        assert pt_reg.register_op(name, body, custom=True) is body
        assert pt_reg.get_op(name).fn is body
    finally:
        ref_reg._OPS.pop(name, None)
        pt_reg._OPS.pop(name, None)


def test_inplace_on_a_graph_keeps_the_gradient():
    x_np = np.array([0.5, 1.0, 2.0], np.float32)

    def run(P):
        x = P.to_tensor(x_np, stop_gradient=False)
        y = x * 3.0
        y.exp_()
        y.add_(x)
        y.sum().backward()
        return x.grad
    r, t = _both(run)
    np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=1e-6)


DECOMPOSITIONS = {
    "cholesky": lambda P, a: P.linalg.cholesky(a),
    "inv": lambda P, a: P.linalg.inv(a),
    "det": lambda P, a: P.linalg.det(a),
    "slogdet": lambda P, a: P.linalg.slogdet(a),
    "svd": lambda P, a: P.linalg.svd(a)[1],
    "qr": lambda P, a: P.linalg.qr(a)[0],
    "eigh": lambda P, a: P.linalg.eigh(a)[0],
    "eig": lambda P, a: P.linalg.eig(a)[0],
    "pinv": lambda P, a: P.linalg.pinv(a),
    "solve": lambda P, a: P.linalg.solve(a, a),
    "lstsq": lambda P, a: P.linalg.lstsq(a, a)[0],
    "lu": lambda P, a: P.linalg.lu(a)[0],
    "matrix_rank": lambda P, a: P.linalg.matrix_rank(a),
    "svdvals": lambda P, a: P.svdvals(a),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(DECOMPOSITIONS))
def test_decompositions_refuse_low_precision_as_the_reference(name, dtype):
    a = np.eye(4, dtype=np.float32) * 2 + 0.1
    for P in (ref, pt):
        with pytest.raises(NotImplementedError):
            DECOMPOSITIONS[name](P, P.to_tensor(a, dtype=dtype)).numpy()


def test_low_precision_triangular_solve_and_householder_match():
    rng = np.random.RandomState(1)
    a = (np.triu(rng.randn(5, 5)) + 3 * np.eye(5)).astype(np.float32)
    b = rng.randn(5, 2).astype(np.float32)
    for fn in (lambda P: P.linalg.triangular_solve(
            P.to_tensor(a, dtype="bfloat16"), P.to_tensor(b,
                                                          dtype="bfloat16")),
               lambda P: P.linalg.householder_product(
            P.to_tensor(a, dtype="bfloat16"),
            P.to_tensor(np.array([0.5, 1.2], np.float32),
                        dtype="bfloat16")),
               lambda P: P.cholesky_solve(P.to_tensor(b, dtype="bfloat16"),
                                          P.to_tensor(a.T,
                                                      dtype="bfloat16"))):
        r, t = _both(fn)
        assert t.dtype.name == r.dtype.name == "bfloat16"
        np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=2 ** -6,
                                   atol=2 ** -6)


_OPERATORS = {
    "and": lambda a, b: a & b, "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b, "and_scalar": lambda a, b: a & 6,
    "or_scalar": lambda a, b: a | 6, "invert": lambda a, b: ~a,
}


@pytest.mark.parametrize("dtype", ["bool", "int32", "int64", "uint8"])
@pytest.mark.parametrize("op", sorted(_OPERATORS))
def test_bitwise_operators_match_reference(op, dtype):
    x = np.array([0, 1, 5, 2], np.int64)
    y = np.array([3, 1, 4, 0], np.int64)

    def run(P):
        a = P.to_tensor(x).astype(dtype)
        b = P.to_tensor(y).astype(dtype)
        if dtype == "bool" and op.endswith("scalar"):
            return None
        return _OPERATORS[op](a, b)
    r, t = _both(run)
    if r is not None:
        _eq(t, r)


def test_reflected_bitwise_operators_equal_the_forward_ones():
    """The reference has no reflected forms; the port's equal the forward
    operator with the operands swapped."""
    a = pt.to_tensor(np.array([0, 1, 5, 2], np.int32))
    for got, want in ((6 & a, a & 6), (6 | a, a | 6), (6 ^ a, a ^ 6)):
        _eq(got, want)


@pytest.mark.parametrize("op", ["lshift", "rshift", "rlshift"])
def test_shift_operators_equal_the_shift_ops(op):
    a = pt.to_tensor(np.array([1, 5, -8], np.int32))
    s = pt.to_tensor(np.array([1, 2, 1], np.int32))
    fn = {"lshift": lambda: (a << s, ref.bitwise_left_shift),
          "rshift": lambda: (a >> s, ref.bitwise_right_shift),
          "rlshift": lambda: (2 << s, None)}[op]
    got, ref_fn = fn()
    if ref_fn is None:
        np.testing.assert_array_equal(got.numpy(), 2 << s.numpy())
        return
    want = ref_fn(ref.to_tensor(np.array([1, 5, -8], np.int32)),
                  ref.to_tensor(np.array([1, 2, 1], np.int32)))
    _eq(got, want)


def test_getitem_rules_match_reference():
    x = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    m = x[..., 0] > 20

    def run(P):
        t = P.to_tensor(x)
        i = P.to_tensor(np.array([2, 0, 2]))
        return [t[0, :, [1, 3]], t[i, 1:, i], t[P.to_tensor(m)],
                t[:, ::-1], t[None, ..., ::-2], t[[0, 2], 1], t[-1, -2],
                t[1:, P.to_tensor(np.array([True, False, True, True]))]]
    for a, b in zip(*_both(run)):
        _eq(b, a)
