"""The port's random ops, held by their distributions: the port does not
reproduce ``jax.random``'s numbers, so each op's draw at a fixed seed is
held against its law (moments, and a Kolmogorov-Smirnov statistic from
``scipy`` for the continuous ones, each with a limit far outside the
statistic's spread at that sample size) and against the reference's
shape and type. The same seed on the same device gives the same draw;
another seed another one.

KS limits: at n = 20000 draws the 0.999 quantile of the statistic is
1.95 / sqrt(n) = 0.0138; the tests take 0.02. Moment limits: five
standard errors of the sample mean.
"""
import math

import numpy as np
import pytest
import scipy.stats as st

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

KS = 0.02
N = 20000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    pt.seed(1234)


def _ks(sample, cdf):
    return st.kstest(np.asarray(sample, np.float64).ravel(), cdf).statistic


def _same_meta(name, fn):
    r, t = fn(ref), fn(pt)
    assert t.shape == list(r.shape), (name, t.shape, r.shape)
    assert t.dtype.name == r.dtype.name, (name, t.dtype, r.dtype)
    return t.numpy()


CONTINUOUS = {
    "rand": (lambda P: P.rand([N]), st.uniform(0, 1).cdf),
    "uniform": (lambda P: P.uniform([N], min=-2.0, max=3.0),
                st.uniform(-2, 5).cdf),
    "uniform_seeded": (lambda P: P.uniform([N], min=0.0, max=1.0, seed=7),
                       st.uniform(0, 1).cdf),
    "randn": (lambda P: P.randn([N]), st.norm().cdf),
    "standard_normal": (lambda P: P.standard_normal([N]), st.norm().cdf),
    "normal": (lambda P: P.normal(1.5, 2.0, [N]), st.norm(1.5, 2.0).cdf),
    "normal_tensor": (lambda P: P.normal(
        P.to_tensor(np.full(N, -1.0, np.float32)),
        P.to_tensor(np.full(N, 0.5, np.float32))), st.norm(-1, 0.5).cdf),
    "standard_gamma": (lambda P: P.standard_gamma(
        P.to_tensor(np.full(N, 2.5, np.float32))), st.gamma(2.5).cdf),
    "exponential_": (lambda P: P.exponential_(
        P.to_tensor(np.zeros(N, np.float32)), 2.0), st.expon(
            scale=0.5).cdf),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_draws_follow_their_law(name):
    fn, cdf = CONTINUOUS[name]
    x = _same_meta(name, fn)
    assert _ks(x, cdf) < KS


def test_uniform_range_and_dtype():
    x = pt.uniform([N], dtype="float64", min=2.0, max=2.5)
    assert x.dtype == "float64"
    assert 2.0 <= float(x.min()) and float(x.max()) < 2.5


def test_randint_randperm():
    x = _same_meta("randint", lambda P: P.randint(-3, 5, [N]))
    assert x.min() >= -3 and x.max() < 5
    counts = np.bincount(x + 3, minlength=8)
    assert st.chisquare(counts).pvalue > 1e-4
    y = _same_meta("randint_like", lambda P: P.randint_like(
        P.to_tensor(np.zeros((4, 5), np.int32)), 0, 3))
    assert y.min() >= 0 and y.max() < 3
    p = _same_meta("randperm", lambda P: P.randperm(1000))
    np.testing.assert_array_equal(np.sort(p), np.arange(1000))
    assert not np.array_equal(p, np.arange(1000))


def test_discrete_means():
    probs = np.full(N, 0.3, np.float32)
    b = _same_meta("bernoulli", lambda P: P.bernoulli(P.to_tensor(probs)))
    assert set(np.unique(b)) <= {0.0, 1.0}
    assert abs(b.mean() - 0.3) < 5 * math.sqrt(0.21 / N)
    lam = np.full(N, 4.0, np.float32)
    p = _same_meta("poisson", lambda P: P.poisson(P.to_tensor(lam)))
    assert abs(p.mean() - 4.0) < 5 * math.sqrt(4.0 / N)
    assert abs(p.var() - 4.0) < 0.3
    c = _same_meta("binomial", lambda P: P.binomial(
        P.to_tensor(np.full(N, 10.0, np.float32)),
        P.to_tensor(np.full(N, 0.25, np.float32))))
    assert c.min() >= 0 and c.max() <= 10
    assert abs(c.mean() - 2.5) < 5 * math.sqrt(10 * 0.25 * 0.75 / N)


def test_multinomial_and_dirichlet():
    w = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    s = _same_meta("multinomial", lambda P: P.multinomial(
        P.to_tensor(w), 2000, replacement=True))
    f = np.stack([np.bincount(r, minlength=3) / 2000.0 for r in s])
    np.testing.assert_allclose(f, w, atol=0.05)
    nr = pt.multinomial(pt.to_tensor(w[:1]), 3).numpy()
    assert sorted(nr[0].tolist()) == [0, 1, 2]  # without replacement
    a = np.tile(np.array([[1.0, 2.0, 3.0]], np.float32), (N, 1))
    d = _same_meta("dirichlet", lambda P: P.dirichlet(P.to_tensor(a)))
    np.testing.assert_allclose(d.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(d.mean(0), [1 / 6, 2 / 6, 3 / 6], atol=0.01)


def test_dropout_family_keeps_the_right_share():
    x = np.ones((200, 100), np.float32)
    y = np.zeros((200, 100), np.float32)
    out = _same_meta("fused_dropout_add", lambda P: P.fused_dropout_add(
        P.to_tensor(x), P.to_tensor(y), p=0.25))
    kept = out != 0
    assert abs(kept.mean() - 0.75) < 5 * math.sqrt(0.1875 / x.size)
    np.testing.assert_allclose(out[kept], 1 / 0.75, rtol=1e-6)
    f = pt.nn.functional.dropout(pt.to_tensor(x), 0.4).numpy()
    assert abs((f != 0).mean() - 0.6) < 5 * math.sqrt(0.24 / x.size)
    w = np.ones(100, np.float32)
    ln = _same_meta("fused_bias_dropout_residual_layer_norm",
                    lambda P: P.fused_bias_dropout_residual_layer_norm(
                        P.to_tensor(x * 2), P.to_tensor(y), P.to_tensor(w),
                        P.to_tensor(w), P.to_tensor(w * 0), 0.3))
    assert np.isfinite(ln).all()
    np.testing.assert_allclose(ln.mean(-1), 0.0, atol=1e-5)


def test_gumbel_softmax_and_random_routing():
    x = np.log(np.tile(np.array([[0.2, 0.3, 0.5]], np.float32), (N, 1)))
    g = _same_meta("gumbel_softmax", lambda P: P.ops.parity.gumbel_softmax(
        P.to_tensor(x)))
    np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-5)
    h = pt.ops.parity.gumbel_softmax(pt.to_tensor(x), hard=True).numpy()
    np.testing.assert_allclose(h, np.round(h), atol=1e-12)  # one-hot
    np.testing.assert_allclose(h.sum(-1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.bincount(h.argmax(-1), minlength=3) / N,
                               [0.2, 0.3, 0.5], atol=0.02)
    idx = np.tile(np.array([[3, 1]], np.int64), (N, 1))
    prob = np.full((N, 2), 0.4, np.float32)
    rr = _same_meta("random_routing", lambda P: P.ops.parity.random_routing(
        P.to_tensor(idx), P.to_tensor(prob), P.to_tensor(prob)))
    assert set(np.unique(rr)) <= {-1, 1, 3}
    assert abs((rr != -1).mean() - 0.4) < 5 * math.sqrt(0.24 / rr.size)


def test_top_p_sampling_stays_in_the_nucleus():
    p = np.array([[0.5, 0.3, 0.15, 0.05]] * 4000, np.float32)
    ps = np.full(4000, 0.7, np.float32)
    probs, ids = pt.top_p_sampling(pt.to_tensor(p), pt.to_tensor(ps))
    r_probs, r_ids = ref.top_p_sampling(ref.to_tensor(p), ref.to_tensor(ps))
    assert ids.shape == list(r_ids.shape) and ids.dtype == r_ids.dtype.name
    assert probs.dtype == r_probs.dtype.name
    ids = ids.numpy()[:, 0]
    assert set(np.unique(ids)) <= {0, 1}  # mass before id 2 is 0.8 >= 0.7
    np.testing.assert_allclose(np.bincount(ids, minlength=2)[:2] / 4000,
                               [0.625, 0.375], atol=0.03)
    a = pt.top_p_sampling(pt.to_tensor(p[:50]), pt.to_tensor(ps[:50]),
                          seed=5)[1].numpy()
    b = pt.top_p_sampling(pt.to_tensor(p[:50]), pt.to_tensor(ps[:50]),
                          seed=5)[1].numpy()
    np.testing.assert_array_equal(a, b)


SEEDED = {
    "rand": lambda: pt.rand([64]), "randn": lambda: pt.randn([64]),
    "randint": lambda: pt.randint(0, 100, [64]),
    "randperm": lambda: pt.randperm(64),
    "bernoulli": lambda: pt.bernoulli(pt.to_tensor(np.full(64, 0.5,
                                                           np.float32))),
    "dropout": lambda: pt.nn.functional.dropout(
        pt.to_tensor(np.ones(64, np.float32)), 0.5),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_same_seed_same_draw(name):
    pt.seed(11)
    a = SEEDED[name]().numpy()
    pt.seed(11)
    b = SEEDED[name]().numpy()
    pt.seed(12)
    c = SEEDED[name]().numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
