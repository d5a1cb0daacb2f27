"""The port's ``nn.Layer`` and core layers against the JAX package's, on
the CPU: ``state_dict`` key names and shapes, ``set_state_dict`` from
numpy, parameter registration, train/eval, ``astype`` and forward hooks,
and each layer's forward and gradients with the reference's weights.

Tolerances: fp32 on both sides, 1e-6 (relative and absolute; a linear or
layer norm over 16 features).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here), restored
    after it."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


class _MLP:
    """A plain MLP in either framework: Linear, ReLU, Dropout, Linear."""

    @staticmethod
    def build(p):
        class MLP(p.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = p.nn.Linear(16, 32)
                self.drop = p.nn.Dropout(0.5)
                self.fc2 = p.nn.Linear(32, 4, bias_attr=False)

            def forward(self, x):
                return self.fc2(self.drop(p.nn.functional.relu(self.fc1(x))))
        return MLP()


LAYERS = {
    "linear": lambda p: p.nn.Linear(16, 8),
    "linear_no_bias": lambda p: p.nn.Linear(16, 8, bias_attr=False),
    "embedding": lambda p: p.nn.Embedding(50, 16),
    "layer_norm": lambda p: p.nn.LayerNorm(16),
    "layer_list": lambda p: p.nn.LayerList(
        [p.nn.Linear(16, 16), p.nn.LayerNorm(16)]),
    "sequential": lambda p: p.nn.Sequential(p.nn.Linear(16, 16),
                                            p.nn.LayerNorm(16)),
    "mlp": _MLP.build,
}


def _input(case, p, seed=0):
    r = np.random.RandomState(seed)
    if case == "embedding":
        return p.to_tensor(r.randint(0, 50, (3, 5)))
    return p.to_tensor(r.randn(3, 5, 16).astype(np.float32),
                       stop_gradient=False)


def _pair(case):
    ref.seed(0)
    rl, tl = LAYERS[case](ref), LAYERS[case](pt)
    missing, unexpected = tl.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in rl.state_dict().items()})
    assert not missing and not unexpected
    return rl, tl


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_state_dict_keys_and_shapes_match_reference(case):
    rl, tl = _pair(case)
    want = [(k, tuple(v.shape)) for k, v in rl.state_dict().items()]
    assert [(k, tuple(v.shape)) for k, v in tl.state_dict().items()] == want
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in rl.named_parameters()]
    for p in tl.parameters():
        assert not p.stop_gradient and p.persistable


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_forward_and_grads_match_reference(case):
    rl, tl = _pair(case)
    if case in ("layer_list",):
        fwd = lambda m, x: m[1](m[0](x))  # noqa: E731
    else:
        fwd = lambda m, x: m(x)  # noqa: E731
    rl.eval()  # no dropout: the two draw different masks
    tl.eval()
    assert not tl.training and all(not s.training for s in tl.sublayers())
    rx, tx = _input(case, ref), _input(case, pt)
    ry, ty = fwd(rl, rx), fwd(tl, tx)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=1e-6, atol=1e-6)
    w = np.random.RandomState(1).randn(*ry.shape).astype(np.float32)
    (ry * ref.to_tensor(w)).sum().backward()
    (ty * pt.to_tensor(w)).sum().backward()
    for (name, rp), tp in zip(rl.named_parameters(), tl.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), rp.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_set_state_dict_takes_numpy_tensors_and_reports_keys():
    lin = pt.nn.Linear(4, 3)
    w = np.arange(12, dtype=np.float64).reshape(4, 3)
    missing, unexpected = lin.set_state_dict(
        {"weight": w, "extra": np.zeros(2)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert lin.weight.dtype == pt.float32
    np.testing.assert_array_equal(lin.weight.numpy(), w.astype(np.float32))
    lin.set_state_dict({"bias": pt.to_tensor([1.0, 2.0, 3.0])})
    np.testing.assert_array_equal(lin.bias.numpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        lin.set_state_dict({"bias": np.zeros(4)})


def test_dropout_train_mode_draws_from_the_seeded_generator():
    x = pt.ones([4, 256])
    drop = pt.nn.Dropout(0.25)
    pt.seed(7)
    a = drop(x)
    pt.seed(7)
    b = drop(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    kept = a.numpy() != 0
    np.testing.assert_allclose(a.numpy()[kept], 1 / 0.75, rtol=1e-6)
    assert 0.6 < kept.mean() < 0.9
    drop.eval()
    assert drop(x) is x


def test_astype_hooks_and_create_parameter():
    lin = pt.nn.Linear(4, 4)
    seen = []
    h = lin.register_forward_post_hook(lambda m, a, out: seen.append(
        out.dtype.name))
    lin.astype("bfloat16")
    assert lin.weight.dtype == pt.bfloat16 and not lin.weight.stop_gradient
    lin(pt.ones([2, 4], "bfloat16"))
    h.remove()
    lin(pt.ones([2, 4], "bfloat16"))
    assert seen == ["bfloat16"]
    p = pt.create_parameter([3, 2], "float32",
                            default_initializer=pt.nn.initializer.Constant(
                                0.5))
    assert isinstance(p, pt.nn.Parameter) and p.name.startswith("param_")
    np.testing.assert_array_equal(p.numpy(), np.full((3, 2), 0.5))
    attr = pt.nn.ParamAttr(name="w0", trainable=False,
                           initializer=pt.nn.initializer.Constant(1.0))
    q = pt.create_parameter([2], attr=attr)
    assert q.name == "w0" and q.stop_gradient


@pytest.mark.parametrize("init", ["Normal", "XavierNormal", "XavierUniform"])
def test_initializer_statistics_match_reference(init):
    """Same distribution, different numbers (``jax.random`` against
    torch's generator): the means of 64k draws agree to 6 standard errors
    and the standard deviations to 2%; the port's draws repeat after
    ``seed``."""
    shape = [256, 256]
    ref.seed(0)
    pt.seed(0)
    r = np.asarray(getattr(ref.nn.initializer, init)()(shape, "float32"))
    t = getattr(pt.nn.initializer, init)()(shape, "float32").numpy()
    se = r.std() / np.sqrt(r.size)
    assert abs(t.mean() - r.mean()) < 6 * se
    assert abs(t.std() / r.std() - 1) < 0.02
    pt.seed(0)
    again = getattr(pt.nn.initializer, init)()(shape, "float32").numpy()
    np.testing.assert_array_equal(t, again)
