"""The port's AMP (``paddle_tpu_torch.amp``) against the JAX package's, on
the CPU: the output type of each op of the eager slice under
``auto_cast`` (O1 and O2 in bf16 and fp16, custom lists, O0 and a disabled
scope), ``decorate`` and ``GradScaler``.

Types are compared exactly; values are not (each side rounds to the low
type at its own places). The scaler's step is held at fp32 1e-6.
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


def _f(p, *shape, seed=0, dtype="float32"):
    return p.to_tensor(np.random.RandomState(seed).randn(*shape)
                       .astype(np.float32)).astype(dtype)


OPS = {
    "linear": lambda p: p.nn.functional.linear(_f(p, 2, 8), _f(p, 8, 4, seed=1),
                                               _f(p, 4, seed=2)),
    "matmul": lambda p: p.matmul(_f(p, 2, 8), _f(p, 8, 3, seed=1)),
    "matmul_transpose_y": lambda p: p.matmul(_f(p, 2, 8),
                                             _f(p, 3, 8, seed=1),
                                             transpose_y=True),
    "add_mixed": lambda p: _f(p, 4) + _f(p, 4, dtype="bfloat16"),
    "mul_scalar_bf16": lambda p: _f(p, 4, dtype="bfloat16") * 0.5,
    "layer_norm_bf16": lambda p: p.nn.functional.layer_norm(
        _f(p, 2, 8, dtype="bfloat16"), 8),
    "softmax_bf16": lambda p: p.nn.functional.softmax(
        _f(p, 2, 8, dtype="bfloat16")),
    "gelu_bf16": lambda p: p.nn.functional.gelu(
        _f(p, 2, 8, dtype="bfloat16"), approximate=True),
    "relu": lambda p: p.nn.functional.relu(_f(p, 2, 8)),
    "cross_entropy_bf16": lambda p: p.nn.functional.cross_entropy(
        _f(p, 4, 10, dtype="bfloat16"), p.to_tensor([1, 2, 3, 4]),
        reduction="none"),
    "mean_bf16": lambda p: p.mean(_f(p, 4, dtype="bfloat16")),
    "sum_bf16": lambda p: p.sum(_f(p, 4, dtype="bfloat16")),
    "exp_bf16": lambda p: p.exp(_f(p, 4, dtype="bfloat16")),
    "log_bf16": lambda p: p.log(p.abs(_f(p, 4, dtype="bfloat16"))),
    "tanh": lambda p: p.tanh(_f(p, 4)),
    "pow_bf16": lambda p: _f(p, 4, dtype="bfloat16") ** 2,
    "embedding": lambda p: p.nn.functional.embedding(
        p.to_tensor([[1, 3]]), _f(p, 5, 4)),
    "reshape_transpose": lambda p: p.transpose(
        _f(p, 2, 8, dtype="bfloat16").reshape([4, 4]), [1, 0]),
    "flash_attention_bf16": lambda p: p.nn.functional.flash_attention(
        *(_f(p, 1, 128, 2, 8, seed=s, dtype="bfloat16") for s in range(3)),
        causal=True)[0],
    "linear_layer": lambda p: p.nn.Linear(8, 4)(_f(p, 2, 8)),
    "layer_norm_layer": lambda p: p.nn.LayerNorm(8)(_f(p, 2, 8)),
}
SCOPES = {
    "O1_bf16": dict(dtype="bfloat16"),
    "O1_fp16": dict(level="O1", dtype="float16"),
    "O2_bf16": dict(level="O2", dtype="bfloat16"),
    "O0": dict(level="O0", dtype="bfloat16"),
    "disabled": dict(enable=False),
    "custom": dict(dtype="bfloat16", custom_white_list={"tanh", "exp"},
                   custom_black_list={"linear", "gelu"}),
}


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_output_types_under_auto_cast_match_reference(scope):
    diffs = []
    for name, op in OPS.items():
        with ref.amp.auto_cast(**SCOPES[scope]):
            want = op(ref).dtype.name
        with pt.amp.auto_cast(**SCOPES[scope]):
            got = op(pt).dtype.name
        if got != want:
            diffs.append((name, want, got))
    assert not diffs
    # outside the scope nothing is cast
    assert OPS["matmul"](pt).dtype == pt.float32


def test_lists_match_reference_and_scopes_nest():
    assert pt.amp.white_list() == ref.amp.white_list()
    assert pt.amp.black_list() == ref.amp.black_list()
    x = _f(pt, 2, 8)

    def xxt():
        return pt.matmul(x, x, transpose_y=True).dtype

    with pt.amp.auto_cast(dtype="bfloat16"):
        with pt.amp.auto_cast(enable=False):
            assert xxt() == pt.float32
        assert xxt() == pt.bfloat16
    assert xxt() == pt.float32


def test_decorate_o2_casts_the_model_and_sets_master_weights():
    for p in (ref, pt):
        model = p.nn.Linear(4, 4)
        opt = p.optimizer.AdamW(1e-3, parameters=model.parameters())
        model, opt = p.amp.decorate(model, opt, level="O2", dtype="bfloat16")
        assert model.weight.dtype.name == "bfloat16"
        assert opt._multi_precision


@pytest.mark.parametrize("enable", [True, False], ids=["scaled", "off"])
def test_grad_scaler_step_matches_reference(enable):
    """fp32 weights, a loss scaled by 2^16 and unscaled before the step:
    the updated weights equal the reference's, and equal the unscaled
    step's (the scale is a power of two)."""
    w0 = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    x = np.random.RandomState(6).randn(2, 4).astype(np.float32)
    out = []
    for p in (ref, pt):
        lin = p.nn.Linear(4, 3)
        lin.set_state_dict({"weight": w0, "bias": np.zeros(3, np.float32)})
        opt = p.optimizer.SGD(0.1, parameters=lin.parameters())
        scaler = p.amp.GradScaler(enable=enable)
        loss = p.mean(lin(p.to_tensor(x)) ** 2)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        assert scaler.is_enable() == enable
        out.append(lin.weight.numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)


def test_grad_scaler_skips_a_step_with_an_inf_gradient():
    lin = pt.nn.Linear(2, 1)
    before = lin.weight.numpy().copy()
    opt = pt.optimizer.SGD(0.1, parameters=lin.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=4.0)
    loss = pt.sum(lin(pt.to_tensor([[1e38, 1e38]])))
    scaler.scale(loss).backward()
    scaler.step(opt)
    np.testing.assert_array_equal(lin.weight.numpy(), before)
    assert scaler.get_init_loss_scaling() == 2.0
