"""The eager vision path on the card against the port's CPU path.

Convolution, pooling and batch norm through ``paddle_tpu_torch.nn.functional``
on CUDA tensors (cuDNN and PyTorch's CUDA ops) against the same calls on
CPU tensors (the path the CPU tests hold against the JAX package), forward
and the gradients of the input, weight and bias; then a ResNet-18 step.
Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
there is no CUDA device. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_vision.py

Tolerances: fp32 with TF32 off (the fixture turns it off), 1e-5 of each
element plus 1e-5 of the tensor's largest (the same sums in other
orders); bf16, one bf16 ulp of each element (2^-7 |x|) plus 1e-3 of the
largest (both sides accumulate in fp32 and round once, the gradients
through bf16 intermediates). ResNet-18 training: float64 1e-9 of each
tensor's largest element.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card path has no CPU mode)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def _limit(want: np.ndarray, dtype) -> np.ndarray:
    scale = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "bfloat16":
        return 2 ** -7 * np.abs(want) + 1e-3 * scale
    return 1e-5 * np.abs(want) + 1e-5 * max(scale, 1.0)


def _both(fn, arrays, dtype="float32", seed=9):
    """``fn`` on the card and on the CPU from the same arrays (cast to
    ``dtype``); each output weighted by a fixed random array and summed,
    so the gradients of every input are compared too."""
    results = []
    for dev in ("cuda", "cpu"):
        ts = [None if a is None else torch.tensor(a, device=dev).to(
            getattr(torch, dtype)).requires_grad_() for a in arrays]
        out = fn(*ts)
        w = torch.from_numpy(np.random.RandomState(seed).randn(
            *out.shape).astype(np.float32)).to(dev)
        (out.float() * w).sum().backward()
        results.append([out.detach().float().cpu().numpy()] + [
            None if t is None else t.grad.float().cpu().numpy()
            for t in ts])
    for got, want in zip(*results):
        if want is not None:
            assert got.shape == want.shape
            assert np.all(np.abs(got - want) <= _limit(want, dtype)), \
                float(np.abs(got - want).max())


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


DTYPES = ["float32", "bfloat16"]
CONV = {
    "pad1": ((2, 8, 17, 17), (16, 8, 3, 3), dict(padding=1)),
    "same_stride2": ((2, 8, 17, 15), (16, 8, 3, 3),
                     dict(padding="SAME", stride=2)),
    "pairs": ((2, 8, 16, 16), (16, 8, 3, 3), dict(padding=[[2, 0], [1, 1]])),
    "stem_7x7_s2": ((2, 3, 32, 32), (16, 3, 7, 7), dict(padding=3, stride=2)),
    "1x1_s2": ((2, 16, 16, 16), (32, 16, 1, 1), dict(stride=2)),
    "groups_dilation": ((2, 8, 17, 17), (8, 2, 3, 3),
                        dict(padding=2, dilation=2, groups=4)),
    "nhwc": ((2, 17, 17, 8), (16, 8, 3, 3),
             dict(padding=1, data_format="NHWC")),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CONV))
def test_conv2d_matches_cpu(cuda, case, dtype):
    xs, ws, kw = CONV[case]
    _both(lambda x, w, b: F.conv2d(x, w, b, **kw),
          [_rand(0, *xs), _rand(1, *ws) * 0.2, _rand(2, ws[0])], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv2d_transpose_matches_cpu(cuda, dtype):
    _both(lambda x, w, b: F.conv2d_transpose(
        x, w, b, stride=2, padding=[[2, 0], [1, 1]], output_padding=1),
        [_rand(3, 2, 8, 9, 9), _rand(4, 8, 6, 3, 3) * 0.2, _rand(5, 6)],
        dtype)


POOLS = {
    "max_k3s2p1": lambda x: F.max_pool2d(x, 3, 2, 1),
    "max_ceil": lambda x: F.max_pool2d(x, 3, 2, ceil_mode=True),
    "avg_exclusive": lambda x: F.avg_pool2d(x, 3, 2, 1, ceil_mode=True),
    "avg_inclusive": lambda x: F.avg_pool2d(x, 3, 2, 1, ceil_mode=True,
                                            exclusive=False),
    "avg_divisor": lambda x: F.avg_pool2d(x, 3, 2, 1, divisor_override=5),
    "adaptive_avg": lambda x: F.adaptive_avg_pool2d(x, 3),
    "adaptive_max": lambda x: F.adaptive_max_pool2d(x, (2, 3)),
    "avg_nhwc": lambda x: F.avg_pool2d(x.permute(0, 2, 3, 1), 2,
                                       data_format="NHWC"),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_matches_cpu(cuda, case, dtype):
    _both(POOLS[case], [_rand(6, 2, 8, 15, 15)], dtype)


def test_max_pool_mask_matches_cpu(cuda):
    x = _rand(7, 2, 8, 15, 15)
    g = F.max_pool2d(torch.tensor(x, device=cuda), 3, 2, 1, return_mask=True)
    c = F.max_pool2d(torch.tensor(x), 3, 2, 1, return_mask=True)
    np.testing.assert_array_equal(g[1].cpu().numpy(), c[1].numpy())
    np.testing.assert_array_equal(g[0].cpu().numpy(), c[0].numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_cpu(cuda, fmt, training, dtype):
    """Forward and gradients; in train mode the running buffers after the
    step too (float32 buffers, the reference's update)."""
    shape = (4, 15, 15, 8) if fmt == "NHWC" else (4, 8, 15, 15)
    buffers = {}

    def fn(x, w, b):
        rm = torch.zeros(8, device=x.device)
        rv = torch.ones(8, device=x.device)
        out = F.batch_norm(x, rm, rv, w, b, training=training,
                           data_format=fmt)
        buffers[x.device.type] = (rm.cpu().numpy(), rv.cpu().numpy())
        return out

    _both(fn, [_rand(8, *shape) * 2 + 1, _rand(9, 8), _rand(10, 8)], dtype)
    for got, want in zip(buffers["cuda"], buffers["cpu"]):
        assert np.all(np.abs(got - want) <= _limit(want, dtype))


def test_resnet18_steps_match_cpu_in_float64(cuda, monkeypatch):
    """Three Momentum steps of ``resnet18(num_classes=10)`` on the card
    and on the CPU from the same float64 weights: losses, parameters and
    BN buffers to 1e-9 of each tensor's largest element."""
    from paddle_tpu_torch._core import device as pt_device
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 32, 32)
    y = rng.randint(0, 10, (4,))
    monkeypatch.setattr(pt_device, "_current", "cpu")
    pt.seed(0)
    init = {k: v.numpy() for k, v in resnet18(num_classes=10)
            .state_dict().items()}
    runs = []
    for dev in ("gpu", "cpu"):
        pt.set_device(dev)
        model = resnet18(num_classes=10)
        model.set_state_dict(init)
        model.astype("float64")
        opt = pt.optimizer.Momentum(0.1, parameters=model.parameters())
        xs = pt.to_tensor(x, dtype="float64")
        ys = pt.to_tensor(y)
        losses = []
        for _ in range(3):
            loss = F.cross_entropy(model(xs), ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.numpy())
        runs.append((losses, {k: v.numpy()
                              for k, v in model.state_dict().items()}))
    (g_loss, g_state), (c_loss, c_state) = runs
    np.testing.assert_allclose(g_loss, c_loss, rtol=1e-9, atol=1e-9)
    for k, want in c_state.items():
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(g_state[k] - want).max()) <= 1e-9 * scale, k
