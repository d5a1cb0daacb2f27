"""The port's VGG and MobileNet against the JAX package's, on the CPU:
``state_dict`` keys and shapes, and the eval-mode logits with the same
weights on both sides (MobileNet's depthwise convolutions
are ``Conv2D`` with ``groups`` equal to the channels). Tolerance fp32
1e-5 (convolutions summed in other orders)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from test_torch_vision_models import built


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("name,kw", [
    ("vgg11", dict(batch_norm=True, num_classes=10)),
    ("MobileNetV1", dict(scale=0.25, num_classes=10)),
    ("MobileNetV2", dict(scale=0.25, num_classes=10))])
def test_eval_logits_match_reference(name, kw):
    r, p, _ = built(name, **kw)
    want = [(k, tuple(v.shape)) for k, v in r.state_dict().items()]
    assert [(k, tuple(v.shape)) for k, v in p.state_dict().items()] == want
    r.eval()
    p.eval()
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(p(pt.to_tensor(x)).numpy(),
                               np.asarray(r(ref.to_tensor(x)).numpy()),
                               rtol=1e-5, atol=1e-5)
