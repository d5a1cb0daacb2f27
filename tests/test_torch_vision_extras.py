"""The port's five extra vision families (``vision/models/extras.py``:
AlexNet, SqueezeNet 1.1, DenseNet-121, ShuffleNetV2 x1.0, GoogLeNet
without aux heads) against the JAX package's, on the CPU: ``state_dict``
keys and shapes, and the eval-mode logits with the same weights on both
sides (``test_torch_vision_models.built``). Tolerance fp32 1e-5
(convolutions summed in other orders); inputs at the smallest size each
family takes (AlexNet 64², the others 32²), ten classes."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from test_torch_vision_models import built

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("name,size", [
    ("alexnet", 64), ("squeezenet1_1", 32), ("densenet121", 32),
    ("shufflenet_v2_x1_0", 32), ("googlenet", 32)])
def test_eval_logits_match_reference(name, size):
    r, p, _ = built(name, num_classes=10)
    want = [(k, tuple(v.shape)) for k, v in r.state_dict().items()]
    assert [(k, tuple(v.shape)) for k, v in p.state_dict().items()] == want
    r.eval()
    p.eval()
    x = np.random.RandomState(4).randn(2, 3, size, size).astype(np.float32)
    got = p(pt.to_tensor(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, np.asarray(r(ref.to_tensor(x)).numpy()),
                               rtol=TOL, atol=TOL)


def test_constructors_and_classes_are_exported():
    from paddle_tpu_torch.vision import models as M
    for cls, fn in (("AlexNet", "alexnet"), ("SqueezeNet", "squeezenet1_1"),
                    ("DenseNet", "densenet121"),
                    ("ShuffleNetV2", "shufflenet_v2_x1_0"),
                    ("GoogLeNet", "googlenet")):
        assert isinstance(getattr(M, fn)(num_classes=3), getattr(M, cls))
