"""The port's eager ResNet-50 against the JAX package's, on the CPU: the
benchmark's model (``resnet50()`` as ``resnet.py`` builds it, here with 10
classes) at 2 x 3 x 64 x 64, and the output type of every op along its
stem, one bottleneck block and its head under ``auto_cast(level="O1")``.

One pair of models serves the file (the reference builds and first runs
its eager ResNet-50 for about 30 s on the CPU); each test starts from the
reference's initial weights. Tolerances as in ``test_torch_vision_models``:
training in float64 on both sides, 1e-9 (in fp32, train-mode batch norm
over 8 values per channel in layer4 leaves either framework's gradients
up to about 2% of the largest early-layer gradient from its own float64
ones; the fp32 path is held in eval mode on ResNet-18 and per op).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch._core import device as pt_device
from test_torch_vision_models import (_np_state, built,
                                      hold_training_against_reference)



@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture(scope="module")
def models():
    pt_device._current, saved = "cpu", pt_device._current
    try:
        rm, pm, pm64 = built("resnet50", num_classes=10)
    finally:
        pt_device._current = saved
    return rm, pm, pm64, _np_state(rm)


def _reset(models):
    rm, pm, pm64, init = models
    rm.astype("float32")
    pm64.astype("float32")
    for m in (rm, pm, pm64):
        m.set_state_dict(init)
        m.train()
    return rm, pm, pm64


def test_resnet50_training_matches_reference(models):
    """Logits, loss and every gradient of the first step; the parameters
    and BN buffers after three Momentum(0.1) steps, the velocity carried
    across after the first, in float64
    (``hold_training_against_reference``)."""
    rm, pm, pm64 = _reset(models)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.int64)
    state = hold_training_against_reference(rm, pm, pm64, x, y, fp32=False)
    assert not np.allclose(state["layer4.2.bn3._mean"], 0.0)


def _op_types(p, F_, m, x, y):
    """The output type of each op along the stem, the first bottleneck
    block of layer2 (with its downsample) and the head, under O1 bf16."""
    blk = m.layer2[0]
    seq = {}
    with p.amp.auto_cast(level="O1", dtype="bfloat16"):
        a = m.conv1(x)
        seq["stem.conv"] = a
        a = m.bn1(a)
        seq["stem.bn"] = a
        a = m.relu(a)
        seq["stem.relu"] = a
        a = m.maxpool(a)
        seq["stem.maxpool"] = a
        a = m.layer1(a)
        seq["layer1"] = a
        c1 = blk.conv1(a)
        seq["conv1"] = c1
        b1 = blk.bn1(c1)
        seq["bn1"] = b1
        r1 = blk.relu(b1)
        seq["relu1"] = r1
        c2 = blk.conv2(r1)
        seq["conv2"] = c2
        b2 = blk.bn2(c2)
        seq["bn2"] = b2
        c3 = blk.conv3(blk.relu(b2))
        seq["conv3"] = c3
        b3 = blk.bn3(c3)
        seq["bn3"] = b3
        ident = blk.downsample(a)
        seq["downsample"] = ident
        s = b3 + ident
        seq["residual_add"] = s
        out = blk.relu(s)
        seq["block_out"] = out
        feats = m.layer4(m.layer3(m.layer2[1:](out)))
        pooled = m.avgpool(feats)
        seq["avgpool"] = pooled
        flat = p.flatten(pooled, 1)
        seq["flatten"] = flat
        logits = m.fc(flat)
        seq["fc"] = logits
        seq["loss"] = F_.cross_entropy(logits, y)
    return {k: str(v.dtype).split(".")[-1] for k, v in seq.items()}


def test_o1_types_along_a_resnet_block_match_reference(models):
    """Convolutions and the fc in bf16 (white list), batch norm and the
    loss in float32 (black list), ReLU, pooling, flatten and the residual
    add in their input's type (neither list)."""
    rm, pm, _ = _reset(models)
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    y = np.array([1, 2])
    want = _op_types(ref, RF, rm, ref.to_tensor(x), ref.to_tensor(y))
    got = _op_types(pt, F, pm, pt.to_tensor(x), pt.to_tensor(y))
    assert got == want
    assert want["conv1"] == "bfloat16" and want["bn1"] == "float32"
    assert want["fc"] == "bfloat16" and want["loss"] == "float32"
