"""The port's vision models, datasets and DataLoader against the JAX
package's, on the CPU.

- LeNet and ``resnet18(num_classes=10)`` with the same weights on both
  sides, carried as numpy (BN buffers included): logits, loss, every
  parameter's gradient, then the parameters and BN buffers after three
  ``Momentum`` steps, with the optimizer's velocity carried across after
  the first (ResNet-50 and the O1 types have a file of their own,
  ``test_torch_vision_resnet50.py``, VGG and MobileNet another,
  ``test_torch_vision_families.py``: the reference's first eager steps
  compile for tens of seconds);
- the synthetic datasets bit for bit, and ``DataLoader`` batches
  (``shuffle=False``) value for value, with two worker processes too;
- LeNet trains on the synthetic MNIST as ``tests/test_lenet_e2e.py``
  asserts for the reference.

Tolerances: training in float64 on both sides 1e-9, and LeNet's also in
fp32 1e-5; a ResNet's train-mode fp32 gradients on a batch of 2 are too
ill-conditioned to compare (``hold_training_against_reference``), so its
fp32 path is held in eval mode, 1e-5, and per op in
``test_torch_vision_ops.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.io import DataLoader as RDataLoader
from paddle_tpu.io import TensorDataset as RTensorDataset
from paddle_tpu.nn import initializer as rinit
from paddle_tpu.vision import datasets as rds
from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.io import DataLoader, Subset, TensorDataset
from paddle_tpu_torch.models.convert import optimizer_state_renamed
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import models as pmodels

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here)."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np_state(layer):
    return {k: np.array(v.numpy()) for k, v in layer.state_dict().items()}


def built(name, **kw):
    """Model ``name`` on both sides and a second port model, all three
    with the port's random weights from ``pt.seed(0)``. The reference's
    random initializers are swapped for zeros while it builds: its
    weights are replaced at once, and its per-shape ``jax.random``
    compiles take 15 s for a ResNet-50 on the CPU."""
    def zeros(self, shape, dtype="float32"):
        return jnp.zeros(tuple(shape), dtype)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (rinit.KaimingNormal, rinit.XavierNormal, rinit.Normal):
            mp.setattr(cls, "__call__", zeros)
        rm = getattr(rmodels, name)(**kw)
    pt.seed(0)
    pm, pm64 = (getattr(pmodels, name)(**kw) for _ in range(2))
    state = _np_state(pm)
    rm.set_state_dict(state)
    pm64.set_state_dict(state)
    return rm, pm, pm64


def carried(ref_model, port_model):
    """The reference's weights and BN buffers into the port's model."""
    missing, unexpected = port_model.set_state_dict(_np_state(ref_model))
    assert not missing and not unexpected


def _trace(p, F_, model, x, y, steps, lr, velocity=None):
    """``steps`` Momentum steps of ``model`` on (x, y): the first step's
    logits, loss and gradients, then the state_dict after the last step,
    and the optimizer's state after the first. ``velocity``: an optimizer
    state to load after the first step into a fresh optimizer (the
    reference's, crossing to the port)."""
    out = {}
    opt = p.optimizer.Momentum(lr, parameters=model.parameters())
    for step in range(steps):
        logits = model(p.to_tensor(x, dtype=x.dtype.name))
        loss = F_.cross_entropy(logits, p.to_tensor(y))
        loss.backward()
        if step == 0:
            out["logits"] = np.array(logits.numpy())
            out["loss"] = np.array(loss.numpy())
            for i, q in enumerate(model.parameters()):
                out[f"grad{i}"] = np.array(q.grad.numpy())
        opt.step()
        opt.clear_grad()
        if step == 0:
            out["opt_state"] = {
                k: v if isinstance(v, (int, dict)) else np.array(v.numpy())
                for k, v in opt.state_dict().items()}
            out["names"] = [q.name for q in model.parameters()]
            if velocity is not None:
                opt = p.optimizer.Momentum(lr, parameters=model.parameters())
                opt.set_state_dict(optimizer_state_renamed(
                    velocity["opt_state"], velocity["names"], out["names"]))
    for k, v in _np_state(model).items():
        out[f"state.{k}"] = v
    return out


def hold_training_against_reference(rm, pm, pm64, x, y, fp32, steps=3,
                                    lr=0.1):
    """Trains the reference model ``rm`` and the port's model ``steps``
    Momentum steps on (x, y) from the same weights; after the first, the
    reference's optimizer state (its velocity) crosses to a fresh port
    optimizer. Compared: the first step's logits, loss and every
    gradient, and the parameters and BN buffers after the last step.

    In float64 on both sides (the reference under ``jax.enable_x64``, the
    port as ``pm64``), to 1e-9: the two compute the same function. With
    ``fp32`` also in float32 (``pm``), to 1e-5. A ResNet trained in train
    mode on a batch of 2 is not held in fp32: batch norm over a few values
    per channel (8 in a ResNet-50's layer4 at 64 x 64 inputs) amplifies
    rounding so far that either framework's fp32 gradients stand up to
    about 2% of the largest early-layer gradient from its own float64 ones.
    Leaves ``rm`` in float32; returns the reference's final state (float64
    run)."""
    init = _np_state(rm)
    carried(rm, pm64)
    pm64.astype("float64")
    pairs = []
    if fp32:
        carried(rm, pm)
        want = _trace(ref, RF, rm, x, y, steps, lr)
        got = _trace(pt, F, pm, x, y, steps, lr, velocity=want)
        pairs.append((got, want, 1e-5))
        rm.set_state_dict(init)
    with jax.enable_x64(True):
        rm.astype("float64")
        want64 = _trace(ref, RF, rm, x.astype(np.float64), y, steps, lr)
    got64 = _trace(pt, F, pm64, x.astype(np.float64), y, steps, lr,
                   velocity=want64)
    pairs.append((got64, want64, 1e-9))
    rm.astype("float32")
    final = {k[6:]: v for k, v in want64.items() if k.startswith("state.")}
    rm.set_state_dict(final)
    for got, want, tol in pairs:
        for k, w in want.items():
            if k not in ("opt_state", "names"):
                np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                           err_msg=k)
    return final


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_training_matches_reference(name):
    rng = np.random.RandomState(0)
    shape = (4, 1, 28, 28) if name == "LeNet" else (2, 3, 64, 64)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, 10, (shape[0],)).astype(np.int64)
    rm, pm, pm64 = built(name, num_classes=10)
    state = hold_training_against_reference(rm, pm, pm64, x, y,
                                            fp32=name == "LeNet")
    if name == "resnet18":  # the BN buffers moved in train mode
        assert not np.allclose(state["bn1._mean"], 0.0)
        assert not np.allclose(state["bn1._variance"], 1.0)


def test_resnet34_state_dict_keys_and_shapes_match_reference():
    r, p, _ = built("resnet34", num_classes=10)
    assert [(k, tuple(v.shape)) for k, v in p.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in r.state_dict().items()]


def test_eval_uses_the_running_statistics():
    """After ``eval()`` the BN layers normalise with their buffers: the
    port's logits equal the reference's and the buffers do not move."""
    rm, pm, _ = built("resnet18", num_classes=10)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    rm.eval()
    pm.eval()
    before = _np_state(pm)
    _close(pm(pt.to_tensor(x)).numpy(), rm(ref.to_tensor(x)).numpy())
    after = _np_state(pm)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


# ------------------------------------------------------------- datasets

@pytest.mark.parametrize("name,mode", [
    ("MNIST", "train"), ("MNIST", "test"), ("FashionMNIST", "train"),
    ("Cifar10", "train"), ("Cifar10", "test"), ("Cifar100", "train")])
def test_synthetic_datasets_are_bit_equal(name, mode):
    r, p = getattr(rds, name)(mode=mode), getattr(pds, name)(mode=mode)
    assert len(p) == len(r)
    np.testing.assert_array_equal(p.images, r.images)
    np.testing.assert_array_equal(p.labels, r.labels)
    for i in (0, len(r) - 1):
        for a, b in zip(p[i], r[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch_size,drop_last", [(64, False), (100, True),
                                                  (100, False)])
def test_dataloader_batches_match_reference(batch_size, drop_last):
    rl = RDataLoader(rds.MNIST(mode="test"), batch_size=batch_size,
                     shuffle=False, drop_last=drop_last)
    pl = DataLoader(pds.MNIST(mode="test"), batch_size=batch_size,
                    shuffle=False, drop_last=drop_last)
    assert len(pl) == len(rl)
    n = 0
    for (rx, ry), (px, py) in zip(rl, pl):
        np.testing.assert_array_equal(px.numpy(), np.asarray(rx.numpy()))
        np.testing.assert_array_equal(py.numpy(), np.asarray(ry.numpy()))
        assert px.dtype == pt.float32
        n += 1
    assert n == len(pl)


def test_tensor_dataset_subset_concat_and_split_match_reference():
    rng = np.random.RandomState(3)
    a = rng.randn(10, 3).astype(np.float32)
    b = rng.randint(0, 5, (10,)).astype(np.int64)
    rds_ = RTensorDataset([ref.to_tensor(a), ref.to_tensor(b)])
    pds_ = TensorDataset([pt.to_tensor(a), pt.to_tensor(b)])
    for (rx, ry), (px, py) in zip(RDataLoader(rds_, batch_size=4),
                                  DataLoader(pds_, batch_size=4)):
        np.testing.assert_array_equal(px.numpy(), np.asarray(rx.numpy()))
        np.testing.assert_array_equal(py.numpy(), np.asarray(ry.numpy()))
    ref.seed(5)
    pt.seed(5)
    r_parts = ref.io.random_split(rds.MNIST(mode="test"), [100, 412])
    p_parts = pt.io.random_split(pds.MNIST(mode="test"), [100, 412])
    for r, p in zip(r_parts, p_parts):
        assert p.indices == r.indices
    cat = pt.io.ConcatDataset(p_parts)
    assert len(cat) == 512
    np.testing.assert_array_equal(cat[150][0], p_parts[1][50][0])
    # shuffled batches are a permutation: the same set of labels
    loader = DataLoader(pds.MNIST(mode="test"), batch_size=64, shuffle=True)
    labels = np.concatenate([y.numpy() for _, y in loader])
    np.testing.assert_array_equal(np.sort(labels),
                                  np.sort(pds.MNIST(mode="test").labels))


@pytest.mark.timeout(60)
def test_dataloader_refuses_worker_processes():
    """Named when worker processes were refused; now that they are
    ported: two workers give the single-process batches of the synthetic
    MNIST bit for bit, in order (``test_torch_io_workers.py`` holds the
    rest of the worker loader)."""
    ds = Subset(pds.MNIST(mode="test"), list(range(40)))
    single = [(x.numpy(), y.numpy()) for x, y in DataLoader(ds,
                                                            batch_size=6)]
    workers = [(x.numpy(), y.numpy()) for x, y in DataLoader(
        ds, batch_size=6, num_workers=2, timeout=30)]
    assert len(workers) == len(single) == 7
    for (wx, wy), (sx, sy) in zip(workers, single):
        np.testing.assert_array_equal(wx, sx)
        np.testing.assert_array_equal(wy, sy)


def test_lenet_trains_on_synthetic_mnist():
    """The reference's LeNet test, on the port: loss down by 30% over two
    epochs, test accuracy above chance (0.3)."""
    pt.seed(0)
    loader = DataLoader(pds.MNIST(mode="train"), batch_size=64, shuffle=True,
                        drop_last=True)
    model = pmodels.LeNet(num_classes=10)
    opt = pt.optimizer.Adam(learning_rate=1e-3,
                            parameters=model.parameters())
    losses = []
    model.train()
    for _ in range(2):
        for x, y in loader:
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    model.eval()
    correct = total = 0
    with pt.no_grad():
        for x, y in DataLoader(pds.MNIST(mode="test"), batch_size=128):
            pred = model(x).numpy().argmax(-1)
            correct += int((pred == y.numpy()).sum())
            total += len(pred)
    assert correct / total > 0.3, correct / total
