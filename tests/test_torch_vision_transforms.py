"""The port's ``vision.transforms`` against the JAX package's on the CPU:
each of the 11 classes on the same uint8 images, with Python's ``random``
seeded alike before each side, so the random crops and flips draw the
same numbers. Results are exact, or within 1e-7 for ``ToTensor`` and
``Normalize`` (float32 arithmetic; both sides run the same numpy code, so
they are bit-equal in practice).

Pinned here as well: ``ToTensor`` gives a CPU ``Tensor`` (the batch moves
to the card in the ``DataLoader``), ``Resize`` is the reference's
nearest-index gather, and ``RandomResizedCrop`` reads neither ``ratio``
nor ``interpolation``.
"""
import random

import numpy as np
import pytest

import paddle_tpu.vision.transforms as RT
import paddle_tpu_torch.vision.transforms as PT
from paddle_tpu_torch._core import device as pt_device

TOL = 1e-7


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _img(h=17, w=23, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)) \
        .astype(np.uint8)


def _np(x):
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _both(make, img, seed=7, repeats=6):
    """``make(T)(img)`` on both sides, ``repeats`` times, ``random``
    seeded alike before each side."""
    outs = []
    for T in (PT, RT):
        random.seed(seed)
        t = make(T)
        outs.append([_np(t(img)) for _ in range(repeats)])
    return outs


def _exact(make, img=None, **kw):
    mine, theirs = _both(make, _img() if img is None else img, **kw)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return mine


@pytest.mark.parametrize("make", [
    lambda T: T.Resize(8), lambda T: T.Resize((9, 31)),
    lambda T: T.Resize((40, 5), interpolation="bicubic"),
    lambda T: T.CenterCrop(9), lambda T: T.CenterCrop((40, 11)),
    lambda T: T.RandomCrop(9), lambda T: T.RandomCrop((10, 12), padding=3),
    lambda T: T.RandomResizedCrop(7), lambda T: T.RandomResizedCrop(
        (5, 9), scale=(0.3, 0.6), ratio=(0.2, 5.0)),
    lambda T: T.RandomHorizontalFlip(), lambda T: T.RandomVerticalFlip(0.3),
    lambda T: T.Transpose(), lambda T: T.Transpose((1, 0, 2)),
    lambda T: T.Pad(2), lambda T: T.Pad((1, 2), fill=9),
    lambda T: T.Pad((1, 2, 3, 4)),
], ids=["resize8", "resize9x31", "resize_bicubic", "center9",
        "center40x11", "randcrop9", "randcrop_pad", "rrc7", "rrc_ratio",
        "hflip", "vflip", "transpose", "transpose102", "pad2", "pad12_fill",
        "pad1234"])
def test_geometric_transforms_match_reference(make):
    _exact(make)


def test_grey_images_take_a_channel_axis():
    grey = _img()[:, :, 0]
    _exact(lambda T: T.Compose([T.RandomResizedCrop(6),
                                T.RandomHorizontalFlip()]), img=grey)


@pytest.mark.parametrize("data_format", ["CHW", "HWC"])
def test_to_tensor_and_normalize_match_reference(data_format):
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    mine, theirs = _both(lambda T: T.Compose([
        T.RandomResizedCrop(11), T.RandomHorizontalFlip(),
        T.ToTensor(data_format), T.Normalize(mean, std, data_format)]),
        _img())
    for a, b in zip(mine, theirs):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # Normalize on a numpy array gives numpy, as the reference
    arr = _img().astype(np.float32)
    got = PT.Normalize(127.5, 60.0, "HWC")(arr)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, RT.Normalize(127.5, 60.0, "HWC")(arr),
                               rtol=TOL, atol=TOL)


def test_to_tensor_scales_only_byte_images():
    unit = np.random.RandomState(1).uniform(0, 1, (4, 5, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(_np(PT.ToTensor()(unit)),
                               _np(RT.ToTensor()(unit)), rtol=TOL,
                               atol=TOL)


def test_to_tensor_is_on_the_cpu_whatever_the_device(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "gpu:0")
    t = PT.ToTensor()(_img())
    assert t._t.device.type == "cpu"
    assert PT.Normalize(0.5, 0.25)(t)._t.device.type == "cpu"


def test_resize_is_a_nearest_index_gather():
    img = np.arange(4 * 6).reshape(4, 6, 1).astype(np.uint8)
    out = PT.Resize((2, 3), interpolation="bilinear")(img)
    np.testing.assert_array_equal(out[:, :, 0], img[::2, ::2, 0])


def test_random_resized_crop_ignores_ratio():
    """The crop keeps the image's aspect (the scale applies to both
    sides), whatever ``ratio`` asks for: the same draws give the same
    image under two ratios."""
    img = _img(30, 20)
    outs = []
    for ratio in ((0.1, 0.2), (5.0, 9.0)):
        random.seed(3)
        outs.append(PT.RandomResizedCrop(6, ratio=ratio)(img))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_random_draw_order_is_the_references():
    """``RandomCrop`` draws top then left; the flips one ``random()``
    each; ``RandomResizedCrop`` the scale, then top, then left."""
    img = _img(20, 30)
    random.seed(5)
    out = PT.RandomCrop(8)(img)
    random.seed(5)
    top, left = random.randint(0, 12), random.randint(0, 22)
    np.testing.assert_array_equal(out, img[top:top + 8, left:left + 8])
