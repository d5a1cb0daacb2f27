"""``vision.transforms``: the counterpart of
``paddle_tpu/vision/transforms.py``, numpy on the host.

Each random transform draws from Python's ``random`` in the reference's
order (``RandomCrop``: top then left; ``RandomResizedCrop``: the scale,
then top and left), so one seeded run gives the same images on both
sides. ``ToTensor`` (and ``Normalize`` of a ``Tensor``) give a ``Tensor``
on the CPU whatever the current device: a sample stays on the host, and
the ``DataLoader`` moves each collated batch to the card once. Two of the
reference's rules are kept as they are: ``Resize`` is a nearest-index
gather (``interpolation`` is not read), and ``RandomResizedCrop`` crops a
square share ``scale`` of the image's sides (``ratio`` and
``interpolation`` are not read).
"""
from __future__ import annotations

import numbers
import random as pyrandom

import numpy as np
import torch

from .._core.tensor import Tensor

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "Pad", "RandomResizedCrop"]


def _as_hwc(img):
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor:
    """HWC uint8 [0,255] -> CHW float32 [0,1] ``Tensor`` on the CPU."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = _as_hwc(img).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return Tensor(torch.from_numpy(arr))  # no copy: arr is fresh


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        if isinstance(img, Tensor):
            arr = img.numpy()
        else:
            arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        out = arr - m
        np.divide(out, s, out=out)  # (arr - m) / s, in place
        return Tensor(torch.from_numpy(out)) if isinstance(img, Tensor) \
            else out


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Integral) \
            else tuple(size)

    def __call__(self, img):
        arr = _as_hwc(img)
        h, w = self.size
        ih, iw = arr.shape[:2]
        yi = (np.arange(h) * (ih / h)).astype(np.int64).clip(0, ih - 1)
        xi = (np.arange(w) * (iw / w)).astype(np.int64).clip(0, iw - 1)
        return arr[yi][:, xi]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Integral) \
            else tuple(size)

    def __call__(self, img):
        arr = _as_hwc(img)
        h, w = self.size
        ih, iw = arr.shape[:2]
        top = max((ih - h) // 2, 0)
        left = max((iw - w) // 2, 0)
        return arr[top:top + h, left:left + w]


class RandomCrop:
    def __init__(self, size, padding=0, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, numbers.Integral) \
            else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = _as_hwc(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, ((p, p), (p, p), (0, 0)))
        h, w = self.size
        ih, iw = arr.shape[:2]
        top = pyrandom.randint(0, max(ih - h, 0))
        left = pyrandom.randint(0, max(iw - w, 0))
        return arr[top:top + h, left:left + w]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Integral) \
            else tuple(size)
        self.scale = scale

    def __call__(self, img):
        arr = _as_hwc(img)
        ih, iw = arr.shape[:2]
        s = pyrandom.uniform(*self.scale)
        ch = max(int(ih * np.sqrt(s)), 1)
        cw = max(int(iw * np.sqrt(s)), 1)
        top = pyrandom.randint(0, max(ih - ch, 0))
        left = pyrandom.randint(0, max(iw - cw, 0))
        crop = arr[top:top + ch, left:left + cw]
        return Resize(self.size)(crop)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        arr = _as_hwc(img)
        if pyrandom.random() < self.prob:
            return arr[:, ::-1].copy()
        return arr


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        arr = _as_hwc(img)
        if pyrandom.random() < self.prob:
            return arr[::-1].copy()
        return arr


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return _as_hwc(img).transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding if isinstance(padding, (list, tuple)) \
            else (padding,) * 4
        self.fill = fill

    def __call__(self, img):
        arr = _as_hwc(img)
        l, t, r, b = self.padding if len(self.padding) == 4 else \
            (self.padding[0], self.padding[1]) * 2
        return np.pad(arr, ((t, b), (l, r), (0, 0)),
                      constant_values=self.fill)
