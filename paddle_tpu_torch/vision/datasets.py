"""Vision datasets: a copy of ``paddle_tpu/vision/datasets.py``.

MNIST and FashionMNIST read IDX files from a local path when one is given
and exists; otherwise every dataset is the reference's synthetic set, made
from a fixed seed by ``_synthetic_images``, so the arrays are bit-equal to
the reference's. Samples are numpy (CHW float32 in [0, 1], int64 label);
the ``DataLoader`` puts batches on the device. Nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"]


def _synthetic_images(n, h, w, c, num_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    images = np.zeros((n, h, w, c), np.uint8)
    # class-dependent pattern so models can actually fit it
    for i in range(n):
        k = labels[i]
        base = rng.randint(0, 60, (h, w, c)).astype(np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        pattern = ((yy * (k + 1) + xx * (k + 3)) % 17 < 6)
        base[pattern] = 180 + (k * 7) % 70
        images[i] = base
    return images, labels


class MNIST(Dataset):
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        images = labels = None
        if image_path and os.path.exists(image_path):
            images = self._read_idx_images(image_path)
            labels = self._read_idx_labels(label_path)
        else:
            n = 2048 if mode == "train" else 512
            images, labels = _synthetic_images(
                n, 28, 28, 1, self.NUM_CLASSES,
                seed=42 if mode == "train" else 43)
        self.images = images
        self.labels = labels

    @staticmethod
    def _read_idx_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, h, w = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), np.uint8).reshape(n, h, w, 1)
        return data

    @staticmethod
    def _read_idx_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32) / 255.0
            img = img.transpose(2, 0, 1)
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.transform = transform
        n = 2048 if mode == "train" else 512
        self.images, self.labels = _synthetic_images(
            n, 32, 32, 3, self.NUM_CLASSES, seed=44 if mode == "train"
            else 45)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = int(self.labels[idx])
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)
        return img, np.asarray(label, np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
