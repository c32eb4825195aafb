"""Vision datasets (the port of ``paddle_tpu/vision/datasets.py``; parity:
python/paddle/vision/datasets).

Synthetic-capable: when download is unavailable (no network egress), each
dataset can generate deterministic fake data with the real shapes/dtypes so
training pipelines remain runnable end-to-end.  The images and labels
come from ``np.random.RandomState(seed)`` as in the JAX package, so both
packages' datasets are equal bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeImageNet", "ImageFolder"]


class _SyntheticImageDataset(Dataset):
    NUM_CLASSES = 10
    SHAPE = (1, 28, 28)
    SIZE = 1024

    def __init__(self, mode="train", transform=None, size=None, seed=0,
                 backend="cv2", download=True):
        self.mode = mode
        self.transform = transform
        self.size = size or self.SIZE
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        self.images = rng.rand(self.size, *self.SHAPE).astype(np.float32)
        self.labels = rng.randint(0, self.NUM_CLASSES, self.size).astype(np.int64)

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size


class MNIST(_SyntheticImageDataset):
    NUM_CLASSES = 10
    SHAPE = (1, 28, 28)


class FashionMNIST(_SyntheticImageDataset):
    NUM_CLASSES = 10
    SHAPE = (1, 28, 28)


class Cifar10(_SyntheticImageDataset):
    NUM_CLASSES = 10
    SHAPE = (3, 32, 32)


class Cifar100(_SyntheticImageDataset):
    NUM_CLASSES = 100
    SHAPE = (3, 32, 32)


class FakeImageNet(_SyntheticImageDataset):
    NUM_CLASSES = 1000
    SHAPE = (3, 224, 224)
    SIZE = 256


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, transform=None):
        import os

        self.samples = []
        self.transform = transform
        self.loader = loader or _default_loader
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".npy")):
                    self.samples.append(os.path.join(dirpath, f))

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples)


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32) / 255.0
