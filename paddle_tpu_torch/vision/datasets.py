"""Vision datasets — the counterpart of ``paddle_tpu/vision/datasets.py``
(reference: ``python/paddle/vision/datasets/``).

No downloads. ``FakeData`` gives synthetic images at a chosen shape, each
drawn from ``RandomState(idx)`` (the same samples as the JAX package's);
``DatasetFolder`` and ``MNIST`` read local files.
"""
from __future__ import annotations

import os

import numpy as np

from ..io.dataset import Dataset


class FakeData(Dataset):
    """Synthetic dataset with deterministic per-index samples."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=1000,
                 transform=None, dtype=np.float32):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx % 2 ** 31)
        img = rng.standard_normal(self.image_shape).astype(self.dtype)
        label = np.asarray(rng.randint(0, self.num_classes), np.int32)
        if self.transform:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size


class DatasetFolder(Dataset):
    """ImageFolder-style local-directory dataset (requires a local image
    decoder; npy/npz files are supported natively)."""

    def __init__(self, root, loader=None, extensions=(".npy",), transform=None):
        self.root = root
        self.transform = transform
        self.loader = loader or np.load
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(d, f), self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.asarray(label, np.int32)

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


class MNIST(Dataset):
    """MNIST from local idx files (``image_path``/``label_path`` required —
    zero-egress)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if download:
            raise RuntimeError("downloads unavailable (zero-egress environment)")
        if image_path is None or label_path is None:
            raise ValueError("provide local image_path/label_path idx files")
        import gzip
        op = gzip.open if image_path.endswith(".gz") else open
        with op(image_path, "rb") as f:
            f.read(16)
            self.images = np.frombuffer(f.read(), np.uint8).reshape(-1, 28, 28)
        op = gzip.open if label_path.endswith(".gz") else open
        with op(label_path, "rb") as f:
            f.read(8)
            self.labels = np.frombuffer(f.read(), np.uint8)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx][:, :, None]
        if self.transform:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int32)

    def __len__(self):
        return len(self.images)
