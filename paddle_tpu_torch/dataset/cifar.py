"""CIFAR-10/100 readers: each yields (3072 float32 values in [0, 1], int
label) from the JAX package's synthetic generator: each class a fixed
random prototype, each sample its prototype plus noise, clipped."""
from __future__ import annotations

import numpy as np


def _synthetic(n, num_classes, seed):
    """(images [n, 3072] float32, labels [n] int64)."""
    rng = np.random.RandomState(777)
    prototypes = rng.rand(num_classes, 3072).astype(np.float32)
    rng2 = np.random.RandomState(seed)
    labels = rng2.randint(0, num_classes, n)
    images = np.clip(prototypes[labels]
                     + 0.2 * rng2.randn(n, 3072).astype(np.float32), 0, 1)
    return images, labels.astype(np.int64)


def _reader(num_classes, n_synth, seed):
    def reader():
        images, labels = _synthetic(n_synth, num_classes, seed)
        for i in range(n_synth):
            yield images[i], int(labels[i])

    return reader


def train10():
    return _reader(10, 4096, 0)


def test10():
    return _reader(10, 512, 1)


def train100():
    return _reader(100, 4096, 2)


def test100():
    return _reader(100, 512, 3)
