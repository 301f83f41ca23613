"""MNIST readers: ``train()`` / ``test()`` yield (784 float32 pixels in
[-1, 1], int label) from the JAX package's synthetic digit generator: each
class a fixed random prototype, each sample its prototype plus noise."""
from __future__ import annotations

import numpy as np


def _synthetic(n: int, seed: int):
    """(images [n, 784] float32, labels [n] int64)."""
    rng = np.random.RandomState(1234)
    prototypes = rng.rand(10, 784).astype(np.float32) * 2 - 1
    rng2 = np.random.RandomState(seed)
    labels = rng2.randint(0, 10, n)
    noise = rng2.randn(n, 784).astype(np.float32) * 0.3
    images = prototypes[labels] + noise
    return np.clip(images, -1, 1), labels.astype(np.int64)


def _reader_creator(n_synth, seed):
    def reader():
        images, labels = _synthetic(n_synth, seed)
        for i in range(n_synth):
            yield images[i], int(labels[i])

    return reader


def train():
    return _reader_creator(n_synth=8192, seed=0)


def test():
    return _reader_creator(n_synth=1024, seed=1)
