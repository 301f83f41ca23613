"""Movie-review sentiment readers with the JAX package's schema: each
sample is (word-id sequence, 0/1 label), from its deterministic synthetic
corpus: 8-40 words a review, 75 % of them from the label's half of a
600-word vocabulary (ids 0-299 lean negative, 300-599 positive) and the
rest from the other half, so a bag-of-words or convolutional classifier
learns it."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "get_word_dict"]

_VOCAB = 600
_HALF = _VOCAB // 2


def get_word_dict():
    """word -> id, most frequent first."""
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n_samples: int, seed: int):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            label = int(rng.randint(0, 2))
            ln = int(rng.randint(8, 41))
            dominant = rng.randint(label * _HALF, (label + 1) * _HALF, size=ln)
            noise = rng.randint((1 - label) * _HALF, (2 - label) * _HALF, size=ln)
            pick = rng.rand(ln) < 0.75
            yield np.where(pick, dominant, noise).tolist(), label

    return reader


def train(n_samples: int = 1600):
    """Reader of (word-id sequence, label) training pairs."""
    return _reader(n_samples, seed=30)


def test(n_samples: int = 400):
    return _reader(n_samples, seed=31)
