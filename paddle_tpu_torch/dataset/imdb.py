"""IMDB sentiment readers with the JAX package's schema: each sample is
(word-id list, 0/1 label), from its synthetic generator: class-correlated
token sequences of 8-63 words over a fixed vocabulary (positive reviews
skew to low ids, negative ones to high ids)."""
from __future__ import annotations

import numpy as np


def word_dict(vocab_size: int = 5148):
    return {f"w{i}": i for i in range(vocab_size)}


def _synthetic(n, vocab_size, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 64))
        if label == 1:
            ids = rng.zipf(1.3, length) % (vocab_size // 2)
        else:
            ids = vocab_size // 2 + (rng.zipf(1.3, length) % (vocab_size // 2))
        yield [int(i) for i in ids], label


def train(word_idx=None):
    vocab = len(word_idx) if word_idx else 5148

    def reader():
        yield from _synthetic(2048, vocab, seed=0)

    return reader


def test(word_idx=None):
    vocab = len(word_idx) if word_idx else 5148

    def reader():
        yield from _synthetic(256, vocab, seed=1)

    return reader
