"""UCI housing readers: ``train()`` / ``test()`` yield (13 float32
features, [1] float32 price) from the JAX package's synthetic generator:
a fixed linear ground truth (seed 42) plus 3.0 and noise.  The download of
the real data is not ported."""
from __future__ import annotations

import numpy as np

FEATURE_NUM = 13


def _synthetic(n, seed):
    """(x [n, 13] float32, y [n, 1] float32)."""
    rng = np.random.RandomState(42)
    w = rng.randn(FEATURE_NUM, 1).astype(np.float32)
    rng2 = np.random.RandomState(seed)
    x = rng2.randn(n, FEATURE_NUM).astype(np.float32)
    y = x @ w + 3.0 + 0.1 * rng2.randn(n, 1).astype(np.float32)
    return x, y


def _creator(n_synth, seed):
    def reader():
        x, y = _synthetic(n_synth, seed)
        for i in range(len(x)):
            yield x[i], y[i]

    return reader


def train():
    return _creator(n_synth=404, seed=0)


def test():
    return _creator(n_synth=102, seed=1)
