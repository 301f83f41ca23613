"""Dataset helpers of the JAX package's ``dataset/common.py`` without its
``download``: where a dataset file would be cached, and its md5."""
from __future__ import annotations

import hashlib
import os

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def cache_path(module: str, filename: str) -> str:
    """The cached file's path (nothing is created)."""
    return os.path.join(DATA_HOME, module, filename)


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
