"""Unique name generator: ``key_0``, ``key_1``, ...  Building a model under
``guard()`` in both packages gives its variables the same names."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(prefix: str = ""):
    global generator
    old = generator
    generator = UniqueNameGenerator(prefix)
    try:
        yield
    finally:
        generator = old
