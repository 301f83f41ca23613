"""WMT14 fr->en machine-translation readers with the JAX package's
schema: (src_ids, trg_ids, trg_next_ids) with a dict per side, and a
``gen`` split for generation; the synthetic corpus of ``wmt16``."""
from __future__ import annotations

from . import wmt16


def get_dict(dict_size: int, reverse: bool = False):
    src = wmt16.get_dict("fr", dict_size, reverse)
    trg = wmt16.get_dict("en", dict_size, reverse)
    return src, trg


def train(dict_size: int):
    return wmt16._pair_reader(2000, dict_size, dict_size, seed=10)


def test(dict_size: int):
    return wmt16._pair_reader(200, dict_size, dict_size, seed=11)


def gen(dict_size: int):
    return wmt16._pair_reader(100, dict_size, dict_size, seed=12)


def fetch():
    return None
