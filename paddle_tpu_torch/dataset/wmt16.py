"""WMT16 en<->de machine-translation readers with the JAX package's
schema: (src_ids, trg_ids, trg_next_ids) triples with <s>/<e>/<unk>
framing and per-language dicts of configurable size, from its synthetic
parallel corpus: the "translation" of a source sentence is an affine
token remap and a reversal, so a seq2seq model can learn the mapping.
Only the synthetic branch exists; nothing is downloaded."""
from __future__ import annotations

import numpy as np

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"


def _dict(dict_size: int, lang: str):
    d = {START_MARK: 0, END_MARK: 1, UNK_MARK: 2}
    for i in range(3, dict_size):
        d[f"{lang}{i}"] = i
    return d


def get_dict(lang: str, dict_size: int, reverse: bool = False):
    """The word -> id dict of ``lang`` (id -> word with ``reverse``)."""
    d = _dict(dict_size, lang)
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def _pair_reader(n_pairs: int, src_dict_size: int, trg_dict_size: int,
                 seed: int, min_len: int = 4, max_len: int = 12):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_pairs):
            n = int(rng.randint(min_len, max_len + 1))
            src = rng.randint(3, src_dict_size, size=n).tolist()
            # deterministic "translation": affine remap into the trg vocab,
            # reversed word order (so attention has something to learn)
            trg = [3 + ((7 * t + 13) % (trg_dict_size - 3))
                   for t in reversed(src)]
            src_ids = [0] + src + [1]
            trg_ids = [0] + trg
            trg_next = trg + [1]
            yield src_ids, trg_ids, trg_next

    return reader


def train(src_dict_size: int, trg_dict_size: int, src_lang: str = "en"):
    return _pair_reader(2000, src_dict_size, trg_dict_size, seed=0)


def test(src_dict_size: int, trg_dict_size: int, src_lang: str = "en"):
    return _pair_reader(200, src_dict_size, trg_dict_size, seed=1)


def validation(src_dict_size: int, trg_dict_size: int, src_lang: str = "en"):
    return _pair_reader(200, src_dict_size, trg_dict_size, seed=2)


def fetch():
    """Nothing to download: the corpus is synthetic."""
    return None
