"""Multi-level LoD: nested ragged data as padded dense arrays + per-level
length side channels.

Reference: framework/lod_tensor.h:110 — a LoDTensor carries an arbitrary
nesting of offset tables (level 0 outermost); beam_search_decode_op.cc
emits 2-level output (hypotheses per source, tokens per hypothesis).

Static-shape encoding of a lod_level=k value named ``x``:
  * dense array padded to ``[N, S1, ..., Sk, *features]``;
  * ``x@SEQ_LEN``          int32 ``[N]``              level-1 lengths;
  * ``x@SEQ_LEN@1``        int32 ``[N, S1]``          level-2 lengths;
  * ``x@SEQ_LEN@j``        int32 ``[N, S1, .., Sj]``  level-(j+1) lengths.
Padding rows/steps beyond a length are zero and masked by consumers; the
channels travel through DataFeeder feeds, op lowerings and fetches like
any other array.  ``to_nested``/``from_nested`` are the exact round-trip
between this encoding and Python nested lists.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .core.lower import SEQ_LEN_SUFFIX


def seq_len_name(name: str, level: int = 0) -> str:
    """Side-channel name for the lengths of nesting ``level`` (0-based:
    level 0 = outermost = plain @SEQ_LEN)."""
    return name + SEQ_LEN_SUFFIX + ("" if level == 0 else f"@{level}")


def from_nested(rows: Sequence, lod_level: int, dtype=np.float32
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Nested python lists -> (padded array, [level-1 lens, level-2 lens,
    ...]).

    ``rows`` is the batch (length N, NOT itself a LoD level) with
    ``lod_level`` levels of ragged nesting above the feature items:
    lod_level=1 -> each row is a sequence ([T] items or [T, ...features]);
    lod_level=2 -> each row is a list of sequences.  Returns the
    zero-padded dense array ``[N, S1, ..., Sk, *features]`` and one int32
    lengths array per level (shapes [N], [N, S1], ...).
    """
    if lod_level < 1:
        raise ValueError("from_nested needs lod_level >= 1")
    rows = list(rows)
    n = len(rows)

    def dims_of(node, level):
        """[ragged dims...] + [feature dims...] of one level-``level``
        node (max over children)."""
        if level == 0:
            return list(np.asarray(node, dtype=dtype).shape)
        sub = None
        for child in node:
            d = dims_of(child, level - 1)
            if sub is None:
                sub = d
            else:
                if len(d) < len(sub):          # e.g. an empty sub-list
                    d = d + [0] * (len(sub) - len(d))
                elif len(d) > len(sub):
                    sub = sub + [0] * (len(d) - len(sub))
                sub = [max(a, b) for a, b in zip(sub, d)]
        return [len(node)] + (sub if sub is not None else [])

    per_row = [dims_of(r, lod_level) for r in rows]
    width = max(len(d) for d in per_row)
    per_row = [d + [0] * (width - len(d)) for d in per_row]
    maxes = [max(d[k] for d in per_row) for k in range(width)]
    padded = np.zeros([n] + maxes, dtype=dtype)
    lens: List[np.ndarray] = [
        np.zeros([n] + maxes[:k], dtype=np.int32) for k in range(lod_level)]

    def fill(node, level, index):
        if level == 0:
            arr = np.asarray(node, dtype=dtype)
            padded[index + tuple(slice(0, d) for d in arr.shape)] = arr
            return
        lens[lod_level - level][index] = len(node)
        for j, child in enumerate(node):
            fill(child, level - 1, index + (j,))

    for i, row in enumerate(rows):
        fill(row, lod_level, (i,))
    return padded, lens


def to_nested(padded: np.ndarray, level_lens: Sequence[np.ndarray]) -> list:
    """(padded array, [level lengths...]) -> nested python lists; the
    inverse of :func:`from_nested` (innermost sequences come back as numpy
    arrays trimmed to their true length)."""
    padded = np.asarray(padded)
    level_lens = [np.asarray(l) for l in level_lens]
    k = len(level_lens)

    def build(index):
        depth = len(index)                     # levels consumed so far
        count = int(level_lens[depth - 1][index])
        if depth == k:
            return padded[index][:count]
        return [build(index + (j,)) for j in range(count)]

    return [build((i,)) for i in range(padded.shape[0])]
