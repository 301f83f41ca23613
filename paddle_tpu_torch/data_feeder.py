"""DataFeeder: minibatch (list of tuples) -> feed dict of numpy arrays
(Fluid's python/paddle/fluid/data_feeder.py:83), ported from the JAX
package: the same arrays in the same dtypes (int64 stays int64 here; the
executor narrows it), the same padding and the same ``@SEQ_LEN`` channels.
LoD raggedness is handled by padding to static shapes.

Recompilation control: every distinct padded length is a distinct cache
entry of the executor (on the card, a CUDA graph with a memory pool of its
own), so padding to the *batch max* captures O(# distinct lengths) times
over a ragged epoch.  Opt in with ``seq_len_buckets="pow2"`` (or a
boundary list) to pad the time dim up to a bucket boundary instead, so an
epoch builds at most one entry per bucket (assert via
``Executor.compile_count``).  Sequence masking comes from the @SEQ_LEN
side channel, which still carries the TRUE lengths, so SEQ_LEN-aware ops
are unaffected; it is opt-in (default exact padding) because consumers
that ignore @SEQ_LEN see the longer pad.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from .core.framework import Program, Variable, default_main_program

Buckets = Union[None, str, Sequence[int]]


def bucketed_len(n: int, buckets: Buckets) -> int:
    """Smallest bucket boundary >= n.  ``buckets``: None (exact), "pow2"
    (next power of two), or a sorted iterable of boundaries (lengths past
    the largest bucket pad to the exact length)."""
    if buckets is None or n <= 0:
        return n
    if buckets == "pow2":
        m = 1
        while m < n:
            m <<= 1
        return m
    for b in sorted(int(b) for b in buckets):
        if b >= n:
            return b
    return n


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None,
                 seq_len_buckets: Buckets = None):
        program = program or default_main_program()
        self.feed_vars: List[Variable] = []
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block.var(v)
            self.feed_vars.append(v)
        self.place = place
        self.seq_len_buckets = seq_len_buckets
        if seq_len_buckets is not None:
            # stamp the bucketing on the feed VarDescs, as the JAX package
            # does for its verifier's recompile-hazard lint; scrubbed from
            # the fingerprint (desc.NONSEMANTIC_VAR_ATTRS), so cache keys
            # don't change
            for v in self.feed_vars:
                if v.lod_level > 0:
                    v.desc.attrs["seq_len_buckets"] = (
                        seq_len_buckets if isinstance(seq_len_buckets, str)
                        else list(seq_len_buckets))

    def feed(self, iterable) -> dict:
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            cols = [row[i] for row in rows]
            if var.lod_level >= 2:
                # nested LoD (Fluid's lod_tensor.h:110 multi-level): pad
                # each level, emit one @SEQ_LEN@k channel per level; the
                # ragged axes honor seq_len_buckets like the level-1 path
                # (channels keep true lengths, so masking is unaffected)
                from .lod import from_nested, seq_len_name
                padded, lens = from_nested(cols, var.lod_level,
                                           dtype=var.dtype.np_dtype)
                pad_width = [(0, 0)] * padded.ndim
                for ax in range(1, var.lod_level + 1):
                    want = bucketed_len(padded.shape[ax],
                                        self.seq_len_buckets)
                    pad_width[ax] = (0, want - padded.shape[ax])
                if any(p[1] for p in pad_width):
                    padded = np.pad(padded, pad_width)
                out[var.name] = padded
                for level, l in enumerate(lens):
                    out[seq_len_name(var.name, level)] = l
                continue
            arr = self._stack(cols, var)
            if isinstance(arr, tuple):        # ragged: (padded, lengths)
                arr, lens = arr
                from .core.lower import SEQ_LEN_SUFFIX
                out[var.name + SEQ_LEN_SUFFIX] = lens
            out[var.name] = arr
        return out

    def _stack(self, cols, var):
        dtype = var.dtype.np_dtype
        first = cols[0] if cols else None
        if (isinstance(first, np.ndarray) and first.dtype == dtype
                and all(isinstance(c, np.ndarray) and c.dtype == dtype
                        and c.shape == first.shape for c in cols[1:])):
            # fast path: rows are already correctly-typed same-shape
            # ndarrays — skip the per-element conversion pass entirely
            # (dtype+shape keyed; the common case for dataset readers
            # that yield preprocessed float32/int arrays)
            from .core.staging import COUNTERS
            COUNTERS.inc("feed_fastpath_hits")
            arrs = list(cols)
        else:
            arrs = [np.asarray(c, dtype=dtype) for c in cols]
        want_rank = len(var.shape)
        # ragged sequences (lod_level>0): pad to the bucketed batch max
        # length + true lengths in the side channel
        if var.lod_level > 0:
            # coerce each sequence to (len,) + declared feature dims
            tail = tuple(d for d in var.shape[2:] if d != -1) or None
            if tail:
                arrs = [a.reshape((a.shape[0],) + tail) if a.ndim == 1 or
                        a.shape[1:] != tail else a for a in arrs]
            maxlen = bucketed_len(max(a.shape[0] for a in arrs),
                                  self.seq_len_buckets)
            lens = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
            padded = []
            for a in arrs:
                pad = [(0, maxlen - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                padded.append(np.pad(a, pad))
            return np.stack(padded), lens
        out = np.stack(arrs)
        # Fluid reshapes flat features to the declared shape, e.g. (784,)
        tail = tuple(d for d in var.shape[1:])
        if tail and -1 not in tail and out.shape[1:] != tail:
            out = out.reshape((out.shape[0],) + tail)
        if out.ndim < want_rank and want_rank == out.ndim + 1:
            out = out[..., None]  # labels (N,) -> (N,1) like LoDTensor feeds
        return out
