"""Embedding-subsystem ops (the JAX package's ``ops/embedding_ops.py``):
in-graph id dedup and a row gather.

* ``row_prefetch``: Ids -> the batch's unique ids ascending, padded to
  the static id count K with ``height`` (the padding
  :meth:`~paddle_tpu_torch.core.selected_rows.SelectedRows.merged` uses),
  plus the count of live (< height) unique ids.  A sort, a head mask and
  a prefix sum: nothing is read on the host, so it records into a graph.
* ``gather_rows``: (W, Ids) -> the [K, D] rows at a prefetched id set;
  an id outside [0, height) (``row_prefetch``'s padding) gives a zero
  row.  Plain PyTorch, as the JAX package's ``jnp.take(mode="fill")``
  is XLA's (not K2's wrapper of the same name in ops/cuda/embedding.py).

The shape rules are copied in ops/shape_infer.py for the standalone
loaders.
"""
from __future__ import annotations

import torch

from ..core.registry import mark_no_gradient, register_infer_shape, register_lowering
from ..core.selected_rows import SelectedRows, row_mask
from .common import in_dtype, in_shape, set_out_shape


def _flat_k(ids_shape):
    """Static id count K of a flattened Ids tensor (a trailing 1 squeezed:
    the lookup_table ids convention)."""
    shape = tuple(ids_shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    k = 1
    for d in shape:
        k *= int(d)
    return k


@register_lowering("row_prefetch", no_gradient=True)
def _row_prefetch(ctx, op):
    """Out = unique(Ids) padded to K with attr ``height``; UniqueCount =
    [1] int32 count of the live (< height) unique ids."""
    height = int(op.attr("height"))
    flat = ctx.read_slot(op, "Ids").reshape(-1).to(torch.int32)
    uniq = SelectedRows(flat, torch.zeros((flat.shape[0], 0), device=flat.device),
                        height).merged().ids
    ctx.write_slot(op, "Out", uniq)
    if (op.outputs.get("UniqueCount") or [""])[0]:
        ctx.write_slot(op, "UniqueCount",
                       (uniq < height).sum(dtype=torch.int32).reshape(1))


@register_infer_shape("row_prefetch")
def _row_prefetch_shape(block, op):
    k = _flat_k(in_shape(block, op, "Ids"))
    set_out_shape(block, op, "Out", (k,), "int32")
    if op.outputs.get("UniqueCount"):
        set_out_shape(block, op, "UniqueCount", (1,), "int32")


@register_lowering("gather_rows", no_gradient=True)
def _gather_rows(ctx, op):
    """Out[k] = W[Ids[k]]; an id outside [0, height) gathers a zero row."""
    w = ctx.read_slot(op, "W")
    flat = ctx.read_slot(op, "Ids").reshape(-1)
    valid = (flat >= 0) & (flat < w.shape[0])
    rows = w[torch.where(valid, flat, 0).long()]
    ctx.write_slot(op, "Out", torch.where(row_mask(valid, rows), rows, 0.0))


@register_infer_shape("gather_rows")
def _gather_rows_shape(block, op):
    ws = in_shape(block, op, "W")
    k = _flat_k(in_shape(block, op, "Ids"))
    set_out_shape(block, op, "Out", (k,) + tuple(ws[1:]), in_dtype(block, op, "W"))


mark_no_gradient("row_prefetch", "gather_rows")
