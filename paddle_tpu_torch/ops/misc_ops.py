"""The sparse parameter-server utility ops (the JAX package's
``ops/misc_ops.py``, their part of it): ``split_ids`` hashes ids to
shards, ``merge_ids`` puts the shards' rows back in the ids' order, and
``split_selected_rows`` splits a SelectedRows by row sections.  Static
shapes throughout (padding instead of compaction), as in the JAX
package, so none reads a device value on the host."""
from __future__ import annotations

import torch

from ..core.registry import register_lowering
from ..core.selected_rows import SelectedRows, row_mask


@register_lowering("split_ids", no_gradient=True)
def _split_ids(ctx, op):
    """Out[s] holds the ids with id % n_shards == s, in their order, then
    -1 up to the ids' count; each [T, 1]."""
    ids = ctx.read_slot(op, "Ids").reshape(-1)
    outs = op.output("Out")
    n, t = len(outs), ids.shape[0]
    for s, name in enumerate(outs):
        mask = torch.remainder(ids, n) == s
        order = torch.argsort((~mask).to(torch.int8), stable=True)   # members first
        vals = torch.where(mask[order], ids[order], -1)
        ctx.write(name, vals.reshape(t, 1))


def _occurrence_rank(v):
    """For each element, how many equal elements come before it."""
    eq = v[:, None] == v[None, :]
    return torch.tril(eq, -1).sum(dim=1)


@register_lowering("merge_ids", no_gradient=True)
def _merge_ids(ctx, op):
    """The shards' rows back in the order of Ids: the k-th occurrence of an
    id takes the k-th occurrence in its shard (``split_ids`` keeps the
    order), so each id gets exactly one row."""
    ids = ctx.read_slot(op, "Ids").reshape(-1)
    shard_ids = ctx.read_slot_list(op, "X")
    shard_rows = ctx.read_slot_list(op, "Rows")
    d = shard_rows[0].shape[-1]
    occ = _occurrence_rank(ids)
    out = torch.zeros((ids.shape[0], d), dtype=shard_rows[0].dtype, device=ids.device)
    for sid, rows in zip(shard_ids, shard_rows):
        sid = sid.reshape(-1)
        rows = rows.reshape(sid.shape[0], d)
        match = ((ids[:, None] == sid[None, :])
                 & (occ[:, None] == _occurrence_rank(sid)[None, :])
                 & (sid[None, :] >= 0))
        out = out + match.to(rows.dtype) @ rows
    ctx.write_slot(op, "Out", out)


@register_lowering("split_selected_rows", no_gradient=True)
def _split_selected_rows(ctx, op):
    """Output s keeps the rows whose id falls in its section of
    ``height_sections``, ids rebased to the section (the others padded to
    the section's height, their rows zero)."""
    x = ctx.read_slot(op, "X")
    if not isinstance(x, SelectedRows):
        raise TypeError("split_selected_rows input must be SelectedRows")
    sections = [int(s) for s in op.attr("height_sections")]
    lo = 0
    for sec, name in zip(sections, op.output("Out")):
        in_sec = (x.ids >= lo) & (x.ids < lo + sec)
        ids = torch.where(in_sec, x.ids - lo, sec)
        rows = torch.where(row_mask(in_sec, x.rows), x.rows, 0.0)
        ctx.write(name, SelectedRows(ids, rows, sec))
        lo += sec
