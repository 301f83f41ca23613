"""SelectedRows: the sparse-gradient value (the JAX package's
``core/selected_rows.py``).

A (ids, rows, height) triple carrying only the embedding rows a batch
touched: int32 ids ``[K]`` (K = the batch's id count, duplicates
included), rows ``[K, D...]`` and the table's row count ``height``.  The
shapes are static, so a step that makes and consumes one can be recorded
in a CUDA graph: :meth:`SelectedRows.merged` deduplicates with a sort, a
head mask, a prefix sum and scatters (``torch.unique`` returns a
data-dependent size, which the host would have to read), and
keeps the JAX package's layout: the unique ids ascending, padded to K
with ``height`` (a row past the table's edge, which the sparse updates
drop), each unique id's rows summed into its slot.

The segment sum adds each slot's rows in float64 and rounds once: the
rows go into their sorted order, a float64 prefix sum runs along them (a
parallel scan), and a slot's sum is the difference of the prefix at its
last row and at the last row of the slot before it, plus the same
difference of a second prefix sum over what the first one rounded away
at each row.  It is deterministic (a replay of a recorded step is
bit-equal to an op-by-op step) and its work does not grow with a hot
id's count; ``index_add_`` on the card adds by atomics in no fixed order,
and ``index_put_(accumulate=True)`` adds a slot's rows one after another
in one warp, so a hot id of a skewed batch (a thousand copies of one id)
makes a long serial chain.  A slot's sum is off by a few 2**-53 of its
own rows' magnitudes plus about K * 2**-106 of the running prefix: within
float32 rounding of the exact sum while the rows before it in a column
sum to less than ~2**82 / K times it (a single prefix difference holds
that only to ~2**29).  The sparse updates and :meth:`SelectedRows.to_dense`
write merged rows, one a unique id.
"""
from __future__ import annotations

import torch


class SelectedRows:
    """ids: int32 [K] row indices (may repeat); rows: [K, D...] values;
    height: the full table's row count."""

    def __init__(self, ids: torch.Tensor, rows: torch.Tensor, height: int):
        self.ids = ids
        self.rows = rows
        self.height = int(height)
        self._merged = False

    @property
    def dtype(self) -> torch.dtype:
        return self.rows.dtype

    @property
    def shape(self) -> tuple:
        """The dense shape it stands for: ``[height, D...]``."""
        return (self.height,) + tuple(self.rows.shape[1:])

    def _like(self, ids: torch.Tensor, rows: torch.Tensor) -> "SelectedRows":
        """New rows over these ids (merged if these were)."""
        out = SelectedRows(ids, rows, self.height)
        out._merged = self._merged
        return out

    def astype(self, dtype: torch.dtype) -> "SelectedRows":
        return self._like(self.ids, self.rows.to(dtype))

    to = astype      # the ``cast`` lowering's spelling

    def clone(self) -> "SelectedRows":
        return self._like(self.ids.clone(), self.rows.clone())

    def merged(self) -> "SelectedRows":
        """An equal SelectedRows with duplicate ids summed: the unique ids
        ascending, padded to K with ``height``, each one's rows summed into
        its slot (the JAX package's ``jnp.unique(size=K,
        fill_value=height)`` + ``segment_sum``; the sum in float64,
        rounded once).  What this returns is merged already and returns
        itself (a sparse update merges the gradient its source merged)."""
        if self._merged:
            return self
        ids = self.ids
        k = ids.shape[0]
        if k == 0:
            return SelectedRows(ids, self.rows, self.height)
        dev = ids.device
        srt, order = torch.sort(ids, stable=True)
        head = torch.ones(k, dtype=torch.bool, device=dev)
        head[1:] = srt[1:] != srt[:-1]
        tail = torch.ones(k, dtype=torch.bool, device=dev)
        tail[:-1] = head[1:]
        slot = torch.cumsum(head, 0) - 1
        # a run's head writes its id into its slot and its tail its sorted
        # position; every other member writes into a place of its own past
        # K: no two writes meet (a hot id's run would queue on one address)
        pos = torch.arange(k, device=dev)
        uniq = torch.full((2 * k,), self.height, dtype=ids.dtype, device=dev)
        uniq.scatter_(0, torch.where(head, slot, k + pos), srt)
        # the unused slots keep the last position: their difference below is 0
        last = torch.full((2 * k,), k - 1, dtype=torch.int64, device=dev)
        last.scatter_(0, torch.where(tail, slot, k + pos), pos)
        uniq, last = uniq[:k], last[:k]
        x = self.rows.reshape(k, -1)[order].to(torch.float64).t().contiguous()
        prefix = x.cumsum(1)
        # what the scan rounded away at each row: x_j - (p_j - p_{j-1}),
        # of the order of 2**-53 of the running prefix; a slot's sum is its
        # prefix difference plus its rows' share of these, so the earlier
        # slots' magnitude does not reach it (the prefix differences
        # telescope exactly over the reals)
        lost = (x - torch.diff(prefix, dim=1, prepend=torch.zeros_like(prefix[:, :1]))).cumsum(1)
        ends = torch.stack([prefix, lost])[:, :, last]
        parts = torch.cat([ends[:, :, :1], ends[:, :, 1:] - ends[:, :, :-1]], 2)
        rows = (parts[0] + parts[1]).t().to(self.rows.dtype).reshape(self.rows.shape)
        out = SelectedRows(uniq, rows, self.height)
        out._merged = True
        return out

    def to_dense(self) -> torch.Tensor:
        """The rows summed into a zero ``[height, D...]`` tensor, ids
        outside [0, height) dropped (the JAX package's ``mode="drop"``)."""
        dense = torch.zeros(self.shape, dtype=self.rows.dtype, device=self.rows.device)
        m = self.merged()
        at, valid, (old,) = update_slots(m, dense)
        dense.index_put_((at,), settle(m.rows, old, valid))
        return dense

    def __repr__(self):
        return (f"SelectedRows(k={self.ids.shape[0]}, height={self.height}, "
                f"row_shape={tuple(self.rows.shape[1:])})")


def concat_rows(a: SelectedRows, b: SelectedRows) -> SelectedRows:
    """Two sparse gradients of one table accumulated (``sum`` over
    SelectedRows): concatenated; duplicates stay, the updates merge."""
    if a.height != b.height:
        raise ValueError(f"SelectedRows height mismatch {a.height} vs {b.height}")
    return SelectedRows(torch.cat([a.ids, b.ids]), torch.cat([a.rows, b.rows]), a.height)


def shard_rows(sr: SelectedRows, row_offset: int, local_rows: int) -> SelectedRows:
    """The part of a whole table's gradient ``sr`` that lands in one
    rank's row shard ``[row_offset, row_offset + local_rows)``: merged over
    the whole batch first (so each row's sum is the single-device one),
    then the slots in the shard shifted by ``-row_offset`` and moved to the
    front in their ascending order, the others padded with
    ``local_rows``, the shard's height, and zero rows (as :meth:`merged`
    pads: a sum over every rank's rows counts each row once); merged, so
    the sparse updates run on the rank's own rows and slots as a single
    device runs on its table."""
    m = sr.merged()
    local = m.ids - row_offset
    keep = (local >= 0) & (local < local_rows)
    order = torch.sort(torch.logical_not(keep).to(torch.int32), stable=True).indices
    ids = torch.where(keep, local, local_rows).to(m.ids.dtype)[order]
    rows = torch.where(row_mask(keep, m.rows), m.rows, 0.0)[order]
    out = SelectedRows(ids, rows, local_rows)
    out._merged = True
    return out


def update_slots(sr: SelectedRows, *tables: torch.Tensor):
    """Where a merged SelectedRows' rows live in ``tables`` (tensors of
    ``height`` rows): ``(at, valid, gathered)`` -- int64 indices, the
    slots that hold a real row (a padded slot holds ``height``), and each
    table's rows at ``at``.  A padded slot points at slot 0's row, so a
    write of every slot with :func:`settle` stays in the table and writes
    that row's value twice, which is no race."""
    valid = (sr.ids >= 0) & (sr.ids < sr.height)
    at = torch.where(valid, sr.ids, sr.ids[:1].clamp(0, sr.height - 1)).long()
    return at, valid, [t[at] for t in tables]


def row_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [K] mask shaped to broadcast over ``like``'s [K, D...] rows."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def settle(new: torch.Tensor, old: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The rows a sparse update writes: ``new`` where the slot is real;
    in a padded slot, what slot 0 writes (its new row, or its old one
    where slot 0 is padded too, and nothing changes)."""
    first = torch.where(row_mask(valid[:1], new), new[:1], old[:1])
    return torch.where(row_mask(valid, new), new, first)
