"""Embedding row gather and scatter-add: the hand-written Hopper kernels
(csrc/embedding_gather.cu, csrc/embedding_scatter_add.cu) and their plain
PyTorch versions.

Replace the TPU kernels ``paddle_tpu/ops/pallas/embedding.py::
_gather_kernel`` and ``::_scatter_add_kernel``.
``gather_rows(w, ids)[n] = w[ids[n]]``, and an id outside [0, V) gives a
zero row; ``scatter_add_rows(w, ids, rows)`` is a zero [V, D] table with
``rows[n]`` added at row ``ids[n]`` (duplicates summed) and an id outside
[0, V) adding nothing -- the Pallas kernels' one-hot semantics.  The
scatter-add also takes a bf16 table and rows (the ``amp-bf16`` pass casts
the word table for its gradient): each output row is summed in float32 and
rounded once to bf16, as the Pallas kernel's float32 one-hot product is
written in the table's dtype.
``GatherRows`` is the gather with the scatter-add as its gradient.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches, and
``scatter_add_rows.bf16_launches`` those of the bf16 instance among them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
_GATHER = build.Entry("ptt_gather_rows_f32", _ARGTYPES)
_SCATTER_ARGTYPES = _ARGTYPES[:3] + [ctypes.c_void_p] + _ARGTYPES[3:]
_SCATTER_ADD = {torch.float32: build.Entry("ptt_scatter_add_rows_f32", _SCATTER_ARGTYPES),
                torch.bfloat16: build.Entry("ptt_scatter_add_rows_bf16", _SCATTER_ARGTYPES)}
_SORT_TILE = 512    # ids a tile of the scatter-add's radix sort
_LONG = 32          # a longer segment of one id goes to the scatter-add's long blocks


def _scratch_ints(n: int, v: int) -> int:
    """int32 scratch of the scatter-add kernel for ``n`` ids into ``v``
    rows: two key and two index arrays, the digit histogram of every sort
    tile, the counts of valid ids and of long segments, the ``v + 1`` row
    offsets, and the list of long segments (each holds more than ``_LONG``
    ids)."""
    return 4 * n + 256 * -(-n // _SORT_TILE) + 2 + (v + 1) + n // (_LONG + 1)


def _check(name, w, flat_ids, rows=None) -> bool:
    """Validate the arguments; True when they lie on the CPU.  What the
    kernel takes passes on a few attribute reads; everything else goes
    through the checks below, one by one."""
    dev = w.device
    if (dev.type == "cuda" and flat_ids.device == dev and flat_ids.dtype is torch.int32
            and w.ndim == 2 and flat_ids.ndim == 1
            and w.is_contiguous() and flat_ids.is_contiguous()
            and (w.dtype is torch.float32 if rows is None else
                 (w.dtype in _SCATTER_ADD and rows.dtype is w.dtype and rows.device == dev
                  and rows.is_contiguous() and rows.ndim == 2
                  and rows.shape[0] == flat_ids.shape[0] and rows.shape[1] == w.shape[1]))):
        return False
    if w.ndim != 2 or flat_ids.ndim != 1:
        raise ValueError(f"{name} wants w [V, D] and ids [N], got "
                         f"{tuple(w.shape)} and {tuple(flat_ids.shape)}")
    if flat_ids.dtype != torch.int32:
        raise TypeError(f"{name} wants int32 ids, got {flat_ids.dtype}")
    tensors = [w, flat_ids] + ([rows] if rows is not None else [])
    if rows is not None and tuple(rows.shape) != (flat_ids.shape[0], w.shape[1]):
        raise ValueError(f"{name} wants rows [N, D] = {(flat_ids.shape[0], w.shape[1])}, "
                         f"got {tuple(rows.shape)}")
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if w.device.type != "cuda" or any(t.device != w.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}; "
                         f"all must be on one CUDA device (or all on the CPU)")
    if rows is None and w.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes a float32 table")
    if rows is not None and (w.dtype not in _SCATTER_ADD or rows.dtype != w.dtype):
        raise TypeError(f"{name} kernel takes a float32 or bf16 table and rows of its "
                        f"dtype, got {w.dtype} and {rows.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    return False


def gather_rows_plain(w: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """``index_select`` plus the zero mask for out-of-range ids."""
    valid = (flat_ids >= 0) & (flat_ids < w.shape[0])
    rows = w.index_select(0, torch.where(valid, flat_ids, 0).long())
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=w.dtype, device=w.device))


def gather_rows(w: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``w`` [V, D] at ``flat_ids`` [N] int32 -> [N, D]."""
    if _check("gather_rows", w, flat_ids):
        return gather_rows_plain(w, flat_ids)
    n, (v, d) = flat_ids.shape[0], w.shape
    out = w.new_empty((n, d))
    if n == 0 or d == 0:
        return out
    build.launch(_GATHER, "gather_rows", w.device,
                 w.data_ptr(), flat_ids.data_ptr(), out.data_ptr(), n, v, d)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_add_rows_plain(w: torch.Tensor, flat_ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """``index_add_`` into zeros, out-of-range ids masked to add nothing
    (``zeros.at[ids].add`` in the JAX package's composed path would wrap
    -1 onto the last row instead).  On the CPU ``index_add_`` adds in
    ascending n, the kernel's order (a masked id adds +0.0, which changes
    no sum that starts from +0.0); on the card it adds by atomics, so the
    kernel is held against this version run on a CPU copy.  The sums are
    float32 (float64 for a float64 table) and a bf16 table's output is
    rounded once at the end: adding in bf16 would round at every add."""
    acc = torch.promote_types(w.dtype, torch.float32)
    valid = (flat_ids >= 0) & (flat_ids < w.shape[0])
    out = torch.zeros(w.shape, dtype=acc, device=w.device)
    masked = torch.where(valid[:, None], rows.to(w.dtype).to(acc),
                         torch.zeros((), dtype=acc, device=w.device))
    return out.index_add_(0, torch.where(valid, flat_ids, 0).long(), masked).to(w.dtype)


def scatter_add_rows(w: torch.Tensor, flat_ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Dense [V, D] gradient of a gather: zeros with ``rows`` [N, D] added
    at ``flat_ids`` [N] int32.  ``w`` gives the shape, type and device; its
    values are not read.  Each output row is the sum of its rows in
    ascending n from +0.0 in float32, on the CPU (``index_add_``) and in the
    kernel (a stable radix sort of the ids, each row's offsets, then ordered
    segment sums; a long segment a column slice a block), and
    written in ``w``'s dtype (float32 or bf16), so the kernel is bit-equal
    to the plain version run on the CPU."""
    if _check("scatter_add_rows", w, flat_ids, rows):
        return scatter_add_rows_plain(w, flat_ids, rows)
    n, (v, d) = flat_ids.shape[0], w.shape
    if n >= 2 ** 31 or v >= 2 ** 31 - 1:
        raise ValueError("scatter_add_rows kernel takes fewer than 2**31 ids and 2**31 - 1 rows")
    out = torch.empty((v, d), dtype=w.dtype, device=w.device)
    if v == 0 or d == 0:
        return out
    scratch = torch.empty((_scratch_ints(n, v),), dtype=torch.int32, device=w.device)
    build.launch(_SCATTER_ADD[w.dtype], "scatter_add_rows", w.device,
                 flat_ids.data_ptr(), rows.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 n, v, d)
    scatter_add_rows.launches += 1
    if w.dtype == torch.bfloat16:
        scatter_add_rows.bf16_launches += 1
    return out


scatter_add_rows.launches = 0
scatter_add_rows.bf16_launches = 0


class GatherRows(torch.autograd.Function):
    """``gather_rows`` with ``scatter_add_rows`` as its gradient."""

    @staticmethod
    def forward(ctx, w, flat_ids):
        ctx.save_for_backward(w, flat_ids)
        return gather_rows(w, flat_ids)

    @staticmethod
    def backward(ctx, grad_out):
        w, flat_ids = ctx.saved_tensors
        return scatter_add_rows(w, flat_ids, grad_out.contiguous()), None
