"""Embedding row gather and scatter-add: the hand-written Hopper kernels
(csrc/embedding_gather.cu, csrc/embedding_scatter_add.cu) and their plain
PyTorch versions.

Replace the TPU kernels ``paddle_tpu/ops/pallas/embedding.py::
_gather_kernel`` and ``::_scatter_add_kernel``.
``gather_rows(w, ids)[n] = w[ids[n]]``, and an id outside [0, V) gives a
zero row; ``scatter_add_rows(w, ids, rows)`` is a zero [V, D] table with
``rows[n]`` added at row ``ids[n]`` (duplicates summed) and an id outside
[0, V) adding nothing -- the Pallas kernels' one-hot semantics.
``GatherRows`` is the gather with the scatter-add as its gradient.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]


def _check(name, w, flat_ids, rows=None) -> bool:
    """Validate the arguments; True when they lie on the CPU."""
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
    if w.dtype != torch.float32 or (rows is not None and rows.dtype != torch.float32):
        raise TypeError(f"{name} kernel takes float32 tables and rows")
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
    out = torch.empty((n, d), dtype=w.dtype, device=w.device)
    if n == 0 or d == 0:
        return out
    fn = build.kernel("ptt_gather_rows_f32", _ARGTYPES)
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), flat_ids.data_ptr(), out.data_ptr(), n, v, d,
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_add_rows_plain(w: torch.Tensor, flat_ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """``index_add_`` into zeros, out-of-range ids masked to add nothing
    (``zeros.at[ids].add`` in the JAX package's composed path would wrap
    -1 onto the last row instead)."""
    valid = (flat_ids >= 0) & (flat_ids < w.shape[0])
    out = torch.zeros(w.shape, dtype=w.dtype, device=w.device)
    masked = torch.where(valid[:, None], rows.to(w.dtype),
                         torch.zeros((), dtype=w.dtype, device=w.device))
    return out.index_add_(0, torch.where(valid, flat_ids, 0).long(), masked)


def scatter_add_rows(w: torch.Tensor, flat_ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Dense [V, D] gradient of a gather: zeros with ``rows`` [N, D] added
    at ``flat_ids`` [N] int32.  ``w`` gives the shape, type and device; its
    values are not read.  The kernel sums duplicates with float atomics,
    so the order of the additions, and the last bits, vary run to run."""
    if _check("scatter_add_rows", w, flat_ids, rows):
        return scatter_add_rows_plain(w, flat_ids, rows)
    n, (v, d) = flat_ids.shape[0], w.shape
    out = torch.empty((v, d), dtype=w.dtype, device=w.device)
    if v == 0 or d == 0:
        return out
    fn = build.kernel("ptt_scatter_add_rows_f32", _ARGTYPES)
    with torch.cuda.device(w.device):
        rc = fn(flat_ids.data_ptr(), rows.data_ptr(), out.data_ptr(), n, v, d,
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


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
