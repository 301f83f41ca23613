"""Embedding row gather: the hand-written Hopper kernel
(csrc/embedding_gather.cu) and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/embedding.py::
_gather_kernel``.  ``gather_rows(w, ids)[n] = w[ids[n]]``, and an id
outside [0, V) gives a zero row (the Pallas kernel's semantics).

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``gather_rows.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]


def gather_rows_plain(w: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """``index_select`` plus the zero mask for out-of-range ids."""
    valid = (flat_ids >= 0) & (flat_ids < w.shape[0])
    rows = w.index_select(0, torch.where(valid, flat_ids, 0).long())
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=w.dtype, device=w.device))


def gather_rows(w: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``w`` [V, D] at ``flat_ids`` [N] int32 -> [N, D]."""
    if w.ndim != 2 or flat_ids.ndim != 1:
        raise ValueError(f"gather_rows wants w [V, D] and ids [N], got "
                         f"{tuple(w.shape)} and {tuple(flat_ids.shape)}")
    if flat_ids.dtype != torch.int32:
        raise TypeError(f"gather_rows wants int32 ids, got {flat_ids.dtype}")
    if w.device.type == "cpu" and flat_ids.device.type == "cpu":
        return gather_rows_plain(w, flat_ids)
    if w.device.type != "cuda" or flat_ids.device != w.device:
        raise ValueError(f"gather_rows: w on {w.device}, ids on {flat_ids.device}; "
                         f"both must be on one CUDA device (or both on the CPU)")
    if w.dtype != torch.float32:
        raise TypeError(f"gather_rows kernel takes float32 tables, got {w.dtype}")
    if not (w.is_contiguous() and flat_ids.is_contiguous()):
        raise ValueError("gather_rows kernel needs contiguous w and ids")
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
