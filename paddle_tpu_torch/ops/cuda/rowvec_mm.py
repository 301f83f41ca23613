"""Batched row-vector product: the hand-written Hopper kernel
(csrc/batched_rowvec_mm.cu) and its plain PyTorch version.

``rowvec_mm(x, y)[b, n] = sum_k x[b, k] * y[b, k, n]`` for x [B, K] and
y [B, K, N], float32.  It is the ``matmul`` lowering's route for a batch
of row vectors (M = 1 after the transposes, with batch dims: a decode
step's attention over its cache), and only for that case.  It ports no
TPU kernel: the JAX package leaves this product to XLA.  It exists
because cuBLAS chooses its kernel, and so the order of the sum over K, by
the batch count, so a row's result there depends on the rows beside it.
The kernel sums each output element in one fixed order (k ascending, one
fused multiply-add a step from +0.0), so a row's bits do not depend on B.

A tensor on the CPU goes to the plain version (``torch.bmm``, what the
lowering ran before); a CUDA tensor launches the kernel or raises.
``rowvec_mm.launches`` counts kernel launches.  ``RowvecMM`` is the
product with its gradient (composed of plain PyTorch products), for the
generic grad's re-run of a forward under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ENTRY = build.Entry("ptt_rowvec_mm_f32",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 8 + [ctypes.c_void_p])


def _check(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Validate the arguments; True when they lie on the CPU."""
    if x.ndim != 2 or y.ndim != 3 or y.shape[0] != x.shape[0] or y.shape[1] != x.shape[1]:
        raise ValueError(f"rowvec_mm wants x [B, K] and y [B, K, N], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return True
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"rowvec_mm: tensors on {x.device} and {y.device}; both must be on "
                         f"one CUDA device (or both on the CPU)")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"rowvec_mm kernel takes float32, got {x.dtype} and {y.dtype}")
    return False


def rowvec_mm_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` of [B, 1, K] and [B, K, N]."""
    return torch.bmm(x.unsqueeze(1), y).squeeze(1)


def rowvec_mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [B, K] times y [B, K, N] -> [B, N], each element summed over k in
    ascending order.  Any strides: a transposed y is read as it lies."""
    if _check(x, y):
        return rowvec_mm_plain(x, y)
    (b, k), n = x.shape, y.shape[2]
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    build.launch(_ENTRY, "rowvec_mm", x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                 b, k, n, x.stride(0), x.stride(1), y.stride(0), y.stride(1), y.stride(2))
    rowvec_mm.launches += 1
    return out


rowvec_mm.launches = 0


class RowvecMM(torch.autograd.Function):
    """``rowvec_mm`` with its gradient: dx = g y^T and dy = x^T g per batch
    row, the products ``torch.bmm``'s own gradient takes."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return rowvec_mm(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g3 = g.unsqueeze(1)
        dx = torch.bmm(g3, y.transpose(1, 2)).squeeze(1) if ctx.needs_input_grad[0] else None
        dy = torch.bmm(x.unsqueeze(2), g3) if ctx.needs_input_grad[1] else None
        return dx, dy


def is_rowvec_case(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``matmul(x, y)`` (after the transposes) is a batch of row
    vectors: equal batch dims, M = 1, float32."""
    return (x.ndim >= 3 and x.ndim == y.ndim and x.shape[-2] == 1
            and x.shape[:-2] == y.shape[:-2] and x.shape[-1] == y.shape[-2]
            and x.dtype == torch.float32 and y.dtype == torch.float32)


def batched_rowvec_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``matmul(x, y)`` for ``is_rowvec_case``: [..., 1, K] x [..., K, N]
    -> [..., 1, N] through ``RowvecMM``."""
    batch, k, n = x.shape[:-2], x.shape[-1], y.shape[-1]
    out = RowvecMM.apply(x.reshape(-1, k), y.reshape(-1, k, n))
    return out.reshape(*batch, 1, n)
