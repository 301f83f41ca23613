"""int8 matmul: the hand-written Hopper int8 GEMM (csrc/int8_matmul.cu) and
its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/int8_matmul.py::
_mm_kernel`` (launched by ``_mm_pallas`` from ``int8_matmul``).  The
``pallas_int8_matmul`` op of an ``amp-quant-int8`` + ``pallas-kernels``
program runs ``int8_matmul(x, y, bits)``: both operands are quantized with
the abs-max expression of the JAX package (``s = max(max|x|, 1e-8)``,
``q = round(clip(x, -s, s) * (bin_cnt / s))``, round half to even), the
kernel multiplies the int8 values into an exact int32 accumulator, and
the result is ``acc.float() * ((s_x * s_y) / (bin_cnt * bin_cnt))``, the
combined scale of ``fake_dequantize_max_abs``.  The scales stay device
scalars: no host sync.

Because int32 accumulation is exact, the result is bit-equal to the
composed fake-quant path (float32 GEMM over the quantized values) whenever
every float32 partial sum of that path stays below 2**24.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``int8_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

EPS = 1e-8  # fake_quantize_abs_max's scale floor, kept identical

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def bin_count(bits: int) -> float:
    return float((1 << (int(bits) - 1)) - 1)


def quantize_abs_max(x: torch.Tensor, bin_cnt: float):
    """(quantized values, still float, in [-bin_cnt, bin_cnt]; the abs-max
    scale as a 0-d device tensor): the expression of the composed
    ``fake_quantize_abs_max`` lowering."""
    s = torch.clamp_min(torch.linalg.vector_norm(x, float("inf")), EPS)
    q = torch.clamp(x, -s, s).mul_(bin_cnt / s).round_()
    return q, s


def _dequant(acc: torch.Tensor, sx, sy, bin_cnt: float) -> torch.Tensor:
    return acc.to(torch.float32).mul_((sx * sy) / (bin_cnt * bin_cnt))


def int8_mm_plain(xq: torch.Tensor, yqt: torch.Tensor) -> torch.Tensor:
    """``xq @ yqt.T`` exactly, as int32: int64 products on the CPU, float64
    on the card (exact below 2**53; torch has no CUDA integer matmul)."""
    wide = torch.int64 if xq.device.type == "cpu" else torch.float64
    return torch.matmul(xq.to(wide), yqt.to(wide).t()).to(torch.int32)


def int8_mm(xq: torch.Tensor, yqt: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] times int8 [N, K] transposed -> int32 [M, N]: the
    kernel on CUDA tensors, ``int8_mm_plain`` on CPU tensors."""
    if xq.ndim != 2 or yqt.ndim != 2 or xq.shape[1] != yqt.shape[1]:
        raise ValueError(f"int8_mm wants xq [M, K] and yqt [N, K], got "
                         f"{tuple(xq.shape)} and {tuple(yqt.shape)}")
    if xq.dtype != torch.int8 or yqt.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {xq.dtype}, {yqt.dtype}")
    if xq.device.type == "cpu" and yqt.device.type == "cpu":
        return int8_mm_plain(xq, yqt)
    if xq.device.type != "cuda" or yqt.device != xq.device:
        raise ValueError(f"int8_mm: operands on {xq.device} and {yqt.device}; "
                         f"both must be on one CUDA device (or both on the CPU)")
    if not (xq.is_contiguous() and yqt.is_contiguous()):
        raise ValueError("int8_mm kernel needs contiguous operands")
    (m, k), n = xq.shape, yqt.shape[0]
    if max(m, n, k) >= 2 ** 31 or m > 65535 * 128:
        raise ValueError(f"int8_mm kernel: shape ({m}, {k}) x ({k}, {n}) too large")
    # every product is at most 127 * 127 in magnitude: an int32 sum of K of
    # them cannot overflow below K = 2**31 / 127**2 ~ 133,000
    if k * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int8_mm kernel: K = {k} could overflow the int32 accumulator")
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    if m == 0 or n == 0:
        return out
    fn = build.kernel("ptt_int8_gemm", _ARGTYPES)
    with torch.cuda.device(xq.device):
        rc = fn(xq.data_ptr(), yqt.data_ptr(), out.data_ptr(), m, n, k,
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "int8_mm")
    int8_matmul.launches += 1
    return out


def int8_matmul_plain(x: torch.Tensor, y: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The JAX package's ``int8_matmul`` (its exact integer path) on any
    device: quantize, exact integer product, dequantize.  x [M, K], y [K, N]."""
    bin_cnt = bin_count(bits)
    xq, sx = quantize_abs_max(x.to(torch.float32), bin_cnt)
    yq, sy = quantize_abs_max(y.to(torch.float32), bin_cnt)
    wide = torch.int64 if x.device.type == "cpu" else torch.float64
    acc = torch.matmul(xq.to(wide), yq.to(wide)).to(torch.int32)
    return _dequant(acc, sx, sy, bin_cnt)


def int8_matmul(x: torch.Tensor, y: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``x @ y`` through abs-max int8 quantization of both operands; x
    [M, K], y [K, N] float32 in, float32 out."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"int8_matmul wants x [M, K] and y [K, N], got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return int8_matmul_plain(x, y, bits)
    if not 2 <= int(bits) <= 8:
        raise ValueError(f"int8_matmul kernel takes bit_length 2..8, got {bits}")
    bin_cnt = bin_count(bits)
    xq, sx = quantize_abs_max(x.to(torch.float32), bin_cnt)
    yq, sy = quantize_abs_max(y.to(torch.float32), bin_cnt)
    acc = int8_mm(xq.to(torch.int8), yq.to(torch.int8).t().contiguous())
    return _dequant(acc, sx, sy, bin_cnt)


int8_matmul.launches = 0
