"""int8 matmul: the hand-written Hopper kernels of the int8 path
(csrc/int8_matmul.cu) and their plain PyTorch versions.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/int8_matmul.py::
_mm_kernel`` (launched by ``_mm_pallas`` from ``int8_matmul``) together
with the abs-max quantizers and the dequant that XLA fuses around it there.
The ``pallas_int8_matmul`` op of an ``amp-quant-int8`` + ``pallas-kernels``
program runs ``int8_matmul(x, y, bits)``, on the card four launches and a
memset:

* ``abs_max_pair`` -- ``max|x|`` and ``max|y|`` in one reduction;
* ``quantize_int8`` twice -- ``q = round(clip(v, -s, s) * (bin_cnt / s))``
  with ``s = max(max|v|, 1e-8)``, rounding half to even, written as int8
  rows padded with zeros to a multiple of 16 bytes; the weight [K, N] is
  written transposed, [N, Kp];
* ``int8_mm`` -- the exact int8 x int8 -> int32 GEMM (``wgmma`` fed by
  TMA) whose epilogue writes ``float(acc) * ((s_x * s_y) * r)`` in float32,
  ``r = float32(1 / bin_cnt**2)``: the combined scale of
  ``fake_dequantize_max_abs``.

The expressions are the JAX package's as its ``Executor`` runs them under
``jax.jit``: ``bin_cnt / s`` is one float32 division, and XLA folds a
division by the constant ``bin_cnt**2`` (or ``max_range``) into a product
with its float32 reciprocal.  ``quantize_ratio`` and ``scale_by_reciprocal``
hold those two forms for the plain versions, the simulated fake-quant ops
(ops/quantize_ops.py) and the kernels alike.  The scales stay on the
device: no host sync.

Because int32 accumulation is exact, the result is bit-equal to the
composed fake-quant path (float32 GEMM over the quantized values) whenever
every float32 partial sum of that path stays below 2**24.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``int8_matmul.launches`` counts GEMM launches,
``abs_max_pair.launches`` and ``quantize_int8.launches`` the quantizers'.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build

EPS = 1e-8  # fake_quantize_abs_max's scale floor, kept identical
K_ALIGN = 16  # int8 rows are padded with zeros to a multiple of 16 bytes (TMA)

_ABSMAX_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p]
_QUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
_GEMM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                  ctypes.c_void_p]
_ABSMAX = build.Entry("ptt_int8_absmax2", _ABSMAX_ARGTYPES)
_QUANT = build.Entry("ptt_int8_quantize", _QUANT_ARGTYPES)
_GEMM = build.Entry("ptt_int8_gemm", _GEMM_ARGTYPES)


def bin_count(bits: int) -> float:
    return float((1 << (int(bits) - 1)) - 1)


def padded_k(k: int) -> int:
    return -(-int(k) // K_ALIGN) * K_ALIGN


@functools.lru_cache(maxsize=None)
def reciprocal_f32(divisor: float) -> float:
    """``float32(1 / divisor)``, rounded once: the constant XLA multiplies
    by where the JAX package divides by a constant."""
    return float(np.float32(1.0) / np.float32(divisor))


def scale_by_reciprocal(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as XLA computes it under ``jit``: ``t * float32(1 /
    divisor)``.  No division runs, so no device picks its own route."""
    return t * reciprocal_f32(divisor)


def combined_scale(sx: torch.Tensor, sy: torch.Tensor, bin_cnt: float) -> torch.Tensor:
    """The dequant scale ``(s_x * s_y) / bin_cnt**2`` of the JAX package's
    ``int8_matmul``, in XLA's form ``(s_x * s_y) * float32(1 / bin_cnt**2)``;
    the GEMM's float32 epilogue computes the same two products."""
    return scale_by_reciprocal(sx * sy, bin_cnt * bin_cnt)


def quantize_ratio(s: torch.Tensor, bin_cnt: float) -> torch.Tensor:
    """``bin_cnt / s`` as one float32 division, tensor by tensor (a Python
    float over a tensor would be ``s.reciprocal() * bin_cnt``: two roundings)."""
    return torch.full_like(s, bin_cnt) / s


def quantize_with_scale(x: torch.Tensor, s: torch.Tensor, bin_cnt: float) -> torch.Tensor:
    """``round(clip(x, -s, s) * (bin_cnt / s))``, half to even, still float."""
    return torch.clamp(x, -s, s).mul_(quantize_ratio(s, bin_cnt)).round_()


def quantize_abs_max(x: torch.Tensor, bin_cnt: float):
    """(quantized values, still float, in [-bin_cnt, bin_cnt]; the abs-max
    scale as a 0-d device tensor): the expression of the composed
    ``fake_quantize_abs_max`` lowering."""
    s = torch.clamp_min(torch.linalg.vector_norm(x, float("inf")), EPS)
    return quantize_with_scale(x, s, bin_cnt), s


def _on_cpu(what: str, *ts) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie
    on one CUDA device, contiguous.  One pass over the tensors: this runs
    four times an int8 product."""
    dev = ts[0].device
    same = True
    for t in ts:
        same = same and t.device == dev
    if same and dev.type == "cpu":
        return True
    if not same or dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}; all must be on "
                         f"one CUDA device (or all on the CPU)")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous tensors")
    return False


# ------------------------------------------------------------ the quantizers


def abs_max_pair_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[max|x|, max|y|] float32 (raw: the 1e-8 floor is applied by the
    consumers), NaN kept."""
    return torch.stack([x.abs().amax(), y.abs().amax()]).to(torch.float32)


def abs_max_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Both operands' abs-max in one launch: float32 [2]."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"abs_max_pair takes float32, got {x.dtype}, {y.dtype}")
    if x.numel() == 0 or y.numel() == 0:
        raise ValueError("abs_max_pair: an empty operand has no abs-max")
    if _on_cpu("abs_max_pair", x, y):
        return abs_max_pair_plain(x, y)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    build.launch(_ABSMAX, "abs_max_pair", x.device,
                 x.data_ptr(), x.numel(), y.data_ptr(), y.numel(), out.data_ptr())
    abs_max_pair.launches += 1
    return out


abs_max_pair.launches = 0


def quantize_int8_plain(v: torch.Tensor, scales: torch.Tensor, idx: int, bin_cnt: float,
                        transpose: bool = False) -> torch.Tensor:
    """``v`` [R, C] float32 quantized with ``s = max(scales[idx], 1e-8)``,
    as int8 [R, pad16(C)] (or, ``transpose``, [C, pad16(R)]), zero-padded."""
    s = torch.clamp_min(scales[idx], EPS)
    q = quantize_with_scale(v.to(torch.float32), s, bin_cnt).to(torch.int8)
    if transpose:
        q = q.t()
    return F.pad(q, (0, padded_k(q.shape[1]) - q.shape[1])).contiguous()


def quantize_int8(v: torch.Tensor, scales: torch.Tensor, idx: int, bin_cnt: float,
                  transpose: bool = False) -> torch.Tensor:
    """``quantize_int8_plain`` as one kernel: reads the scale on the
    device, writes int8 rows padded to 16 bytes (transposed through a
    shared-memory tile when ``transpose``)."""
    if v.ndim != 2 or v.dtype != torch.float32:
        raise ValueError(f"quantize_int8 takes float32 [R, C], got {v.dtype} {tuple(v.shape)}")
    if not 0 < bin_cnt <= 127:
        raise ValueError(f"quantize_int8: bin_cnt {bin_cnt} does not fit int8")
    if _on_cpu("quantize_int8", v, scales):
        return quantize_int8_plain(v, scales, idx, bin_cnt, transpose)
    rows, cols = v.shape
    out_rows, kp = (cols, padded_k(rows)) if transpose else (rows, padded_k(cols))
    if max(rows, cols, kp) >= 2 ** 31 or (transpose and cols > 65535 * 64):
        raise ValueError(f"quantize_int8 kernel: shape {tuple(v.shape)} too large")
    out = torch.empty((out_rows, kp), dtype=torch.int8, device=v.device)
    if v.numel() == 0:
        return out.zero_()
    build.launch(_QUANT, "quantize_int8", v.device,
                 v.data_ptr(), rows, cols, kp, scales.data_ptr() + 4 * idx, float(bin_cnt),
                 int(transpose), out.data_ptr())
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0


# ----------------------------------------------------------------- the GEMM


def _wide(dev):
    # exact below 2**53; torch has no CUDA integer matmul
    return torch.int64 if dev.type == "cpu" else torch.float64


def int8_mm_plain(xq: torch.Tensor, yqt: torch.Tensor, scales=None, bin_cnt=None):
    """``xq @ yqt.T`` exactly, as int32; with ``scales`` ([s_x, s_y] raw
    abs-max) and ``bin_cnt``, dequantized to float32 as the kernel's
    float32 epilogue does."""
    wide = _wide(xq.device)
    acc = torch.matmul(xq.to(wide), yqt.to(wide).t()).to(torch.int32)
    if scales is None:
        return acc
    s = torch.clamp_min(scales, EPS)
    return acc.to(torch.float32).mul_(combined_scale(s[0], s[1], bin_cnt))


def int8_mm(xq: torch.Tensor, yqt: torch.Tensor, scales=None, bin_cnt=None) -> torch.Tensor:
    """int8 [M, K] times int8 [N, K] transposed: int32 [M, N], or with
    ``scales`` and ``bin_cnt`` float32 through the dequant epilogue.  The
    kernel on CUDA tensors, ``int8_mm_plain`` on CPU tensors.  K is padded
    with zeros to a multiple of 16 bytes here when it is not already."""
    if xq.ndim != 2 or yqt.ndim != 2 or xq.shape[1] != yqt.shape[1]:
        raise ValueError(f"int8_mm wants xq [M, K] and yqt [N, K], got "
                         f"{tuple(xq.shape)} and {tuple(yqt.shape)}")
    if xq.dtype != torch.int8 or yqt.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {xq.dtype}, {yqt.dtype}")
    if (scales is None) != (bin_cnt is None):
        raise ValueError("int8_mm: pass scales and bin_cnt together (or neither)")
    if _on_cpu("int8_mm", xq, yqt) if scales is None else _on_cpu("int8_mm", xq, yqt, scales):
        return int8_mm_plain(xq, yqt, scales, bin_cnt)
    (m, k), n = xq.shape, yqt.shape[0]
    kp = padded_k(k)
    if max(m, n, kp) >= 2 ** 31 or -(-m // 128) * -(-n // 128) >= 2 ** 31:
        raise ValueError(f"int8_mm kernel: shape ({m}, {k}) x ({k}, {n}) too large")
    # every product is at most 127 * 127 in magnitude: an int32 sum of K of
    # them cannot overflow below K = 2**31 / 127**2 ~ 133,000
    if kp * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int8_mm kernel: K = {k} could overflow the int32 accumulator")
    out = torch.empty((m, n), dtype=torch.int32 if scales is None else torch.float32,
                      device=xq.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    # TMA reads rows whose byte stride and base are multiples of 16
    xq, yqt = (F.pad(t, (0, kp - k)) if kp != k or t.data_ptr() % 16 else t for t in (xq, yqt))
    build.launch(_GEMM, "int8_mm", xq.device,
                 xq.data_ptr(), yqt.data_ptr(), out.data_ptr(), m, n, kp,
                 scales.data_ptr() if scales is not None else None,
                 reciprocal_f32(bin_cnt * bin_cnt) if scales is not None else 0.0)
    int8_matmul.launches += 1
    return out


# --------------------------------------------------------- the whole product


def int8_matmul_plain(x: torch.Tensor, y: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The JAX package's ``int8_matmul`` (its exact integer path) on any
    device: quantize, exact integer product, dequantize.  x [..., M, K], y
    [..., K, N] (batch dims broadcast; each operand quantized whole, one
    scale each: the batched ``matmul`` form)."""
    bin_cnt = bin_count(bits)
    xq, sx = quantize_abs_max(x.to(torch.float32), bin_cnt)
    yq, sy = quantize_abs_max(y.to(torch.float32), bin_cnt)
    wide = _wide(x.device)
    acc = torch.matmul(xq.to(wide), yq.to(wide)).to(torch.int32)
    return acc.to(torch.float32).mul_(combined_scale(sx, sy, bin_cnt))


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
    x, y = (t.to(torch.float32).contiguous() for t in (x, y))
    if x.numel() == 0 or y.numel() == 0:
        return torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32, device=x.device)
    scales = abs_max_pair(x, y)
    xq = quantize_int8(x, scales, 0, bin_cnt)
    yqt = quantize_int8(y, scales, 1, bin_cnt, transpose=True)
    return int8_mm(xq, yqt, scales, bin_cnt)


int8_matmul.launches = 0
