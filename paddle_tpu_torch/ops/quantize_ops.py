"""Quantization ops: ``fake_quantize_abs_max`` and
``fake_dequantize_max_abs``, the simulated-int8 path that the
``amp-quant-int8`` pass writes (and that runs with ``kernels=False``).

Ports of the JAX package's lowerings (``paddle_tpu/ops/quantize_ops.py``)::

    bin_cnt    = 2^(bit_length-1) - 1
    abs_max:    OutScale = max(|X|);  Out = round(clip(X, -s, s) * (bin_cnt / s)),
                s = max(OutScale, 1e-8)
    dequantize: Out = X * (Scale / max_range)

in the form the JAX ``Executor`` computes them under ``jax.jit``:
``bin_cnt / s`` is one float32 division, and ``Scale / max_range`` (a
constant divisor) is ``Scale * float32(1 / max_range)`` -- the helpers of
ops/cuda/int8_matmul.py, which the int8 GEMM's epilogue shares.

"Fake": the quantized values stay in float storage.  Rounding is half to
even (``torch.round``, as ``jnp.round``).  Only the ``amp-quant-int8`` pass
writes these ops, into inference programs.  Not ported yet:
``fake_quantize_range_abs_max`` and the straight-through gradients
(quantization-aware training).
"""
from __future__ import annotations

import torch

from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape
from .cuda.int8_matmul import EPS, quantize_with_scale, scale_by_reciprocal


def _bin_cnt(op) -> float:
    bits = int(op.attr("bit_length", 8))
    if not 1 <= bits <= 16:
        raise ValueError(f"bit_length must be in [1,16], got {bits}")
    return float((1 << (bits - 1)) - 1)


@register_lowering("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, op):
    x = ctx.read_slot(op, "X")
    scale = torch.linalg.vector_norm(x, float("inf")).reshape(1).to(x.dtype)
    s = torch.clamp_min(scale[0], EPS)
    ctx.write_slot(op, "Out", quantize_with_scale(x, s, _bin_cnt(op)))
    ctx.write_slot(op, "OutScale", scale)


@register_infer_shape("fake_quantize_abs_max")
def _fq_abs_max_shape(block, op):
    dt = in_dtype(block, op, "X")
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), dt)
    set_out_shape(block, op, "OutScale", (1,), dt)


@register_lowering("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, op):
    x = ctx.read_slot(op, "X")
    scale = ctx.read_slot(op, "Scale").reshape(())
    ctx.write_slot(op, "Out", x * scale_by_reciprocal(scale, float(op.attr("max_range"))))


@register_infer_shape("fake_dequantize_max_abs")
def _fdq_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))
