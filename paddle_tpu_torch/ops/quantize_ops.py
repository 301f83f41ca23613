"""Quantization ops: ``fake_quantize_abs_max``,
``fake_quantize_range_abs_max`` and ``fake_dequantize_max_abs``, the
simulated-int8 path that the ``amp-quant-int8`` pass writes (and that runs
with ``kernels=False``) and quantization-aware training's quantizer, with
their straight-through gradient ``fake_quantize_ste_grad``.

Ports of the JAX package's lowerings (``paddle_tpu/ops/quantize_ops.py``)::

    bin_cnt    = 2^(bit_length-1) - 1
    abs_max:    OutScale = max(|X|);  Out = round(clip(X, -s, s) * (bin_cnt / s)),
                s = max(OutScale, 1e-8)
    range_abs_max: OutScale = the largest max(|X|) of the last window_size
                steps (the window a persistable buffer, its slot Iter %
                window_size, Iter a persistable counter), or InScale with
                is_test;  Out as abs_max's with that scale
    dequantize: Out = X * (Scale / max_range)
    ste_grad:   dX = dOut * (bin_cnt / s) where |X| <= s, else 0

in the form the JAX ``Executor`` computes them under ``jax.jit``:
``bin_cnt / s`` is one float32 division, and ``Scale / max_range`` (a
constant divisor) is ``Scale * float32(1 / max_range)`` -- the helpers of
ops/cuda/int8_matmul.py, which the int8 GEMM's epilogue shares.

"Fake": the quantized values stay in float storage.  Rounding is half to
even (``torch.round``, as ``jnp.round``).  The range quantizer's window
write and its scale stay on the device (no host read), so a training
step's CUDA graph advances them on every replay.
"""
from __future__ import annotations

import torch

from ..core.desc import OpDesc, grad_var_name
from ..core.dtypes import DataType
from ..core.registry import register_grad_maker, register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape
from .cuda.int8_matmul import EPS, quantize_ratio, quantize_with_scale, scale_by_reciprocal


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


@register_lowering("fake_quantize_range_abs_max")
def _fake_quantize_range_abs_max(ctx, op):
    """InScale / OutScale, InScales / OutScales and Iter / IterOut name the
    same persistable vars: the state advances a step each run.  The window
    is written at ``Iter % window_size`` through a device-side select, and
    its largest entry over the first ``min(Iter + 1, window_size)`` slots
    is the scale."""
    x = ctx.read_slot(op, "X")
    in_scale = ctx.read_slot(op, "InScale").reshape(())
    bin_cnt = _bin_cnt(op)
    if op.attr("is_test", False):
        out_scale = in_scale
    else:
        it, scales = ctx.read_slot(op, "Iter"), ctx.read_slot(op, "InScales")
        if scales is None or it is None:
            raise ValueError(
                "fake_quantize_range_abs_max requires InScales and Iter state inputs in "
                "train mode (use layers.fake_quantize_range_abs_max, which wires them)")
        window = int(op.attr("window_size", 10000))
        cur = torch.linalg.vector_norm(x, float("inf")).to(x.dtype)
        it = it.reshape(()).to(torch.int32)
        slots = torch.arange(window, device=x.device, dtype=torch.int32)
        scales = torch.where(slots == torch.remainder(it, window), cur, scales.reshape(-1))
        n_valid = torch.clamp_max(it + 1, window)
        out_scale = torch.where(slots < n_valid, scales, 0.0).amax().to(x.dtype)
        ctx.write_slot(op, "OutScales", scales)
        ctx.write_slot(op, "IterOut", (it + 1).to(torch.int32))
    ctx.write_slot(op, "Out", quantize_with_scale(x, torch.clamp_min(out_scale, EPS), bin_cnt))
    ctx.write_slot(op, "OutScale", out_scale.reshape(1))


@register_infer_shape("fake_quantize_range_abs_max")
def _fq_range_shape(block, op):
    dt = in_dtype(block, op, "X")
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), dt)
    set_out_shape(block, op, "OutScale", (1,), dt)
    if op.output("OutScales"):
        set_out_shape(block, op, "OutScales", (int(op.attr("window_size", 10000)),), dt)
    if op.output("IterOut"):
        set_out_shape(block, op, "IterOut", (), DataType.INT32)


def _ste_grad_maker(op, block, no_grad_set):
    """One ``fake_quantize_ste_grad`` op reading X, OutScale and Out's grad."""
    xname = op.input("X")[0]
    if xname in no_grad_set:
        return []
    g = OpDesc(type="fake_quantize_ste_grad", attrs=dict(op.attrs))
    g.inputs["X"] = list(op.input("X"))
    g.inputs["OutScale"] = list(op.output("OutScale"))
    g.inputs["OutGrad"] = [grad_var_name(n) for n in op.output("Out")]
    g.outputs["X@GRAD"] = [grad_var_name(xname)]
    return [g]


register_grad_maker("fake_quantize_abs_max")(_ste_grad_maker)
register_grad_maker("fake_quantize_range_abs_max")(_ste_grad_maker)


@register_lowering("fake_quantize_ste_grad")
def _fake_quantize_ste_grad(ctx, op):
    """The straight-through estimator of ``round``: dX = dOut * (bin_cnt /
    s) inside the clip range |X| <= s, 0 outside (s = max(OutScale,
    1e-8)), so a quantize-dequantize pair has the identity's gradient."""
    x = ctx.read_slot(op, "X")
    scale = torch.clamp_min(ctx.read_slot(op, "OutScale").reshape(()), EPS)
    dout = ctx.read_slot(op, "OutGrad")
    dx = torch.where(x.abs() <= scale, dout * quantize_ratio(scale, _bin_cnt(op)),
                     torch.zeros_like(dout))
    ctx.write(op.outputs["X@GRAD"][0], dx)


@register_infer_shape("fake_quantize_ste_grad")
def _ste_grad_shape(block, op):
    names = op.outputs.get("X@GRAD", [])
    if names and names[0]:
        vd = block.find_var(names[0])
        src = block.find_var(op.input("X")[0])
        if vd is not None and src is not None:
            vd.shape = src.shape
            vd.dtype = src.dtype
