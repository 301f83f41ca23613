"""Math op lowerings: mul, elementwise_add, scale, mean, sum.  ``mul`` is a plain
``torch.matmul`` (cuBLAS on the card), as the JAX package left it to XLA
outside any Pallas kernel."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_infer_shape, register_lowering
from .common import bcast_y, in_dtype, in_shape, set_out_shape


@register_lowering("mul")
def _mul(ctx, op):
    """Flatten X to 2-D at x_num_col_dims, Y at y_num_col_dims, then GEMM."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), math.prod(x.shape[xnc:]))
    y2 = y.reshape(math.prod(y.shape[:ync]), math.prod(y.shape[ync:]))
    out = torch.matmul(x2, y2)
    ctx.write_slot(op, "Out", out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


@register_infer_shape("mul")
def _mul_shape(block, op):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    set_out_shape(block, op, "Out", xs[:xnc] + ys[ync:], in_dtype(block, op, "X"))


@register_lowering("elementwise_add")
def _elementwise_add(ctx, op):
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    ctx.write_slot(op, "Out", torch.add(x, bcast_y(x, y, op.attr("axis", -1))))


@register_infer_shape("elementwise_add")
def _elementwise_add_shape(block, op):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    set_out_shape(block, op, "Out", xs if len(xs) >= len(ys) else ys,
                  in_dtype(block, op, "X"))


@register_lowering("scale")
def _scale(ctx, op):
    x = ctx.read_slot(op, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.write_slot(op, "Out", out)


@register_infer_shape("scale")
def _scale_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"),
                  in_dtype(block, op, "X"))


@register_lowering("mean")
def _mean(ctx, op):
    ctx.write_slot(op, "Out", torch.mean(ctx.read_slot(op, "X")))


@register_infer_shape("mean")
def _mean_shape(block, op):
    set_out_shape(block, op, "Out", (), in_dtype(block, op, "X"))


@register_lowering("sum")
def _sum(ctx, op):
    """Multi-input add; ``append_backward`` emits it to merge a gradient
    produced more than once.  (SelectedRows inputs are not ported yet.)"""
    xs = ctx.read_slot_list(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.write_slot(op, "Out", out)


@register_infer_shape("sum")
def _sum_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"),
                  in_dtype(block, op, "X"))
