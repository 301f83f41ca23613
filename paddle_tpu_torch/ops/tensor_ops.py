"""Tensor creation and shape op lowerings: fill_constant, reshape."""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape


@register_lowering("fill_constant", no_gradient=True)
def _fill_constant(ctx, op):
    dtype = convert_dtype(op.attr("dtype", "float32"))
    ctx.write_slot(op, "Out", torch.full(tuple(op.attr("shape", ())),
                                         op.attr("value", 0.0),
                                         dtype=dtype.torch_dtype,
                                         device=ctx.device))


@register_infer_shape("fill_constant")
def _fill_constant_shape(block, op):
    set_out_shape(block, op, "Out", op.attr("shape", ()),
                  convert_dtype(op.attr("dtype", "float32")))


def _infer_reshape(in_sh, target):
    """Fluid reshape semantics: 0 copies the input dim, -1 is inferred."""
    out = [in_sh[i] if d == 0 else d for i, d in enumerate(target)]
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in in_sh:
            total *= d
        out[out.index(-1)] = total // known if known else -1
    return tuple(out)


@register_lowering("reshape")
def _reshape(ctx, op):
    x = ctx.read_slot(op, "X")
    ctx.write_slot(op, "Out", x.reshape(_infer_reshape(tuple(x.shape), op.attr("shape"))))


@register_infer_shape("reshape")
def _reshape_shape(block, op):
    set_out_shape(block, op, "Out",
                  _infer_reshape(in_shape(block, op, "X"), op.attr("shape")),
                  in_dtype(block, op, "X"))
