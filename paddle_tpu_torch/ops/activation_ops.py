"""Activation op lowerings (the slice needs ``relu``)."""
from __future__ import annotations

import torch

from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape


@register_lowering("relu")
def _relu(ctx, op):
    ctx.write_slot(op, "Out", torch.relu(ctx.read_slot(op, "X")))


@register_infer_shape("relu")
def _relu_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"),
                  in_dtype(block, op, "X"))
