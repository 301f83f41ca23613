"""Metric op lowerings (``accuracy``); they have no gradient."""
from __future__ import annotations

import torch

from ..core.dtypes import DataType
from ..core.registry import register_infer_shape, register_lowering
from .common import set_out_shape


@register_lowering("accuracy", no_gradient=True)
def _accuracy(ctx, op):
    """The share of rows whose top-k ``Indices`` hold the row's label:
    Accuracy (float32), Correct and Total (int32 scalars)."""
    indices = ctx.read_slot(op, "Indices")
    label = ctx.read_slot(op, "Label")
    if not (label.ndim == 2 and label.shape[-1] == 1):
        label = label[..., None]
    correct = (indices.to(torch.int32) == label.to(torch.int32)).any(-1)
    num_correct = correct.to(torch.float32).sum()
    total = correct.shape[0]
    ctx.write_slot(op, "Accuracy", num_correct / total)
    ctx.write_slot(op, "Correct", num_correct.to(torch.int32))
    # a fill, not a host copy: the op may run inside a CUDA graph's capture
    ctx.write_slot(op, "Total", torch.full((), total, dtype=torch.int32, device=correct.device))


@register_infer_shape("accuracy")
def _accuracy_shape(block, op):
    set_out_shape(block, op, "Accuracy", (), DataType.FP32)
    set_out_shape(block, op, "Correct", (), DataType.INT32)
    set_out_shape(block, op, "Total", (), DataType.INT32)
