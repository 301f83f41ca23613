"""NN op lowerings: layer_norm, dropout and lookup_table.  ``lookup_table``
gathers through the hand-written embedding kernels (ops/cuda/embedding.py):
the gather forward, and the scatter-add as the gather's gradient."""
from __future__ import annotations

import torch

from ..core.desc import OpDesc, grad_var_name
from ..core.registry import (register_grad_maker, register_infer_shape,
                             register_lowering)
from .common import in_dtype, in_shape, set_out_shape
from .cuda.embedding import GatherRows


@register_lowering("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.read_slot(op, "X")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    scale = ctx.read_slot(op, "Scale")
    bias = ctx.read_slot(op, "Bias")
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape((1,) * begin + norm_shape)
    if bias is not None:
        y = y + bias.reshape((1,) * begin + norm_shape)
    ctx.write_slot(op, "Y", y)
    ctx.write_slot(op, "Mean", mean.reshape(x.shape[:begin]))
    ctx.write_slot(op, "Variance", var.reshape(x.shape[:begin]))


@register_infer_shape("layer_norm")
def _layer_norm_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Y", xs, in_dtype(block, op, "X"))
    begin = op.attr("begin_norm_axis", 1)
    set_out_shape(block, op, "Mean", xs[:begin])
    set_out_shape(block, op, "Variance", xs[:begin])


@register_lowering("dropout")
def _dropout(ctx, op):
    x = ctx.read_slot(op, "X")
    prob = op.attr("dropout_prob", 0.5)
    if op.attr("is_test", False) or prob == 0.0:
        ctx.write_slot(op, "Out", x)
        ctx.write_slot(op, "Mask", torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.generator, device=x.device) >= prob
    if op.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - prob), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    ctx.write_slot(op, "Mask", keep.to(x.dtype))
    ctx.write_slot(op, "Out", out)


@register_infer_shape("dropout")
def _dropout_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", xs, in_dtype(block, op, "X"))
    set_out_shape(block, op, "Mask", xs, in_dtype(block, op, "X"))


@register_grad_maker("dropout")
def _dropout_grad_maker(op, block, no_grad_set):
    """The gradient reads the forward's saved Mask: re-running the forward
    would draw a different mask."""
    xname = op.input("X")[0]
    if xname in no_grad_set:
        return []
    g = OpDesc(type="dropout_grad", attrs=dict(op.attrs))
    g.inputs["Mask"] = list(op.output("Mask"))
    g.inputs["OutGrad"] = [grad_var_name(n) for n in op.output("Out")]
    g.outputs["XGrad"] = [grad_var_name(xname)]
    return [g]


@register_lowering("dropout_grad")
def _dropout_grad(ctx, op):
    mask = ctx.read_slot(op, "Mask")
    dy = ctx.read_slot(op, "OutGrad")
    prob = op.attr("dropout_prob", 0.5)
    if op.attr("is_test", False):
        ctx.write_slot(op, "XGrad", dy)
    elif op.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train":
        ctx.write_slot(op, "XGrad", dy * mask / (1.0 - prob))
    else:
        ctx.write_slot(op, "XGrad", dy * mask)


@register_lowering("lookup_table", non_diff_inputs=("Ids",))
def _lookup_table(ctx, op):
    """Rows of W at Ids.  Ids outside [0, vocab) give zero rows, the
    semantics of the JAX package's Pallas gather kernel.  The generic
    ``lookup_table_grad`` reaches the scatter-add kernel through
    ``GatherRows``' backward; the padding mask stays here, so it masks the
    gradient rows too."""
    w = ctx.read_slot(op, "W")
    ids = ctx.read_slot(op, "Ids")
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    out = GatherRows.apply(w.contiguous(), flat).reshape(tuple(ids.shape) + (w.shape[1],))
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx)[..., None], out, 0.0)
    ctx.write_slot(op, "Out", out)


@register_infer_shape("lookup_table")
def _lookup_table_shape(block, op):
    ws = in_shape(block, op, "W")
    ids = in_shape(block, op, "Ids")
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    set_out_shape(block, op, "Out", tuple(ids) + (ws[-1],),
                  in_dtype(block, op, "W"))
