"""NN op lowerings: layer_norm, dropout, lookup_table, softmax and the
cross-entropy losses.  ``lookup_table`` gathers through the hand-written
embedding kernels (ops/cuda/embedding.py): the gather forward, and the
scatter-add as the gather's gradient.  ``softmax``, ``log_softmax``,
``cross_entropy`` and ``softmax_with_cross_entropy`` are plain PyTorch, as
the JAX package computes them with XLA outside any Pallas kernel; their
gradients go through the generic grad."""
from __future__ import annotations

import torch

from ..core.desc import OpDesc, grad_var_name
from ..core.registry import (register_grad_maker, register_infer_shape,
                             register_lowering)
from .common import in_dtype, in_shape, same_shape, set_out_shape
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


def _dropout_draws(op) -> bool:
    return not op.attr("is_test", False) and op.attr("dropout_prob", 0.5) != 0.0


@register_lowering("dropout", draws=_dropout_draws)
def _dropout(ctx, op):
    x = ctx.read_slot(op, "X")
    prob = op.attr("dropout_prob", 0.5)
    if not _dropout_draws(op):
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


def flat_ids(ids):
    """(Ids without a trailing 1 dim, the same flattened to int32)."""
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids, ids.reshape(-1).to(torch.int32).contiguous()


def lookup_rows(ctx, op, gather):
    """``lookup_table``'s output through ``gather(W, flat int32 ids)``, with
    the ``padding_idx`` rows zeroed."""
    w = ctx.read_slot(op, "W")
    ids, flat = flat_ids(ctx.read_slot(op, "Ids"))
    out = gather(w.contiguous(), flat).reshape(tuple(ids.shape) + (w.shape[1],))
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx)[..., None], out, 0.0)
    ctx.write_slot(op, "Out", out)


@register_lowering("lookup_table", non_diff_inputs=("Ids",))
def _lookup_table(ctx, op):
    """Rows of W at Ids.  Ids outside [0, vocab) give zero rows, the
    semantics of the JAX package's Pallas gather kernel.  The generic
    ``lookup_table_grad`` reaches the scatter-add kernel through
    ``GatherRows``' backward; the padding mask stays here, so it masks the
    gradient rows too."""
    lookup_rows(ctx, op, GatherRows.apply)


@register_infer_shape("lookup_table")
def _lookup_table_shape(block, op):
    ws = in_shape(block, op, "W")
    ids = in_shape(block, op, "Ids")
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    set_out_shape(block, op, "Out", tuple(ids) + (ws[-1],),
                  in_dtype(block, op, "W"))


@register_lowering("softmax")
def _softmax(ctx, op):
    ctx.write_slot(op, "Out", torch.softmax(ctx.read_slot(op, "X"), dim=-1))


@register_lowering("log_softmax")
def _log_softmax(ctx, op):
    ctx.write_slot(op, "Out", torch.log_softmax(ctx.read_slot(op, "X"),
                                                dim=op.attr("axis", -1)))


same_shape("softmax")
same_shape("log_softmax")


def _hard_label(label, ndim):
    """A hard label as int64 gather indices [..., 1] against a [..., C]
    input of ``ndim`` dims."""
    if label.ndim == ndim and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.long().unsqueeze(-1)


@register_lowering("cross_entropy", non_diff_inputs=("Label",))
def _cross_entropy(ctx, op):
    """X is a probability distribution over its last dim: a hard label
    indexes it (Y = -log X[label]), a soft label is dotted with log X."""
    x = ctx.read_slot(op, "X")
    label = ctx.read_slot(op, "Label")
    if op.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=1e-20)), dim=-1, keepdim=True)
    else:
        picked = torch.gather(x, -1, _hard_label(label, x.ndim))
        loss = -torch.log(torch.clamp(picked, min=1e-20))
    ctx.write_slot(op, "Y", loss)


@register_infer_shape("cross_entropy")
def _cross_entropy_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Y", tuple(xs[:-1]) + (1,), in_dtype(block, op, "X"))


@register_lowering("softmax_with_cross_entropy", non_diff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, op):
    """Softmax = exp(log_softmax(Logits)); Loss = -log_softmax at the hard
    label, or the soft label's dot with it, [..., 1]."""
    logits = ctx.read_slot(op, "Logits")
    label = ctx.read_slot(op, "Label")
    logp = torch.log_softmax(logits, dim=-1)
    ctx.write_slot(op, "Softmax", torch.exp(logp))
    if op.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, -1, _hard_label(label, logits.ndim))
    ctx.write_slot(op, "Loss", loss)


@register_infer_shape("softmax_with_cross_entropy")
def _swce_shape(block, op):
    xs = in_shape(block, op, "Logits")
    dt = in_dtype(block, op, "Logits")
    set_out_shape(block, op, "Softmax", xs, dt)
    set_out_shape(block, op, "Loss", tuple(xs[:-1]) + (1,), dt)


@register_lowering("square_error_cost")
def _square_error_cost(ctx, op):
    ctx.write_slot(op, "Out", torch.square(ctx.read_slot(op, "X") - ctx.read_slot(op, "Y")))


same_shape("square_error_cost")
