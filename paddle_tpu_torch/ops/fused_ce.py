"""Fused final projection + softmax cross-entropy: ``fused_fc_softmax_ce``.

``Loss[i] = logsumexp(x_i @ W + b) - (x_i @ W + b)[label_i]`` without the
[rows, V] logits in memory, and its gradient from the saved log-sum-exp
(the JAX package's ``ops/fused_ce.py``).  Both lowerings call the
linear-CE kernels (ops/cuda/linear_ce.py): on a CUDA tensor the
hand-written Hopper kernels, on the CPU their plain versions, which follow
the JAX package's chunked composed path.  The ``use_pallas`` and
``vocab_chunks`` attrs stay in the desc for ProgramDesc parity; the port
ignores them.

Under ``amp-bf16`` the forward reads bf16 X, W and Bias (the pass casts a
whitelist op's inputs) and runs K7's bf16 instance: W taken in X's dtype,
the bias in float32, lse and the loss float32.  The grad op's inputs stay
float32 (``GRAD_UNCAST``), so the backward is float32 K8.
"""
from __future__ import annotations

import math

import torch

from ..core.desc import OpDesc, grad_var_name
from ..core.dtypes import DataType
from ..core.registry import (register_grad_maker, register_infer_shape,
                             register_lowering)
from .common import in_shape, set_out_shape
from .cuda.linear_ce import linear_ce_bwd, linear_ce_fwd


def _inputs(ctx, op):
    """(x, x flattened at num_flatten_dims, w, bias or None, labels [rows] int32)."""
    x = ctx.read_slot(op, "X")
    w = ctx.read_slot(op, "W")
    bias_names = op.input("Bias")
    b = ctx.read(bias_names[0]) if bias_names and bias_names[0] else None
    nfd = int(op.attr("num_flatten_dims", 1))
    x2 = x.reshape(math.prod(x.shape[:nfd]), -1)
    if x2.shape[1] != w.shape[0]:
        raise ValueError(
            f"fused_fc_softmax_ce: x flattened at num_flatten_dims={nfd} "
            f"gives feature dim {x2.shape[1]} but W has {w.shape[0]} rows")
    labels = ctx.read_slot(op, "Label").reshape(-1).to(torch.int32).contiguous()
    return x, x2.contiguous(), w.contiguous(), b, labels


def _on_rows(ctx, fn, x2, w, b, labels, *rows, partial_outs: int = 0):
    """``fn`` (a linear-CE kernel) on each rank's rows under a mesh: x2,
    labels and ``rows`` on x2's batch placements, W and the bias
    replicated for the kernel; the outputs on the batch placements, but
    the last ``partial_outs`` (W's and the bias's gradients), which are
    partial sums over the ranks' rows."""
    if ctx.mesh is None:
        return fn(x2, w, b, labels, *rows)
    from ..parallel.layout import batch_like, on_local, partial_where_sharded, replicate
    pl, rep = batch_like(x2, ctx.mesh), replicate(ctx.mesh)
    outs = 3 if partial_outs else 2
    out_pl = (pl,) * (outs - partial_outs) + (partial_where_sharded(pl),) * partial_outs
    if partial_outs and b is None:
        out_pl = out_pl[:-1] + (None,)
    return on_local(ctx.mesh, fn, (x2, w, b, labels) + rows,
                    (pl, rep, None if b is None else rep, pl) + (pl,) * len(rows), out_pl)


@register_lowering("fused_fc_softmax_ce", non_diff_inputs=("Label",))
def _fused_fc_softmax_ce(ctx, op):
    x, x2, w, b, labels = _inputs(ctx, op)
    lse, lab = _on_rows(ctx, linear_ce_fwd, x2, w, b, labels)
    nfd = int(op.attr("num_flatten_dims", 1))
    ctx.write_slot(op, "Loss", (lse - lab).reshape(tuple(x.shape[:nfd]) + (1,)))
    ctx.write_slot(op, "LogSumExp", lse)            # saved for the backward


@register_infer_shape("fused_fc_softmax_ce")
def _fused_fc_softmax_ce_shape(block, op):
    xs = in_shape(block, op, "X")
    lead = tuple(xs[:int(op.attr("num_flatten_dims", 1))])
    set_out_shape(block, op, "Loss", lead + (1,), DataType.FP32)
    flat = -1 if any(d < 0 for d in lead) else math.prod(lead)
    set_out_shape(block, op, "LogSumExp", (flat,), DataType.FP32)


@register_grad_maker("fused_fc_softmax_ce")
def _fused_fc_softmax_ce_grad_maker(op, block, no_grad_set):
    """The backward reads the saved LogSumExp, so the forward is not
    re-run by the generic grad."""
    g = OpDesc(type="fused_fc_softmax_ce_grad", attrs=dict(op.attrs))
    for slot in ("X", "W", "Bias", "Label"):
        names = op.inputs.get(slot, [])
        if names:
            g.inputs[slot] = list(names)
    g.inputs["LogSumExp"] = list(op.output("LogSumExp"))
    g.inputs["LossGrad"] = [grad_var_name(n) for n in op.output("Loss")]
    for slot in ("X", "W", "Bias"):
        gnames = [grad_var_name(n) if n and n not in no_grad_set else ""
                  for n in op.inputs.get(slot, [])]
        if any(gnames):
            g.outputs[slot + "@GRAD_SLOT"] = gnames
    return [g]


@register_lowering("fused_fc_softmax_ce_grad")
def _fused_fc_softmax_ce_grad(ctx, op):
    x, x2, w, b, labels = _inputs(ctx, op)
    lse = ctx.read_slot(op, "LogSumExp").contiguous()
    gloss = ctx.read_slot(op, "LossGrad").reshape(-1).contiguous()
    dx2, dw, db = _on_rows(ctx, linear_ce_bwd, x2, w, b, labels, lse, gloss, partial_outs=2)
    for slot, val, like in (("X", dx2, x), ("W", dw, w), ("Bias", db, b)):
        gnames = op.outputs.get(slot + "@GRAD_SLOT", [])
        if gnames and gnames[0] and val is not None:
            ctx.write(gnames[0], val.reshape(like.shape).to(like.dtype))
