"""Optimizer update rules as ops.  Each reads Param, Grad and its
accumulators and writes the ``*Out`` vars, which share their inputs'
names, so the executor writes the new values back to the scope.

``adam`` on a CUDA tensor is the hand-written fused kernel
(ops/cuda/fused_optimizer.py); on the CPU it is the composed expression of
the JAX package's ``adam`` lowering.  ``sgd`` is composed (its fused
kernel waits for the SGD path).  Gradients are dense: SelectedRows
(sparse) gradients are not ported yet.
"""
from __future__ import annotations

import torch

from ..core.registry import register_lowering
from .cuda.fused_optimizer import fused_adam


@register_lowering("sgd", no_gradient=True)
def _sgd(ctx, op):
    p = ctx.read_slot(op, "Param")
    g = ctx.read_slot(op, "Grad")
    lr = ctx.read_slot(op, "LearningRate")
    ctx.write_slot(op, "ParamOut", p - lr * g)


@register_lowering("adam", no_gradient=True)
def _adam(ctx, op):
    p = ctx.read_slot(op, "Param")
    g = ctx.read_slot(op, "Grad")
    m1 = ctx.read_slot(op, "Moment1")
    m2 = ctx.read_slot(op, "Moment2")
    b1p = ctx.read_slot(op, "Beta1Pow")
    b2p = ctx.read_slot(op, "Beta2Pow")
    lr = ctx.read_slot(op, "LearningRate")
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    if p.device.type == "cuda":
        outs = fused_adam(p, g.contiguous(), m1, m2, b1p, b2p, lr, b1, b2, eps)
    else:
        m1n = b1 * m1 + (1 - b1) * g
        m2n = b2 * m2 + (1 - b2) * g * g
        lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
        pn = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
        outs = (pn, m1n, m2n, b1p * b1, b2p * b2)
    for slot, val in zip(("ParamOut", "Moment1Out", "Moment2Out",
                          "Beta1PowOut", "Beta2PowOut"), outs):
        ctx.write_slot(op, slot, val)
