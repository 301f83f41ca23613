"""Optimizer update rules as ops.  Each reads Param, Grad and its
accumulators and writes the ``*Out`` vars, which share their inputs'
names, so the executor writes the new values back to the scope.

``sgd`` and ``adam`` on a CUDA tensor are the hand-written fused kernels
K5 and K6 (ops/cuda/fused_optimizer.py).  On the CPU ``sgd`` is K5's plain
version (``p - lr * g`` rounded once, as XLA fuses the JAX package's
``sgd``) and ``adam`` the composed expression of the JAX package's
``adam`` lowering.  The kernel tier's ``pallas_sgd`` (the
``pallas-kernels`` pass's retype, whose op types are part of the
ProgramDesc) lowers through ``sgd``'s function; ``pallas_adam`` has its
own, which on the CPU computes the JAX package's ``fused_adam``
expression, as the reference does.  Gradients are dense: SelectedRows
(sparse) gradients are not ported yet.
"""
from __future__ import annotations

import torch

from ..core.registry import register_lowering
from .cuda.fused_optimizer import fused_adam, fused_sgd


@register_lowering("pallas_sgd", no_gradient=True)
@register_lowering("sgd", no_gradient=True)
def _sgd(ctx, op):
    p = ctx.read_slot(op, "Param")
    g = ctx.read_slot(op, "Grad")
    lr = ctx.read_slot(op, "LearningRate")
    ctx.write_slot(op, "ParamOut", fused_sgd(p, g.contiguous(), lr))


def _adam_slots(ctx, op):
    return ([ctx.read_slot(op, s) for s in ("Param", "Grad", "Moment1", "Moment2",
                                            "Beta1Pow", "Beta2Pow", "LearningRate")],
            (op.attr("beta1", 0.9), op.attr("beta2", 0.999), op.attr("epsilon", 1e-8)))


def _write_adam(ctx, op, outs):
    for slot, val in zip(("ParamOut", "Moment1Out", "Moment2Out",
                          "Beta1PowOut", "Beta2PowOut"), outs):
        ctx.write_slot(op, slot, val)


@register_lowering("adam", no_gradient=True)
def _adam(ctx, op):
    (p, g, m1, m2, b1p, b2p, lr), (b1, b2, eps) = _adam_slots(ctx, op)
    if p.device.type == "cuda":
        outs = fused_adam(p, g.contiguous(), m1, m2, b1p, b2p, lr, b1, b2, eps)
    else:
        # the JAX package's composed ``adam``: ((1 - b2) * g) * g
        m1n = b1 * m1 + (1 - b1) * g
        m2n = b2 * m2 + (1 - b2) * g * g
        lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
        pn = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
        outs = (pn, m1n, m2n, b1p * b1, b2p * b2)
    _write_adam(ctx, op, outs)


@register_lowering("pallas_adam", no_gradient=True)
def _pallas_adam(ctx, op):
    """The JAX package's ``fused_adam``: K6 on the card, its plain version
    (``(1 - b2) * (g * g)``) on the CPU."""
    (p, g, m1, m2, b1p, b2p, lr), (b1, b2, eps) = _adam_slots(ctx, op)
    _write_adam(ctx, op, fused_adam(p, g.contiguous(), m1, m2, b1p, b2p, lr, b1, b2, eps))
