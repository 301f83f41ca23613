"""Optimizer update rules as ops.  Each reads Param, Grad and its
accumulators and writes the ``*Out`` vars, which share their inputs'
names: the update is made in place, into the scope's own tensors, as the
JAX package's executor updates donated state.  An output named apart from
its input (no op that ``optimizer.py`` emits has one) gets a clone of the
input, updated in place, so the input keeps its value.

Each family (``sgd`` / ``pallas_sgd``, ``adam`` / ``pallas_adam``) has a
group lowering: ``core/lower.py`` hands it every update of a step at once,
and it calls the multi-tensor kernel K5 or K6 (ops/cuda/fused_optimizer.py)
once on a CUDA tensor, or the plain versions entry by entry on the CPU.
An op lowered on its own is a group of one.  ``sgd`` and the kernel tier's
``pallas_sgd`` (the ``pallas-kernels`` pass's retype, whose op types are
part of the ProgramDesc) compute the same, ``p - lr * g`` rounded once, as
XLA fuses the JAX package's ``sgd``.  ``adam`` computes the JAX package's
composed ``adam`` lowering, ``pallas_adam`` its ``fused_adam``: each entry
of a K6 launch says which.  Gradients are dense: SelectedRows (sparse)
gradients are not ported yet.
"""
from __future__ import annotations

from ..core.registry import register_group_lowering, register_lowering
from .cuda.fused_optimizer import fused_adam_multi, fused_sgd_multi

_ADAM_IN = ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
_ADAM_OUT = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut")


def _sgd_key(op):
    return "sgd"


def _own(op, slot, out_slot, t):
    """``t`` (the value of ``op``'s input ``slot``) to be updated in place
    into ``out_slot``: ``t`` itself where the output shares the input's
    name, else a clone of it."""
    return t if op.output(out_slot) == op.input(slot) else t.clone()


@register_group_lowering("sgd", "pallas_sgd", key=_sgd_key)
def _sgd_group(ctx, ops):
    entries = []
    for op in ops:
        p, g, lr = (ctx.read_slot(op, s) for s in ("Param", "Grad", "LearningRate"))
        entries.append((_own(op, "Param", "ParamOut", p), g.contiguous(), lr))
    for op, out in zip(ops, fused_sgd_multi(entries)):
        ctx.write_slot(op, "ParamOut", out)


def _adam_attrs(op):
    return op.attr("beta1", 0.9), op.attr("beta2", 0.999), op.attr("epsilon", 1e-8)


def _adam_key(op):
    return ("adam",) + _adam_attrs(op)


@register_group_lowering("adam", "pallas_adam", key=_adam_key)
def _adam_group(ctx, ops):
    entries = []
    for op in ops:
        p, g, m1, m2, b1p, b2p, lr = (ctx.read_slot(op, s) for s in _ADAM_IN)
        p, m1, m2 = (_own(op, s, o, t) for s, o, t in
                     zip(("Param", "Moment1", "Moment2"), _ADAM_OUT, (p, m1, m2)))
        entries.append((p, g.contiguous(), m1, m2, b1p, b2p, lr, op.type == "pallas_adam"))
    for op, outs in zip(ops, fused_adam_multi(entries, *_adam_attrs(ops[0]))):
        for slot, val in zip(_ADAM_OUT, outs):
            ctx.write_slot(op, slot, val)


@register_lowering("pallas_sgd", no_gradient=True)
@register_lowering("sgd", no_gradient=True)
def _sgd(ctx, op):
    _sgd_group(ctx, [op])


@register_lowering("pallas_adam", no_gradient=True)
@register_lowering("adam", no_gradient=True)
def _adam(ctx, op):
    _adam_group(ctx, [op])
