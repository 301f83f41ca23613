"""Mixture-of-Experts FFN with expert parallelism (Switch-style top-1
routing): the JAX package's ``ops/moe_ops.py``.

The recipe (Switch Transformer / GShard): route each token to its top-1
expert under a capacity limit, run the experts, combine by gate
probability, and add the auxiliary load-balancing loss
    aux = E * sum_e( fraction_tokens_e * mean_gate_prob_e ).

Dispatch and combine are dense einsums over a one-hot dispatch tensor,
so an ``expert``-sharded [E, D, H] weight (``switch_moe(expert_axis=)``
stamps the shardings) is one DTensor einsum under a mesh.  Capacity keeps
every shape static; overflow tokens fall through with a zero FFN output
(standard Switch behavior).  The contract is copied as it is: position
bookkeeping in float32, argmax taking the first of ties, and a position
past the capacity selecting no slot (``jax.nn.one_hot`` of an index out of
range is a zero row; ``torch.nn.functional.one_hot`` would raise).

Op contract
  moe_ffn:
    inputs  X [.., D], GateW [D, E], W1 [E, D, H], B1 [E, H],
            W2 [E, H, D], B2 [E, D]
    outputs Out [.., D], AuxLoss []  (scalar; add to the training loss)
    attrs   capacity_factor (float, default 1.25)
"""
from __future__ import annotations

import torch

from ..core.dtypes import DataType
from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def switch_moe_forward(x, gate_w, w1, b1, w2, b2, capacity_factor=1.25):
    """Pure function (shared by the lowering and tests).  x [T, D]."""
    t, d = x.shape
    e = gate_w.shape[1]
    capacity = max(1, int(capacity_factor * t / e))

    logits = x @ gate_w                                       # [T, E]
    gates = torch.softmax(logits, dim=-1)
    expert = torch.argmax(gates, dim=-1)                      # [T] top-1, first of ties
    gate_val = gates.amax(dim=-1)                             # [T]

    # position bookkeeping in fp32 regardless of x.dtype: low-precision
    # cumsum corrupts queue positions past the dtype's exact-integer range
    # (bf16: 256) and silently merges capacity slots
    onehot32 = _one_hot(expert, e, torch.float32)             # [T, E]
    pos = torch.cumsum(onehot32, dim=0) * onehot32 - onehot32  # [T, E]
    keep = ((pos < capacity) * onehot32).to(x.dtype)          # [T, E]
    pos_c = _one_hot(pos.sum(-1).to(torch.int32), capacity, x.dtype)  # [T, C]
    dispatch = keep[:, :, None] * pos_c[:, None, :]           # [T, E, C]
    onehot = onehot32.to(x.dtype)

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)      # [E, C, D]
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :])
    expert_out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    combine = dispatch * gate_val[:, None, None]              # [T, E, C]
    out = torch.einsum("tec,ecd->td", combine, expert_out)    # [T, D]

    # load-balancing auxiliary loss (Switch eq. 4): fraction of tokens per
    # expert x mean router prob per expert, scaled by E
    frac = onehot.mean(dim=0)
    prob = gates.mean(dim=0)
    aux = e * (frac * prob).sum()
    return out, aux.to(torch.float32)


@register_lowering("moe_ffn")
def _moe_ffn(ctx, op):
    x = ctx.read_slot(op, "X")
    gate_w = ctx.read_slot(op, "GateW")
    w1 = ctx.read_slot(op, "W1")
    b1 = ctx.read_slot(op, "B1")
    w2 = ctx.read_slot(op, "W2")
    b2 = ctx.read_slot(op, "B2")
    cf = float(op.attr("capacity_factor", 1.25))

    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    out, aux = switch_moe_forward(x.reshape(-1, d), gate_w, w1, b1, w2, b2, cf)
    ctx.write_slot(op, "Out", out.reshape(*lead, d))
    ctx.write_slot(op, "AuxLoss", aux)


@register_infer_shape("moe_ffn")
def _moe_ffn_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", xs, in_dtype(block, op, "X"))
    set_out_shape(block, op, "AuxLoss", (), DataType.FP32)
