"""Recurrent ops: ``dynamic_lstm``, ``dynamic_gru``, ``lstmp`` and the
single-step cells ``gru_unit`` and ``lstm_unit``.

The JAX package lowers each recurrence as one ``lax.scan`` over time
(``ops/rnn_ops.py``); here it is a Python loop of T steps over torch ops,
which a CUDA graph of the training step records whole (T is the padded
length, a static shape).  Inputs are batch-major padded ``[N, T, G*H]``
(the input-to-hidden projection is an ``fc`` outside, the reference's
contract) with ``@SEQ_LEN`` lengths: a step past a row's length carries
the row's state through unchanged, and the outputs there are zero.  A
reversed recurrence walks t = T-1 .. 0 and so crosses the padded tail
first, its state held, as the JAX scan does.

Gate layouts, as in the reference's lstm_op.cc and gru_op.cc:

* LSTM: the 4H columns are (i, f, c~, o); with ``use_peepholes`` the
  peephole weights are ``Bias[4H:7H]`` (w_ic, w_fc, w_oc);
  c = f*c_prev + i*act(c~), h = o*cell_act(c).
* GRU: ``Weight = [W_update | W_reset | W_cand]`` ([H, 3H]);
  h = u*h_prev + (1-u)*c~.

The gradients go through the generic grad (``core/lower.py``): the
recurrence runs again under autograd, as the JAX package takes the
scan's vjp.
"""
from __future__ import annotations

import torch

from ..core.lower import SEQ_LEN_AWARE, SEQ_LEN_SUFFIX
from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape

SEQ_LEN_AWARE.update({"dynamic_lstm", "dynamic_gru"})

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}


def _valid_steps(x: torch.Tensor, lens):
    """``[T, N, 1]`` booleans, True where step t lies inside row n; None
    without lengths."""
    if lens is None:
        return None
    t = x.shape[1]
    return (torch.arange(t, device=x.device)[:, None] < lens.reshape(1, -1))[:, :, None]


def _carry(valid, t: int, new, old):
    """``new`` where step ``t`` lies inside its row, else ``old``."""
    return new if valid is None else torch.where(valid[t], new, old)


def _outputs(steps, valid):
    """The steps' states stacked to ``[N, T, H]``, zero past each row."""
    out = torch.stack(steps, dim=1)
    if valid is None:
        return out
    return torch.where(valid.transpose(0, 1), out, torch.zeros((), dtype=out.dtype,
                                                                device=out.device))


def _peepholes(b, h: int, use_peepholes: bool):
    """(gate bias, w_ic, w_fc, w_oc) from a ``[1, 4H]`` or ``[1, 7H]``
    bias; the peepholes are None where there are none."""
    if b is None:
        return None, None, None, None
    flat = b.reshape(-1)
    if use_peepholes and flat.numel() >= 7 * h:
        return flat[:4 * h], flat[4 * h:5 * h], flat[5 * h:6 * h], flat[6 * h:7 * h]
    return flat[:4 * h], None, None, None


def _lstm_cell(gates, c_prev, w_ic, w_fc, w_oc, gate_act, cand_act, cell_act):
    """One LSTM step from its pre-activations (i, f, c~, o): (h, c)."""
    gi, gf, gc, go = gates.chunk(4, dim=-1)
    if w_ic is not None:
        gi = gi + c_prev * w_ic
        gf = gf + c_prev * w_fc
    c_new = gate_act(gf) * c_prev + gate_act(gi) * cand_act(gc)
    if w_oc is not None:
        go = go + c_new * w_oc
    return gate_act(go) * cell_act(c_new), c_new


@register_lowering("dynamic_lstm")
def _dynamic_lstm(ctx, op):
    x = ctx.read_slot(op, "Input")            # [N, T, 4H]
    w = ctx.read_slot(op, "Weight")           # [H, 4H]
    b = ctx.read_slot(op, "Bias")             # [1, 4H], or [1, 7H] with peepholes
    h0 = ctx.read_slot(op, "H0")
    c0 = ctx.read_slot(op, "C0")
    lens = ctx.read_opt(op.input("Input")[0] + SEQ_LEN_SUFFIX)
    n, t, four_h = x.shape
    h = four_h // 4
    gate_act = _ACTS[op.attr("gate_activation", "sigmoid")]
    cell_act = _ACTS[op.attr("cell_activation", "tanh")]
    cand_act = _ACTS[op.attr("candidate_activation", "tanh")]
    bias, w_ic, w_fc, w_oc = _peepholes(b, h, bool(op.attr("use_peepholes", True)))
    if bias is not None:
        x = x + bias
    h_prev = h0 if h0 is not None else x.new_zeros((n, h))
    c_prev = c0 if c0 is not None else x.new_zeros((n, h))
    valid = _valid_steps(x, lens)
    hs, cs = [None] * t, [None] * t
    order = range(t - 1, -1, -1) if op.attr("is_reverse", False) else range(t)
    for tt in order:
        h_new, c_new = _lstm_cell(x[:, tt] + h_prev @ w, c_prev, w_ic, w_fc, w_oc,
                                  gate_act, cand_act, cell_act)
        c_prev = cs[tt] = _carry(valid, tt, c_new, c_prev)
        h_prev = hs[tt] = _carry(valid, tt, h_new, h_prev)
    ctx.write_slot(op, "Hidden", _outputs(hs, valid))
    ctx.write_slot(op, "Cell", _outputs(cs, valid))
    if lens is not None:
        for slot in ("Hidden", "Cell"):
            names = op.output(slot)
            if names:
                ctx.write(names[0] + SEQ_LEN_SUFFIX, lens)


@register_infer_shape("dynamic_lstm")
def _dynamic_lstm_shape(block, op):
    xs = in_shape(block, op, "Input")
    out = tuple(xs[:-1]) + (xs[-1] // 4,)
    set_out_shape(block, op, "Hidden", out, in_dtype(block, op, "Input"))
    set_out_shape(block, op, "Cell", out, in_dtype(block, op, "Input"))


def _gru_cell(x_t, h_prev, w, h: int, gate_act, cand_act):
    """One GRU step from the projected input (bias added): (h, gates
    [u | r], candidate, r*h_prev)."""
    g = gate_act(x_t[:, :2 * h] + h_prev @ w[:, :2 * h])
    u, r = g.chunk(2, dim=-1)
    reset_h = r * h_prev
    c = cand_act(x_t[:, 2 * h:] + reset_h @ w[:, 2 * h:])
    return u * h_prev + (1.0 - u) * c, g, c, reset_h


@register_lowering("dynamic_gru")
def _dynamic_gru(ctx, op):
    """reference gru_op.cc: u = act_g(x_u + h W_u), r = act_g(x_r + h W_r),
    c~ = act(x_c + (r*h) W_c), h' = u*h + (1-u)*c~."""
    x = ctx.read_slot(op, "Input")            # [N, T, 3H]
    w = ctx.read_slot(op, "Weight")           # [H, 3H]
    b = ctx.read_slot(op, "Bias")             # [1, 3H]
    h0 = ctx.read_slot(op, "H0")
    lens = ctx.read_opt(op.input("Input")[0] + SEQ_LEN_SUFFIX)
    n, t, three_h = x.shape
    h = three_h // 3
    gate_act = _ACTS[op.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[op.attr("activation", "tanh")]
    if b is not None:
        x = x + b.reshape(-1)
    h_prev = h0 if h0 is not None else x.new_zeros((n, h))
    valid = _valid_steps(x, lens)
    hs = [None] * t
    order = range(t - 1, -1, -1) if op.attr("is_reverse", False) else range(t)
    for tt in order:
        h_new = _gru_cell(x[:, tt], h_prev, w, h, gate_act, cand_act)[0]
        h_prev = hs[tt] = _carry(valid, tt, h_new, h_prev)
    ctx.write_slot(op, "Hidden", _outputs(hs, valid))
    names = op.output("Hidden")
    if lens is not None and names:
        ctx.write(names[0] + SEQ_LEN_SUFFIX, lens)


@register_infer_shape("dynamic_gru")
def _dynamic_gru_shape(block, op):
    xs = in_shape(block, op, "Input")
    set_out_shape(block, op, "Hidden", tuple(xs[:-1]) + (xs[-1] // 3,),
                  in_dtype(block, op, "Input"))


# --------------------------------------------------------------------------
# single-step cells (decoder stepping)
# --------------------------------------------------------------------------

@register_lowering("gru_unit")
def _gru_unit(ctx, op):
    """One GRU step (reference operators/gru_unit_op.cc): Input ``[N, 3H]``
    is the projected x, with dynamic_gru's layout and update rule."""
    x = ctx.read_slot(op, "Input")            # [N, 3H]
    h_prev = ctx.read_slot(op, "HiddenPrev")  # [N, H]
    w = ctx.read_slot(op, "Weight")           # [H, 3H]
    b = ctx.read_slot(op, "Bias")
    if b is not None:
        x = x + b.reshape(-1)
    h_new, g, c, reset_h = _gru_cell(x, h_prev, w, h_prev.shape[-1],
                                     _ACTS[op.attr("gate_activation", "sigmoid")],
                                     _ACTS[op.attr("activation", "tanh")])
    ctx.write_slot(op, "Gate", torch.cat([g, c], dim=-1))
    ctx.write_slot(op, "ResetHiddenPrev", reset_h)
    ctx.write_slot(op, "Hidden", h_new)


@register_infer_shape("gru_unit")
def _gru_unit_shape(block, op):
    hs = in_shape(block, op, "HiddenPrev")
    dt = in_dtype(block, op, "HiddenPrev")
    set_out_shape(block, op, "Hidden", hs, dt)
    set_out_shape(block, op, "ResetHiddenPrev", hs, dt)
    set_out_shape(block, op, "Gate", tuple(hs[:-1]) + (hs[-1] * 3,), dt)


@register_lowering("lstm_unit")
def _lstm_unit(ctx, op):
    """One LSTM step (reference operators/lstm_unit_op.cc): X ``[N, 4H]``
    holds the pre-activations (i, f, o, g); C = sigmoid(f + forget_bias)
    * C_prev + sigmoid(i) * tanh(g), H = sigmoid(o) * tanh(C)."""
    x = ctx.read_slot(op, "X")
    c_prev = ctx.read_slot(op, "C_prev")
    forget_bias = op.attr("forget_bias", 0.0)
    i, f, o, g = x.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + forget_bias) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    ctx.write_slot(op, "C", c_new)
    ctx.write_slot(op, "H", torch.sigmoid(o) * torch.tanh(c_new))


@register_infer_shape("lstm_unit")
def _lstm_unit_shape(block, op):
    cs = in_shape(block, op, "C_prev")
    dt = in_dtype(block, op, "C_prev")
    set_out_shape(block, op, "C", cs, dt)
    set_out_shape(block, op, "H", cs, dt)


@register_lowering("lstmp")
def _lstmp(ctx, op):
    """LSTM with a recurrent projection (reference lstmp_op.cc): the
    recurrence runs on the projected state r = proj_act(h @ ProjWeight)
    ``[N, P]``, so Weight is ``[P, 4H]``; outputs Projection ``[N, T, P]``
    and Cell ``[N, T, H]``.  H0 is the unprojected ``[N, H]`` state,
    projected before the first step.  As the JAX lowering, it reads no
    ``is_reverse``; and any ``proj_activation`` but identity applies the
    CELL activation (the reference's lstmp_op.h:197-200)."""
    x = ctx.read_slot(op, "Input")            # [N, T, 4H]
    w = ctx.read_slot(op, "Weight")           # [P, 4H]
    w_proj = ctx.read_slot(op, "ProjWeight")  # [H, P]
    b = ctx.read_slot(op, "Bias")
    h0 = ctx.read_slot(op, "H0")
    c0 = ctx.read_slot(op, "C0")
    lens = ctx.read_opt(op.input("Input")[0] + SEQ_LEN_SUFFIX)
    n, t, four_h = x.shape
    h = four_h // 4
    gate_act = _ACTS[op.attr("gate_activation", "sigmoid")]
    cell_act = _ACTS[op.attr("cell_activation", "tanh")]
    cand_act = _ACTS[op.attr("candidate_activation", "tanh")]
    proj_act = _ACTS["identity"] if op.attr("proj_activation", "tanh") == "identity" \
        else cell_act
    bias, w_ic, w_fc, w_oc = _peepholes(b, h, bool(op.attr("use_peepholes", True)))
    if bias is not None:
        x = x + bias
    r_prev = proj_act(h0 @ w_proj) if h0 is not None else x.new_zeros((n, w_proj.shape[1]))
    c_prev = c0 if c0 is not None else x.new_zeros((n, h))
    valid = _valid_steps(x, lens)
    rs, cs = [None] * t, [None] * t
    for tt in range(t):
        h_new, c_new = _lstm_cell(x[:, tt] + r_prev @ w, c_prev, w_ic, w_fc, w_oc,
                                  gate_act, cand_act, cell_act)
        c_prev = cs[tt] = _carry(valid, tt, c_new, c_prev)
        r_prev = rs[tt] = _carry(valid, tt, proj_act(h_new @ w_proj), r_prev)
    ctx.write_slot(op, "Projection", _outputs(rs, valid))
    ctx.write_slot(op, "Cell", _outputs(cs, valid))


@register_infer_shape("lstmp")
def _lstmp_shape(block, op):
    xs = in_shape(block, op, "Input")
    ps = in_shape(block, op, "ProjWeight")
    dt = in_dtype(block, op, "Input")
    set_out_shape(block, op, "Projection", tuple(xs[:-1]) + (ps[-1],), dt)
    set_out_shape(block, op, "Cell", tuple(xs[:-1]) + (xs[-1] // 4,), dt)
