"""Activation op lowerings: the JAX package's 22-entry table of unary
activations, each with its formula and attr defaults, plus ``prelu`` and
``maxout``.  Their gradients come from the generic grad."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, same_shape, set_out_shape


def _softplus(x):
    """log(1 + e^x) = logaddexp(x, 0), as ``jax.nn.softplus`` (torch's
    ``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gelu(x, op):
    if op.attr("approximate", True):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def _softshrink(x, op):
    lam = op.attr("lambda", 0.5)
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, 0.0))


ACTIVATIONS = {
    "sigmoid": lambda x, op: torch.sigmoid(x),
    "logsigmoid": lambda x, op: F.logsigmoid(x),
    "relu": lambda x, op: torch.relu(x),
    "tanh": lambda x, op: torch.tanh(x),
    "tanh_shrink": lambda x, op: x - torch.tanh(x),
    "softshrink": _softshrink,
    "hard_shrink": lambda x, op: torch.where(x.abs() > op.attr("threshold", 0.5), x, 0.0),
    "softsign": lambda x, op: x / (1 + x.abs()),
    "softplus": lambda x, op: _softplus(x),
    "elu": lambda x, op: F.elu(x, alpha=op.attr("alpha", 1.0)),
    "relu6": lambda x, op: torch.clamp(x, 0.0, op.attr("threshold", 6.0)),
    # x >= 0 keeps x, as jax.nn.leaky_relu (its gradient at 0 is 1)
    "leaky_relu": lambda x, op: torch.where(x >= 0, x, op.attr("alpha", 0.02) * x),
    "soft_relu": lambda x, op: torch.log(1 + torch.exp(torch.clamp(
        x, -op.attr("threshold", 40.0), op.attr("threshold", 40.0)))),
    "brelu": lambda x, op: torch.clamp(x, op.attr("t_min", 0.0), op.attr("t_max", 24.0)),
    "stanh": lambda x, op: op.attr("scale_b", 1.7159) * torch.tanh(
        op.attr("scale_a", 2.0 / 3.0) * x),
    "hard_sigmoid": lambda x, op: torch.clamp(
        op.attr("slope", 0.2) * x + op.attr("offset", 0.5), 0.0, 1.0),
    "thresholded_relu": lambda x, op: torch.where(x > op.attr("threshold", 1.0), x, 0.0),
    "swish": lambda x, op: x * torch.sigmoid(op.attr("beta", 1.0) * x),
    "gelu": _gelu,
    "mish": lambda x, op: x * torch.tanh(_softplus(x)),
    "silu": lambda x, op: F.silu(x),
    "exp_act": lambda x, op: torch.exp(x),
}


def _register(name, fn):
    @register_lowering(name)
    def _low(ctx, op):
        ctx.write_slot(op, "Out", fn(ctx.read_slot(op, "X"), op))

    same_shape(name)


for _name, _fn in ACTIVATIONS.items():
    _register(_name, _fn)


@register_lowering("prelu")
def _prelu(ctx, op):
    """x where x > 0, else alpha * x; alpha is one value (``all``), one a
    channel (``channel``) or one an element of a row (``element``)."""
    x = ctx.read_slot(op, "X")
    alpha = ctx.read_slot(op, "Alpha")
    if op.attr("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    ctx.write_slot(op, "Out", torch.where(x > 0, x, alpha * x))


same_shape("prelu")


@register_lowering("maxout")
def _maxout(ctx, op):
    """The max over each run of ``groups`` consecutive channels of NCHW."""
    x = ctx.read_slot(op, "X")
    groups = op.attr("groups")
    n, c, h, w = x.shape
    ctx.write_slot(op, "Out", x.reshape(n, c // groups, groups, h, w).amax(2))


@register_infer_shape("maxout")
def _maxout_shape(block, op):
    n, c, h, w = in_shape(block, op, "X")
    g = int(op.attr("groups"))
    set_out_shape(block, op, "Out", (n, c // g if c > 0 else -1, h, w), in_dtype(block, op, "X"))
