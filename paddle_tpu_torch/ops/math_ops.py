"""Math op lowerings: mul and matmul, the elementwise family with Fluid's
broadcast, reductions, unary ops, comparisons, ``isfinite``, scale, clip,
the norm ops the gradient clips use, ``cos_sim``, ``squared_l2_distance``
and the ``sum`` multi-input add.  ``mul``
and ``matmul`` are plain ``torch.matmul`` (cuBLAS on the card), as the JAX
package left them to XLA outside any Pallas kernel; the int8 form of both
is the kernel tier's ``pallas_int8_matmul`` (ops/kernel_ops.py).  Ops
without a grad lowering of their own differentiate through the generic
grad (``core/lower.py``)."""
from __future__ import annotations

import math

import torch

from ..core.dtypes import DataType
from ..core.registry import register_infer_shape, register_lowering
from ..core.selected_rows import SelectedRows, concat_rows
from .common import (bcast_shape, bcast_y, in_dtype, in_shape, normalize_axis,
                     same_shape, set_out_shape)


@register_lowering("mul")
def _mul(ctx, op):
    """Flatten X to 2-D at x_num_col_dims, Y at y_num_col_dims, then GEMM."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), math.prod(x.shape[xnc:]))
    y2 = y.reshape(math.prod(y.shape[:ync]), math.prod(y.shape[ync:]))
    out = torch.matmul(x2, y2)
    ctx.write_slot(op, "Out", out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


@register_infer_shape("mul")
def _mul_shape(block, op):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    set_out_shape(block, op, "Out", xs[:xnc] + ys[ync:], in_dtype(block, op, "X"))


@register_lowering("matmul")
def _matmul(ctx, op):
    """``X @ Y`` over the last two dims (batch dims broadcast), each operand
    transposed first where its flag says, times ``alpha``."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.write_slot(op, "Out", out)


def matmul_out_shape(block, op):
    xs = list(in_shape(block, op, "X"))
    ys = list(in_shape(block, op, "Y"))
    if op.attr("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attr("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1:
        return ys[:-2] + [ys[-1]] if len(ys) > 1 else []
    if len(ys) == 1:
        return xs[:-1]
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    return list(batch) + [xs[-2], ys[-1]]


@register_infer_shape("matmul")
def _matmul_shape(block, op):
    set_out_shape(block, op, "Out", matmul_out_shape(block, op), in_dtype(block, op, "X"))


def _make_elementwise(name, fn):
    """Fluid elementwise op ``name``: ``fn(X, Y)`` with Y broadcast from
    ``axis``; the output has the higher-rank operand's shape.  (The
    ``amp-quant-int8`` pass inserts ``elementwise_mul`` for the combined
    scale s_x * s_w.)"""
    @register_lowering(name)
    def _low(ctx, op):
        x = ctx.read_slot(op, "X")
        y = ctx.read_slot(op, "Y")
        ctx.write_slot(op, "Out", fn(x, bcast_y(x, y, op.attr("axis", -1))))

    @register_infer_shape(name)
    def _shape(block, op):
        xs = in_shape(block, op, "X")
        ys = in_shape(block, op, "Y")
        set_out_shape(block, op, "Out", xs if len(xs) >= len(ys) else ys,
                      in_dtype(block, op, "X"))


_make_elementwise("elementwise_add", torch.add)
_make_elementwise("elementwise_sub", torch.sub)
_make_elementwise("elementwise_mul", torch.mul)
_make_elementwise("elementwise_div", torch.div)
_make_elementwise("elementwise_min", torch.minimum)
_make_elementwise("elementwise_max", torch.maximum)
_make_elementwise("elementwise_pow", torch.pow)
# Python's modulus, with the divisor's sign (jnp.mod); torch.fmod would
# take the dividend's
_make_elementwise("elementwise_mod", torch.remainder)
# floored (jnp.floor_divide); its gradient is zero, as JAX's
_make_elementwise("elementwise_floordiv",
                  lambda x, y: torch.div(x, y, rounding_mode="floor"))


def _make_reduce(name, fn):
    """``reduce_*``: over every dim with ``reduce_all``, else over ``dim``
    (kept as size 1 with ``keep_dim``)."""
    @register_lowering(name)
    def _low(ctx, op):
        x = ctx.read_slot(op, "X")
        if op.attr("reduce_all", False):
            out = fn(x)
        else:
            dims = tuple(normalize_axis(d, x.ndim) for d in op.attr("dim", [0]))
            out = fn(x, dims, op.attr("keep_dim", False))
        ctx.write_slot(op, "Out", out)

    @register_infer_shape(name)
    def _shape(block, op):
        xs = in_shape(block, op, "X")
        if op.attr("reduce_all", False):
            out = ()
        else:
            dims = {normalize_axis(d, len(xs)) for d in op.attr("dim", [0])}
            if op.attr("keep_dim", False):
                out = tuple(1 if i in dims else s for i, s in enumerate(xs))
            else:
                out = tuple(s for i, s in enumerate(xs) if i not in dims)
        set_out_shape(block, op, "Out", out, in_dtype(block, op, "X"))


def _reduce_prod(x, dims=None, keep=False):
    if dims is None:
        return torch.prod(x)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, d, keepdim=keep)
    return x


def _reduce_mean(x, dims=None, keep=False):
    """``torch.mean``; an integer tensor's mean is float32, as ``jnp.mean``'s."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return torch.mean(x) if dims is None else torch.mean(x, dims, keep)


_make_reduce("reduce_sum", torch.sum)
_make_reduce("reduce_mean", _reduce_mean)
_make_reduce("reduce_max", torch.amax)
_make_reduce("reduce_min", torch.amin)
_make_reduce("reduce_prod", _reduce_prod)


@register_lowering("scale")
def _scale(ctx, op):
    x = ctx.read_slot(op, "X")
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.write_slot(op, "Out", out)


same_shape("scale")


@register_lowering("mean")
def _mean(ctx, op):
    ctx.write_slot(op, "Out", torch.mean(ctx.read_slot(op, "X")))


@register_infer_shape("mean")
def _mean_shape(block, op):
    set_out_shape(block, op, "Out", (), in_dtype(block, op, "X"))


@register_lowering("sum")
def _sum(ctx, op):
    """Multi-input add; ``append_backward`` emits it to merge a gradient
    produced more than once, the regularizers to add the decay, and the
    global-norm clip to total the squared norms.  SelectedRows inputs
    concatenate when all are sparse (``concat_rows``: duplicates stay, the
    updates merge); a sparse input beside a dense one is densified."""
    xs = ctx.read_slot_list(op, "X")
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            out = xs[0]
            for x in xs[1:]:
                out = concat_rows(out, x)
            ctx.write_slot(op, "Out", out)
            return
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.write_slot(op, "Out", out)


same_shape("sum")


@register_lowering("clip")
def _clip(ctx, op):
    ctx.write_slot(op, "Out", torch.clamp(ctx.read_slot(op, "X"), op.attr("min"), op.attr("max")))


@register_lowering("clip_by_norm")
def _clip_by_norm(ctx, op):
    """X scaled to L2 norm ``max_norm`` where its norm exceeds it."""
    x = ctx.read_slot(op, "X")
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-12), 1.0)
    ctx.write_slot(op, "Out", x * scale)


def _make_unary(name, fn, no_grad=False):
    @register_lowering(name, no_gradient=no_grad)
    def _low(ctx, op):
        ctx.write_slot(op, "Out", fn(ctx.read_slot(op, "X")))

    same_shape(name)


_make_unary("square", torch.square)
_make_unary("sqrt", torch.sqrt)
_make_unary("rsqrt", torch.rsqrt)
_make_unary("abs", torch.abs)
_make_unary("exp", torch.exp)
_make_unary("log", torch.log)
_make_unary("sin", torch.sin)
_make_unary("cos", torch.cos)
_make_unary("floor", torch.floor)
_make_unary("ceil", torch.ceil)
_make_unary("round", torch.round)
_make_unary("reciprocal", torch.reciprocal)
_make_unary("sign", torch.sign)
_make_unary("logical_not", torch.logical_not, no_grad=True)


@register_lowering("pow")
def _pow(ctx, op):
    ctx.write_slot(op, "Out", torch.pow(ctx.read_slot(op, "X"), op.attr("factor", 1.0)))


for _t in ("pow", "clip", "clip_by_norm", "increment"):
    same_shape(_t)


def _make_compare(name, fn):
    @register_lowering(name, no_gradient=True)
    def _low(ctx, op):
        ctx.write_slot(op, "Out", fn(ctx.read_slot(op, "X"), ctx.read_slot(op, "Y")))

    @register_infer_shape(name)
    def _shape(block, op):
        set_out_shape(block, op, "Out", in_shape(block, op, "X"), DataType.BOOL)


_make_compare("less_than", torch.lt)
_make_compare("less_equal", torch.le)
_make_compare("greater_than", torch.gt)
_make_compare("greater_equal", torch.ge)
_make_compare("equal", torch.eq)
_make_compare("not_equal", torch.ne)
_make_compare("logical_and", torch.logical_and)
_make_compare("logical_or", torch.logical_or)
_make_compare("logical_xor", torch.logical_xor)


@register_lowering("isfinite", no_gradient=True)
def _isfinite(ctx, op):
    """One boolean: whether every entry of X is finite."""
    ctx.write_slot(op, "Out", torch.isfinite(ctx.read_slot(op, "X")).all())


@register_lowering("cos_sim")
def _cos_sim(ctx, op):
    """Cosine similarity along the last axis (Y broadcasts against X), with
    the norms: Out = sum(x * y) / (|x| * |y| + 1e-12)."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    ctx.write_slot(op, "Out", torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12))
    ctx.write_slot(op, "XNorm", xn)
    ctx.write_slot(op, "YNorm", yn)


@register_infer_shape("cos_sim")
def _cos_sim_shape(block, op):
    xs = in_shape(block, op, "X")
    ys = in_shape(block, op, "Y")
    dt = in_dtype(block, op, "X")
    xkeep = tuple(xs[:-1]) + (1,) if xs else (1,)
    ykeep = tuple(ys[:-1]) + (1,) if ys else (1,)
    set_out_shape(block, op, "Out", xkeep, dt)
    set_out_shape(block, op, "XNorm", xkeep, dt)
    set_out_shape(block, op, "YNorm", ykeep, dt)


@register_lowering("squared_l2_distance")
def _squared_l2_distance(ctx, op):
    """Out = sum((X - Y)^2) over the last axis, kept; ``sub_result`` = X - Y."""
    d = ctx.read_slot(op, "X") - ctx.read_slot(op, "Y")
    ctx.write_slot(op, "sub_result", d)
    ctx.write_slot(op, "Out", torch.sum(d * d, dim=-1, keepdim=True))


@register_lowering("squared_l2_norm")
def _squared_l2_norm(ctx, op):
    x = ctx.read_slot(op, "X")
    if isinstance(x, SelectedRows):
        # duplicates sum before they are squared, in float32
        rows = x.merged().rows.to(torch.float32)
        ctx.write_slot(op, "Out", torch.sum(rows * rows).reshape(()))
        return
    ctx.write_slot(op, "Out", torch.sum(x * x).reshape(()))


@register_infer_shape("squared_l2_norm")
def _squared_l2_norm_shape(block, op):
    set_out_shape(block, op, "Out", (), in_dtype(block, op, "X"))


@register_lowering("increment", no_gradient=True)
def _increment(ctx, op):
    """X + step in X's dtype: an integer step counter stays an integer (a
    float32 counter would stop counting at 2**24)."""
    x = ctx.read_slot(op, "X")
    step = op.attr("step", 1.0)
    ctx.write_slot(op, "Out", x + (step if x.is_floating_point() else int(step)))


@register_lowering("maximum")
def _maximum(ctx, op):
    ctx.write_slot(op, "Out", torch.maximum(ctx.read_slot(op, "X"), ctx.read_slot(op, "Y")))


@register_infer_shape("maximum")
def _maximum_shape(block, op):
    set_out_shape(block, op, "Out",
                  bcast_shape(in_shape(block, op, "X"), in_shape(block, op, "Y")),
                  in_dtype(block, op, "X"))
