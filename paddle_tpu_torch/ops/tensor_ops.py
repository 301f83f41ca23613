"""Tensor creation, dtype and shape op lowerings: fill_constant (and its
batch-size-like and zeros-like forms), assign, assign_value, cast,
reshape, flatten, transpose, concat, split, stack, squeeze, unsqueeze,
gather, slice, expand, pad, one_hot, arg_max, arg_min and top_k.

A constant of a 64-bit type is made in its 32-bit type, as the JAX
package's ``jnp.full`` makes it with 64-bit mode off (its default): an
int64 step counter is int32 in both packages' scopes, so a saved
directory loads in either."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import DataType, coerce_feed_dtype, convert_dtype
from ..core.registry import mark_no_gradient, register_infer_shape, register_lowering
from .common import device_constant, in_dtype, in_shape, normalize_axis, same_shape, set_out_shape


def _const_dtype(op) -> torch.dtype:
    return coerce_feed_dtype(convert_dtype(op.attr("dtype", "float32"))).torch_dtype


@register_lowering("fill_constant", no_gradient=True)
def _fill_constant(ctx, op):
    ctx.write_slot(op, "Out", torch.full(tuple(op.attr("shape", ())), op.attr("value", 0.0),
                                         dtype=_const_dtype(op), device=ctx.device))


@register_infer_shape("fill_constant")
def _fill_constant_shape(block, op):
    set_out_shape(block, op, "Out", op.attr("shape", ()),
                  convert_dtype(op.attr("dtype", "float32")))


@register_lowering("cast")
def _cast(ctx, op):
    """``X`` in ``out_dtype`` (the ``amp-bf16`` pass's casts; the legacy
    ``dtype`` attr is read when ``out_dtype`` is absent).  Differentiable:
    the generic ``cast_grad`` casts the cotangent back."""
    x = ctx.read_slot(op, "X")
    dtype = convert_dtype(op.attr("out_dtype", op.attr("dtype", "float32")))
    ctx.write_slot(op, "Out", x.to(dtype.torch_dtype))


@register_infer_shape("cast")
def _cast_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"),
                  convert_dtype(op.attr("out_dtype", op.attr("dtype", "float32"))))


def _infer_reshape(in_sh, target):
    """Fluid reshape semantics: 0 copies the input dim, -1 is inferred."""
    out = [in_sh[i] if d == 0 else d for i, d in enumerate(target)]
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in in_sh:
            total *= d
        out[out.index(-1)] = total // known if known else -1
    return tuple(out)


@register_lowering("reshape")
def _reshape(ctx, op):
    x = ctx.read_slot(op, "X")
    ctx.write_slot(op, "Out", x.reshape(_infer_reshape(tuple(x.shape), op.attr("shape"))))


@register_infer_shape("reshape")
def _reshape_shape(block, op):
    set_out_shape(block, op, "Out",
                  _infer_reshape(in_shape(block, op, "X"), op.attr("shape")),
                  in_dtype(block, op, "X"))


@register_lowering("fill_constant_batch_size_like", no_gradient=True)
def _fill_cbsl(ctx, op):
    """``fill_constant`` of ``shape`` with dim ``output_dim_idx`` taken from
    Input's dim ``input_dim_idx``."""
    shape = list(op.attr("shape"))
    shape[op.attr("output_dim_idx", 0)] = ctx.read_slot(op, "Input").shape[
        op.attr("input_dim_idx", 0)]
    ctx.write_slot(op, "Out", torch.full(tuple(shape), op.attr("value", 0.0),
                                         dtype=_const_dtype(op), device=ctx.device))


@register_infer_shape("fill_constant_batch_size_like")
def _fill_cbsl_shape(block, op):
    shape = list(op.attr("shape"))
    shape[op.attr("output_dim_idx", 0)] = in_shape(block, op, "Input")[op.attr("input_dim_idx", 0)]
    set_out_shape(block, op, "Out", shape, convert_dtype(op.attr("dtype", "float32")))


@register_lowering("fill_zeros_like", no_gradient=True)
def _fill_zeros_like(ctx, op):
    ctx.write_slot(op, "Out", torch.zeros_like(ctx.read_slot(op, "X")))


@register_lowering("assign")
def _assign(ctx, op):
    """A copy of X: Out may name state that a later op updates in place,
    which must not change X."""
    ctx.write_slot(op, "Out", ctx.read_slot(op, "X").clone())


same_shape("fill_zeros_like")
same_shape("assign")


@register_lowering("assign_value", no_gradient=True)
def _assign_value(ctx, op):
    """A constant of ``shape`` from the literal ``values`` (64-bit types made
    in their 32-bit type, as the JAX package makes them), copied to the
    device once (``device_constant``)."""
    shape, dtype = tuple(op.attr("shape")), _const_dtype(op)

    def make():
        np_dtype = convert_dtype(op.attr("dtype", "float32")).np_dtype
        values = np.asarray(op.attr("values"), dtype=np_dtype).reshape(shape)
        return torch.from_numpy(values).to(ctx.device, dtype)
    key = ("assign_value", str(ctx.device), dtype, shape, tuple(op.attr("values")))
    ctx.write_slot(op, "Out", device_constant(key, make))


@register_lowering("flatten")
def _flatten(ctx, op):
    """X as 2-D: the dims before ``axis`` times each other, and the rest."""
    x = ctx.read_slot(op, "X")
    axis = op.attr("axis", 1)
    ctx.write_slot(op, "Out", x.reshape(math.prod(x.shape[:axis]), math.prod(x.shape[axis:])))


@register_infer_shape("flatten")
def _flatten_shape(block, op):
    sh = in_shape(block, op, "X")
    axis = op.attr("axis", 1)
    set_out_shape(block, op, "Out", (math.prod(sh[:axis]), math.prod(sh[axis:])),
                  in_dtype(block, op, "X"))


@register_lowering("transpose")
def _transpose(ctx, op):
    ctx.write_slot(op, "Out", ctx.read_slot(op, "X").permute(tuple(op.attr("axis"))))


@register_infer_shape("transpose")
def _transpose_shape(block, op):
    sh = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", tuple(sh[a] for a in op.attr("axis")),
                  in_dtype(block, op, "X"))


@register_lowering("concat")
def _concat(ctx, op):
    ctx.write_slot(op, "Out", torch.cat(ctx.read_slot_list(op, "X"), dim=op.attr("axis", 0)))


@register_infer_shape("concat")
def _concat_shape(block, op):
    shapes = [tuple(block.find_var(n).shape) for n in op.input("X")]
    axis = normalize_axis(op.attr("axis", 0), len(shapes[0]))
    out = list(shapes[0])
    out[axis] = sum(s[axis] for s in shapes)
    set_out_shape(block, op, "Out", out, in_dtype(block, op, "X"))


@register_lowering("split")
def _split(ctx, op):
    """X cut along ``axis`` into ``sections`` (sizes) or ``num`` equal parts,
    one per name of Out."""
    x = ctx.read_slot(op, "X")
    axis = normalize_axis(op.attr("axis", 0), x.ndim)
    sections = op.attr("sections")
    if sections:
        # cut at the offsets of sections[:-1]: the last part takes the rest,
        # whatever the last section says (the JAX lowering's jnp.split)
        offsets, at = [], 0
        for s in sections[:-1]:
            at += int(s)
            offsets.append(at)
        parts = torch.tensor_split(x, offsets, dim=axis)
    else:
        num = op.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does not divide "
                             f"into {num} equal parts")
        parts = torch.tensor_split(x, num, dim=axis)
    for name, part in zip(op.output("Out"), parts):
        ctx.write(name, part)


@register_infer_shape("split")
def _split_shape(block, op):
    sh = list(in_shape(block, op, "X"))
    axis = normalize_axis(op.attr("axis", 0), len(sh))
    names = op.output("Out")
    sections = op.attr("sections")
    if not sections:
        sections = [sh[axis] // len(names)] * len(names)
    for i, name in enumerate(names):
        s = list(sh)
        s[axis] = sections[i]
        vd = block.find_var(name)
        if vd is not None:
            vd.shape = tuple(s)


@register_lowering("stack")
def _stack(ctx, op):
    ctx.write_slot(op, "Y", torch.stack(ctx.read_slot_list(op, "X"), dim=op.attr("axis", 0)))


@register_infer_shape("stack")
def _stack_shape(block, op):
    sh = list(in_shape(block, op, "X"))
    axis = op.attr("axis", 0)
    if axis < 0:
        axis += len(sh) + 1
    sh.insert(axis, len(op.inputs.get("X", [])))
    set_out_shape(block, op, "Y", tuple(sh), in_dtype(block, op, "X"))


@register_lowering("squeeze")
def _squeeze(ctx, op):
    """X without the dims ``axes`` (each must be of size 1: the JAX
    lowering's ``jnp.squeeze`` raises otherwise, where ``torch.squeeze``
    would keep the dim), or without every dim of size 1 when ``axes`` is
    empty."""
    x = ctx.read_slot(op, "X")
    axes = [normalize_axis(a, x.ndim) for a in op.attr("axes", [])]
    if not axes:
        ctx.write_slot(op, "Out", x.squeeze())
        return
    bad = [a for a in axes if x.shape[a] != 1]
    if bad:
        raise ValueError(f"squeeze: axes {bad} of X's shape {tuple(x.shape)} are not of size 1")
    ctx.write_slot(op, "Out", x.reshape([d for i, d in enumerate(x.shape) if i not in axes]))


@register_lowering("unsqueeze")
def _unsqueeze(ctx, op):
    x = ctx.read_slot(op, "X")
    for a in sorted(op.attr("axes")):
        x = x.unsqueeze(a)
    ctx.write_slot(op, "Out", x)


@register_infer_shape("squeeze")
def _squeeze_shape(block, op):
    xs = list(in_shape(block, op, "X"))
    axes = [a % len(xs) for a in op.attr("axes", [])]
    out = ([d for i, d in enumerate(xs) if i not in axes] if axes
           else [d for d in xs if d != 1])
    set_out_shape(block, op, "Out", tuple(out), in_dtype(block, op, "X"))


@register_infer_shape("unsqueeze")
def _unsqueeze_shape(block, op):
    out = list(in_shape(block, op, "X"))
    for a in sorted(op.attr("axes")):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    set_out_shape(block, op, "Out", tuple(out), in_dtype(block, op, "X"))


def _fill_value(dtype: torch.dtype):
    """What the JAX lowering's ``jnp.take`` writes for an index out of range:
    NaN for floating types, the most negative value for signed integers,
    True for booleans."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


@register_lowering("gather", non_diff_inputs=("Index",))
def _gather(ctx, op):
    """Rows of X at ``Index`` (any shape: Out is Index's shape + X's row
    shape).  An index in [-rows, 0) counts from the end; one outside
    [-rows, rows) gives a row of :func:`_fill_value`, as ``jnp.take``."""
    x = ctx.read_slot(op, "X")
    idx = ctx.read_slot(op, "Index").to(torch.int64)
    rows = x.shape[0]
    inside = (idx >= -rows) & (idx < rows)
    flat = torch.where(idx < 0, idx + rows, idx).clamp(0, max(rows - 1, 0)).reshape(-1)
    out = torch.index_select(x, 0, flat).reshape(tuple(idx.shape) + tuple(x.shape[1:]))
    keep = inside.reshape(tuple(idx.shape) + (1,) * (x.ndim - 1))
    ctx.write_slot(op, "Out", torch.where(keep, out, _fill_value(x.dtype)))


@register_infer_shape("gather")
def _gather_shape(block, op):
    xs = in_shape(block, op, "X")
    isx = in_shape(block, op, "Index")
    set_out_shape(block, op, "Out", tuple(isx) + tuple(xs[1:]), in_dtype(block, op, "X"))


@register_lowering("slice")
def _slice(ctx, op):
    """``Input[starts:ends]`` along ``axes``, bounds clamped as Python
    slicing clamps them."""
    x = ctx.read_slot(op, "Input")
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        idx[a] = slice(s, e)
    ctx.write_slot(op, "Out", x[tuple(idx)])


@register_lowering("expand")
def _expand(ctx, op):
    """X tiled ``expand_times`` times along each dim (``jnp.tile``: a copy,
    not a broadcast view)."""
    x = ctx.read_slot(op, "X")
    times = tuple(op.attr("expand_times"))
    ctx.write_slot(op, "Out", x.repeat((1,) * (x.ndim - len(times)) + times))


@register_lowering("pad")
def _pad(ctx, op):
    """X padded by ``paddings`` (before and after each dim, in dim order)
    with ``pad_value``."""
    x = ctx.read_slot(op, "X")
    p = op.attr("paddings")
    flat = [int(v) for i in reversed(range(x.ndim)) for v in (p[2 * i], p[2 * i + 1])]
    ctx.write_slot(op, "Out", F.pad(x, flat, value=op.attr("pad_value", 0.0)))


@register_lowering("one_hot", no_gradient=True)
def _one_hot(ctx, op):
    """float32 rows of ``depth``, 1 at each id (a trailing dim of 1 is
    squeezed first).  An id outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    x = ctx.read_slot(op, "X")
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = op.attr("depth")
    classes = torch.arange(depth, device=x.device, dtype=torch.int32)
    ctx.write_slot(op, "Out", (x.to(torch.int32).unsqueeze(-1) == classes).to(torch.float32))


def _arg_reduce(op_type, fn):
    """Index of the first largest (smallest) entry along ``axis``, declared
    int64 and made int32 as the JAX package makes it with 64-bit mode off."""
    @register_lowering(op_type, no_gradient=True)
    def _low(ctx, op):
        out = fn(ctx.read_slot(op, "X"), dim=op.attr("axis", -1))
        ctx.write_slot(op, "Out", out.to(coerce_feed_dtype(DataType.INT64).torch_dtype))


_arg_reduce("arg_max", torch.argmax)
_arg_reduce("arg_min", torch.argmin)


@register_lowering("top_k", no_gradient=True)
def _top_k(ctx, op):
    """The ``k`` largest entries of the last dim, in descending order, and
    their indices.  The indices are declared int64 and made int32, as the
    JAX package makes them with 64-bit mode off."""
    vals, idx = torch.topk(ctx.read_slot(op, "X"), op.attr("k", 1), dim=-1)
    ctx.write_slot(op, "Out", vals)
    ctx.write_slot(op, "Indices", idx.to(coerce_feed_dtype(DataType.INT64).torch_dtype))


@register_infer_shape("top_k")
def _top_k_shape(block, op):
    sh = list(in_shape(block, op, "X"))
    sh[-1] = op.attr("k", 1)
    set_out_shape(block, op, "Out", sh, in_dtype(block, op, "X"))
    set_out_shape(block, op, "Indices", sh, DataType.INT64)


mark_no_gradient("shape", "one_hot", "arg_max", "arg_min", "top_k", "is_empty")


@register_lowering("is_empty", no_gradient=True)
def _is_empty(ctx, op):
    """Whether X has no element: a boolean scalar made on the device from
    the static size (a fill, which a graph records)."""
    x = ctx.read_slot(op, "X")
    ctx.write_slot(op, "Out", torch.full((), x.numel() == 0, dtype=torch.bool,
                                         device=ctx.device))


@register_lowering("where", non_diff_inputs=("Condition",))
def _where(ctx, op):
    """Elementwise select: X where Condition holds, else Y (IfElse's merge
    and DynamicRNN's masked memory update).  A [N, 1] condition selects
    the rows of rank-1 [N] values; a lower-rank one broadcasts over the
    trailing dims."""
    cond = ctx.read_slot(op, "Condition").to(torch.bool)
    x, y = ctx.read_slot(op, "X"), ctx.read_slot(op, "Y")
    while cond.ndim > x.ndim and cond.shape[-1] == 1:
        cond = cond[..., 0]
    if cond.ndim > x.ndim:
        raise ValueError(f"where: condition rank {cond.ndim} exceeds value rank {x.ndim} "
                         f"and is not squeezable")
    while cond.ndim < x.ndim:
        cond = cond[..., None]
    ctx.write_slot(op, "Out", torch.where(cond, x, y))


same_shape("where")
