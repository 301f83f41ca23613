"""Tensor creation, dtype and shape op lowerings: fill_constant (and its
batch-size-like and zeros-like forms), assign, cast, reshape, transpose,
concat, split and top_k.

A constant of a 64-bit type is made in its 32-bit type, as the JAX
package's ``jnp.full`` makes it with 64-bit mode off (its default): an
int64 step counter is int32 in both packages' scopes, so a saved
directory loads in either."""
from __future__ import annotations

import torch

from ..core.dtypes import DataType, coerce_feed_dtype, convert_dtype
from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, normalize_axis, same_shape, set_out_shape


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
