"""Sequence (LoD) ops on the padded-dense + lengths representation.

A ragged batch is a padded ``[N, T, ...]`` tensor (batch-major, T the
batch's padded length) and its int32 ``[N]`` lengths, carried in the
environment as ``<var>@SEQ_LEN`` (fed with the batch, propagated by the
ops that keep the time axis).  Masked compute replaces the reference's
offset arithmetic, as in the JAX package's ``ops/sequence_ops.py``, whose
17 op types these are, lowering for lowering.

Lengths stay on the device: no op reads them on the host or takes a shape
from them, so a step that runs these ops may be one CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.desc import OpDesc
from ..core.dtypes import DataType, coerce_feed_dtype, convert_dtype
from ..core.lower import SEQ_LEN_AWARE, SEQ_LEN_SUFFIX, LowerCtx
from ..core.registry import mark_no_gradient, register_infer_shape, register_lowering
from ..lod import seq_len_name
from .common import device_constant, in_dtype, in_shape, set_out_shape

# these ops set and consume lengths themselves; the generic propagation must
# not overwrite their choices (sequence_pool's [N, D] output has no time
# axis even where D == T by coincidence)
SEQ_LEN_AWARE.update({
    "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_conv",
    "sequence_reshape", "sequence_mask", "sequence_first_step",
    "sequence_last_step", "sequence_length",
    "sequence_pad", "sequence_unpad", "sequence_slice",
    "sequence_erase", "lod_reset", "row_conv",
})

_INT32 = torch.int32


def _narrowed(dtype) -> torch.dtype:
    """``dtype`` as the JAX package makes it with 64-bit mode off."""
    return coerce_feed_dtype(convert_dtype(dtype)).torch_dtype


def _lens_for(ctx: LowerCtx, op: OpDesc, slot: str = "X"):
    """The lengths of the (first) input of ``slot``, or None (full T)."""
    return ctx.read_opt(op.input(slot)[0] + SEQ_LEN_SUFFIX)


def _time_mask(x: torch.Tensor, lens) -> torch.Tensor:
    """``[N, T]`` boolean mask, True where a step is inside its row."""
    n, t = x.shape[0], x.shape[1]
    if lens is None:
        return torch.ones((n, t), dtype=torch.bool, device=x.device)
    return torch.arange(t, device=x.device)[None, :] < lens.reshape(-1, 1)


def _bcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - mask.ndim))


def _zero_outside(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(_bcast_mask(mask, x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _propagate(ctx: LowerCtx, op: OpDesc, lens, out_slot: str = "Out"):
    if lens is not None:
        names = op.output(out_slot)
        if names:
            ctx.write(names[0] + SEQ_LEN_SUFFIX, lens)


def _lowest(dtype: torch.dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point else torch.iinfo(dtype).min


def _pool(ctx, op, ptype: str):
    x = ctx.read_slot(op, "X")                       # [N, T, ...]
    lens = _lens_for(ctx, op)
    mask = _bcast_mask(_time_mask(x, lens), x)       # [N, T, 1...]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        out = torch.where(mask, x, zero).sum(dim=1)
        if ptype != "SUM":
            cnt = mask.sum(dim=1).clamp_min(1).to(x.dtype)
            out = out / (cnt if ptype == "AVERAGE" else torch.sqrt(cnt))
    elif ptype == "MAX":
        # amax splits a tie's gradient evenly among the tied steps, as the
        # JAX max reduction does (max(dim) routes it to one index)
        lowest = torch.full((), _lowest(x.dtype), dtype=x.dtype, device=x.device)
        out = torch.where(mask, x, lowest).amax(dim=1)
    elif ptype == "LAST":
        if lens is None:
            idx = torch.full((x.shape[0],), x.shape[1] - 1, dtype=torch.int64, device=x.device)
        else:
            # an empty row's index -1 (wrapped by the JAX gather) is clamped
            # here, and the row zeroed below either way
            idx = (lens.reshape(-1).to(torch.int64) - 1).clamp_min(0)
        idx = idx.reshape((-1, 1) + (1,) * (x.ndim - 2)).expand((-1, 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    if lens is not None and ptype in ("MAX", "LAST", "FIRST"):
        # zero-length rows give exact zeros: MAX would leak the dtype's
        # lowest value, LAST and FIRST would read padding
        empty = (lens.reshape(-1) <= 0).reshape((-1,) + (1,) * (out.ndim - 1))
        out = torch.where(empty, zero, out)
    ctx.write_slot(op, "Out", out)


@register_lowering("sequence_pool")
def _sequence_pool(ctx, op):
    """SUM / AVERAGE / SQRT / MAX / LAST / FIRST over each row's steps;
    ``[N, D]`` out (reference operators/sequence_pool_op.cc)."""
    _pool(ctx, op, str(op.attr("pooltype", "SUM")).upper())


@register_infer_shape("sequence_pool")
def _sequence_pool_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", (xs[0],) + tuple(xs[2:]), in_dtype(block, op, "X"))


@register_lowering("sequence_last_step")
def _sequence_last_step(ctx, op):
    _pool(ctx, op, "LAST")


@register_lowering("sequence_first_step")
def _sequence_first_step(ctx, op):
    _pool(ctx, op, "FIRST")


@register_lowering("sequence_softmax")
def _sequence_softmax(ctx, op):
    """Softmax over each row's steps; padding gives 0."""
    x = ctx.read_slot(op, "X")                        # [N, T]
    lens = _lens_for(ctx, op)
    mask = _time_mask(x, lens)
    lowest = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device)
    out = torch.softmax(torch.where(mask, x, lowest), dim=1)
    ctx.write_slot(op, "Out", _zero_outside(mask, out))
    _propagate(ctx, op, lens)


@register_lowering("sequence_expand")
def _sequence_expand(ctx, op):
    """Tile each row of X along Y's time axis (reference
    sequence_expand_op.cc).  With a 2-level Y (``[N, S, T, ...]`` and its
    ``@SEQ_LEN`` / ``@SEQ_LEN@1`` channels), ``ref_level=0`` expands X per
    sub-sequence (``[N, S, ...]``) and ``ref_level`` 1 or -1 (the innermost)
    per token (``[N, S, T, ...]``)."""
    x = ctx.read_slot(op, "X")                        # [N, D] or [N, T, D]
    y = ctx.read_slot(op, "Y")
    yname = op.input("Y")[0]
    lens = ctx.read_opt(yname + SEQ_LEN_SUFFIX)
    lens1 = ctx.read_opt(seq_len_name(yname, 1))
    ref_level = int(op.attr("ref_level", -1))
    out_name = op.output("Out")[0] if op.output("Out") else ""
    dev = x.device
    if lens1 is not None and ref_level != 0:
        s, t = y.shape[1], y.shape[2]
        out = x[:, None, None].expand((x.shape[0], s, t) + tuple(x.shape[1:]))
        valid = (torch.arange(s, device=dev)[None, :, None] < lens[:, None, None]) & \
                (torch.arange(t, device=dev)[None, None, :] < lens1[:, :, None])
        ctx.write_slot(op, "Out", _zero_outside(valid, out))
        if out_name:
            ctx.write(seq_len_name(out_name, 0), lens)
            ctx.write(seq_len_name(out_name, 1), lens1)
        return
    if lens1 is not None and ref_level == 0:
        out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
        ctx.write_slot(op, "Out", _zero_outside(_time_mask(out, lens), out))
        _propagate(ctx, op, lens)
        return
    if x.ndim == y.ndim:
        out = x
    else:
        out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    ctx.write_slot(op, "Out", _zero_outside(_time_mask(out, lens), out))
    _propagate(ctx, op, lens)


@register_lowering("sequence_concat")
def _sequence_concat(ctx, op):
    """Concatenate along time, each row's valid steps packed to the front
    (reference sequence_concat_op.cc); without lengths a plain concat."""
    xs = ctx.read_slot_list(op, "X")
    lens = [ctx.read_opt(n + SEQ_LEN_SUFFIX) for n in op.input("X")]
    if all(l is None for l in lens):
        ctx.write_slot(op, "Out", torch.cat(xs, dim=1))
        return
    n, dev = xs[0].shape[0], xs[0].device
    total_t = sum(x.shape[1] for x in xs)
    full = torch.cat(xs, dim=1)
    lens_full = [l.reshape(-1).to(_INT32) if l is not None
                 else torch.full((n,), x.shape[1], dtype=_INT32, device=dev)
                 for l, x in zip(lens, xs)]
    stacked = torch.stack(lens_full, 1).to(torch.int64)               # [N, k]
    offs = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(stacked, 1)], 1)                    # [N, k+1]
    # each input's first step in ``full`` (filled on the device: no host
    # copy inside a graph's capture)
    starts = torch.cat([torch.full((n, 1), int(s), dtype=torch.int64, device=dev)
                        for s in np.cumsum([0] + [x.shape[1] for x in xs[:-1]])], 1)
    pos = torch.arange(total_t, device=dev)[None, :]                   # [1, TT]
    seg = (pos[:, :, None] >= offs[:, None, 1:]).sum(-1).clamp(0, len(xs) - 1)
    within = pos - torch.gather(offs, 1, seg)
    src = (torch.gather(starts, 1, seg) + within).clamp(0, total_t - 1)
    src = src.reshape(tuple(src.shape) + (1,) * (full.ndim - 2)).expand(full.shape)
    out = torch.gather(full, 1, src)
    new_lens = sum(lens_full[1:], lens_full[0])
    ctx.write_slot(op, "Out", _zero_outside(_time_mask(out, new_lens), out))
    _propagate(ctx, op, new_lens)


def _shifted(xm: torch.Tensor, off: int) -> torch.Tensor:
    """``xm`` moved ``off`` steps back in time (row t reads t + off), zero
    where t + off leaves [0, T)."""
    t = xm.shape[1]
    shifted = torch.roll(xm, -off, dims=1)
    if off == 0:
        return shifted
    ar = torch.arange(t, device=xm.device)[None, :, None]
    valid = ar < (t - off) if off > 0 else ar >= (-off)
    return torch.where(valid, shifted, torch.zeros((), dtype=xm.dtype, device=xm.device))


@register_lowering("sequence_conv")
def _sequence_conv(ctx, op):
    """Each step's context window [t + start, t + start + len) stacked and
    projected by Filter ``[len * D, M]`` (reference sequence_conv_op.cc):
    shifted copies and one matmul."""
    x = ctx.read_slot(op, "X")                        # [N, T, D]
    filt = ctx.read_slot(op, "Filter")                # [ctx * D, M]
    lens = _lens_for(ctx, op)
    ctx_len = int(op.attr("contextLength"))
    ctx_start = int(op.attr("contextStart", -((ctx_len - 1) // 2)))
    mask = _time_mask(x, lens)
    xm = _zero_outside(mask, x)
    stacked = torch.cat([_shifted(xm, ctx_start + k) for k in range(ctx_len)], dim=-1)
    out = torch.matmul(stacked, filt)
    ctx.write_slot(op, "Out", _zero_outside(mask, out))
    _propagate(ctx, op, lens)


@register_infer_shape("sequence_conv")
def _sequence_conv_shape(block, op):
    xs = in_shape(block, op, "X")
    fs = in_shape(block, op, "Filter")
    set_out_shape(block, op, "Out", tuple(xs[:-1]) + (fs[-1],), in_dtype(block, op, "X"))


@register_lowering("sequence_reshape")
def _sequence_reshape(ctx, op):
    """Rows regrouped to width ``new_dim``; lengths scale by D / new_dim
    (reference sequence_reshape_op.cc)."""
    x = ctx.read_slot(op, "X")                        # [N, T, D]
    new_dim = int(op.attr("new_dim"))
    n, t, d = x.shape
    ctx.write_slot(op, "Out", x.reshape(n, t * d // new_dim, new_dim))
    lens = _lens_for(ctx, op)
    if lens is not None:
        _propagate(ctx, op, (lens * d) // new_dim)


@register_infer_shape("sequence_reshape")
def _sequence_reshape_shape(block, op):
    # the var desc's shape is batchless [T, D] (the data layer's convention)
    xs = in_shape(block, op, "X")
    new_dim = int(op.attr("new_dim"))
    t, d = xs[-2], xs[-1]
    set_out_shape(block, op, "Out", tuple(xs[:-2]) + (t * d // new_dim, new_dim),
                  in_dtype(block, op, "X"))


@register_lowering("sequence_expand_as")
def _sequence_expand_as(ctx, op):
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    lens = ctx.read_opt(op.input("Y")[0] + SEQ_LEN_SUFFIX)
    out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    ctx.write_slot(op, "Out", _zero_outside(_time_mask(out, lens), out))
    _propagate(ctx, op, lens)


@register_lowering("sequence_mask")
def _sequence_mask(ctx, op):
    """``[N, maxlen]`` validity mask from lengths X.  ``maxlen`` comes from
    the attr, else from the time axis of a ``MaxLenLike`` input."""
    lens = ctx.read_slot(op, "X").reshape(-1)
    maxlen = op.attr("maxlen", -1)
    t = int(maxlen) if maxlen and int(maxlen) > 0 else None
    if t is None:
        ref = ctx.read_slot(op, "MaxLenLike")
        if ref is not None:
            t = ref.shape[1]
    if t is None:
        raise ValueError("sequence_mask needs a static maxlen (pass maxlen= or MaxLenLike)")
    mask = torch.arange(t, device=lens.device)[None, :] < lens[:, None]
    ctx.write_slot(op, "Y", mask.to(_narrowed(op.attr("out_dtype", "int64"))))


@register_infer_shape("sequence_mask")
def _sequence_mask_shape(block, op):
    xs = in_shape(block, op, "X")
    maxlen = int(op.attr("maxlen", -1))
    if maxlen <= 0 and op.input("MaxLenLike"):
        ref = in_shape(block, op, "MaxLenLike")
        maxlen = ref[1] if len(ref) > 1 else -1
    set_out_shape(block, op, "Y", (xs[0] if xs else -1, maxlen if maxlen > 0 else -1),
                  convert_dtype(op.attr("out_dtype", "int64")))


@register_lowering("sequence_length")
def _sequence_length(ctx, op):
    """A var's ``@SEQ_LEN`` lengths as an int32 ``[N]`` tensor; full T
    where it has none."""
    x = ctx.read_slot(op, "X")
    lens = _lens_for(ctx, op)
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1], dtype=_INT32, device=x.device)
    ctx.write_slot(op, "Out", lens.reshape(-1).to(_INT32))


@register_infer_shape("sequence_length")
def _sequence_length_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", (xs[0],), DataType.INT32)


mark_no_gradient("sequence_mask", "sequence_length")


# --------------------------------------------------------------------------
# padding, slicing, erasing (reference sequence_pad_op.cc,
# sequence_slice_op.cc, sequence_erase_op.cc, lod_reset_op.cc, row_conv_op.cc)
# --------------------------------------------------------------------------

@register_lowering("sequence_pad")
def _sequence_pad(ctx, op):
    """Re-pad to ``padded_length`` (default T) with PadValue; Length is
    the lengths, capped there."""
    x = ctx.read_slot(op, "X")                        # [N, T, ...]
    pad_value = ctx.read_slot(op, "PadValue")
    lens = _lens_for(ctx, op)
    n, t = x.shape[0], x.shape[1]
    target = int(op.attr("padded_length", -1))
    if target <= 0:
        target = t
    if lens is None:
        lens = torch.full((n,), t, dtype=_INT32, device=x.device)
    lens = lens.reshape(-1)
    if pad_value is not None:
        pv = pad_value.reshape(-1)[0].to(x.dtype)
    else:
        pv = torch.zeros((), dtype=x.dtype, device=x.device)
    if target > t:
        x = torch.cat([x, x.new_zeros((n, target - t) + tuple(x.shape[2:]))], dim=1)
    elif target < t:
        x = x[:, :target]
    mask = torch.arange(target, device=x.device)[None, :] < lens[:, None]
    ctx.write_slot(op, "Out", torch.where(_bcast_mask(mask, x), x, pv))
    ctx.write_slot(op, "Length", lens.clamp_max(target).to(_narrowed("int64")))


@register_infer_shape("sequence_pad")
def _sequence_pad_shape(block, op):
    xs = in_shape(block, op, "X")
    target = int(op.attr("padded_length", -1))
    t = target if target > 0 else (xs[1] if len(xs) > 1 else -1)
    set_out_shape(block, op, "Out", (xs[0], t) + tuple(xs[2:]), in_dtype(block, op, "X"))
    set_out_shape(block, op, "Length", (xs[0],), DataType.INT64)


@register_lowering("sequence_unpad")
def _sequence_unpad(ctx, op):
    """Padded + Length -> ragged: the padding zeroed and ``@SEQ_LEN``
    installed from Length."""
    x = ctx.read_slot(op, "X")
    lens = ctx.read_slot(op, "Length").reshape(-1).to(_INT32)
    ctx.write_slot(op, "Out", _zero_outside(_time_mask(x, lens), x))
    ctx.write(op.output("Out")[0] + SEQ_LEN_SUFFIX, lens)


@register_infer_shape("sequence_unpad")
def _sequence_unpad_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))


@register_lowering("sequence_slice")
def _sequence_slice(ctx, op):
    """Each row's [Offset, Offset + Length): the same padded T, new
    lengths."""
    x = ctx.read_slot(op, "X")                      # [N, T, ...]
    offset = ctx.read_slot(op, "Offset").reshape(-1).to(_INT32)
    length = ctx.read_slot(op, "Length").reshape(-1).to(_INT32)
    n, t = x.shape[0], x.shape[1]
    idx = (torch.arange(t, device=x.device)[None, :] + offset[:, None]).clamp_max(t - 1)
    idx = idx.to(torch.int64).reshape((n, t) + (1,) * (x.ndim - 2)).expand(x.shape)
    gathered = torch.gather(x, 1, idx)
    ctx.write_slot(op, "Out", _zero_outside(_time_mask(x, length), gathered))
    ctx.write(op.output("Out")[0] + SEQ_LEN_SUFFIX, length)


@register_infer_shape("sequence_slice")
def _sequence_slice_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))


@register_lowering("sequence_erase")
def _sequence_erase(ctx, op):
    """Remove the listed tokens from each row and pack the rest to the
    front (reference sequence_erase_op.cc)."""
    x = ctx.read_slot(op, "X")                      # [N, T] ids (or [N, T, 1])
    tokens = [int(v) for v in op.attr("tokens", [])]
    squeeze_back = x.ndim == 3 and x.shape[-1] == 1
    if squeeze_back:
        x = x[:, :, 0]
    n, t = x.shape
    lens = _lens_for(ctx, op)
    if lens is None:
        lens = torch.full((n,), t, dtype=_INT32, device=x.device)
    in_range = torch.arange(t, device=x.device)[None, :] < lens.reshape(-1)[:, None]
    erase = torch.zeros_like(x, dtype=torch.bool)
    for tok in tokens:
        erase = erase | (x == tok)
    keep = ~erase & in_range
    pos = torch.cumsum(keep.to(_INT32), dim=1) - 1
    # erased steps go to a spare column t, dropped after the scatter
    dest = torch.where(keep, pos, t).to(torch.int64)
    buf = torch.zeros((n, t + 1), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest, torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)))
    out = buf[:, :t]
    if squeeze_back:
        out = out[:, :, None]
    ctx.write_slot(op, "Out", out)
    ctx.write(op.output("Out")[0] + SEQ_LEN_SUFFIX, keep.sum(dim=1).to(_INT32))


mark_no_gradient("sequence_erase")


@register_infer_shape("sequence_erase")
def _sequence_erase_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))


@register_lowering("lod_reset")
def _lod_reset(ctx, op):
    """New lengths for X (reference lod_reset_op.cc): from the lengths in
    Y, or from the offsets in attr ``target_lod``.  Those are copied to
    the device once (``device_constant``), as ``assign_value``'s: a copy
    from pageable host memory cannot be captured in a CUDA graph."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    if y is not None:
        lens = y.reshape(-1).to(_INT32)
    else:
        offsets = tuple(int(v) for v in op.attr("target_lod"))
        lens = device_constant(("lod_reset", str(x.device), offsets), lambda: torch.from_numpy(
            np.diff(np.asarray(offsets)).astype(np.int32)).to(x.device))
    ctx.write_slot(op, "Out", x)
    ctx.write(op.output("Out")[0] + SEQ_LEN_SUFFIX, lens)


@register_infer_shape("lod_reset")
def _lod_reset_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))


@register_lowering("row_conv")
def _row_conv(ctx, op):
    """Lookahead row convolution (reference row_conv_op.cc, DeepSpeech2):
    ``out[t] = sum_k w[k] * x[t + k]``, per-channel weights ``[len, D]``."""
    x = ctx.read_slot(op, "X")                      # [N, T, D]
    w = ctx.read_slot(op, "Filter")                 # [len, D]
    lens = _lens_for(ctx, op)
    mask = _time_mask(x, lens)
    xm = _zero_outside(mask, x)
    out = torch.zeros_like(x)
    for k in range(w.shape[0]):
        out = out + _shifted(xm, k) * w[k][None, None, :]
    ctx.write_slot(op, "Out", _zero_outside(mask, out))
    _propagate(ctx, op, lens)


@register_infer_shape("row_conv")
def _row_conv_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))
