"""NN op lowerings: convolution and its transpose, pooling, batch_norm,
layer_norm, lrn, dropout, lookup_table, softmax and the cross-entropy
losses (``sigmoid_cross_entropy_with_logits`` too).  ``lookup_table``
gathers through the hand-written embedding kernels
(ops/cuda/embedding.py): the gather forward, and the scatter-add as the
gather's gradient.  The convolutions (cuDNN through ``F.conv2d``
and ``F.conv_transpose2d``), pooling, ``batch_norm``, ``lrn``,
``softmax``, ``log_softmax``, ``cross_entropy`` and
``softmax_with_cross_entropy`` are plain PyTorch, as the JAX package
computes them with XLA outside any Pallas kernel; the gradients go through
the generic grad, except ``batch_norm``'s, which has a lowering of its own
(``batch_norm_grad``) as in the JAX package."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.desc import OpDesc, grad_var_name
from ..core.registry import (register_grad_maker, register_infer_shape,
                             register_lowering)
from .common import in_dtype, in_shape, same_shape, set_out_shape
from .cuda.embedding import GatherRows


def _conv_out_size(in_size, k, pad, stride, dilation=1):
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


@register_lowering("conv2d")
def _conv2d(ctx, op):
    """NCHW input, OIHW filter, symmetric padding, ``groups``."""
    ctx.write_slot(op, "Output", F.conv2d(
        ctx.read_slot(op, "Input"), ctx.read_slot(op, "Filter"),
        stride=tuple(op.attr("strides", [1, 1])), padding=tuple(op.attr("paddings", [0, 0])),
        dilation=tuple(op.attr("dilations", [1, 1])), groups=op.attr("groups", 1)))


@register_infer_shape("conv2d")
def _conv2d_shape(block, op):
    xs = in_shape(block, op, "Input")
    ws = in_shape(block, op, "Filter")
    strides = op.attr("strides", [1, 1])
    pads = op.attr("paddings", [0, 0])
    dil = op.attr("dilations", [1, 1])
    oh = _conv_out_size(xs[2], ws[2], pads[0], strides[0], dil[0])
    ow = _conv_out_size(xs[3], ws[3], pads[1], strides[1], dil[1])
    set_out_shape(block, op, "Output", (xs[0], ws[0], oh, ow), in_dtype(block, op, "Input"))


@register_lowering("depthwise_conv2d")
def _depthwise_conv2d(ctx, op):
    """One group a channel; as in the JAX lowering, ``dilations`` is not
    read (and the JAX package registers no infer-shape rule for it)."""
    x = ctx.read_slot(op, "Input")
    ctx.write_slot(op, "Output", F.conv2d(
        x, ctx.read_slot(op, "Filter"), stride=tuple(op.attr("strides", [1, 1])),
        padding=tuple(op.attr("paddings", [0, 0])), groups=x.shape[1]))


@register_lowering("conv2d_transpose")
def _conv2d_transpose(ctx, op):
    """The gradient of a convolution with respect to its input: NCHW
    input, filter (in, out, kh, kw), output (H - 1) * stride - 2 * pad +
    dilation * (kh - 1) + 1.  As in the JAX lowering, ``groups`` and any
    requested output size are not read."""
    ctx.write_slot(op, "Output", F.conv_transpose2d(
        ctx.read_slot(op, "Input"), ctx.read_slot(op, "Filter"),
        stride=tuple(op.attr("strides", [1, 1])), padding=tuple(op.attr("paddings", [0, 0])),
        dilation=tuple(op.attr("dilations", [1, 1]))))


@register_lowering("pool2d")
def _pool2d(ctx, op):
    """Max or average pooling over NCHW, output sizes floored (the JAX
    lowering's ``reduce_window``, whatever ``ceil_mode`` says).  Max pads
    with -inf.  Average divides by the in-bounds count of each window when
    ``exclusive`` is set and there is padding, else by kh * kw.  torch's
    pooling pads at most half a window; a wider pad is applied first."""
    x = ctx.read_slot(op, "X")
    is_max = op.attr("pooling_type", "max") == "max"
    ksize, strides, pads = (tuple(op.attr(k, d)) for k, d in (
        ("ksize", [2, 2]), ("strides", [2, 2]), ("paddings", [0, 0])))
    if op.attr("global_pooling", False):     # one window over H x W
        out = x.amax((2, 3), keepdim=True) if is_max else x.mean((2, 3), keepdim=True)
    elif is_max:
        if pads[0] > ksize[0] // 2 or pads[1] > ksize[1] // 2:
            x = F.pad(x, (pads[1], pads[1], pads[0], pads[0]), value=float("-inf"))
            pads = (0, 0)
        out = F.max_pool2d(x, ksize, strides, pads)
    else:
        exclusive = bool(op.attr("exclusive", True) and (pads[0] or pads[1]))
        if pads[0] > ksize[0] // 2 or pads[1] > ksize[1] // 2:
            padding = (pads[1], pads[1], pads[0], pads[0])
            summed = F.avg_pool2d(F.pad(x, padding), ksize, strides,
                                  divisor_override=1)
            if exclusive:
                ones = F.pad(torch.ones_like(x[:1, :1]), padding)
                out = summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)
            else:
                out = summed / (ksize[0] * ksize[1])
        else:
            out = F.avg_pool2d(x, ksize, strides, pads, count_include_pad=not exclusive)
    ctx.write_slot(op, "Out", out)


@register_infer_shape("pool2d")
def _pool2d_shape(block, op):
    """The JAX package's rule, ``ceil_mode`` included (its runtime floors:
    ROADMAP.md, faults of the reference)."""
    xs = in_shape(block, op, "X")
    if op.attr("global_pooling", False):
        set_out_shape(block, op, "Out", (xs[0], xs[1], 1, 1), in_dtype(block, op, "X"))
        return
    ksize = op.attr("ksize", [2, 2])
    strides = op.attr("strides", [2, 2])
    pads = op.attr("paddings", [0, 0])
    ceil = op.attr("ceil_mode", False)

    def osz(i, k, p, s):
        if ceil:
            return (xs[i] - k + 2 * p + s - 1) // s + 1
        return (xs[i] - k + 2 * p) // s + 1

    set_out_shape(block, op, "Out",
                  (xs[0], xs[1], osz(2, ksize[0], pads[0], strides[0]),
                   osz(3, ksize[1], pads[1], strides[1])),
                  in_dtype(block, op, "X"))


def _bn_dims(x):
    """(the reduced dims, the [C] broadcast shape) of a batch_norm input:
    N, H, W of NCHW, N of NC."""
    return (0,) + tuple(range(2, x.ndim)), (1, -1) + (1,) * (x.ndim - 2)


def _bn_stats(x, dims):
    """The batch's float32 mean and biased variance.  A bf16 input is
    reduced with float32 accumulation as E[x^2] - E[x]^2, clamped at 0,
    the square taken in float32 (XLA keeps the JAX lowering's bf16 square
    in float32 before the float32 mean: its default excess precision);
    float32 in one pass of ``var_mean`` (the JAX lowering's ``jnp.var`` is
    two-pass: the same statistics, rounded otherwise)."""
    if x.dtype == torch.bfloat16:
        m = x.mean(dims, dtype=torch.float32)
        m2 = x.float().square().mean(dims)
        return m, torch.clamp(m2 - m.square(), min=0.0)
    var, m = torch.var_mean(x, dims, correction=0)
    return m, var


def _bn_coeffs(mean, var, scale, bias, eps):
    """(a, b, inv) of the normalization as one affine y = x * a + b, with
    a = scale * inv and b = bias - mean * scale * inv in float32, inv =
    rsqrt(var + eps)."""
    inv = torch.rsqrt(var + eps)
    return (scale * inv).float(), (bias - mean * scale * inv).float(), inv


def _bn_affine(x, a, b, bshape):
    """x * a + b in float32 (a widening multiply-add), written in x's dtype."""
    return (x.float() * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)


@register_lowering("batch_norm")
def _batch_norm(ctx, op):
    """Training mode normalizes with the batch's statistics, writes the
    running statistics as ``momentum * running + (1 - momentum) * batch``
    (the biased variance in both places) into MeanOut / VarianceOut (the
    same state as Mean / Variance), and saves the batch mean and
    1/sqrt(var + eps).  Test mode (the op's ``is_test``) normalizes with
    the running statistics and writes nothing else."""
    x = ctx.read_slot(op, "X")
    scale, bias = ctx.read_slot(op, "Scale"), ctx.read_slot(op, "Bias")
    mean, var = ctx.read_slot(op, "Mean"), ctx.read_slot(op, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    dims, bshape = _bn_dims(x)
    if op.attr("is_test", False):
        use_mean, use_var = mean, var
    else:
        use_mean, use_var = _bn_stats(x, dims)
        # float32 sums, as XLA computes the JAX lowering's update; momentum
        # in the running statistics' dtype (a Python float meeting a bf16
        # array is a bf16 in JAX)
        mom = float(torch.tensor(momentum, dtype=mean.dtype))
        ctx.write_slot(op, "MeanOut", mom * mean.float() + (1 - momentum) * use_mean)
        ctx.write_slot(op, "VarianceOut", mom * var.float() + (1 - momentum) * use_var)
        ctx.write_slot(op, "SavedMean", use_mean)
        ctx.write_slot(op, "SavedVariance", 1.0 / torch.sqrt(use_var + eps))
    a, b, _ = _bn_coeffs(use_mean, use_var, scale, bias, eps)
    ctx.write_slot(op, "Y", _bn_affine(x, a, b, bshape))


@register_infer_shape("batch_norm")
def _batch_norm_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Y", xs, in_dtype(block, op, "X"))
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_out_shape(block, op, slot, (xs[1],))


@register_grad_maker("batch_norm")
def _batch_norm_grad_maker(op, block, no_grad_set):
    """``batch_norm_grad`` reads X, Scale, Bias, Mean, Variance, Y and Y's
    gradient and writes the gradients of X, Scale and Bias; the running
    statistics are not differentiated."""
    g = OpDesc(type="batch_norm_grad", attrs=dict(op.attrs))
    for slot in ("X", "Scale", "Bias", "Mean", "Variance"):
        g.inputs[slot] = list(op.input(slot))
    g.inputs["__out__Y"] = list(op.output("Y"))
    g.inputs["__outgrad__Y"] = [grad_var_name(n) for n in op.output("Y")]
    for slot in ("X", "Scale", "Bias"):
        gnames = [grad_var_name(n) if n not in no_grad_set else "" for n in op.input(slot)]
        if any(gnames):
            g.outputs[slot + "@GRAD_SLOT"] = gnames
    return [g]


@register_lowering("batch_norm_grad")
def _batch_norm_grad(ctx, op):
    """The closed form of the gradient of ``batch_norm``'s Y through
    x * a + b.  In training mode the statistics are the batch's, so with
    xhat = (x - mean) * inv over the N reduced elements of a channel:
    dx = a * (dy - mean(dy) - xhat * mean(dy * xhat)); in test mode they
    are constants and dx = a * dy.  dScale = sum(dy * xhat), dBias =
    sum(dy).  Computed in float32; dx is written in X's dtype."""
    x = ctx.read_slot(op, "X")
    scale, bias = ctx.read_slot(op, "Scale"), ctx.read_slot(op, "Bias")
    dy = ctx.read(op.input("__outgrad__Y")[0]).float()
    eps = op.attr("epsilon", 1e-5)
    dims, bshape = _bn_dims(x)
    if op.attr("is_test", False):
        mean, var = ctx.read_slot(op, "Mean"), ctx.read_slot(op, "Variance")
    else:
        mean, var = _bn_stats(x, dims)
    a, _, inv = _bn_coeffs(mean, var, scale, bias, eps)
    xhat = (x.float() - mean.float().reshape(bshape)) * inv.float().reshape(bshape)
    dbias = dy.sum(dims)
    dscale = (dy * xhat).sum(dims)
    if op.attr("is_test", False):
        dx = dy * a.reshape(bshape)
    else:
        n = dy.numel() // dy.shape[1]
        dx = a.reshape(bshape) * (dy - (dbias / n).reshape(bshape)
                                  - xhat * (dscale / n).reshape(bshape))
    for slot, value in (("X", dx.to(x.dtype)), ("Scale", dscale.to(scale.dtype)),
                        ("Bias", dbias.to(bias.dtype))):
        names = op.outputs.get(slot + "@GRAD_SLOT", [])
        if names and names[0]:
            ctx.write(names[0], value)


@register_lowering("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.read_slot(op, "X")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    scale = ctx.read_slot(op, "Scale")
    bias = ctx.read_slot(op, "Bias")
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape((1,) * begin + norm_shape)
    if bias is not None:
        y = y + bias.reshape((1,) * begin + norm_shape)
    ctx.write_slot(op, "Y", y)
    ctx.write_slot(op, "Mean", mean.reshape(x.shape[:begin]))
    ctx.write_slot(op, "Variance", var.reshape(x.shape[:begin]))


@register_infer_shape("layer_norm")
def _layer_norm_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Y", xs, in_dtype(block, op, "X"))
    begin = op.attr("begin_norm_axis", 1)
    set_out_shape(block, op, "Mean", xs[:begin])
    set_out_shape(block, op, "Variance", xs[:begin])


@register_lowering("lrn")
def _lrn(ctx, op):
    """Local response normalization across channels (NCHW): MidOut = k +
    alpha * (the sum of x^2 over the ``n`` channels centred on each, zero
    outside), Out = x / MidOut^beta.  ``k`` defaults to 2.0 when the attr
    is absent (the lowering's default; ``layers.lrn`` writes 1.0).

    Computed in X's dtype op by op, each result rounded to it, with the
    scalars rounded to it first: the JAX lowering's weak-typed Python
    floats take a bf16 array's dtype, and XLA rounds each bf16 op's float32
    result (under ``enable_amp`` ``lrn`` follows its bf16 input)."""
    x = ctx.read_slot(op, "X")
    n = op.attr("n", 5)
    k, alpha, beta = (float(torch.tensor(op.attr(a, d), dtype=x.dtype))
                      for a, d in (("k", 2.0), ("alpha", 1e-4), ("beta", 0.75)))
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    ctx.write_slot(op, "MidOut", mid)
    ctx.write_slot(op, "Out", x / torch.pow(mid, beta))


same_shape("lrn", out_slots=("Out", "MidOut"))


def _dropout_draws(op) -> bool:
    return not op.attr("is_test", False) and op.attr("dropout_prob", 0.5) != 0.0


@register_lowering("dropout", draws=_dropout_draws)
def _dropout(ctx, op):
    x = ctx.read_slot(op, "X")
    prob = op.attr("dropout_prob", 0.5)
    if not _dropout_draws(op):
        ctx.write_slot(op, "Out", x)
        ctx.write_slot(op, "Mask", torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.generator, device=x.device) >= prob
    if op.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - prob), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    ctx.write_slot(op, "Mask", keep.to(x.dtype))
    ctx.write_slot(op, "Out", out)


@register_infer_shape("dropout")
def _dropout_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Out", xs, in_dtype(block, op, "X"))
    set_out_shape(block, op, "Mask", xs, in_dtype(block, op, "X"))


@register_grad_maker("dropout")
def _dropout_grad_maker(op, block, no_grad_set):
    """The gradient reads the forward's saved Mask: re-running the forward
    would draw a different mask."""
    xname = op.input("X")[0]
    if xname in no_grad_set:
        return []
    g = OpDesc(type="dropout_grad", attrs=dict(op.attrs))
    g.inputs["Mask"] = list(op.output("Mask"))
    g.inputs["OutGrad"] = [grad_var_name(n) for n in op.output("Out")]
    g.outputs["XGrad"] = [grad_var_name(xname)]
    return [g]


@register_lowering("dropout_grad")
def _dropout_grad(ctx, op):
    mask = ctx.read_slot(op, "Mask")
    dy = ctx.read_slot(op, "OutGrad")
    prob = op.attr("dropout_prob", 0.5)
    if op.attr("is_test", False):
        ctx.write_slot(op, "XGrad", dy)
    elif op.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train":
        ctx.write_slot(op, "XGrad", dy * mask / (1.0 - prob))
    else:
        ctx.write_slot(op, "XGrad", dy * mask)


def flat_ids(ids):
    """(Ids without a trailing 1 dim, the same flattened to int32)."""
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids, ids.reshape(-1).to(torch.int32).contiguous()


def lookup_rows(ctx, op, gather):
    """``lookup_table``'s output through ``gather(W, flat int32 ids)``, with
    the ``padding_idx`` rows zeroed.  Under a mesh the gather runs on each
    rank's ids against the whole table (W replicated for the kernel), and
    W's gradient is a partial sum over the ranks that hold other ids."""
    w = ctx.read_slot(op, "W")
    ids = ctx.read_slot(op, "Ids")
    padding_idx = op.attr("padding_idx", -1)

    def rows(w, ids):
        ids, flat = flat_ids(ids)
        out = gather(w.contiguous(), flat).reshape(tuple(ids.shape) + (w.shape[1],))
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((ids != padding_idx)[..., None], out, 0.0)
        return out

    if ctx.mesh is None:
        ctx.write_slot(op, "Out", rows(w, ids))
        return
    from ..parallel.layout import batch_like, on_local, partial_where_sharded, replicate
    pl = batch_like(ids, ctx.mesh)
    ctx.write_slot(op, "Out", on_local(ctx.mesh, rows, (w, ids), (replicate(ctx.mesh), pl), pl,
                                       (partial_where_sharded(pl), None)))


@register_lowering("lookup_table", non_diff_inputs=("Ids",))
def _lookup_table(ctx, op):
    """Rows of W at Ids.  Ids outside [0, vocab) give zero rows, the
    semantics of the JAX package's Pallas gather kernel.  The generic
    ``lookup_table_grad`` reaches the scatter-add kernel through
    ``GatherRows``' backward; the padding mask stays here, so it masks the
    gradient rows too."""
    lookup_rows(ctx, op, GatherRows.apply)


@register_infer_shape("lookup_table")
def _lookup_table_shape(block, op):
    ws = in_shape(block, op, "W")
    ids = in_shape(block, op, "Ids")
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    set_out_shape(block, op, "Out", tuple(ids) + (ws[-1],),
                  in_dtype(block, op, "W"))


@register_lowering("sigmoid_cross_entropy_with_logits", non_diff_inputs=("Label",))
def _sigmoid_ce(ctx, op):
    """max(x, 0) - x * label + log1p(exp(-|x|)), elementwise (the JAX
    lowering's expression); the label is not differentiated."""
    x = ctx.read_slot(op, "X")
    label = ctx.read_slot(op, "Label")
    ctx.write_slot(op, "Out", torch.clamp_min(x, 0) - x * label
                   + torch.log1p(torch.exp(-torch.abs(x))))


@register_lowering("softmax")
def _softmax(ctx, op):
    ctx.write_slot(op, "Out", torch.softmax(ctx.read_slot(op, "X"), dim=-1))


@register_lowering("log_softmax")
def _log_softmax(ctx, op):
    ctx.write_slot(op, "Out", torch.log_softmax(ctx.read_slot(op, "X"),
                                                dim=op.attr("axis", -1)))


same_shape("softmax")
same_shape("log_softmax")


def _pick_label(x, label):
    """``x[..., label]`` as [..., 1] for a hard label against a [..., C]
    input, indexed as the JAX lowerings' ``take_along_axis`` indexes: a
    label in [-C, 0) counts from the end, and a label outside [-C, C)
    picks NaN (one ``where`` over the labels, so no index is ever out of
    bounds for the gather)."""
    if label.ndim == x.ndim and label.shape[-1] == 1:
        label = label.squeeze(-1)
    c = x.shape[-1]
    label = label.long().unsqueeze(-1)
    label = torch.where(label < 0, label + c, label)
    inside = (label >= 0) & (label < c)
    picked = torch.gather(x, -1, torch.where(inside, label, 0))
    return torch.where(inside, picked, float("nan"))


@register_lowering("cross_entropy", non_diff_inputs=("Label",))
def _cross_entropy(ctx, op):
    """X is a probability distribution over its last dim: a hard label
    indexes it (Y = -log X[label]), a soft label is dotted with log X."""
    x = ctx.read_slot(op, "X")
    label = ctx.read_slot(op, "Label")
    if op.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=1e-20)), dim=-1, keepdim=True)
    else:
        loss = -torch.log(torch.clamp(_pick_label(x, label), min=1e-20))
    ctx.write_slot(op, "Y", loss)


@register_infer_shape("cross_entropy")
def _cross_entropy_shape(block, op):
    xs = in_shape(block, op, "X")
    set_out_shape(block, op, "Y", tuple(xs[:-1]) + (1,), in_dtype(block, op, "X"))


@register_lowering("softmax_with_cross_entropy", non_diff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, op):
    """Softmax = exp(log_softmax(Logits)); Loss = -log_softmax at the hard
    label, or the soft label's dot with it, [..., 1]."""
    logits = ctx.read_slot(op, "Logits")
    label = ctx.read_slot(op, "Label")
    logp = torch.log_softmax(logits, dim=-1)
    ctx.write_slot(op, "Softmax", torch.exp(logp))
    if op.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -_pick_label(logp, label)
    ctx.write_slot(op, "Loss", loss)


@register_infer_shape("softmax_with_cross_entropy")
def _swce_shape(block, op):
    xs = in_shape(block, op, "Logits")
    dt = in_dtype(block, op, "Logits")
    set_out_shape(block, op, "Softmax", xs, dt)
    set_out_shape(block, op, "Loss", tuple(xs[:-1]) + (1,), dt)


@register_lowering("square_error_cost")
def _square_error_cost(ctx, op):
    ctx.write_slot(op, "Out", torch.square(ctx.read_slot(op, "X") - ctx.read_slot(op, "Y")))


same_shape("square_error_cost")
