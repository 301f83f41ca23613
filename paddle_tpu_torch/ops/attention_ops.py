"""Fused attention as a framework op, and the position-id indexer.

``flash_attention`` splits heads into the kernel's [N*H, T, d] layout and
runs the hand-written flash-attention forward (ops/cuda/flash_attention.py)
through its autograd Function, masking keys by the @SEQ_LEN lengths of
**K** -- so cross-attention masks by source lengths -- and causally when
the op says so.  The ``pallas-kernels`` pass's ``pallas_kernel`` stamp is
honoured as the JAX package honours it: ``True`` (or no stamp) launches
the kernel on a CUDA tensor, ``False`` runs the plain composed attention
(``flash_attn_fwd_plain``) on a CPU tensor and raises on a CUDA tensor,
where the port has no attention but the kernel.  The generic
``flash_attention_grad`` differentiates either.
"""
from __future__ import annotations

import math

import torch

from ..core.lower import SEQ_LEN_AWARE, SEQ_LEN_SUFFIX
from ..core.registry import register_infer_shape, register_lowering
from ..core.dtypes import convert_dtype
from .common import in_dtype, in_shape, set_out_shape
from .cuda.flash_attention import HEAD_DIMS, FlashAttention, flash_attn_fwd_plain
from .cuda.kernel_pass import KERNEL_DECISION_ATTR

SEQ_LEN_AWARE.add("flash_attention")


@register_lowering("flash_attention")
def _flash_attention_op(ctx, op):
    q = ctx.read_slot(op, "Q")          # [N, Tq, H*D]
    k = ctx.read_slot(op, "K")          # [N, Tk, H*D]
    v = ctx.read_slot(op, "V")
    num_heads = int(op.attr("num_heads", 1))
    n, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // num_heads
    kv_lens = ctx.read_opt(op.input("K")[0] + SEQ_LEN_SUFFIX)
    if kv_lens is not None:
        kv_lens = kv_lens.reshape(-1).to(torch.int32).repeat_interleave(num_heads)

    def split(x, t):
        return (x.reshape(n, t, num_heads, d).transpose(1, 2)
                .reshape(n * num_heads, t, d).contiguous())

    args = (split(q, tq), split(k, tk), split(v, tk), kv_lens,
            bool(op.attr("causal", False)), 1.0 / math.sqrt(d))
    if op.attr(KERNEL_DECISION_ATTR, True):
        out = FlashAttention.apply(*args)
    elif q.device.type == "cpu":
        out = flash_attn_fwd_plain(*args)[0]
    else:
        reason = (f"head_dim {d} is not one K1 takes {HEAD_DIMS}" if d not in HEAD_DIMS
                  else "the kernel policy disables flash_attention")
        raise NotImplementedError(
            f"flash_attention stamped {KERNEL_DECISION_ATTR}=False ({reason}) on a "
            f"{q.device.type} tensor: the port has no attention for the card besides K1")
    out = out.reshape(n, num_heads, tq, d).transpose(1, 2).reshape(n, tq, hd)
    ctx.write_slot(op, "Out", out)
    q_lens = ctx.read_opt(op.input("Q")[0] + SEQ_LEN_SUFFIX)
    if q_lens is not None:
        ctx.write(op.output("Out")[0] + SEQ_LEN_SUFFIX, q_lens)


@register_infer_shape("flash_attention")
def _flash_attention_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "Q"),
                  in_dtype(block, op, "Q"))


@register_lowering("position_ids", no_gradient=True)
def _position_ids(ctx, op):
    """[N, T] int32 position ids; T > max_len is rejected rather than
    silently reusing the last position embedding."""
    x = ctx.read_slot(op, "X")
    n, t = x.shape[0], x.shape[1]
    max_len = op.attr("max_len", None)
    if max_len is not None and t > int(max_len):
        raise ValueError(
            f"position_ids: sequence length {t} exceeds the position "
            f"table max_len={max_len}; raise max_len or shorten sequences")
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    ctx.write_slot(op, "Out", pos[None, :].expand(n, t))


@register_infer_shape("position_ids")
def _position_ids_shape(block, op):
    xs = in_shape(block, op, "X")
    max_len = op.attr("max_len", None)
    # desc dims may be -1; only a known-positive T can be checked here
    if (max_len is not None and len(xs) >= 2 and xs[1] > 0
            and xs[1] > int(max_len)):
        raise ValueError(
            f"position_ids: sequence length {xs[1]} exceeds the position "
            f"table max_len={max_len}; raise max_len or shorten sequences")
    set_out_shape(block, op, "Out", tuple(xs[:2]), convert_dtype("int32"))
