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

Under a mesh the kernel runs on each rank's shard (the batch over its
axes, the heads over ``tp``); with ``use_ring`` and a ``seq`` axis the op
is ring attention over that axis, the JAX lowering's branch.
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


def _attend(q, k, v, kv_lens, num_heads: int, d: int, causal: bool, use_kernel: bool):
    """Attention of local tensors q [N, Tq, H*d], k and v [N, Tk, H*d] with
    the row lengths ``kv_lens`` [N] (or None): the heads split into the
    kernel's [N*H, T, d] layout, K1 through its autograd Function, merged
    back.  ``num_heads`` is the heads these tensors hold."""
    n, tq, hd = q.shape
    tk = k.shape[1]
    if kv_lens is not None:
        kv_lens = kv_lens.reshape(-1).to(torch.int32).repeat_interleave(num_heads)

    def split(x, t):
        return (x.reshape(n, t, num_heads, d).transpose(1, 2)
                .reshape(n * num_heads, t, d).contiguous())

    args = (split(q, tq), split(k, tk), split(v, tk), kv_lens, causal, 1.0 / math.sqrt(d))
    if use_kernel:
        out = FlashAttention.apply(*args)
    elif q.device.type == "cpu":
        out = flash_attn_fwd_plain(*args)[0]
    else:
        reason = (f"head_dim {d} is not one K1 takes {HEAD_DIMS}" if d not in HEAD_DIMS
                  else "the kernel policy disables flash_attention")
        raise NotImplementedError(
            f"flash_attention stamped {KERNEL_DECISION_ATTR}=False ({reason}) on a "
            f"{q.device.type} tensor: the port has no attention for the card besides K1")
    return out.reshape(n, num_heads, tq, d).transpose(1, 2).reshape(n, tq, hd)


def _ring(ctx, op, q, k, v, kv_lens, num_heads: int, d: int, causal: bool):
    """``use_ring`` under a mesh with the ``seq`` axis: ring attention over
    it (``parallel/ring_attention.py``), the JAX lowering's branch."""
    if kv_lens is not None:
        raise ValueError(
            "flash_attention(use_ring=True) does not support ragged "
            "keys (@SEQ_LEN) — pad to full length or drop use_ring")
    n, tq, hd = q.shape
    tk = k.shape[1]
    if tq != tk:
        raise ValueError("ring attention requires self-attention (Tq == Tk)")
    from ..parallel.ring_attention import ring_attention
    batch_axis = str(op.attr("ring_batch_axis", "data"))
    if batch_axis not in ctx.mesh.shape:
        batch_axis = None       # seq-only mesh: batch replicated

    def split(x, t):
        return x.reshape(n, t, num_heads, d).transpose(1, 2)
    out = ring_attention(split(q, tq), split(k, tk), split(v, tk), ctx.mesh,
                         seq_axis=str(op.attr("ring_seq_axis", "seq")),
                         batch_axis=batch_axis, causal=causal)
    # the sequence gathered back: the ops after this one flatten [N, T]
    # (an fc), which DTensor cannot do with T sharded
    from ..parallel.layout import batch_like
    out = out.redistribute(ctx.mesh.device_mesh, batch_like(out, ctx.mesh))
    return out.transpose(1, 2).reshape(n, tq, hd)


@register_lowering("flash_attention")
def _flash_attention_op(ctx, op):
    q = ctx.read_slot(op, "Q")          # [N, Tq, H*D]
    k = ctx.read_slot(op, "K")          # [N, Tk, H*D]
    v = ctx.read_slot(op, "V")
    num_heads = int(op.attr("num_heads", 1))
    causal = bool(op.attr("causal", False))
    d = q.shape[2] // num_heads
    kv_lens = ctx.read_opt(op.input("K")[0] + SEQ_LEN_SUFFIX)
    use_kernel = bool(op.attr(KERNEL_DECISION_ATTR, True))
    mesh = ctx.mesh
    if mesh is None:
        out = _attend(q, k, v, kv_lens, num_heads, d, causal, use_kernel)
    elif op.attr("use_ring", False) and str(op.attr("ring_seq_axis", "seq")) in mesh.shape:
        out = _ring(ctx, op, q, k, v, kv_lens, num_heads, d, causal)
    else:
        # K1 on each rank's shard: the batch split over its axes and the
        # heads over ``tp`` (a slice of whole heads a rank)
        from ..parallel.layout import batch_like, on_local
        pl = batch_like(q, mesh, dims=(0, 2))
        lens_pl = batch_like(q, mesh, dims=(0,))

        def local(ql, kl, vl, lens):
            return _attend(ql, kl, vl, lens, ql.shape[2] // d, d, causal, use_kernel)
        out = on_local(mesh, local, (q, k, v, kv_lens), (pl, pl, pl, None if kv_lens is None
                                                          else lens_pl), pl)
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
    def ids(x):
        pos = torch.arange(t, dtype=torch.int32, device=x.device)
        return pos[None, :].expand(x.shape[0], t)
    if ctx.mesh is None:
        ctx.write_slot(op, "Out", ids(x))
        return
    # under a mesh each rank makes its own rows' ids
    from ..parallel.layout import batch_like, on_local
    pl = batch_like(x, ctx.mesh)
    ctx.write_slot(op, "Out", on_local(ctx.mesh, ids, (x,), (pl,), pl))


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
