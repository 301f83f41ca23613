"""Flash-attention forward: the hand-written Hopper kernel
(csrc/flash_attention_fwd.cu) and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py::
_attn_fwd_kernel``.  Same function and layout as the JAX package's
``flash_attention``: q, k, v are [B, H, T, d] (or [B*H, T, d]); scores are
scaled by ``sm_scale`` (default 1/sqrt(d)) applied to q; keys at positions
>= ``kv_lens`` and, with ``causal``, keys after the query are masked; a
query row with no valid key gives exact zeros.  Returns ``(out, lse)``
with lse = m + log(l) in float32 (float64 for float64 inputs on the
CPU), which the backward reads.

``FlashAttention`` is the autograd Function around it: the forward is the
kernel (saving q, k, v, kv_lens, out and lse), the backward the composed
torch port of the JAX package's ``_flash_bwd_xla`` -- that package has no
Pallas backward kernel either.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``flash_attn_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def flash_attn_fwd_plain(q, k, v, kv_lens, causal: bool, sm_scale: float,
                         block_k: int = 128):
    """Tiled torch loop over key blocks with the online softmax -- the
    structure of the JAX package's ``_flash_fwd_xla``.  q/k/v [BH, T, d]."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dev = q.device
    ft = torch.promote_types(q.dtype, torch.float32)   # float64 stays float64
    qf = q.to(ft) * sm_scale
    q_pos = torch.arange(tq, device=dev)
    acc = torch.zeros((bh, tq, d), dtype=ft, device=dev)
    m = torch.full((bh, tq), NEG_INF, dtype=ft, device=dev)
    l = torch.zeros((bh, tq), dtype=ft, device=dev)
    for k0 in range(0, tk, block_k):
        ks = k[:, k0:k0 + block_k].to(ft)
        vs = v[:, k0:k0 + block_k].to(ft)
        s = torch.einsum("bqd,bkd->bqk", qf, ks)
        k_pos = torch.arange(k0, k0 + ks.shape[1], device=dev)
        if causal:
            s = torch.where(q_pos[None, :, None] >= k_pos[None, None, :], s, NEG_INF)
        if kv_lens is not None:
            s = torch.where(k_pos[None, None, :] < kv_lens[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 1.0)
        # rows masked so far keep p = 0 (not exp(-inf - -inf) = 1)
        p = torch.where(m_new[..., None] > NEG_INF / 2,
                        torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vs)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-20)
    out = acc / l_safe[..., None]
    # rows with no valid key at all (kv_len == 0) emit exact zeros
    out = torch.where(m[..., None] > NEG_INF / 2, out, 0.0).to(q.dtype)
    return out, m + torch.log(l_safe)


def _launch(q, k, v, kv_lens, causal: bool, sm_scale: float):
    bh, tq, d = q.shape
    tk = k.shape[1]
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn_fwd kernel takes float32 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd kernel takes head_dim in {HEAD_DIMS}, got {d}")
    tensors = [q, k, v] + ([kv_lens] if kv_lens is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attn_fwd: q, k, v and kv_lens must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attn_fwd kernel needs contiguous q, k, v and kv_lens")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attn_fwd kernel needs 16-byte aligned q, k, v")
    if kv_lens is not None and kv_lens.dtype != torch.int32:
        raise TypeError(f"flash_attn_fwd kernel takes int32 kv_lens, got {kv_lens.dtype}")
    if bh > 65535:
        raise ValueError(f"flash_attn_fwd kernel takes at most 65535 batch*heads, got {bh}")
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    if bh == 0 or tq == 0:
        return out, lse
    fn = build.kernel("ptt_flash_attn_fwd_f32", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_lens.data_ptr() if kv_lens is not None else None,
                out.data_ptr(), lse.data_ptr(), bh, tq, tk, d, int(causal),
                float(sm_scale), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return out, lse


def flash_attn_fwd(q, k, v, kv_lens=None, causal: bool = False, sm_scale=None):
    """Attention forward.  q [B, H, Tq, d] or [B*H, Tq, d]; k, v with Tk;
    ``kv_lens`` int [B] (repeated over heads) or [B*H], or None.  Returns
    (out shaped like q, lse [B, H, Tq] or [B*H, Tq] float32)."""
    bh4 = None
    if q.ndim == 4:
        b, h, tq, d = q.shape
        bh4 = (b, h)
        q = q.reshape(b * h, tq, d)
        k = k.reshape(b * h, k.shape[2], d)
        v = v.reshape(b * h, v.shape[2], d)
        if kv_lens is not None and kv_lens.shape[0] == b:
            kv_lens = kv_lens.repeat_interleave(h)
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attn_fwd: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_lens is not None and tuple(kv_lens.shape) != (q.shape[0],):
        raise ValueError(f"flash_attn_fwd: kv_lens {tuple(kv_lens.shape)} does "
                         f"not match batch*heads {q.shape[0]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    on_cpu = all(t.device.type == "cpu" for t in (q, k, v)) and (
        kv_lens is None or kv_lens.device.type == "cpu")
    if on_cpu:
        out, lse = flash_attn_fwd_plain(q, k, v, kv_lens, causal, sm_scale)
    elif q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    else:
        out, lse = _launch(q, k, v, kv_lens, causal, sm_scale)
    if bh4 is not None:
        out = out.reshape(*bh4, *out.shape[1:])
        lse = lse.reshape(*bh4, lse.shape[-1])
    return out, lse


flash_attn_fwd.launches = 0


def flash_attn_bwd(q, k, v, kv_lens, out, lse, g, causal: bool, sm_scale: float):
    """Backward from the saved lse, recomputing p: the JAX package's
    ``_flash_bwd_xla`` over one key block.  q/k/v/out/g [BH, T, d],
    lse [BH, Tq].  Returns (dq, dk, dv)."""
    tq, tk = q.shape[1], k.shape[1]
    dev = q.device
    ft = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ft) * sm_scale
    gf = g.to(ft)
    kf, vf = k.to(ft), v.to(ft)
    delta = (out.to(ft) * gf).sum(dim=-1)                        # [bh, tq]
    s = torch.einsum("bqd,bkd->bqk", qf, kf)
    k_pos = torch.arange(tk, device=dev)
    if causal:
        q_pos = torch.arange(tq, device=dev)
        s = torch.where(q_pos[None, :, None] >= k_pos[None, None, :], s, NEG_INF)
    if kv_lens is not None:
        s = torch.where(k_pos[None, None, :] < kv_lens[:, None, None], s, NEG_INF)
    # masked entries give p = 0: for a row with no valid key (lse ~ -1e30)
    # exp(s - lse) would be 1 and leak gradients into dk/dv
    p = torch.where(s > NEG_INF / 2, torch.exp(s - lse[..., None].to(ft)), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    return (dq * sm_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable ``flash_attn_fwd`` on [BH, T, d] tensors with
    ``kv_lens`` [BH] or None; returns out."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal: bool, sm_scale: float):
        out, lse = flash_attn_fwd(q, k, v, kv_lens=kv_lens, causal=causal,
                                  sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, kv_lens, out, lse, g,
                                    ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None
