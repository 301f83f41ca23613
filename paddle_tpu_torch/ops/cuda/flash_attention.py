"""Flash-attention forward: the hand-written Hopper kernel
(csrc/flash_attention_fwd.cu) and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py::
_attn_fwd_kernel``.  Same function and layout as the JAX package's
``flash_attention``: q, k, v are [B, H, T, d] (or [B*H, T, d]); scores are
scaled by ``sm_scale`` (default 1/sqrt(d)) applied to q; keys at positions
>= ``kv_lens`` and, with ``causal``, keys after the query are masked; a
query row with no valid key gives exact zeros.  Returns ``(out, lse)``
with lse = m + log(l) in float32, which the backward will read.

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
    qf = q.float() * sm_scale
    q_pos = torch.arange(tq, device=dev)
    acc = torch.zeros((bh, tq, d), dtype=torch.float32, device=dev)
    m = torch.full((bh, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, tq), dtype=torch.float32, device=dev)
    for k0 in range(0, tk, block_k):
        ks = k[:, k0:k0 + block_k].float()
        vs = v[:, k0:k0 + block_k].float()
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
