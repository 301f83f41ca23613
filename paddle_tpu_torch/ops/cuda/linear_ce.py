"""Fused final projection + softmax cross-entropy: the hand-written Hopper
kernels (csrc/linear_ce.cu) and their plain PyTorch versions.

Replace the TPU kernels ``paddle_tpu/ops/pallas/linear_ce.py::_fwd_kernel``
(``linear_ce_fwd``) and ``::_bwd_kernel`` (``linear_ce_bwd``).

``linear_ce_fwd(x, w, b, labels)`` -> (lse, label_logit), each [B] float32:
the log-sum-exp of each row of ``x @ w + b`` and its logit at the label (0
for a label outside [0, V)), without the [B, V] logits in memory.
``linear_ce_bwd(x, w, b, labels, lse, g)`` -> (dx, dw, db): the gradient of
``sum(g * (lse - label_logit))``, the logits recomputed from the saved lse.
``b`` may be None (zero bias; db is then None).

The plain versions follow the JAX package's chunked composed path
(``ops/fused_ce.py::_fused_lse_and_label_logit``, ``::_fused_ce_bwd``):
vocabulary chunks of ``CHUNK`` columns with an online log-sum-exp.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``<wrapper>.launches`` counts wrapper calls that launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

CHUNK = 4096   # vocabulary columns per chunk (plain versions, kernel backward)
FWD_TILES_PER_SPLIT = 8

_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(name, x, w, b, labels, *extra) -> bool:
    """Validate the arguments; True when they all lie on the CPU."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name} wants x [B, D] and w [D, V], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    bsz, v = x.shape[0], w.shape[1]
    if b is not None and tuple(b.shape) != (v,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} is not [{v}]")
    if tuple(labels.shape) != (bsz,) or any(tuple(t.shape) != (bsz,) for t in extra):
        raise ValueError(f"{name}: labels and per-row inputs must be [{bsz}]")
    if labels.dtype != torch.int32:
        raise TypeError(f"{name} wants int32 labels, got {labels.dtype}")
    tensors = [x, w, labels, *extra] + ([b] if b is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; "
                         f"all must be on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors if t is not labels):
        raise TypeError(f"{name} kernel takes float32 x, w, bias and per-row inputs")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    if x.shape[1] % 4 or v % 4:
        raise ValueError(f"{name} kernel needs D and V multiples of 4, got "
                         f"D={x.shape[1]}, V={v}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned x and w")
    if bsz >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"{name} kernel takes fewer than 2**31 rows and columns")
    return False


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _acc_dtype(x):
    """The plain versions compute in float32, or in float64 when given
    float64 (a double-precision reference run of the same program)."""
    return torch.promote_types(x.dtype, torch.float32)


def linear_ce_fwd_plain(x, w, b, labels):
    bsz, v = x.shape[0], w.shape[1]
    acc = _acc_dtype(x)
    xf = x.to(acc)
    m = torch.full((bsz,), float("-inf"), dtype=acc, device=x.device)
    s = torch.zeros((bsz,), dtype=acc, device=x.device)
    lab = torch.zeros((bsz,), dtype=acc, device=x.device)
    lbl = labels.long()
    for v0 in range(0, v, CHUNK):
        vc = min(CHUNK, v - v0)
        logits = xf @ w[:, v0:v0 + vc].to(acc)
        if b is not None:
            logits = logits + b[v0:v0 + vc].to(acc)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        rel = lbl - v0
        hit = (rel >= 0) & (rel < vc)
        picked = logits.gather(1, rel.clamp(0, vc - 1)[:, None])[:, 0]
        lab = torch.where(hit, picked, lab)
        m = m_new
    return m + torch.log(s), lab


def linear_ce_fwd(x, w, b, labels):
    """x [B, D], w [D, V], b [V] or None, labels [B] int32 -> (lse, label
    logit), [B] float32 each."""
    if _check("linear_ce_fwd", x, w, b, labels):
        return linear_ce_fwd_plain(x, w, b, labels)
    bsz, v = x.shape[0], w.shape[1]
    lse = torch.empty((bsz,), dtype=torch.float32, device=x.device)
    lab = torch.empty_like(lse)
    if bsz == 0:
        return lse, lab
    # a block walks FWD_TILES_PER_SPLIT vocabulary tiles of 128 columns
    n_tiles = -(-v // 128)
    splits = -(-n_tiles // FWD_TILES_PER_SPLIT)
    part = torch.empty((3, splits, bsz), dtype=torch.float32, device=x.device)
    fn = build.kernel("ptt_linear_ce_fwd_f32", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), _ptr(b), labels.data_ptr(), lse.data_ptr(),
                lab.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
                bsz, x.shape[1], v, splits, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "linear_ce_fwd")
    linear_ce_fwd.launches += 1
    return lse, lab


linear_ce_fwd.launches = 0


def linear_ce_bwd_plain(x, w, b, labels, lse, g):
    bsz, d = x.shape
    v = w.shape[1]
    acc = _acc_dtype(x)
    xf, gf, lbl = x.to(acc), g.to(acc), labels.long()
    dx = torch.zeros((bsz, d), dtype=acc, device=x.device)
    dw = torch.empty((d, v), dtype=acc, device=x.device)
    db = torch.empty((v,), dtype=acc, device=x.device) if b is not None else None
    for v0 in range(0, v, CHUNK):
        vc = min(CHUNK, v - v0)
        wc = w[:, v0:v0 + vc].to(acc)
        logits = xf @ wc
        if b is not None:
            logits = logits + b[v0:v0 + vc].to(acc)
        p = torch.exp(logits - lse[:, None].to(acc))
        col = torch.arange(vc, device=x.device)
        onehot = (col[None, :] == (lbl - v0)[:, None]).to(acc)
        dl = (p - onehot) * gf[:, None]
        dx = dx + dl @ wc.T
        dw[:, v0:v0 + vc] = xf.T @ dl
        if db is not None:
            db[v0:v0 + vc] = dl.sum(dim=0)
    return dx, dw, db


def linear_ce_bwd(x, w, b, labels, lse, g):
    """Gradients of ``sum(g * (lse - label_logit))``: (dx [B, D], dw [D, V],
    db [V] or None), float32.  One call runs, per vocabulary chunk, the
    dl, dx and dW kernels of csrc/linear_ce.cu."""
    if _check("linear_ce_bwd", x, w, b, labels, lse, g):
        return linear_ce_bwd_plain(x, w, b, labels, lse, g)
    bsz, d = x.shape
    v = w.shape[1]
    dx = torch.empty((bsz, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
    db = torch.empty((v,), dtype=torch.float32, device=x.device) if b is not None else None
    chunk = min(CHUNK, v)
    dl = torch.empty((bsz, chunk), dtype=torch.float32, device=x.device)
    fn = build.kernel("ptt_linear_ce_bwd_f32", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), _ptr(b), labels.data_ptr(), lse.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dw.data_ptr(), _ptr(db), dl.data_ptr(),
                bsz, d, v, chunk, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "linear_ce_bwd")
    linear_ce_bwd.launches += 1
    return dx, dw, db


linear_ce_bwd.launches = 0
