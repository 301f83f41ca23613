"""Fused final projection + softmax cross-entropy: the hand-written Hopper
kernels (csrc/linear_ce.cu the forward, csrc/linear_ce_bwd.cu the backward,
both on the 3xTF32 tensor-core mainloop of csrc/gemm_3xtf32.cuh) and their
plain PyTorch versions.

Replace the TPU kernels ``paddle_tpu/ops/pallas/linear_ce.py::_fwd_kernel``
(``linear_ce_fwd``) and ``::_bwd_kernel`` (``linear_ce_bwd``).

``linear_ce_fwd(x, w, b, labels)`` -> (lse, label_logit), each [B] float32:
the log-sum-exp of each row of ``x @ w + b`` and its logit at the label (0
for a label outside [0, V)), without the [B, V] logits in memory.
``linear_ce_bwd(x, w, b, labels, lse, g)`` -> (dx, dw, db): the gradient of
``sum(g * (lse - label_logit))``, the logits recomputed from the saved lse.
``b`` may be None (zero bias; db is then None).

bf16 (the ``amp-bf16`` pass casts the forward's operands): the forward
takes bf16 ``x`` and ``w`` (``w`` is taken in ``x``'s dtype and the bias
in float32, as the Pallas ``linear_ce_fwd`` takes them), multiplies in
bf16 with float32 sums (csrc/linear_ce.cu's bf16 instance, on bf16
``wgmma``) and returns lse and the label logit in float32.  The backward
stays float32: the pass leaves ``fused_fc_softmax_ce_grad``'s inputs
uncast.

The plain versions follow the JAX package's chunked composed path
(``ops/fused_ce.py::_fused_lse_and_label_logit``, ``::_fused_ce_bwd``):
vocabulary chunks of ``CHUNK`` columns with an online log-sum-exp.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``<wrapper>.launches`` counts wrapper calls that launch,
and ``linear_ce_fwd.bf16_launches`` those of the bf16 instance among them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

CHUNK = 4096   # vocabulary columns per chunk (plain versions, kernel backward)

_FWD = build.Entry("ptt_linear_ce_fwd_f32",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD = build.Entry("ptt_linear_ce_bwd_f32",
                   [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_FWD_BF16 = build.Entry("ptt_linear_ce_fwd_bf16",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_GEMM = build.Entry("ptt_gemm_3xtf32",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3
                    + [ctypes.c_int, ctypes.c_void_p])


def _check(name, x, w, b, labels, *extra, bf16=False) -> bool:
    """Validate the arguments; True when they all lie on the CPU.  With
    ``bf16`` the kernel takes bf16 x and w beside a float32 bias."""
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
    if bf16 and x.dtype == torch.bfloat16:
        if w.dtype != torch.bfloat16 or (b is not None and b.dtype != torch.float32) \
                or any(t.dtype != torch.float32 for t in extra):
            raise TypeError(f"{name} kernel takes bf16 x and w with a float32 bias")
    elif any(t.dtype != torch.float32 for t in tensors if t is not labels):
        raise TypeError(f"{name} kernel takes float32 x, w, bias and per-row inputs"
                        + (" (or bf16 x and w)" if bf16 else ""))
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
    """bf16 ``x`` and ``w`` are widened exactly: the products and their sums
    are float32, as the Pallas kernel's ``preferred_element_type``."""
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
    logit), [B] float32 each.  float32 x: one call runs the product in
    3xTF32 on the tensor cores, one launch over the whole vocabulary whose
    epilogue reduces each half of every 128-column vocabulary tile, and a
    merge of the halves in order: deterministic (no float atomics).  bf16
    x: ``w`` is taken in bf16 and the bias in float32; the product runs on
    bf16 ``wgmma`` with ``w`` read as stored, and the same epilogue and
    merge."""
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)
        b = b.float() if b is not None else None
    if _check("linear_ce_fwd", x, w, b, labels, bf16=True):
        return linear_ce_fwd_plain(x, w, b, labels)
    bsz, d = x.shape
    v = w.shape[1]
    if d == 0:
        raise ValueError("linear_ce_fwd kernel needs D > 0")
    lse = torch.empty((bsz,), dtype=torch.float32, device=x.device)
    lab = torch.empty_like(lse)
    if bsz == 0:
        return lse, lab
    # scratch: the (max, sum of exp) of each half of every 128-column
    # vocabulary tile, for every row
    part = torch.empty((2, 2 * -(-v // 128), bsz), dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"linear_ce_fwd bf16 kernel needs D a multiple of 8, got {d}")
        wp = _pad_rows16(w)
        build.launch(_FWD_BF16, "linear_ce_fwd", x.device,
                     x.data_ptr(), wp.data_ptr(), _ptr(b), labels.data_ptr(), lse.data_ptr(),
                     lab.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), bsz, d, v,
                     wp.shape[1])
        linear_ce_fwd.bf16_launches += 1
    else:
        build.launch(_FWD, "linear_ce_fwd", x.device,
                     x.data_ptr(), w.data_ptr(), _ptr(b), labels.data_ptr(), lse.data_ptr(),
                     lab.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), bsz, d, v)
    linear_ce_fwd.launches += 1
    return lse, lab


linear_ce_fwd.launches = 0
linear_ce_fwd.bf16_launches = 0


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
    db [V] or None), float32.  One call runs, per vocabulary chunk, the dl,
    dx, dW and db kernels of csrc/linear_ce_bwd.cu: the three products in
    3xTF32 on the tensor cores, deterministic (no float atomics)."""
    if _check("linear_ce_bwd", x, w, b, labels, lse, g):
        return linear_ce_bwd_plain(x, w, b, labels, lse, g)
    bsz, d = x.shape
    v = w.shape[1]
    dx = torch.empty((bsz, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
    db = torch.empty((v,), dtype=torch.float32, device=x.device) if b is not None else None
    chunk = min(CHUNK, v)
    # scratch: the chunk's dl transposed, [chunk, B] with rows padded to 16
    # bytes (TMA's stride rule), and for db each 128-row tile's sums of it
    ldl = -(-bsz // 4) * 4
    dlt = torch.empty((chunk, ldl), dtype=torch.float32, device=x.device)
    part = (torch.empty((-(-bsz // 128), chunk), dtype=torch.float32, device=x.device)
            if b is not None else None)
    build.launch(_BWD, "linear_ce_bwd", x.device,
                 x.data_ptr(), w.data_ptr(), _ptr(b), labels.data_ptr(), lse.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), dw.data_ptr(), _ptr(db), dlt.data_ptr(),
                 _ptr(part), bsz, d, v, chunk, ldl)
    linear_ce_bwd.launches += 1
    return dx, dw, db


linear_ce_bwd.launches = 0


# ------------------------------------------------------- the 3xTF32 mainloop


def split_tf32(t: torch.Tensor):
    """(hi, lo) of a float32 tensor as csrc/gemm_3xtf32.cuh splits it, bit
    for bit: ``hi`` is ``t`` with its low 13 mantissa bits cleared (what a
    tensor core reads of a float32 word), ``lo`` is ``t - hi`` (exact)
    rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``).  ``hi + lo`` rebuilds ``t`` to 2**-21 relative.
    The kernel's mirror for the tests; nothing else calls it."""
    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {t.dtype}")
    mask = -(1 << 13)                       # 0xffffe000 as an int32
    hi = (t.contiguous().view(torch.int32) & mask).view(torch.float32)
    rest = (t - hi).view(torch.int32)       # sign and magnitude: adding half
    lo = ((rest + (1 << 12)) & mask).view(torch.float32)  # an ulp rounds the magnitude
    return hi, lo


def gemm_3xtf32_plain(at: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    return at.t() @ bk.t()


def gemm_3xtf32(at: torch.Tensor, bk: torch.Tensor, n_fast: bool = False) -> torch.Tensor:
    """``at.T @ bk.T`` for ``at`` [K, M] and ``bk`` [N, K] float32: the
    3xTF32 tensor-core mainloop of K7 and K8 on its own (both operands as it
    reads them: ``at`` M-major through registers, ``bk`` K-major through
    shared memory), for tests and measurements of that mainloop."""
    if at.ndim != 2 or bk.ndim != 2 or at.shape[0] != bk.shape[1]:
        raise ValueError(f"gemm_3xtf32 wants at [K, M] and bk [N, K], got "
                         f"{tuple(at.shape)} and {tuple(bk.shape)}")
    if at.device.type == "cpu" and bk.device.type == "cpu":
        return gemm_3xtf32_plain(at, bk)
    if at.device.type != "cuda" or bk.device != at.device:
        raise ValueError(f"gemm_3xtf32: tensors on {at.device} and {bk.device}; both must "
                         f"be on one CUDA device (or both on the CPU)")
    if at.dtype != torch.float32 or bk.dtype != torch.float32:
        raise TypeError("gemm_3xtf32 kernel takes float32 operands")
    (k, m), n = at.shape, bk.shape[0]
    if not (at.is_contiguous() and bk.is_contiguous()) or m % 4 or k % 4 or k == 0 \
            or at.data_ptr() % 16 or bk.data_ptr() % 16:
        raise ValueError("gemm_3xtf32 kernel needs contiguous, 16-byte aligned operands "
                         "with M and K multiples of 4 and K > 0")
    out = torch.empty((m, n), dtype=torch.float32, device=at.device)
    build.launch(_GEMM, "gemm_3xtf32", at.device,
                 at.data_ptr(), bk.data_ptr(), out.data_ptr(), m, n, k, m, k, n, int(n_fast))
    gemm_3xtf32.launches += 1
    return out


gemm_3xtf32.launches = 0


_GEMM_BF16 = build.Entry("ptt_gemm_bf16", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])


def _pad_rows16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 matrix whose rows are a multiple of 16 bytes (TMA's stride
    rule): ``t`` itself, or a copy in a wider buffer whose first columns are
    ``t`` (the kernels read only those)."""
    cols = t.shape[1]
    if cols % 8 == 0:
        return t
    out = torch.empty((t.shape[0], -(-cols // 8) * 8), dtype=t.dtype, device=t.device)
    out[:, :cols] = t
    return out


def gemm_bf16_plain(at: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    return at.float().t() @ bk.float().t()


def gemm_bf16(at: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    """``at.T @ bk.T`` in float32 for bf16 ``at`` [K, M] and ``bk`` [N, K]:
    the bf16 ``wgmma`` mainloop of K7's bf16 instance on its own (both
    operands as it reads them from shared memory: ``at`` M-major through
    ``wgmma``'s transpose bit, ``bk`` K-major), for tests and measurements
    of that mainloop."""
    if at.ndim != 2 or bk.ndim != 2 or at.shape[0] != bk.shape[1]:
        raise ValueError(f"gemm_bf16 wants at [K, M] and bk [N, K], got "
                         f"{tuple(at.shape)} and {tuple(bk.shape)}")
    if at.device.type == "cpu" and bk.device.type == "cpu":
        return gemm_bf16_plain(at, bk)
    if at.device.type != "cuda" or bk.device != at.device:
        raise ValueError(f"gemm_bf16: tensors on {at.device} and {bk.device}; both must "
                         f"be on one CUDA device (or both on the CPU)")
    if at.dtype != torch.bfloat16 or bk.dtype != torch.bfloat16:
        raise TypeError("gemm_bf16 kernel takes bf16 operands")
    (k, m), n = at.shape, bk.shape[0]
    if not (at.is_contiguous() and bk.is_contiguous()) or k % 8 or k == 0 \
            or at.data_ptr() % 16 or bk.data_ptr() % 16:
        raise ValueError("gemm_bf16 kernel needs contiguous, 16-byte aligned operands "
                         "with K a positive multiple of 8")
    ap = _pad_rows16(at)
    out = torch.empty((m, n), dtype=torch.float32, device=at.device)
    build.launch(_GEMM_BF16, "gemm_bf16", at.device, ap.data_ptr(), bk.data_ptr(),
                 out.data_ptr(), m, n, k, ap.shape[1])
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0
