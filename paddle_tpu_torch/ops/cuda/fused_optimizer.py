"""Fused optimizer updates: the hand-written Hopper kernels
(csrc/fused_sgd.cu, csrc/fused_adam.cu) and their plain PyTorch versions.

``fused_sgd`` replaces the TPU kernel ``paddle_tpu/ops/pallas/
fused_optimizer.py::_sgd_kernel`` (launched by ``fused_sgd``): one pass of
``p - lr * g`` with ``lr`` read on the device, rounded once per element
(a fused multiply-add), as XLA compiles the JAX kernel's expression.

``fused_adam`` replaces ``_adam_kernel`` (launched by ``fused_adam``).  One
pass over the parameter,
its gradient and both moments; returns the same quintuple as the JAX
package's ``fused_adam``: (param_out, moment1_out, moment2_out,
beta1_pow_out, beta2_pow_out).  The bias-corrected step size
lr_t = lr * sqrt(1 - beta2_pow * beta2) / (1 - beta1_pow * beta1) is
computed on the device from the scalar tensors, never on the host.

Both kernels write into fresh tensors (the inputs are left as they were),
so the caller may still hold the old values, and both use explicit ``_rn``
intrinsics, so each rounds every element as its plain version does.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``fused_sgd.launches`` and ``fused_adam.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 5
             + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p])
_SGD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
_ADAM = build.Entry("ptt_fused_adam_f32", _ARGTYPES)
_SGD = build.Entry("ptt_fused_sgd_f32", _SGD_ARGTYPES)


def _on_cpu(name, tensors) -> bool:
    """True when every tensor lies on the CPU; raises unless they all lie
    on one CUDA device as float32 contiguous tensors."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}; "
                         f"all must be on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} kernel takes float32 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    return False


def fused_sgd_plain(p, g, lr):
    """``p - lr * g`` rounded once, as a fused multiply-add rounds it.

    float32 tensors go through float64: ``lr * g`` is exact there, the
    sum's rounding error is recovered exactly (TwoSum), and rounding the
    sum to odd before the one rounding to float32 makes that rounding the
    correctly rounded result (53 >= 24 + 2 bits).  Other float types
    compute in their own precision."""
    lr = lr.reshape(())
    if p.dtype != torch.float32:
        return p - lr.to(p.dtype) * g.to(p.dtype)
    a, b = p.double(), -(lr.double() * g.double())
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)                  # a + b == s + err exactly
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf).to(s))
    return torch.where(inexact_even, toward, s).float()


def fused_sgd(p, g, lr):
    """One SGD step: p, g of one shape, lr a one-element tensor.  Returns
    the updated parameter in a fresh tensor."""
    if g.shape != p.shape:
        raise ValueError(f"fused_sgd: p {tuple(p.shape)} and g {tuple(g.shape)} differ")
    if lr.numel() != 1:
        raise ValueError("fused_sgd: lr must have one element")
    if _on_cpu("fused_sgd", (p, g, lr)):
        return fused_sgd_plain(p, g, lr)
    out = torch.empty_like(p)
    build.launch(_SGD, "fused_sgd", p.device,
                 p.data_ptr(), g.data_ptr(), lr.data_ptr(), out.data_ptr(), p.numel())
    fused_sgd.launches += 1
    return out


fused_sgd.launches = 0


def fused_adam_plain(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1: float,
                     beta2: float, epsilon: float):
    """The JAX package's ``fused_adam`` expression, element for element."""
    b1p = beta1_pow.reshape(()).float()
    b2p = beta2_pow.reshape(()).float()
    lr_t = lr.reshape(()).float() * torch.sqrt(1.0 - b2p * beta2) / (1.0 - b1p * beta1)
    gf = g.float()
    m1n = beta1 * m1 + (1.0 - beta1) * gf
    m2n = beta2 * m2 + (1.0 - beta2) * (gf * gf)
    pn = p - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return (pn.to(p.dtype), m1n.to(m1.dtype), m2n.to(m2.dtype),
            (b1p * beta1).reshape(beta1_pow.shape).to(beta1_pow.dtype),
            (b2p * beta2).reshape(beta2_pow.shape).to(beta2_pow.dtype))


def fused_adam(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1: float,
               beta2: float, epsilon: float):
    """One Adam step.  p, g, m1, m2 of one shape; beta1_pow, beta2_pow, lr
    one-element tensors.  Returns (p, m1, m2, beta1_pow, beta2_pow) updated."""
    big = (p, g, m1, m2)
    scalars = (beta1_pow, beta2_pow, lr)
    if any(t.shape != p.shape for t in big):
        raise ValueError(f"fused_adam: p, g, m1, m2 shapes differ: "
                         f"{[tuple(t.shape) for t in big]}")
    if any(t.numel() != 1 for t in scalars):
        raise ValueError("fused_adam: beta1_pow, beta2_pow and lr must have one element")
    tensors = big + scalars
    if _on_cpu("fused_adam", tensors):
        return fused_adam_plain(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1, beta2, epsilon)
    outs = [torch.empty_like(t) for t in (p, m1, m2, beta1_pow, beta2_pow)]
    # (1 - beta) is computed in double and rounded to float32 by ctypes, as
    # the plain version's Python scalars are
    build.launch(_ADAM, "fused_adam", p.device,
                 *(t.data_ptr() for t in tensors), beta1, beta2,
                 1.0 - beta1, 1.0 - beta2, epsilon,
                 *(t.data_ptr() for t in outs), p.numel())
    fused_adam.launches += 1
    return tuple(outs)


fused_adam.launches = 0
