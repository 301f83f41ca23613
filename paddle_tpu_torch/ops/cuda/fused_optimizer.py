"""Fused Adam update: the hand-written Hopper kernel (csrc/fused_adam.cu)
and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_optimizer.py::
_adam_kernel`` (launched by ``fused_adam``).  One pass over the parameter,
its gradient and both moments; returns the same quintuple as the JAX
package's ``fused_adam``: (param_out, moment1_out, moment2_out,
beta1_pow_out, beta2_pow_out).  The bias-corrected step size
lr_t = lr * sqrt(1 - beta2_pow * beta2) / (1 - beta1_pow * beta1) is
computed on the device from the scalar tensors, never on the host.

The kernel writes into fresh tensors (the inputs are left as they were),
so the caller may still hold the old values.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises.  ``fused_adam.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 5
             + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p])


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
    if all(t.device.type == "cpu" for t in tensors):
        return fused_adam_plain(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1, beta2, epsilon)
    if p.device.type != "cuda" or any(t.device != p.device for t in tensors):
        raise ValueError(f"fused_adam: tensors on {sorted({str(t.device) for t in tensors})}; "
                         f"all must be on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_adam kernel takes float32 tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adam kernel needs contiguous tensors")
    outs = [torch.empty_like(t) for t in (p, m1, m2, beta1_pow, beta2_pow)]
    fn = build.kernel("ptt_fused_adam_f32", _ARGTYPES)
    # (1 - beta) is computed in double and rounded to float32 by ctypes, as
    # the plain version's Python scalars are
    with torch.cuda.device(p.device):
        rc = fn(*(t.data_ptr() for t in tensors), beta1, beta2,
                1.0 - beta1, 1.0 - beta2, epsilon,
                *(t.data_ptr() for t in outs), p.numel(),
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "fused_adam")
    fused_adam.launches += 1
    return tuple(outs)


fused_adam.launches = 0
