"""Fused optimizer updates: the hand-written Hopper kernels
(csrc/fused_sgd.cu, csrc/fused_adam.cu) and their plain PyTorch versions.

Both kernels are multi-tensor: one launch updates every parameter of a
step.  ``fused_adam_multi`` and ``fused_sgd_multi`` take a list of
entries, one a parameter, and pass the kernel a table of their pointers,
element counts and first chunks (``plan_launches``, worked out here on the
host); a persistent grid walks fixed-size chunks of all of them.  A group
larger than one launch's table goes out as several launches, in order.

``fused_sgd_multi`` replaces the TPU kernel ``paddle_tpu/ops/pallas/
fused_optimizer.py::_sgd_kernel`` (launched by ``fused_sgd``): one pass of
``p - lr * g`` with ``lr`` read on the device, rounded once per element
(a fused multiply-add), as XLA compiles the JAX kernel's expression.  The
``sgd`` and ``pallas_sgd`` ops compute the same.

``fused_adam_multi`` replaces ``_adam_kernel`` (launched by
``fused_adam``).  Each entry carries its op type's expression: *fused*
for ``pallas_adam`` (the JAX package's ``fused_adam``, ``(1 - b2) * (g *
g)``: ``fused_adam_plain``), *composed* for ``adam`` (the JAX package's
``adam`` lowering, ``((1 - b2) * g) * g``: ``adam_plain``).  An entry's
outputs are (param_out, moment1_out, moment2_out, beta1_pow_out,
beta2_pow_out).  The bias-corrected step size lr_t = lr * sqrt(1 -
beta2_pow * beta2) / (1 - beta1_pow * beta1) is computed on the device
from each entry's scalar tensors, never on the host.

The multi-tensor calls update in place, as the JAX package's executor
updates donated state: every p (and Adam's m1, m2) is overwritten with its
update, and the table's output pointers are the inputs' own.  Each element
is read and written by one thread, so that is race-free.  Adam's beta
powers are the exception: every chunk of a tensor reads them to form lr_t,
so their updates go into fresh one-element tensors (one allocation a
call), which the caller copies home.  Both kernels use explicit ``_rn``
intrinsics, so each entry is rounded element for element as its plain
version rounds it; the plain versions update in place too (``copy_``).
``fused_adam`` and ``fused_sgd`` update one tensor out of place: a table
of one over clones of the inputs.

Tensors on the CPU go to the plain versions; CUDA tensors launch the
kernel or raise.  ``fused_sgd.launches`` and ``fused_adam.launches`` count
kernel launches (one a group within a launch's table).
"""
from __future__ import annotations

import ctypes
import functools
import math
from array import array
from typing import List, Sequence, Tuple

import torch

from . import build

# floats a chunk: kChunk in csrc/fused_adam.cu and csrc/fused_sgd.cu, which
# walk the chunks this module's planner counts
CHUNK = 8192
# tensors a launch's table holds (kMaxTensors in csrc/fused_adam.cu and
# csrc/fused_sgd.cu: the table is one kernel parameter of at most 32,764 bytes)
ADAM_CAPACITY = 256
SGD_CAPACITY = 512
# an entry's flags (kFused, kVec4 in the sources)
FUSED, VEC4 = 1, 2

_MULTI_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int]
_ADAM = build.Entry("ptt_fused_adam_multi_f32",
                    _MULTI_ARGTYPES + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_SGD = build.Entry("ptt_fused_sgd_multi_f32", _MULTI_ARGTYPES + [ctypes.c_void_p])


def plan_launches(counts: Sequence[int], capacity: int,
                  chunk: int = CHUNK) -> List[Tuple[int, List[int]]]:
    """The launches of a group of tensors with ``counts`` elements: a list
    of ``(first, starts)``, one a launch of at most ``capacity`` tensors in
    order, ``first`` its first tensor and ``starts`` the prefix sum of its
    tensors' chunks (one longer than the launch's tensors).  A tensor has
    ceil(n / chunk) chunks, and one if it is empty, so that its beta powers
    are written."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk {chunk}: a positive multiple of 4")
    launches = []
    for first in range(0, len(counts), capacity):
        starts = [0]
        for n in counts[first:first + capacity]:
            starts.append(starts[-1] + max(1, -(-n // chunk)))
        launches.append((first, starts))
    return launches


# a step's update plans the same launches every step
_plan = functools.lru_cache(maxsize=16)(plan_launches)


def _on_cpu(name, entries, width) -> bool:
    """True when the first ``width`` tensors of every entry lie on the CPU,
    False when the first one lies on a CUDA device (``_check`` then holds
    the rest to it); raises on a CPU tensor beside a CUDA one."""
    if entries[0][0].is_cuda:
        return False
    devices = {t.device for e in entries for t in e[:width]}
    if devices != {torch.device("cpu")}:
        _refuse(name, devices)
    return True


def _refuse(name, devices):
    raise ValueError(f"{name}: tensors on {sorted(str(d) for d in devices)}; "
                     f"all must be on one CUDA device (or all on the CPU)")


def _check(name, t, index, contiguous=True):
    """Raise unless ``t`` is a float32 tensor (a contiguous one where
    ``contiguous``) on CUDA device ``index`` (-1: the CPU)."""
    if t.get_device() != index:
        _refuse(name, {t.device, torch.device("cuda", index)})
    if t.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32 tensors")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous tensors")


def _scalars(device, like):
    """A fresh float32 tensor shaped as each of ``like`` (one-element
    tensors), all views of one allocation; and their addresses."""
    flat = torch.empty(len(like), device=device)
    base = flat.data_ptr()
    return [v if t.dim() == 0 else v.view(t.shape) for v, t in zip(flat.unbind(), like)], \
        [base + 4 * k for k in range(len(like))]


def _launch(entry, name, counter, dev, capacity, rows, counts, flags, scalars):
    """One launch per ``plan_launches`` part: ``rows`` holds each entry's
    pointers, ``counts`` and ``flags`` its element count and flags."""
    width = len(rows) // len(counts)
    for first, starts in _plan(tuple(counts), capacity):
        k = len(starts) - 1
        ptrs = array("q", rows[first * width:(first + k) * width])
        ns, fl = array("q", counts[first:first + k]), array("i", flags[first:first + k])
        st = array("i", starts)
        build.launch(entry, name, dev, ptrs.buffer_info()[0], ns.buffer_info()[0],
                     fl.buffer_info()[0], st.buffer_info()[0], k, *scalars)
        counter.launches += 1


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


def fused_sgd_multi(entries):
    """One SGD step of every entry ``(p, g, lr)`` in place: p, g of one
    shape, lr a one-element tensor; each p is overwritten with its update.
    Returns the parameters (the entries' own tensors), in order."""
    if not entries:
        return []
    counts = []
    for p, g, lr in entries:
        if g.shape != p.shape:
            raise ValueError(f"fused_sgd: p {tuple(p.shape)} and g {tuple(g.shape)} differ")
        if lr.numel() != 1:
            raise ValueError("fused_sgd: lr must have one element")
        counts.append(p.numel())
    if _on_cpu("fused_sgd", entries, 3):
        return fused_sgd_multi_plain(entries)
    _sgd_launch(entries, counts)()
    return [e[0] for e in entries]


def fused_sgd_multi_plain(entries):
    """``fused_sgd_multi``'s plain version: ``fused_sgd_plain`` entry by
    entry, copied into p."""
    return [p.copy_(fused_sgd_plain(p, g, lr)) for p, g, lr in entries]


def _sgd_launch(entries, counts):
    """A function that launches K5 over ``entries`` in place (timed alone
    by chip_smoke.py and tools/k56_sweep.py)."""
    dev = entries[0][0].device
    rows, flags = sgd_table(entries, dev.index)
    return functools.partial(_launch, _SGD, "fused_sgd", fused_sgd, dev, SGD_CAPACITY,
                             rows, counts, flags, ())


def sgd_table(entries, index):
    """K5's table for ``entries``: each entry's four pointers (p, g, lr and
    p' = p: in place) and its flags (VEC4 where p and g are 16-byte
    aligned).  Raises unless the entries are float32 tensors on CUDA device
    ``index``, p and g contiguous."""
    rows, flags = [], []
    f32 = torch.float32
    for p, g, lr in entries:
        for t in (p, g):
            if t.get_device() != index or t.dtype != f32 or not t.is_contiguous():
                _check("fused_sgd", t, index)
        if lr.get_device() != index or lr.dtype != f32:
            _check("fused_sgd", lr, index, contiguous=False)
        ptrs = (p.data_ptr(), g.data_ptr(), lr.data_ptr(), p.data_ptr())
        rows += ptrs
        flags.append(0 if (ptrs[0] | ptrs[1]) & 15 else VEC4)
    return rows, flags


def fused_sgd(p, g, lr):
    """One SGD step of one tensor, out of place (a table of one over a
    clone of p).  Returns the updated parameter in a fresh tensor."""
    return fused_sgd_multi([(p.clone(memory_format=torch.contiguous_format), g, lr)])[0]


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


def adam_plain(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1: float, beta2: float,
               epsilon: float):
    """The JAX package's composed ``adam`` lowering: ``((1 - b2) * g) * g``,
    each operation in the tensors' own type."""
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * g * g
    lr_t = lr * torch.sqrt(1 - beta2_pow * beta2) / (1 - beta1_pow * beta1)
    pn = p - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return pn, m1n, m2n, beta1_pow * beta1, beta2_pow * beta2


def fused_adam_multi(entries, beta1: float, beta2: float, epsilon: float):
    """One Adam step of every entry ``(p, g, m1, m2, beta1_pow, beta2_pow,
    lr, fused)``: p, g, m1, m2 of one shape, beta1_pow, beta2_pow, lr
    one-element tensors, ``fused`` True for ``pallas_adam``'s expression
    and False for ``adam``'s.  p, m1 and m2 are updated in place, the beta
    powers into fresh tensors.  Returns each entry's (p, m1, m2,
    beta1_pow', beta2_pow'), in the entries' order."""
    if not entries:
        return []
    counts = []
    for e in entries:
        shape = e[0].shape
        if e[1].shape != shape or e[2].shape != shape or e[3].shape != shape:
            raise ValueError(f"fused_adam: p, g, m1, m2 shapes differ: "
                             f"{[tuple(t.shape) for t in e[:4]]}")
        if e[4].numel() != 1 or e[5].numel() != 1 or e[6].numel() != 1:
            raise ValueError("fused_adam: beta1_pow, beta2_pow and lr must have one element")
        counts.append(e[0].numel())
    if _on_cpu("fused_adam", entries, 7):
        return fused_adam_multi_plain(entries, beta1, beta2, epsilon)
    pows, launch = _adam_launch(entries, counts, beta1, beta2, epsilon)
    launch()
    n = len(entries)
    return [e[:1] + e[2:4] + (b1, b2) for e, b1, b2 in zip(entries, pows[:n], pows[n:])]


def fused_adam_multi_plain(entries, beta1: float, beta2: float, epsilon: float):
    """``fused_adam_multi``'s plain version: entry by entry,
    ``fused_adam_plain`` where the entry says ``fused``, else
    ``adam_plain``, with p, m1 and m2 copied into the entry's own."""
    outs = []
    for e in entries:
        pn, m1n, m2n, b1, b2 = (fused_adam_plain if e[7] else adam_plain)(
            *e[:7], beta1, beta2, epsilon)
        outs.append((e[0].copy_(pn), e[2].copy_(m1n), e[3].copy_(m2n), b1, b2))
    return outs


def _adam_launch(entries, counts, beta1, beta2, epsilon):
    """The fresh beta powers of a K6 call on the card (each entry's
    beta1_pow', then each entry's beta2_pow') and a function that launches
    the kernel over ``entries`` in place, writing them (timed alone by
    chip_smoke.py and tools/k56_sweep.py)."""
    dev = entries[0][0].device
    n = len(entries)
    pows, pow_addrs = _scalars(dev, [e[4] for e in entries] + [e[5] for e in entries])
    rows, flags = adam_table(entries, pow_addrs[:n], pow_addrs[n:], dev.index)
    # (1 - beta) is computed in double and rounded to float32 by ctypes, as
    # the plain versions' Python scalars are
    return pows, functools.partial(
        _launch, _ADAM, "fused_adam", fused_adam, dev, ADAM_CAPACITY, rows, counts, flags,
        (beta1, beta2, 1.0 - beta1, 1.0 - beta2, epsilon))


def adam_table(entries, b1_addrs, b2_addrs, index):
    """K6's table for ``entries`` whose beta1_pow' and beta2_pow' lie at
    ``b1_addrs`` and ``b2_addrs``: each entry's 12 pointers (its seven
    inputs, then its five outputs: p, m1 and m2 themselves, in place, and
    the two powers) and its flags (FUSED for ``pallas_adam``'s expression;
    VEC4 where p, g, m1 and m2 are 16-byte aligned).  Raises unless the
    entries are float32 tensors on CUDA device ``index``, p, g, m1 and m2
    contiguous."""
    rows, flags = [], []
    f32 = torch.float32
    for e, b1o, b2o in zip(entries, b1_addrs, b2_addrs):
        p, g, m1, m2, b1p, b2p, lr, fused = e
        for t in (p, g, m1, m2):
            if t.get_device() != index or t.dtype != f32 or not t.is_contiguous():
                _check("fused_adam", t, index)
        for t in (b1p, b2p, lr):
            if t.get_device() != index or t.dtype != f32:
                _check("fused_adam", t, index, contiguous=False)
        ptrs = (p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr())
        rows += ptrs
        rows += (b1p.data_ptr(), b2p.data_ptr(), lr.data_ptr()) + ptrs[:1] + ptrs[2:] + (b1o, b2o)
        aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15
        flags.append((FUSED if fused else 0) | (VEC4 if aligned else 0))
    return rows, flags


def fused_adam(p, g, m1, m2, beta1_pow, beta2_pow, lr, beta1: float,
               beta2: float, epsilon: float):
    """One Adam step of one tensor in ``pallas_adam``'s expression, out of
    place (a table of one over clones of p, m1 and m2).  Returns (p, m1,
    m2, beta1_pow, beta2_pow) updated, in fresh tensors."""
    p, m1, m2 = (t.clone(memory_format=torch.contiguous_format) for t in (p, m1, m2))
    return fused_adam_multi([(p, g, m1, m2, beta1_pow, beta2_pow, lr, True)],
                            beta1, beta2, epsilon)[0]


fused_adam.launches = 0
