"""Block lowering: run a BlockDesc's ops, one by one, on torch tensors.

The JAX package traces a whole block into one XLA computation; here each
op's lowering runs eagerly as it is reached, as Fluid's executor
interpreted a block.  Op lowerings are registered in ``registry.OPS``.

A ``<type>_grad`` op without a lowering of its own is lowered generically:
the forward lowering runs again on leaf tensors that require grad, and
``torch.autograd.grad`` pulls the output cotangents back (the JAX
package's ``jax.vjp`` of the forward lowering).  Eager torch does not
remove that recompute, so a forward kernel launches again in each grad op
of its forward op.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .desc import BlockDesc, OpDesc
from .registry import OPS

# Env key suffix carrying per-row sequence lengths of a padded ragged
# batch: var `x` with lod_level>0 is a padded [N, T, ...] tensor and
# `x@SEQ_LEN` its int32 [N] lengths (fed by the caller, propagated below).
SEQ_LEN_SUFFIX = "@SEQ_LEN"

# Op types that manage @SEQ_LEN themselves; the generic propagation below
# must not second-guess them.  Populated by op modules at registration.
SEQ_LEN_AWARE: set = set()


def _propagate_seq_len(ctx: "LowerCtx", op: OpDesc):
    """Carry lengths through shape-preserving ops (fc over flattened [N,T],
    elementwise, activations, embedding...): if an input has lengths and
    an output keeps the same leading [N, T] dims, the output is the same
    ragged batch."""
    in_lens = lead = None
    for n in op.input_names():
        if not n:
            continue
        lens = ctx.read_opt(n + SEQ_LEN_SUFFIX)
        if lens is not None:
            v = ctx.read_opt(n)
            if v is not None and getattr(v, "ndim", 0) >= 2:
                in_lens, lead = lens, tuple(v.shape[:2])
                break
    if in_lens is None:
        return
    for n in op.output_names():
        if not n or ctx.read_opt(n + SEQ_LEN_SUFFIX) is not None:
            continue
        v = ctx.read_opt(n)
        if (v is not None and getattr(v, "ndim", 0) >= 2
                and tuple(v.shape[:2]) == lead):
            ctx.write(n + SEQ_LEN_SUFFIX, in_lens)


class LowerCtx:
    """Environment of one block run: ``env`` maps var name -> tensor.
    ``generator`` is the ``torch.Generator`` random ops draw from;
    ``device`` is where ops create new tensors.  (The JAX package's parent
    contexts for control-flow sub-blocks come with control flow.)"""

    def __init__(self, block: BlockDesc, env: Dict[str, Any],
                 generator: torch.Generator, device: torch.device):
        self.block = block
        self.env = env
        self.generator = generator
        self.device = device

    def read(self, name: str):
        if name not in self.env:
            raise KeyError(
                f"var {name!r} is not defined at this point of block {self.block.idx}"
            )
        return self.env[name]

    def read_opt(self, name: str):
        return self.env.get(name)

    def write(self, name: str, value):
        if name:
            self.env[name] = value

    def read_slot(self, op: OpDesc, slot: str):
        names = op.input(slot)
        return self.read(names[0]) if names else None

    def read_slot_list(self, op: OpDesc, slot: str):
        return [self.read(n) for n in op.input(slot)]

    def write_slot(self, op: OpDesc, slot: str, value):
        names = op.output(slot)
        if names:
            self.write(names[0], value)


def lower_op(ctx: LowerCtx, op: OpDesc, index: Optional[int] = None):
    info = OPS.get(op.type) if OPS.has(op.type) else None
    if info is not None and info.lower is not None:
        info.lower(ctx, op)
        if op.type not in SEQ_LEN_AWARE:
            _propagate_seq_len(ctx, op)
        return
    if op.type.endswith("_grad"):
        fwd_type = op.type[: -len("_grad")]
        if OPS.has(fwd_type) and OPS.get(fwd_type).lower is not None:
            _lower_generic_grad(ctx, op, fwd_type)
            return
    where = f" (op {index})" if index is not None else ""
    raise NotImplementedError(f"no lowering registered for op {op.type!r}{where}")


def lower_block(ctx: LowerCtx, block: BlockDesc):
    for idx, op in enumerate(block.ops):
        lower_op(ctx, op, index=idx)


def _lower_generic_grad(ctx: LowerCtx, op: OpDesc, fwd_type: str):
    """Gradient of a forward op by torch autograd over its lowering.

    The forward OpDesc is rebuilt from the grad op's slots (forward inputs
    under their own slot names, outputs under ``__out__<slot>``, output
    grads under ``__outgrad__<slot>``).  The forward lowering runs again on
    detached leaf copies of the differentiable inputs; outputs whose grad
    is absent get a zero cotangent, which contributes nothing and is
    left out of ``torch.autograd.grad``."""
    info = OPS.get(fwd_type)
    fwd_inputs = {s: list(ns) for s, ns in op.inputs.items() if not s.startswith("__")}
    out_slots = {s[len("__out__"):]: list(ns) for s, ns in op.inputs.items()
                 if s.startswith("__out__")}
    outgrad_slots = {s[len("__outgrad__"):]: list(ns) for s, ns in op.inputs.items()
                     if s.startswith("__outgrad__")}
    fwd_op = OpDesc(type=fwd_type, inputs=fwd_inputs, outputs=out_slots,
                    attrs=dict(op.attrs))
    grad_out = {s[: -len("@GRAD_SLOT")]: ns for s, ns in op.outputs.items()}

    diff_names: List[str] = []
    for slot, gnames in grad_out.items():
        for n, g in zip(fwd_inputs.get(slot, []), gnames):
            if g and n not in diff_names:
                diff_names.append(n)
    if not diff_names:
        return

    out_grad = {}
    for slot, onames in out_slots.items():
        for on, gn in zip(onames, outgrad_slots.get(slot, [])):
            if on and gn:
                out_grad[on] = ctx.read(gn)

    with torch.enable_grad():
        primals = [ctx.read(n).detach().requires_grad_(True) for n in diff_names]
        sub = _GradTraceCtx(ctx, dict(zip(diff_names, primals)))
        info.lower(sub, fwd_op)
        outs, cots = [], []
        for name, g in out_grad.items():
            out = sub.captured.get(name)
            if out is None:
                continue
            if not out.requires_grad:
                # a lowering whose output lost its autograd history (a kernel
                # called without its autograd.Function) would silently drop
                # this gradient
                raise RuntimeError(
                    f"{op.type}: forward output {name!r} of {fwd_type} has no "
                    f"autograd history; its lowering is not differentiable")
            outs.append(out)
            cots.append(g.to(out.dtype))
        if outs:
            grads = torch.autograd.grad(outs, primals, cots, allow_unused=True)
        else:
            grads = [None] * len(primals)
    name_to_grad = {n: (torch.zeros_like(p) if g is None else g).detach()
                    for n, p, g in zip(diff_names, primals, grads)}

    # autograd returns the combined gradient of a var that feeds several
    # slots; the grad maker emitted one grad output per slot and backward
    # sums them, so write it once and zeros for the other occurrences
    written = set()
    for slot, gnames in grad_out.items():
        for n, g in zip(fwd_inputs.get(slot, []), gnames):
            if not g:
                continue
            if n in written:
                ctx.write(g, torch.zeros_like(name_to_grad[n]))
            else:
                ctx.write(g, name_to_grad[n])
                written.add(n)


class _GradTraceCtx(LowerCtx):
    """The context a forward lowering runs in while its gradient is taken:
    differentiable inputs come from the leaf tensors, every other read goes
    through to the real environment detached, and writes are captured."""

    def __init__(self, base: LowerCtx, overrides: Dict[str, Any]):
        super().__init__(base.block, {}, base.generator, base.device)
        self._base = base
        self._overrides = overrides
        self.captured: Dict[str, Any] = {}

    def read_opt(self, name: str):
        if name in self.captured:
            return self.captured[name]
        if name in self._overrides:
            return self._overrides[name]
        v = self._base.read_opt(name)
        return v.detach() if isinstance(v, torch.Tensor) else v

    def read(self, name: str):
        v = self.read_opt(name)
        if v is None:
            raise KeyError(f"var {name!r} missing while taking a gradient")
        return v

    def write(self, name: str, value):
        if name:
            self.captured[name] = value
