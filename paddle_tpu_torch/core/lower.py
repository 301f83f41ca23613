"""Block lowering: run a BlockDesc's ops, one by one, on torch tensors.

The JAX package traces a whole block into one XLA computation; here each
op's lowering runs eagerly as it is reached, as Fluid's executor
interpreted a block.  Op lowerings are registered in ``registry.OPS``.

Ops with a group lowering (the optimizer updates) are the exception: the
block's run gathers a run of them into one call, so that one kernel launch
updates every parameter of a step (``lower_block``).  The result is
bit-equal to lowering the ops one by one in program order.

A ``<type>_grad`` op without a lowering of its own is lowered generically:
the forward lowering runs again on leaf tensors that require grad, and
``torch.autograd.grad`` pulls the output cotangents back (the JAX
package's ``jax.vjp`` of the forward lowering).  Eager torch does not
remove that recompute, so a forward kernel launches again in each grad op
of its forward op.

The executor gives the context :func:`plan_frees`' plan: each value leaves the
environment after the last op that reads or writes it, so a block holds
only what it still needs (the reference's XLA computation frees its
buffers as it goes too).

While a torch profiler is active each op's lowering runs inside a
``record_function`` range named ``op<idx>:<type>@<file.py:line>`` (the JAX
package's ``jax.named_scope`` of the same name), so a device trace maps a
kernel back to the ProgramDesc op and the user-code line that appended it.
With no profiler active the lowering pays one check.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .desc import BlockDesc, OpDesc
from .registry import OPS

# whether any torch profiler is recording (one C call)
_profiler_enabled = torch._C._autograd._profiler_enabled

# Env key suffix carrying per-row sequence lengths of a padded ragged
# batch: var `x` with lod_level>0 is a padded [N, T, ...] tensor and
# `x@SEQ_LEN` its int32 [N] lengths (fed by the caller, propagated below).
SEQ_LEN_SUFFIX = "@SEQ_LEN"

# Op types that manage @SEQ_LEN themselves; the generic propagation below
# must not second-guess them.  Populated by op modules at registration.
SEQ_LEN_AWARE: set = set()

# op types no lowering runs: the executor, the localization and the op
# profiler's replay skip them (the JAX executor skips the same set)
_SKIP_OPS = frozenset({"feed", "fetch", "read"})


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
    ``device`` is where ops create new tensors; ``frees`` is
    :func:`plan_frees`' plan for the block, or None to keep every value.
    (The JAX package's parent contexts for control-flow sub-blocks come
    with control flow.)"""

    def __init__(self, block: BlockDesc, env: Dict[str, Any],
                 generator: torch.Generator, device: torch.device,
                 frees: Optional[List[List[str]]] = None):
        self.block = block
        self.env = env
        self.generator = generator
        self.device = device
        self.frees = frees

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


def _op_scope_name(op: OpDesc, index: Optional[int]) -> str:
    """The profiler range of one op: ``op<idx>:<type>@<file.py:line>``."""
    name = f"op{'?' if index is None else index}:{op.type}"
    callsite = op.callsite
    if callsite:
        name += "@" + callsite.replace("\\", "/").rsplit("/", 1)[-1].replace(" ", "")
    return name


def lower_op(ctx: LowerCtx, op: OpDesc, index: Optional[int] = None):
    if _profiler_enabled():
        with torch.profiler.record_function(_op_scope_name(op, index)):
            _lower_op(ctx, op, index)
    else:
        _lower_op(ctx, op, index)


def _lower_op(ctx: LowerCtx, op: OpDesc, index: Optional[int]):
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


def plan_frees(block: BlockDesc, keep) -> List[List[str]]:
    """For each op of ``block``, the names no later op reads or writes:
    their values may leave the environment once it has run.  Names in
    ``keep`` (read after the block: its fetches, the state it writes) and
    ``@SEQ_LEN`` lengths (read by name, not through a slot) never leave."""
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_names() + op.output_names():
            if n:
                last[n] = i
    dead: List[List[str]] = [[] for _ in block.ops]
    for n, i in last.items():
        if n not in keep and not n.endswith(SEQ_LEN_SUFFIX):
            dead[i].append(n)
    return dead


def lower_block(ctx: LowerCtx, block: BlockDesc):
    """Lower ``block``'s ops in order (a group's updates in one call).  With
    ``ctx.frees`` (:func:`plan_frees`), each value leaves the environment
    after the last op that reads or writes it, so its memory goes back to
    the allocator (during a CUDA graph's capture, to the graph's pool)
    while the block runs: a training step then holds what it still needs,
    not every activation and gradient it made."""
    ops, frees = block.ops, ctx.frees
    i = done = 0
    while i < len(ops):
        info = OPS.get(ops[i].type) if OPS.has(ops[i].type) else None
        if info is None or info.group_lower is None:
            lower_op(ctx, ops[i], index=i)
            i += 1
        else:
            i = _lower_group(ctx, ops, i, info)
        if frees is not None:
            # every op before i has run (a group runs ops past its first out
            # of order, but all of them before it returns)
            for names in frees[done:i]:
                for n in names:
                    ctx.env.pop(n, None)
            done = i


def _lower_group(ctx: LowerCtx, ops: List[OpDesc], start: int, info) -> int:
    """Lower ``ops[start]`` together with the following ops of its group
    (an equal ``group_key``) in one ``group_lower`` call; returns the index
    of the first op not lowered.

    The group reads every input before it writes an output.  A following
    op passes the group if it reads no name a member collected so far
    writes and writes no name such a member reads or writes: an op of the
    group then joins it, and any other op (the bf16 step's gradient casts,
    an update of another family or other attributes) is lowered at once,
    ahead of the group.  The first op that does not pass ends the group,
    which is lowered before it.  Either way each op sees what it would see
    in program order."""
    key = info.group_key(ops[start])
    group = [ops[start]]
    reads, writes = set(group[0].input_names()), set(group[0].output_names())
    i = start + 1
    while i < len(ops):
        op = ops[i]
        op_in, op_out = op.input_names(), op.output_names()
        if not writes.isdisjoint(op_in) or not writes.isdisjoint(op_out) \
                or not reads.isdisjoint(op_out):
            break
        other = OPS.get(op.type) if OPS.has(op.type) else None
        if other is not None and other.group_key is not None and other.group_key(op) == key:
            group.append(op)
            reads.update(op_in)
            writes.update(op_out)
        else:
            lower_op(ctx, op, index=i)
        i += 1
    if _profiler_enabled():
        name = f"{_op_scope_name(group[0], start)}[group of {len(group)}]"
        with torch.profiler.record_function(name):
            info.group_lower(ctx, group)
    else:
        info.group_lower(ctx, group)
    for op in group:
        if op.type not in SEQ_LEN_AWARE:
            _propagate_seq_len(ctx, op)
    return i


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
    through to the real environment detached, and writes are captured.
    Random ops draw from a fork of the base generator's state, so the
    re-run neither advances the live generator nor depends on its later
    state (the JAX package reuses the forward's key without consuming it)."""

    def __init__(self, base: LowerCtx, overrides: Dict[str, Any]):
        super().__init__(base.block, {}, None, base.device)
        self._base = base
        self._overrides = overrides
        self.captured: Dict[str, Any] = {}

    @property
    def generator(self):
        # forked at the first draw: most lowerings draw nothing
        if self._fork is None:
            base = self._base.generator
            self._fork = torch.Generator(device=base.device)
            self._fork.set_state(base.get_state())
        return self._fork

    @generator.setter
    def generator(self, value):
        self._fork = value

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
