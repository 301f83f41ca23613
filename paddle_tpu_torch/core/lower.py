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
buffers as it goes too).  A control-flow op runs its sub-block in a child
context (:meth:`LowerCtx.child`) with the sub-block's own plan, and the
names its sub-block reads count as read by the op.

Under a mesh (``LowerCtx(mesh=)``, a ``parallel.mesh.Mesh``) the values
are DTensors and each op runs on them as the JAX package's lowering runs
under GSPMD: a non-persistable output whose var carries a ``sharding``
attr is redistributed to it after its op (``with_sharding_constraint``),
each gradient an update group reads is redistributed to its parameter's
placements before the group runs (``_lower_group``), and the hand-written
kernels run on local shards (``parallel.layout.on_local``).

While a torch profiler is active each op's lowering runs inside a
``record_function`` range named ``op<idx>:<type>@<file.py:line>`` (the JAX
package's ``jax.named_scope`` of the same name), so a device trace maps a
kernel back to the ProgramDesc op and the user-code line that appended it.
With no profiler active the lowering pays one check.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..amp import policy as _amp_policy
from .desc import BlockDesc, OpDesc, block_outer_reads, block_written_names
from .registry import OPS, sub_blocks

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

# The lowering-time casts of bf16 mixed precision, for a program flagged
# ``amp`` that the ``amp-bf16`` pass does not rewrite (one of several
# blocks), as the JAX package's lowering applies them: while an op of the
# bf16 class (``amp.policy.WHITELIST``) runs, the float32 values it reads
# are read as bf16; while an op of the float32 class (the BLACKLIST, but
# batch_norm, which this path leaves alone) runs, bf16 values are read as
# float32.  A grad op takes its forward op's class, but for the fused head's
# grad, whose body casts its own operands.
AMP_WHITELIST = frozenset(_amp_policy.WHITELIST)
AMP_BLACKLIST = frozenset(_amp_policy.BLACKLIST - {"batch_norm"})
AMP_GRAD_UNCAST = frozenset(_amp_policy.GRAD_UNCAST)


def _amp_class(op_type: str) -> Optional[torch.dtype]:
    """The dtype an op's float reads are cast to under the lowering-time
    casts: bf16, float32, or None (read as they are)."""
    if op_type in AMP_GRAD_UNCAST:
        return None
    base = op_type[:-len("_grad")] if op_type.endswith("_grad") else op_type
    if base in AMP_WHITELIST:
        return torch.bfloat16
    if base in AMP_BLACKLIST:
        return torch.float32
    return None


def _amp_cast(v, want: Optional[torch.dtype]):
    """``v`` moved between float32 and bf16 to ``want``; any other value
    as it is."""
    if want is None or not isinstance(v, torch.Tensor) or v.dtype == want:
        return v
    if v.dtype in (torch.float32, torch.bfloat16):
        return v.to(want)
    return v


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


def is_dtensor(v) -> bool:
    """Whether ``v`` is a DTensor, without importing DTensor (a second
    and more at import): no value is one before something imported it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(v, mod.DTensor)


class TensorArrayVal(list):
    """The value of a TENSOR_ARRAY var: a list of tensors (Fluid's
    LoDTensorArray)."""


class LowerCtx:
    """Environment of one block run: ``env`` maps var name -> tensor.
    ``generator`` is the ``torch.Generator`` random ops draw from;
    ``device`` is where ops create new tensors; ``frees`` is
    :func:`plan_frees`' plan for the block, or None to keep every value.

    A control-flow op runs its sub-block in a :meth:`child` context:
    reads fall through to the parent (the block's lexical scope), writes
    stay in the child, and the child draws from the parent's generator
    unless it is given one of its own."""

    def __init__(self, block: BlockDesc, env: Dict[str, Any],
                 generator: Optional[torch.Generator], device: torch.device,
                 frees: Optional[List[List[str]]] = None,
                 parent: Optional["LowerCtx"] = None, amp: bool = False,
                 mesh=None):
        self.block = block
        self.env = env
        self.parent = parent
        # the executor's mesh: the values are DTensors over it
        self.mesh = mesh
        self.generator = generator
        self.device = device
        self.frees = frees
        # the lowering-time bf16 casts (``_amp_class``): ``amp_cast`` is
        # the dtype the running op's float reads are cast to
        self.amp = amp
        self.amp_cast: Optional[torch.dtype] = None

    @property
    def generator(self):
        if self._generator is None and self.parent is not None:
            return self.parent.generator
        return self._generator

    @generator.setter
    def generator(self, value):
        self._generator = value

    def read(self, name: str):
        v = self.read_opt(name)
        if v is None:
            raise KeyError(
                f"var {name!r} is not defined at this point of block {self.block.idx}"
            )
        return v if self.amp_cast is None else _amp_cast(v, self.amp_cast)

    def read_opt(self, name: str):
        v = self.env.get(name)
        if v is None and self.parent is not None:
            return self.parent.read_opt(name)
        return v

    def has(self, name: str) -> bool:
        return self.read_opt(name) is not None

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

    def child(self, block: BlockDesc, env: Optional[Dict[str, Any]] = None,
              frees: Optional[List[List[str]]] = None,
              generator: Optional[torch.Generator] = None,
              amp: Optional[bool] = None) -> "LowerCtx":
        """The context of ``block`` (a sub-block) run under this one, with
        this one's lowering-time casts unless ``amp`` says otherwise."""
        return LowerCtx(block, {} if env is None else env, generator, self.device,
                        frees=frees, parent=self, amp=self.amp if amp is None else amp,
                        mesh=self.mesh)


def _op_scope_name(op: OpDesc, index: Optional[int]) -> str:
    """The profiler range of one op: ``op<idx>:<type>@<file.py:line>``."""
    name = f"op{'?' if index is None else index}:{op.type}"
    callsite = op.callsite
    if callsite:
        name += "@" + callsite.replace("\\", "/").rsplit("/", 1)[-1].replace(" ", "")
    return name


def lower_op(ctx: LowerCtx, op: OpDesc, index: Optional[int] = None):
    if ctx.amp:
        prev, ctx.amp_cast = ctx.amp_cast, _amp_class(op.type)
        try:
            _lower_op_ranged(ctx, op, index)
        finally:
            ctx.amp_cast = prev
    else:
        _lower_op_ranged(ctx, op, index)


def _lower_op_ranged(ctx: LowerCtx, op: OpDesc, index: Optional[int]):
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
        if ctx.mesh is not None:
            _apply_sharding_constraints(ctx, op)
        return
    if op.type.endswith("_grad"):
        fwd_type = op.type[: -len("_grad")]
        if OPS.has(fwd_type) and OPS.get(fwd_type).lower is not None:
            _lower_generic_grad(ctx, op, fwd_type)
            return
    where = f" (op {index})" if index is not None else ""
    raise NotImplementedError(f"no lowering registered for op {op.type!r}{where}")


def _apply_sharding_constraints(ctx: LowerCtx, op: OpDesc):
    """Redistribute each non-persistable output of ``op`` whose var carries
    a ``sharding`` spec (``Variable.set_sharding``) to that spec's
    placements: the JAX package's ``with_sharding_constraint`` at the
    var's definition point (persistable state is placed by the executor)."""
    from ..parallel.layout import as_placements
    for name in op.output_names():
        if not name:
            continue
        vd = ctx.block.find_var(name)
        spec = vd.attrs.get("sharding") if vd is not None else None
        if spec is None or vd.persistable:
            continue
        val = ctx.env.get(name)
        if is_dtensor(val) and val.ndim == len(spec):
            want = as_placements(spec, ctx.mesh)
            if tuple(val.placements) != want:
                ctx.write(name, val.redistribute(ctx.mesh.device_mesh, want))


def _grads_to_params(ctx: LowerCtx, group: List[OpDesc]):
    """Under a mesh, each update's gradient redistributed to its
    parameter's placements (a partial sum reduced, all-reduce or
    reduce-scatter), so the group runs on shards that line up."""
    for op in group:
        gname, pname = op.input("Grad"), op.input("Param")
        if not gname or not pname:
            continue
        g, p = ctx.read_opt(gname[0]), ctx.read_opt(pname[0])
        if is_dtensor(g) and is_dtensor(p) \
                and tuple(g.placements) != tuple(p.placements):
            ctx.write(gname[0], g.redistribute(p.device_mesh, p.placements))


def op_names(block: BlockDesc, op: OpDesc) -> Tuple[List[str], List[str]]:
    """(reads, writes) of ``op`` in ``block``: its slots, and for an op that
    owns a sub-block (a control-flow op, or its grad) the names the
    sub-block reads from and writes to the enclosing scope, which the op's
    slots need not declare (StaticRNN declares only the parameters it
    reads)."""
    reads = [n for n in op.input_names() if n]
    writes = [n for n in op.output_names() if n]
    for sub in sub_blocks(op, block.program):
        reads += [n for n in block_outer_reads(sub) if n not in sub.vars]
        writes += [n for n in block_written_names(sub) if n not in sub.vars]
    return reads, writes


def plan_frees(block: BlockDesc, keep) -> List[List[str]]:
    """For each op of ``block``, the names no later op reads or writes:
    their values may leave the environment once it has run.  Names in
    ``keep`` (read after the block: its fetches, the state it writes, a
    sub-block's carries) and ``@SEQ_LEN`` lengths (read by name, not
    through a slot) never leave.  A name a sub-block reads counts as read
    by the op that owns the sub-block (:func:`op_names`)."""
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        reads, writes = op_names(block, op)
        for n in reads + writes:
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
            # feed, fetch and read are bound by the executor, not lowered
            if ops[i].type not in _SKIP_OPS:
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
    if ctx.mesh is not None:
        _grads_to_params(ctx, group)
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
                # read uncast: the cotangent takes its output's dtype below
                out_grad[on] = ctx.read_opt(gn)
                if out_grad[on] is None:
                    raise KeyError(f"var {gn!r} is not defined at this point of block "
                                   f"{ctx.block.idx}")

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
            cots.append(_cotangent_like(g.to(out.dtype), out))
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


def _cotangent_like(g, out):
    """Under a mesh, ``g`` in ``out``'s kind: a plain tensor (an op's
    whole value, the same on every rank) as a replicated DTensor for a
    DTensor output, a DTensor gathered whole for a plain one."""
    if is_dtensor(out) and not is_dtensor(g):
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(g, out.device_mesh, [Replicate()] * out.device_mesh.ndim,
                                  run_check=False)
    if is_dtensor(g) and not is_dtensor(out):
        return g.full_tensor()
    return g


class _GradTraceCtx(LowerCtx):
    """The context a forward lowering runs in while its gradient is taken:
    differentiable inputs come from the leaf tensors, every other read goes
    through to the real environment detached, and writes are captured.
    Random ops draw from a fork of the base generator's state, so the
    re-run neither advances the live generator nor depends on its later
    state (the JAX package reuses the forward's key without consuming it)."""

    def __init__(self, base: LowerCtx, overrides: Dict[str, Any]):
        super().__init__(base.block, {}, None, base.device, amp=base.amp, mesh=base.mesh)
        self.amp_cast = base.amp_cast
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
        return v if self.amp_cast is None else _amp_cast(v, self.amp_cast)

    def write(self, name: str, value):
        if name:
            self.captured[name] = value
