"""Control-flow lowerings: ``while``, ``conditional_block``, ``recurrent``
(StaticRNN and DynamicRNN), the tensor arrays, and the grads of the first
two.

The JAX package turns each sub-block into XLA control flow inside its one
computation.  Here a sub-block runs in a child context of the block that
owns it (``LowerCtx.child``: reads fall through to the enclosing block,
writes stay local), and every form but one keeps its decisions on the
device, so a CUDA graph records the whole construct:

* a ``while`` with ``max_iters`` runs exactly ``max_iters`` trips; each
  runs the body and keeps the old carries where the condition, a device
  value, is false (``torch.where``), as the JAX package's masked
  ``lax.scan`` does.  Trips past the bound are cut in the forward and the
  grad alike;
* a ``while`` without ``max_iters`` reads its condition on the host before
  each trip, so it runs op by op (``executor.graph_blockers`` names it);
* a ``conditional_block`` runs its body and keeps the values from before
  it where the condition is false;
* a ``recurrent`` op runs its body once for each of the T steps of its
  inputs (T is a static dim).

A masked trip or branch still runs its body.  Its forward is selected
away, but its backward would give 0 x (the body's local Jacobian), which
is NaN where a dead body computes inf; the JAX package's ``lax.cond``
never runs the dead branch.  So a body reads each input that carries a
gradient through ``where(pred, v, v.detach())``: in a dead trip the
selection, not a product, zeroes what flows back.

The grads of ``while`` and ``conditional_block`` run the construct again
under autograd from the values the forward consumed (stashed in the
environment under ``<name>@PRE@<op_uid>``, with a fork of the generator
where the body draws); ``recurrent``'s is the generic grad over the T-step
loop.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.desc import OpDesc, block_outer_reads, block_written_names, grad_var_name
from ..core.lower import TensorArrayVal, _GradTraceCtx, lower_block, plan_frees
from ..core.registry import (OPS, mark_no_gradient, op_draws, register_grad_maker,
                             register_infer_shape, register_lowering)
from .common import in_shape

_INT32 = torch.int32


def _sub_block(ctx, op: OpDesc, attr: str = "sub_block"):
    idx = op.block_attr(attr)
    if idx is None:
        raise ValueError(f"{op.type} op has no {attr!r} block attr")
    return ctx.block.program.blocks[idx]


def _stash_key(name: str, uid: str) -> str:
    return f"{name}@PRE@{uid}"


def _stashed_read(ctx, name: str, uid: str):
    """``name`` as the control-flow op consumed it: the forward's stash,
    else the current value."""
    v = ctx.read_opt(_stash_key(name, uid))
    return v if v is not None else ctx.read(name)


def _diff_names(block, names, no_grad_set) -> List[str]:
    """``names`` that may take a gradient: float, dense, not stopped."""
    out = []
    for n in names:
        vd = block.find_var(n)
        if n in no_grad_set or vd is None or not vd.dtype.is_floating or vd.stop_gradient:
            continue
        out.append(n)
    return out


def _plan(sub, keep):
    """(``plan_frees``' plan of ``sub`` keeping ``keep``, the names the
    sub-block reads from outside that are not in ``keep``): made once a
    lowering, used by each of its trips."""
    return plan_frees(sub, set(keep)), [n for n in block_outer_reads(sub) if n not in keep]


def _like(new, old):
    """A body's new value of a carry, in the carry's dtype and shape."""
    return new.to(old.dtype).reshape(old.shape)


def _guard(pred, v):
    """``v`` as a masked body reads it: unchanged forward, and where ``v``
    carries a gradient, none flows back from a dead trip (module
    docstring)."""
    if isinstance(v, torch.Tensor) and v.requires_grad:
        return torch.where(pred, v, v.detach())
    return v


def _run_body(ctx, sub, env, plan, pred=None, generator=None, amp=None):
    """Lower ``sub`` once in a child of ``ctx`` over ``env`` (the names the
    construct binds); ``plan``: ``_plan`` of ``sub``.  With ``pred`` (a
    masked trip or branch) each value with a gradient that the body reads
    from outside is bound guarded.  ``amp``: the child's lowering-time
    casts (default: ``ctx``'s)."""
    frees, outer = plan
    if pred is not None:
        env = {n: _guard(pred, v) for n, v in env.items()}
        for n in outer:
            if n not in env:
                v = ctx.read_opt(n)
                if isinstance(v, torch.Tensor) and v.requires_grad:
                    env[n] = _guard(pred, v)
    bctx = ctx.child(sub, env, frees=frees, generator=generator, amp=amp)
    lower_block(bctx, sub)
    return bctx


def _fork(gen):
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    return copy


def _stash(ctx, op: OpDesc, sub, carried: List[str], vals, extra: Dict[str, object]):
    """Keep what the op's grad re-runs from, where a grad op of this op
    follows in the block: the carries' values before the op, its closure
    reads, a fork of the generator where the body draws, and ``extra``.
    Without a grad op nothing is kept, so nothing outlives its last
    reader."""
    uid = op.attr("op_uid")
    if not uid or not any(o.type == op.type + "_grad" and o.attr("op_uid") == uid
                          for o in ctx.block.ops):
        return
    for n, v in zip(carried, vals):
        ctx.write(_stash_key(n, uid), v)
    for n in op.input("X"):
        if n not in carried and ctx.has(n):
            ctx.write(_stash_key(n, uid), ctx.read(n))
    for k, v in extra.items():
        ctx.write(_stash_key(k, uid), v)
    if any(op_draws(o, ctx.block.program) for o in sub.ops):
        ctx.write(_stash_key("@RNG", uid), _fork(ctx.generator))


def _grad_through(ctx, op: OpDesc, names: List[str], pre_vals, run, out_slot: str,
                  grad_names_attr: str, pre_slot: str):
    """The shared grad of ``while`` and ``conditional_block``: ``run(base,
    vals, generator)`` re-runs the construct from the carries' values
    ``vals`` in the context ``base``, where the closure reads ``X`` are
    leaves; autograd pulls the cotangents of the carries' final values back
    to the closure reads (``X@GRAD_SLOT``) and the carries' values before
    the op (``<pre_slot>@GRAD_SLOT``)."""
    uid = op.attr("op_uid")
    read_names = list(op.input("X"))
    grad_names = op.attr(grad_names_attr, [])
    diff = [n for n in grad_names if n in names]
    gen = ctx.read_opt(_stash_key("@RNG", uid))
    with torch.enable_grad():
        reads = [_stashed_read(ctx, n, uid).detach().requires_grad_(True) for n in read_names]
        leaves = {n: pre_vals[names.index(n)].detach().requires_grad_(True) for n in diff}
        base = _GradTraceCtx(ctx, dict(zip(read_names, reads)))
        vals = [leaves.get(n, v) for n, v in zip(names, pre_vals)]
        finals = dict(zip(names, run(base, vals, None if gen is None else _fork(gen))))
        g_by_name = dict(zip(grad_names, op.input("__outgrad__" + out_slot)))
        outs, cots = [], []
        for n in diff:
            gname = g_by_name.get(n)
            g = ctx.read_opt(gname) if gname else None
            if g is not None and finals[n].requires_grad:
                outs.append(finals[n])
                cots.append(g.to(finals[n].dtype).reshape(finals[n].shape))
        primals = reads + [leaves[n] for n in diff]
        grads = torch.autograd.grad(outs, primals, cots, allow_unused=True) if outs else \
            [None] * len(primals)
    grads = [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(primals, grads)]
    for gname, g in zip(op.output("X@GRAD_SLOT"), grads[:len(reads)]):
        if gname:
            ctx.write(gname, g)
    pre_out = dict(zip(grad_names, op.output(pre_slot + "@GRAD_SLOT")))
    for n, g in zip(diff, grads[len(reads):]):
        if pre_out.get(n):
            ctx.write(pre_out[n], g)


# --------------------------------------------------------------------- while

def _while_carries(ctx, op, sub) -> List[str]:
    """Every name the body writes that exists outside it: the loop's
    carries (the condition among them)."""
    carried = [n for n in block_written_names(sub) if n not in sub.vars and ctx.has(n)]
    cond_name = op.input("Condition")[0]
    if cond_name not in carried:
        raise ValueError(
            "while sub-block must write the Condition var each iteration "
            f"({cond_name!r} is never written -- would loop forever)")
    return carried


def _while_masked(ctx, sub, carried, cond_idx, vals, max_iters, generator=None):
    """``max_iters`` trips, each keeping the old carries where the
    condition is false (the forward with ``max_iters``, and its grad's
    re-run)."""
    plan = _plan(sub, carried)
    for _ in range(max_iters):
        pred = vals[cond_idx].reshape(()).to(torch.bool)
        bctx = _run_body(ctx, sub, dict(zip(carried, vals)), plan, pred, generator)
        vals = [torch.where(pred, _like(bctx.read(n), v), v) for n, v in zip(carried, vals)]
    return vals


@register_lowering("while")
def _while(ctx, op):
    """The body runs while the Condition carry holds; the body must write
    the condition each trip.  With ``max_iters``, a fixed number of masked
    trips on the device; without, the condition is read on the host
    before each trip."""
    sub = _sub_block(ctx, op)
    carried = _while_carries(ctx, op, sub)
    cond_idx = carried.index(op.input("Condition")[0])
    vals = [ctx.read(n) for n in carried]
    _stash(ctx, op, sub, carried, vals, {"@CARRIED": list(carried)})
    max_iters = op.attr("max_iters")
    if max_iters is not None:
        vals = _while_masked(ctx, sub, carried, cond_idx, vals, int(max_iters))
    else:
        plan = _plan(sub, carried)
        while bool(vals[cond_idx].reshape(()).item()):
            bctx = _run_body(ctx, sub, dict(zip(carried, vals)), plan)
            vals = [_like(bctx.read(n), v) for n, v in zip(carried, vals)]
    for n, v in zip(carried, vals):
        ctx.write(n, v)


@register_grad_maker("while")
def _while_grad_maker(op, block, no_grad_set):
    """Grads flow into the closure reads the body makes (``X``) and the
    carries' values before the loop; only a bounded loop can be re-run
    that way."""
    if op.attr("max_iters") is None:
        raise ValueError(
            "gradients were requested through a While loop without max_iters: its trip "
            "count is read on the host, so it cannot be re-run for a gradient.  Construct "
            "it as layers.While(cond, max_iters=N) (an upper bound on trips), or use "
            "StaticRNN/DynamicRNN for recurrences.")
    if op.attr("op_uid") is None:
        raise ValueError("this While op has no op_uid attr; rebuild the program with "
                         "layers.While")
    carried_set = set(op.output("Out"))
    diff_reads = _diff_names(block, [n for n in op.input("X") if n not in carried_set],
                             no_grad_set)
    diff_carried = _diff_names(block, op.output("Out"), no_grad_set)
    if not diff_reads and not diff_carried:
        return []
    g = OpDesc(type="while_grad", attrs=dict(op.attrs))
    g.inputs["Condition"] = list(op.input("Condition"))
    g.inputs["X"] = list(diff_reads)
    g.inputs["__outgrad__Out"] = [grad_var_name(n) for n in diff_carried]
    g.attrs["carried_grad_names"] = list(diff_carried)
    g.outputs["X@GRAD_SLOT"] = [grad_var_name(n) for n in diff_reads]
    g.outputs["Carried@GRAD_SLOT"] = [grad_var_name(n) for n in diff_carried]
    return [g]


@register_lowering("while_grad")
def _while_grad(ctx, op):
    """The loop again, masked, from the stashed values before it, under
    autograd."""
    sub = _sub_block(ctx, op)
    uid = op.attr("op_uid")
    carried = list(ctx.read(_stash_key("@CARRIED", uid)))
    cond_idx = carried.index(op.input("Condition")[0])
    pre = [ctx.read(_stash_key(n, uid)) for n in carried]
    max_iters = int(op.attr("max_iters"))
    _grad_through(ctx, op, carried, pre,
                  lambda base, vals, gen: _while_masked(base, sub, carried, cond_idx, vals,
                                                        max_iters, gen),
                  "Out", "carried_grad_names", "Carried")


# --------------------------------------------------------- conditional_block

def _cond_branch(ctx, sub, cond, out_names, vals, generator=None):
    """The body run, its writes kept where ``cond`` holds and the values
    before it elsewhere."""
    bctx = _run_body(ctx, sub, dict(zip(out_names, vals)), _plan(sub, out_names), cond,
                     generator)
    return [torch.where(cond, _like(bctx.read(n), v), v) for n, v in zip(out_names, vals)]


@register_lowering("conditional_block")
def _conditional_block(ctx, op):
    """The sub-block where the scalar Cond holds.  What it writes must be
    defined before it (the values where the condition is false)."""
    sub = _sub_block(ctx, op)
    cond = ctx.read(op.input("Cond")[0]).reshape(()).to(torch.bool)
    written = block_written_names(sub)
    out_names = [n for n in written if ctx.has(n)]
    missing = [n for n in written if n not in sub.vars and not ctx.has(n)
               and ctx.block.find_var(n) is not None]
    if missing:
        raise ValueError(
            f"conditional_block writes {missing} which are undefined in the enclosing scope; "
            f"initialize them before the block (the values where the condition is false)")
    vals = [ctx.read(n) for n in out_names]
    _stash(ctx, op, sub, out_names, vals, {"@COND": cond, "@OUTS": list(out_names)})
    for n, v in zip(out_names, _cond_branch(ctx, sub, cond, out_names, vals)):
        ctx.write(n, v)


@register_grad_maker("conditional_block")
def _conditional_block_grad_maker(op, block, no_grad_set):
    """On the true branch grads flow through the body into its closure
    reads and the values before it; on the false branch the values pass
    through."""
    if op.attr("op_uid") is None:
        raise ValueError("this conditional_block op has no op_uid attr; rebuild the "
                         "program with layers.ConditionalBlock")
    outs_set = set(op.output("Out"))
    diff_reads = _diff_names(block, [n for n in op.input("X") if n not in outs_set],
                             no_grad_set)
    diff_outs = _diff_names(block, op.output("Out"), no_grad_set)
    if not diff_reads and not diff_outs:
        return []
    g = OpDesc(type="conditional_block_grad", attrs=dict(op.attrs))
    g.inputs["Cond"] = list(op.input("Cond"))
    g.inputs["X"] = list(diff_reads)
    g.inputs["__outgrad__Out"] = [grad_var_name(n) for n in diff_outs]
    g.attrs["out_grad_names"] = list(diff_outs)
    g.outputs["X@GRAD_SLOT"] = [grad_var_name(n) for n in diff_reads]
    g.outputs["PreOut@GRAD_SLOT"] = [grad_var_name(n) for n in diff_outs]
    return [g]


@register_lowering("conditional_block_grad")
def _conditional_block_grad(ctx, op):
    sub = _sub_block(ctx, op)
    uid = op.attr("op_uid")
    out_names = list(ctx.read(_stash_key("@OUTS", uid)))
    cond = ctx.read(_stash_key("@COND", uid))
    pre = [ctx.read(_stash_key(n, uid)) for n in out_names]
    _grad_through(ctx, op, out_names, pre,
                  lambda base, vals, gen: _cond_branch(base, sub, cond, out_names, vals, gen),
                  "Out", "out_grad_names", "PreOut")


# ----------------------------------------------------------------- recurrent

@register_lowering("recurrent")
def _recurrent(ctx, op):
    """StaticRNN: the sub-block once for each step of axis 0 of
    ``Inputs``.  attrs: ``step_input_vars`` (the sub-block's names of each
    input's step), ``ex_state_vars`` / ``state_vars`` (each memory's name
    before and after a step, in ``InitStates``' order),
    ``step_output_vars`` (stacked into ``Outputs``).  Parameters the body
    reads resolve through this context, so the generic grad's re-run takes
    their gradients."""
    sub = _sub_block(ctx, op)
    step_in = list(op.attr("step_input_vars", []))
    ex_states = list(op.attr("ex_state_vars", []))
    state_names = list(op.attr("state_vars", []))
    step_out = list(op.attr("step_output_vars", []))
    xs = [ctx.read(n) for n in op.input("Inputs")]
    if not xs:
        raise ValueError("recurrent op has no step input: its step count comes from Inputs")
    states = [ctx.read(n) for n in op.input("InitStates")]
    plan = _plan(sub, list(dict.fromkeys(state_names + step_out)))
    outs: List[list] = [[] for _ in step_out]
    for t in range(xs[0].shape[0]):
        env = dict(zip(step_in, (x[t] for x in xs)))
        env.update(zip(ex_states, states))
        # as in the JAX package, a step runs without the lowering-time casts
        bctx = _run_body(ctx, sub, env, plan, amp=False)
        states = [_like(bctx.read(n), s) for n, s in zip(state_names, states)]
        for o, n in zip(outs, step_out):
            o.append(bctx.read(n))
    for name, o in zip(op.output("Outputs"), outs):
        ctx.write(name, torch.stack(o))
    for name, s in zip(op.output("LastStates"), states):
        ctx.write(name, s)


@register_infer_shape("recurrent")
def _recurrent_shape(block, op):
    """Outputs: [T] + the sub-block's step output shape; LastStates: each
    initial state's shape."""
    if not op.input("Inputs"):
        return
    t_dim = in_shape(block, op, "Inputs")[0]
    sub_idx = op.block_attr("sub_block")
    sub = block.program.blocks[sub_idx] if sub_idx is not None else None
    for name, sub_name in zip(op.output("Outputs"), op.attr("step_output_vars", [])):
        vd = block.find_var(name)
        svd = sub.find_var(sub_name) if sub is not None else None
        if vd is not None and svd is not None:
            vd.shape = (t_dim,) + tuple(svd.shape)
            vd.dtype = svd.dtype
    for name, init in zip(op.output("LastStates"), op.input("InitStates")):
        vd, ivd = block.find_var(name), block.find_var(init)
        if vd is not None and ivd is not None:
            vd.shape = tuple(ivd.shape)
            vd.dtype = ivd.dtype


# -------------------------------------------------------------- tensor arrays

@register_lowering("array_write")
def _array_write(ctx, op):
    """Append X to the array (a new list: the old value may be a carry's
    value before a loop).  As in the JAX package, writes are sequential, so
    the index I is not read."""
    name = op.output("Out")[0]
    arr = ctx.read_opt(name)
    arr = TensorArrayVal(arr) if isinstance(arr, TensorArrayVal) else TensorArrayVal()
    arr.append(ctx.read_slot(op, "X"))
    ctx.write(name, arr)


@register_lowering("array_read")
def _array_read(ctx, op):
    """The array's element at the index tensor I, gathered from the stacked
    array on the device (never read on the host: a graph records it).  As
    the JAX gather, a negative index counts from the end and an index out
    of range is clamped."""
    arr = ctx.read_slot(op, "X")
    if not isinstance(arr, TensorArrayVal):
        raise TypeError("array_read input is not a tensor array")
    stacked = torch.stack(list(arr))
    idx = ctx.read_slot(op, "I").reshape(1).long()
    idx = torch.where(idx < 0, idx + len(arr), idx).clamp(0, len(arr) - 1)
    ctx.write_slot(op, "Out", torch.index_select(stacked, 0, idx)[0])


@register_lowering("array_length")
def _array_length(ctx, op):
    arr = ctx.read_slot(op, "X")
    ctx.write_slot(op, "Out", torch.full((), len(arr), dtype=_INT32, device=ctx.device))


mark_no_gradient("array_write", "array_read", "array_length")


def _alias(new_type: str, existing_type: str):
    """``new_type`` lowered, shaped and differentiated as ``existing_type``
    (Fluid's names of the array ops)."""
    src, dst = OPS.get(existing_type), OPS.get_or_create(new_type)
    dst.lower, dst.infer_shape, dst.grad_maker = src.lower, src.infer_shape, src.grad_maker
    dst.no_gradient, dst.non_diff_inputs = src.no_gradient, src.non_diff_inputs


_alias("write_to_array", "array_write")
_alias("read_from_array", "array_read")
_alias("lod_array_length", "array_length")
