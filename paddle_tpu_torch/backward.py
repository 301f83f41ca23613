"""Program-rewriting autodiff: ``append_backward``, ``calc_gradient`` and
``split_for_gradient_accumulation``.

Gradients are ops appended to the program, so the optimizer and the
executor see one IR.  Each op's grad ops come from its registered grad
maker or from ``registry.default_grad_maker``, whose ``<type>_grad`` op is
lowered by re-running the forward lowering under torch autograd
(``core/lower.py``).  The same construction as the JAX package's
``backward.py``, op for op, so both packages build identical training
ProgramDescs.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core.desc import OpDesc, VarDesc, VarType, grad_var_name, strip_grad_suffix
from .core.dtypes import DataType
from .core.framework import Block, Program, Variable
from .core.registry import OPS, default_grad_maker


def _collect_relevant_ops(block: Block, loss_name: str, stop_idx: int) -> List[int]:
    """Backward slice: indices of ops (<= stop_idx) that influence the loss."""
    needed: Set[str] = {loss_name}
    keep: List[int] = []
    for i in range(stop_idx, -1, -1):
        op = block.ops[i].desc
        if set(op.output_names()) & needed:
            keep.append(i)
            needed.update(n for n in op.input_names() if n)
    keep.reverse()
    return keep


def append_backward(target: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None
                    ) -> List[Tuple[Variable, Variable]]:
    """Append grad ops for the loss ``target`` and return
    [(param, grad_var), ...]."""
    pairs, _ = _backward_core([target], [None], parameter_list, no_grad_set,
                              check_params=True)
    return pairs


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of ``targets`` (one var or a list; their gradients sum into
    shared inputs) with respect to ``inputs``.  ``target_gradients`` gives
    each target's cotangent as a var of its shape (None: ones).  Returns
    one grad var per input, None where this call produced no gradient."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(
            f"calc_gradient got {len(targets)} targets but {len(target_gradients)} "
            f"target_gradients: they must align 1:1 (None entries seed with ones)")
    _, written = _backward_core(list(targets), list(target_gradients), None,
                                no_grad_set, check_params=False)
    block = targets[0].block
    return [block.var(grad_var_name(v.name)) if grad_var_name(v.name) in written else None
            for v in inputs]


def _backward_core(targets, target_gradients, parameter_list, no_grad_set, check_params):
    """``append_backward`` (one target, a unit seed) and ``calc_gradient``
    (several targets, optional cotangent seeds) alike.  Returns ``(pairs,
    written)``: the (param, grad) pairs and the grad names this call
    produced."""
    program: Program = targets[0].block.program
    block: Block = program.block(0)
    no_grad = set(no_grad_set or ())
    no_grad.update(v.name for v in block.vars.values() if v.stop_gradient)

    relevant_set: Set[int] = set()
    for t in targets:
        target_idx = None
        for i, o in enumerate(block.ops):
            if t.name in o.desc.output_names():
                target_idx = i
        if target_idx is None:
            raise ValueError(f"target var {t.name!r} is not produced in block 0")
        relevant_set.update(_collect_relevant_ops(block, t.name, target_idx))
    relevant = sorted(relevant_set)

    # 1. the seeds: d target / d target = 1, or the given cotangent
    grad_ops: List[OpDesc] = []
    produced: Dict[str, int] = defaultdict(int)
    for t, tg in zip(targets, target_gradients):
        t_grad_name = grad_var_name(t.name)
        _ensure_grad_var(block, t_grad_name, t.name)
        if tg is None:
            grad_ops.append(OpDesc(
                type="fill_constant", outputs={"Out": [t_grad_name]},
                attrs={"shape": list(t.shape), "value": 1.0,
                       "dtype": t.dtype, "op_role": "backward"}))
        else:
            if tuple(tg.shape) != tuple(t.shape):
                raise ValueError(
                    f"target_gradient {tg.name!r} shape {tuple(tg.shape)} does not match "
                    f"target {t.name!r} shape {tuple(t.shape)}")
            grad_ops.append(OpDesc(
                type="assign", inputs={"X": [tg.name]}, outputs={"Out": [t_grad_name]},
                attrs={"op_role": "backward"}))
        produced[t_grad_name] += 1

    # 2. relevant ops in reverse; a grad name produced twice is written to
    #    a renamed var and summed into the canonical one
    def rename_dup(g: OpDesc) -> List[OpDesc]:
        extra: List[OpDesc] = []
        for names in g.outputs.values():
            for i, n in enumerate(names):
                if not n:
                    continue
                if produced[n] > 0:
                    alias = f"{n}@RENAME@{produced[n]}"
                    names[i] = alias
                    _ensure_grad_var(block, alias, strip_grad_suffix(n))
                    extra.append(OpDesc(
                        type="sum", inputs={"X": [n, alias]},
                        outputs={"Out": [n]}, attrs={"op_role": "backward"}))
                produced[n] += 1
        return extra

    for idx in reversed(relevant):
        fwd = block.ops[idx].desc
        info = OPS.get_or_create(fwd.type)
        out_grads_avail = any(produced[grad_var_name(n)] > 0
                              for n in fwd.output_names() if n)
        gs = []
        if out_grads_avail and not info.no_gradient:
            maker = info.grad_maker or default_grad_maker
            gs = maker(fwd, block.desc, no_grad)
            for g in gs:
                g.attrs.setdefault("op_role", "backward")
                # output grads never produced are dropped; the generic
                # lowering zero-fills their cotangents
                for slot in [s for s in g.inputs if s.startswith("__outgrad__")]:
                    g.inputs[slot] = [n if produced[n] > 0 else ""
                                      for n in g.inputs[slot]]
        # this op (re)defined its outputs: their cotangents are consumed here
        for n in fwd.output_names():
            if n:
                produced[grad_var_name(n)] = 0
        for g in gs:
            extra = rename_dup(g)
            for names in g.outputs.values():
                for n in names:
                    if n:
                        _ensure_grad_var(block, n, strip_grad_suffix(n))
            grad_ops.append(g)
            grad_ops.extend(extra)

    # 3. append to the program
    written = {n for g in grad_ops for names in g.outputs.values() for n in names if n}
    for g in grad_ops:
        block.desc.append_op(g)
        # a sparse embedding's gradient is a SelectedRows, not a dense
        # tensor: the clips, regularizers and the kernel pass read the type
        if g.type == "lookup_table_grad" and g.attrs.get("is_sparse"):
            for n in g.output_names():
                vd = block.desc.find_var(n) if n else None
                if vd is not None:
                    vd.type = VarType.SELECTED_ROWS
    block._sync_with_desc()

    # 4. (param, grad) pairs
    if parameter_list is not None:
        params = [block.var(n) for n in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    pairs = [(p, block.var(grad_var_name(p.name))) for p in params
             if produced[grad_var_name(p.name)] > 0]
    if check_params:
        _check_params(block, targets, relevant, params, pairs, no_grad, no_grad_set)
    return pairs, written


def _check_params(block, targets, relevant, params, pairs, no_grad, no_grad_set):
    """A trainable param that feeds the loss but got no gradient means a
    path to the loss is cut by a non-differentiable op: fail loudly instead
    of never training it."""
    grad_names = {g.name for _, g in pairs}
    read_by_relevant = set()
    for idx in relevant:
        read_by_relevant.update(block.ops[idx].desc.input_names())
    candidates = [p.name for p in params
                  if grad_var_name(p.name) not in grad_names
                  and p.name in read_by_relevant and p.name not in no_grad]
    if candidates:
        user_prune = set(no_grad_set or ())
        cot = {t.name for t in targets}
        for idx in reversed(relevant):
            op = block.ops[idx].desc
            if any(n in cot for n in op.output_names() if n):
                cot.update(n for n in op.input_names() if n and n not in user_prune)
        silent = [n for n in candidates if n in cot]
        if silent:
            raise ValueError(
                f"parameters {silent} influence the loss but received no "
                f"gradient: a path to the loss is blocked by a "
                f"non-differentiable op (e.g. a While without max_iters, or "
                f"array ops) or by a stop_gradient var (e.g. a "
                f"fill_constant-initialized accumulator: set "
                f"var.stop_gradient = False).  Fix the blocker, or add the "
                f"parameter to no_grad_set to train without it.")


def _ensure_grad_var(block: Block, grad_name: str, fwd_name: str):
    if block.desc.has_var_local(grad_name):
        return
    fwd = block.desc.find_var(fwd_name)
    block.desc.add_var(VarDesc(
        name=grad_name, shape=fwd.shape if fwd is not None else (),
        dtype=fwd.dtype if fwd is not None else DataType.FP32))
    block._sync_with_desc()


ACCUM_SUFFIX = "@ACC"


def split_for_gradient_accumulation(program: Program, startup_program: Program,
                                    accum_steps: int):
    """Split a built forward + backward + optimize program into the
    gradient-accumulation pair ``(accum_program, apply_program)``:

    * ``accum_program``: forward and backward of one micro-batch, without
      the optimize and lr-schedule ops; each gradient an update reads is
      summed into a persistable ``<grad>@ACC`` buffer;
    * ``apply_program``: the updates and the schedule, each reading its
      gradient as ``acc / accum_steps`` (the mean over the window), then the
      buffers filled with zeros for the next window.

    ``startup_program`` gains the buffers' zero fills.  Run the accumulate
    program every micro-step and the apply program every ``accum_steps``-th
    (``Trainer(accum_steps=N)``).  Gradient clipping and regularization
    stay in the accumulate program, so they act on each micro-batch's
    gradients, as in the JAX package.  Both programs write only state that
    exists (the buffers, parameters, slots and counter), so on the card
    each replays one CUDA graph."""
    if accum_steps < 2:
        raise ValueError(f"accum_steps must be >= 2, got {accum_steps}")
    src = program.desc.block(0)
    pairs, seen = [], set()
    for od in src.ops:
        if od.attrs.get("op_role") != "optimize":
            continue
        p = (od.inputs.get("Param") or [None])[0]
        g = (od.inputs.get("Grad") or [None])[0]
        if p and g and g not in seen:
            seen.add(g)
            pairs.append((p, g))
    if not pairs:
        raise ValueError("no optimizer ops with Param/Grad inputs found: call "
                         "optimizer.minimize() before splitting for accumulation")

    accum, apply_p = program.clone(), program.clone()
    abd, pbd, sbd = accum.desc.block(0), apply_p.desc.block(0), startup_program.desc.block(0)
    abd.ops = [od for od in abd.ops if od.attrs.get("op_role") not in ("optimize", "lr_sched")]
    pre, post = [], []
    for pname, gname in pairs:
        pvd = src.find_var(pname)
        acc_name = gname + ACCUM_SUFFIX
        for bd in (abd, pbd, sbd):
            vd = VarDesc(name=acc_name, shape=tuple(pvd.shape), dtype=pvd.dtype,
                         persistable=True)
            vd.attrs["slot_of"] = pname
            bd.add_var(vd)
        abd.append_op(OpDesc(type="sum", inputs={"X": [acc_name, gname]},
                             outputs={"Out": [acc_name]}, attrs={"op_role": "backward"}))
        sbd.append_op(OpDesc(type="fill_constant", outputs={"Out": [acc_name]},
                             attrs={"shape": list(pvd.shape), "dtype": pvd.dtype,
                                    "value": 0.0}))
        # the window's mean, written to the grad name the updates read
        pre.append(OpDesc(type="scale", inputs={"X": [acc_name]}, outputs={"Out": [gname]},
                          attrs={"scale": 1.0 / accum_steps, "op_role": "optimize"}))
        post.append(OpDesc(type="fill_constant", outputs={"Out": [acc_name]},
                           attrs={"shape": list(pvd.shape), "dtype": pvd.dtype,
                                  "value": 0.0, "op_role": "optimize"}))
    pbd.ops = pre + [od for od in pbd.ops
                     if od.attrs.get("op_role") in ("optimize", "lr_sched")] + post
    for prog in (accum, apply_p, startup_program):
        prog.desc._bump()
        prog.sync_with_desc()
    return accum, apply_p
