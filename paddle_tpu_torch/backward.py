"""Program-rewriting autodiff: ``append_backward``.

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

from .core.desc import OpDesc, VarDesc, grad_var_name, strip_grad_suffix
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
    program: Program = target.block.program
    block: Block = program.block(0)
    no_grad = set(no_grad_set or ())
    no_grad.update(v.name for v in block.vars.values() if v.stop_gradient)

    target_idx = None
    for i, o in enumerate(block.ops):
        if target.name in o.desc.output_names():
            target_idx = i
    if target_idx is None:
        raise ValueError(f"target var {target.name!r} is not produced in block 0")
    relevant = _collect_relevant_ops(block, target.name, target_idx)

    # 1. the seed: d target / d target = 1
    t_grad_name = grad_var_name(target.name)
    _ensure_grad_var(block, t_grad_name, target.name)
    grad_ops: List[OpDesc] = [OpDesc(
        type="fill_constant", outputs={"Out": [t_grad_name]},
        attrs={"shape": list(target.shape), "value": 1.0,
               "dtype": target.dtype, "op_role": "backward"})]
    produced: Dict[str, int] = defaultdict(int)
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
    if any(g.type == "lookup_table_grad" and g.attrs.get("is_sparse")
           for g in grad_ops):
        raise NotImplementedError(
            "sparse (SelectedRows) embedding gradients are not ported yet: "
            "build the embedding with is_sparse=False")
    for g in grad_ops:
        block.desc.append_op(g)
    block._sync_with_desc()

    # 4. (param, grad) pairs
    if parameter_list is not None:
        params = [block.var(n) for n in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    pairs = [(p, block.var(grad_var_name(p.name))) for p in params
             if produced[grad_var_name(p.name)] > 0]

    # a trainable param that feeds the loss but got no gradient means a
    # path to the loss is cut by a non-differentiable op: fail loudly
    # instead of never training it
    grad_names = {g.name for _, g in pairs}
    read_by_relevant = set()
    for idx in relevant:
        read_by_relevant.update(block.ops[idx].desc.input_names())
    candidates = [p.name for p in params
                  if grad_var_name(p.name) not in grad_names
                  and p.name in read_by_relevant and p.name not in no_grad]
    if candidates:
        user_prune = set(no_grad_set or ())
        cot = {target.name}
        for idx in reversed(relevant):
            op = block.ops[idx].desc
            if any(n in cot for n in op.output_names() if n):
                cot.update(n for n in op.input_names() if n and n not in user_prune)
        silent = [n for n in candidates if n in cot]
        if silent:
            raise ValueError(
                f"parameters {silent} influence the loss but received no "
                f"gradient: a path to the loss is blocked by a "
                f"non-differentiable op or a stop_gradient var.  Fix the "
                f"blocker, or add the parameter to no_grad_set to train "
                f"without it.")
    return pairs


def _ensure_grad_var(block: Block, grad_name: str, fwd_name: str):
    if block.desc.has_var_local(grad_name):
        return
    fwd = block.desc.find_var(fwd_name)
    block.desc.add_var(VarDesc(
        name=grad_name, shape=fwd.shape if fwd is not None else (),
        dtype=fwd.dtype if fwd is not None else DataType.FP32))
    block._sync_with_desc()
