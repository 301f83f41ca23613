"""Operator registry: op type -> lowering, compile-time infer-shape and
gradient metadata.

``lower(ctx, op)`` reads the op's inputs from the executor's environment
(torch tensors), computes with torch functions or a hand-written kernel,
and writes its outputs back.  ``infer_shape(block, op)`` propagates shapes
and dtypes into the block's VarDescs when the op is appended, exactly as
the JAX package does, so both packages build identical ProgramDescs.

``group_lower(ctx, ops)`` lowers several ops of one family in one call
(the optimizer updates of a step, to one multi-tensor kernel launch);
``group_key(op)`` is equal for ops that one such call may take.
``core/lower.py`` schedules the groups.

``draws`` marks a lowering that draws from the executor's generator
(``True``, or ``draws(op)`` for an op that draws only under some attrs;
:func:`op_draws`): a CUDA graph of a program with such an op registers
the generator, so each replay draws anew.  A generic grad of such an op
forks the generator (:func:`op_forks`), and its program gets no graph.

:meth:`OpInfoMap.infer_shape_fn` is the static analysis's lookup (the
verifier's shape checker and the memory planner): a ``<type>_grad`` op
without a rule of its own gets the structural grad rule, each
``<name>@GRAD`` output taking its forward var's shape and dtype.

``grad_maker(op, block, no_grad_set)`` emits the grad OpDescs that
``append_backward`` appends.  Without one, :func:`default_grad_maker`
emits a single ``<type>_grad`` op whose lowering is derived from the
forward lowering with torch autograd (``core/lower.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .desc import BlockDesc, OpDesc, grad_var_name, strip_grad_suffix

LowerFn = Callable[..., None]  # (ctx, op) -> None
InferShapeFn = Callable[[BlockDesc, OpDesc], None]
# grad_maker(op, block, no_grad_set) -> list[OpDesc]
GradMakerFn = Callable[..., Any]


@dataclass
class OpInfo:
    type: str
    lower: Optional[LowerFn] = None
    infer_shape: Optional[InferShapeFn] = None
    grad_maker: Optional[GradMakerFn] = None
    # True if the op has no gradient (initializers, optimizer updates...)
    no_gradient: bool = False
    # input slots whose tensors are not differentiable (integer ids...)
    non_diff_inputs: tuple = ()
    # (ctx, ops) -> None over ops whose group_key(op) are equal
    group_lower: Optional[Callable[..., None]] = None
    group_key: Optional[Callable[[OpDesc], Any]] = None
    # True, or draws(op): the lowering draws from the executor's generator
    draws: Any = False


class OpInfoMap:
    def __init__(self):
        self._map: Dict[str, OpInfo] = {}

    def get(self, op_type: str) -> OpInfo:
        if op_type not in self._map:
            raise KeyError(f"op type {op_type!r} is not registered")
        return self._map[op_type]

    def get_or_create(self, op_type: str) -> OpInfo:
        if op_type not in self._map:
            self._map[op_type] = OpInfo(type=op_type)
        return self._map[op_type]

    def has(self, op_type: str) -> bool:
        return op_type in self._map

    def infer_shape_fn(self, op_type: str) -> Optional[InferShapeFn]:
        """The registered infer-shape rule of ``op_type``, or None (shape
        propagation skips an op without one); a ``<type>_grad`` op without
        a rule gets :func:`_generic_grad_infer_shape`."""
        info = self._map.get(op_type)
        fn = info.infer_shape if info is not None else None
        if fn is None and op_type.endswith("_grad"):
            return _generic_grad_infer_shape
        return fn

    def infer_shape_coverage(self) -> List[str]:
        """Op types with a registered infer-shape rule."""
        return sorted(t for t, i in self._map.items() if i.infer_shape is not None)


def _generic_grad_infer_shape(block: BlockDesc, op: OpDesc):
    """A gradient has its forward var's shape and dtype (what the default
    grad maker guarantees); renamed accumulation copies
    (``x@GRAD@RENAME@...``) strip back to the same forward var."""
    for names in op.outputs.values():
        for n in names:
            if not n:
                continue
            base_name = strip_grad_suffix(n)
            if base_name == n:
                continue
            gvd = block.find_var(n)
            base = block.find_var(base_name)
            if gvd is None or base is None or not base.shape:
                continue
            gvd.shape = tuple(base.shape)
            gvd.dtype = base.dtype


OPS = OpInfoMap()


def register_lowering(op_type: str, *, no_gradient: bool = False,
                      non_diff_inputs: tuple = (), draws=False):
    def deco(fn: LowerFn):
        info = OPS.get_or_create(op_type)
        info.lower = fn
        info.no_gradient = info.no_gradient or no_gradient
        info.non_diff_inputs = non_diff_inputs or info.non_diff_inputs
        info.draws = draws
        return fn

    return deco


def sub_blocks(op: OpDesc, program) -> List[BlockDesc]:
    """The sub-blocks ``op`` owns (a control-flow op's body; its grad op
    carries the same attr) in ``program`` (a ProgramDesc; None: none)."""
    if program is None:
        return []
    return [program.blocks[b] for b in (op.block_attr(a) for a in op.attrs) if b is not None]


def op_draws(op: OpDesc, program=None) -> bool:
    """Whether ``op``'s lowering draws from the executor's generator; a
    ``<type>_grad`` op lowered generically re-runs its forward's lowering
    and draws where the forward does, and a control-flow op draws where an
    op of its sub-block (in ``program``, a ProgramDesc) does."""
    info = OPS.get(op.type) if OPS.has(op.type) else None
    if (info is None or info.lower is None) and op.type.endswith("_grad"):
        fwd = op.type[: -len("_grad")]
        info = OPS.get(fwd) if OPS.has(fwd) else None
    if info is not None and (info.draws(op) if callable(info.draws) else info.draws):
        return True
    return any(op_draws(o, program) for sub in sub_blocks(op, program) for o in sub.ops)


def op_forks(op: OpDesc, program=None) -> bool:
    """Whether ``op`` draws from a fork of the executor's generator, a
    generator no CUDA graph knows of: a ``<type>_grad`` op lowered
    generically whose forward draws (its re-run draws from a fork,
    ``core/lower.py``), or the grad of a control-flow op whose sub-block
    draws (it re-runs the body from the fork its forward stashed)."""
    if not op.type.endswith("_grad"):
        return False
    info = OPS.get(op.type) if OPS.has(op.type) else None
    if (info is None or info.lower is None) and op_draws(op, program):
        return True
    return any(op_draws(o, program) for sub in sub_blocks(op, program) for o in sub.ops)


def register_group_lowering(*op_types: str, key: Callable[[OpDesc], Any]):
    """``fn(ctx, ops)`` lowers a list of ops of ``op_types`` whose ``key(op)``
    are equal, in one call."""
    def deco(fn):
        for op_type in op_types:
            info = OPS.get_or_create(op_type)
            info.group_lower, info.group_key = fn, key
        return fn

    return deco


def register_infer_shape(op_type: str):
    def deco(fn: InferShapeFn):
        OPS.get_or_create(op_type).infer_shape = fn
        return fn

    return deco


def register_grad_maker(op_type: str):
    def deco(fn: GradMakerFn):
        OPS.get_or_create(op_type).grad_maker = fn
        return fn

    return deco


def mark_no_gradient(*op_types: str):
    """Mark ``op_types`` as having no gradient, whether or not they have a
    lowering yet (the JAX package's ``mark_no_gradient``)."""
    for t in op_types:
        OPS.get_or_create(t).no_gradient = True


def default_grad_maker(op: OpDesc, block: BlockDesc, no_grad_set) -> List[OpDesc]:
    """One ``<type>_grad`` op with every forward input (under its slot),
    forward output (``__out__<slot>``) and output grad
    (``__outgrad__<slot>``) as inputs, and one grad output per
    differentiable forward input (``<slot>@GRAD_SLOT``; ``""`` where no
    grad is needed)."""
    info = OPS.get(op.type)
    grad = OpDesc(type=op.type + "_grad", attrs=dict(op.attrs))
    for slot, names in op.inputs.items():
        grad.inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        grad.inputs["__out__" + slot] = list(names)
        grad.inputs["__outgrad__" + slot] = [grad_var_name(n) for n in names]
    for slot, names in op.inputs.items():
        if slot in info.non_diff_inputs:
            continue
        outs = []
        for n in names:
            v = block.find_var(n)
            diff = (v is not None and v.dtype.is_floating
                    and not v.stop_gradient and n not in no_grad_set)
            outs.append(grad_var_name(n) if diff else "")
        if any(outs):
            grad.outputs[slot + "@GRAD_SLOT"] = outs
    if not grad.outputs:
        return []
    return [grad]
