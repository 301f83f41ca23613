"""Operator registry: op type -> lowering, compile-time infer-shape and
gradient metadata.

``lower(ctx, op)`` reads the op's inputs from the executor's environment
(torch tensors), computes with torch functions or a hand-written kernel,
and writes its outputs back.  ``infer_shape(block, op)`` propagates shapes
and dtypes into the block's VarDescs when the op is appended, exactly as
the JAX package does, so both packages build identical ProgramDescs.

``grad_maker(op, block, no_grad_set)`` emits the grad OpDescs that
``append_backward`` appends.  Without one, :func:`default_grad_maker`
emits a single ``<type>_grad`` op whose lowering is derived from the
forward lowering with torch autograd (``core/lower.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .desc import BlockDesc, OpDesc, grad_var_name

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


OPS = OpInfoMap()


def register_lowering(op_type: str, *, no_gradient: bool = False,
                      non_diff_inputs: tuple = ()):
    def deco(fn: LowerFn):
        info = OPS.get_or_create(op_type)
        info.lower = fn
        info.no_gradient = info.no_gradient or no_gradient
        info.non_diff_inputs = non_diff_inputs or info.non_diff_inputs
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
