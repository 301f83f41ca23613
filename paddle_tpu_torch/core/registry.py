"""Operator registry: op type -> lowering and compile-time infer-shape.

``lower(ctx, op)`` reads the op's inputs from the executor's environment
(torch tensors), computes with torch functions or a hand-written kernel,
and writes its outputs back.  ``infer_shape(block, op)`` propagates shapes
and dtypes into the block's VarDescs when the op is appended, exactly as
the JAX package does, so both packages build identical ProgramDescs.
Gradient makers, and the per-op gradient metadata they read, are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from .desc import BlockDesc, OpDesc

LowerFn = Callable[..., None]  # (ctx, op) -> None
InferShapeFn = Callable[[BlockDesc, OpDesc], None]


@dataclass
class OpInfo:
    type: str
    lower: Optional[LowerFn] = None
    infer_shape: Optional[InferShapeFn] = None


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


def register_lowering(op_type: str):
    def deco(fn: LowerFn):
        OPS.get_or_create(op_type).lower = fn
        return fn

    return deco


def register_infer_shape(op_type: str):
    def deco(fn: InferShapeFn):
        OPS.get_or_create(op_type).infer_shape = fn
        return fn

    return deco

