"""Shared helpers for op lowerings and shape inference."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.desc import BlockDesc, OpDesc
from ..core.dtypes import DataType, convert_dtype
from ..core.registry import register_infer_shape


def set_out_shape(block: BlockDesc, op: OpDesc, slot: str, shape,
                  dtype: Optional[DataType] = None, idx: int = 0):
    names = op.output(slot)
    if not names or not names[idx]:
        return
    vd = block.find_var(names[idx])
    if vd is None:
        return
    vd.shape = tuple(int(s) for s in shape)
    if dtype is not None:
        vd.dtype = convert_dtype(dtype)


def in_shape(block: BlockDesc, op: OpDesc, slot: str, idx: int = 0):
    names = op.input(slot)
    vd = block.find_var(names[idx])
    if vd is None:
        raise KeyError(f"input var {names[idx]!r} of {op.type} not found")
    return tuple(vd.shape)


def in_dtype(block: BlockDesc, op: OpDesc, slot: str, idx: int = 0) -> DataType:
    names = op.input(slot)
    vd = block.find_var(names[idx])
    if vd is None:
        raise KeyError(f"input var {names[idx]!r} of {op.type} not found")
    return vd.dtype


def bcast_y(x, y, axis: int):
    """Fluid elementwise broadcast: Y's dims match a contiguous run of X's
    dims starting at ``axis`` (-1 = align trailing); Y gets singleton dims
    elsewhere, then broadcasts."""
    if x.ndim == y.ndim:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim))


def bcast_shape(x_shape, y_shape):
    """An elementwise op's output shape: the higher-rank operand's."""
    if len(x_shape) >= len(y_shape):
        return tuple(x_shape)
    return tuple(y_shape)


def normalize_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def same_shape(op_type: str, in_slot: str = "X", out_slots=("Out",)):
    """Register the infer-shape rule "each of ``out_slots`` has ``in_slot``'s
    shape and dtype" for ``op_type``."""
    @register_infer_shape(op_type)
    def rule(block, op):
        sh = in_shape(block, op, in_slot)
        dt = in_dtype(block, op, in_slot)
        for slot in out_slots:
            set_out_shape(block, op, slot, sh, dt)
    return rule


# constants on their device, made by a lowering's first run (an eager one:
# a capture runs the block eagerly first): key -> tensor
_DEVICE_CONSTANTS: dict = {}


def device_constant(key, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A copy of the constant ``make()`` gives, on its device: made once
    for ``key`` (which names the device) and cloned for each run.  A copy
    from pageable host memory, which a CUDA graph's capture cannot record,
    happens at the first run only; a clone between device buffers is
    captured."""
    const = _DEVICE_CONSTANTS.get(key)
    if const is None:
        const = _DEVICE_CONSTANTS[key] = make()
    return const.clone()
