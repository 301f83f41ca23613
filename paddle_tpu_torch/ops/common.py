"""Shared helpers for op lowerings and shape inference."""
from __future__ import annotations

from typing import Optional

from ..core.desc import BlockDesc, OpDesc
from ..core.dtypes import DataType, convert_dtype


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
