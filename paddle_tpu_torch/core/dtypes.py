"""Data types for the framework IR, mapped onto torch dtypes.

The same ``DataType`` enum as the JAX package (string values are the
serialized form, so a ``ProgramDesc`` written by either package parses in
the other).  Each member maps 1:1 to a torch dtype; the numpy dtype is
kept for feeds, which arrive as numpy arrays.  numpy has no bfloat16, so
``DataType.BF16.np_dtype`` raises: a bf16 var is fed from a float32 (or
any float) array, rounded to bf16 on the way in, and a fetched bf16 value
comes back as a float32 array (:func:`to_numpy`), an exact widening.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FP16 = "float16"
    BF16 = "bfloat16"
    FP32 = "float32"
    FP64 = "float64"

    @property
    def np_dtype(self):
        if self not in _NP:
            raise TypeError(f"{self.value} has no numpy dtype")
        return _NP[self]

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self]

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FP16, DataType.BF16, DataType.FP32, DataType.FP64)


_NP = {
    DataType.BOOL: np.dtype("bool"),
    DataType.INT8: np.dtype("int8"),
    DataType.UINT8: np.dtype("uint8"),
    DataType.INT16: np.dtype("int16"),
    DataType.INT32: np.dtype("int32"),
    DataType.INT64: np.dtype("int64"),
    DataType.FP16: np.dtype("float16"),
    DataType.FP32: np.dtype("float32"),
    DataType.FP64: np.dtype("float64"),
}

_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.INT8: torch.int8,
    DataType.UINT8: torch.uint8,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FP16: torch.float16,
    DataType.BF16: torch.bfloat16,
    DataType.FP32: torch.float32,
    DataType.FP64: torch.float64,
}

_FROM_STR = {d.value: d for d in DataType}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}
_ALIASES = {
    "float": DataType.FP32,
    "double": DataType.FP64,
    "half": DataType.FP16,
    "int": DataType.INT32,
    "long": DataType.INT64,
}


def convert_dtype(dtype) -> DataType:
    """Coerce str / numpy dtype / torch dtype / DataType into a DataType."""
    if isinstance(dtype, DataType):
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _FROM_TORCH:
            return _FROM_TORCH[dtype]
        raise ValueError(f"cannot convert {dtype!r} to DataType")
    if isinstance(dtype, str):
        if dtype in _FROM_STR:
            return _FROM_STR[dtype]
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        raise ValueError(f"unknown dtype string: {dtype!r}")
    try:
        npd = np.dtype(dtype)
    except TypeError:
        npd = None
    if npd is not None:
        for k, v in _NP.items():
            if v == npd:
                return k
    raise ValueError(f"cannot convert {dtype!r} to DataType")


def coerce_feed_dtype(want: DataType) -> DataType:
    """Feed dtype rule of the JAX package's executor with 64-bit mode off
    (its default): int64 feeds narrow to int32 and float64 to float32, so
    both packages see the same values in the same types."""
    return {DataType.INT64: DataType.INT32,
            DataType.FP64: DataType.FP32}.get(want, want)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array.  numpy has no bfloat16, so a bf16
    tensor comes back as float32: every bf16 value is a float32 value, so
    the widening is exact."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
