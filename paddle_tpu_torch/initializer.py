"""Initializers: each appends its init op to the startup program."""
from __future__ import annotations

import math

import numpy as np

from .core.framework import Block, Variable


class Initializer:
    def __call__(self, var: Variable, block: Block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    recept = int(np.prod(shape[2:]))
    return shape[1] * recept, shape[0] * recept


class XavierInitializer(Initializer):
    """Glorot uniform init.  The normal form needs ``gaussian_random``,
    which is not ported yet."""

    def __init__(self, fan_in=None, fan_out=None, seed: int = 0):
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        UniformInitializer(-limit, limit, self.seed)(var, block)
