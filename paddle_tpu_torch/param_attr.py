"""ParamAttr: name, initializer and training attributes of a parameter."""
from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None or arg is False:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
