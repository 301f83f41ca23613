"""Operator overloading on Variable (Fluid's layers/math_op_patch.py),
copied from the JAX package: ``+ - * / **``, the comparisons and unary
``-`` between Variables and scalars append ops to the program (a scalar
operand of ``+ - * /`` on the right becomes one ``scale`` op), and
``Variable.astype`` a ``cast``.  ``layers`` applies it at import, so a
program such as ``loss + 1e-9 * layers.mean(x)`` builds as it does in the
JAX package."""
from __future__ import annotations

from ..core.dtypes import convert_dtype
from ..core.framework import Variable
from ..layer_helper import LayerHelper


def _scalar_to_var(value, ref: Variable):
    from .tensor import fill_constant
    shape = list(ref.shape)
    shape = [d if d > 0 else 1 for d in shape] or [1]
    return fill_constant(shape, ref.dtype, float(value))


def _binary_creator(method_name, op_type, reverse=False):
    def __impl__(self, other):
        if isinstance(other, (int, float)):
            if op_type in ("elementwise_add", "elementwise_sub",
                           "elementwise_mul", "elementwise_div") and not reverse:
                # scalar fast path via scale op
                if op_type == "elementwise_add":
                    return _scale(self, 1.0, float(other))
                if op_type == "elementwise_sub":
                    return _scale(self, 1.0, -float(other))
                if op_type == "elementwise_mul":
                    return _scale(self, float(other), 0.0)
                if op_type == "elementwise_div":
                    return _scale(self, 1.0 / float(other), 0.0)
            other = _scalar_to_var(other, self)
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": -1})
        return out

    __impl__.__name__ = method_name
    return __impl__


def _scale(x, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": True})
    return out


def _neg(self):
    return _scale(self, -1.0, 0.0)


def _astype(self, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op("cast", inputs={"X": self}, outputs={"Out": out},
                     attrs={"out_dtype": convert_dtype(dtype)})
    return out


def monkey_patch_variable():
    Variable.__add__ = _binary_creator("__add__", "elementwise_add")
    Variable.__radd__ = _binary_creator("__radd__", "elementwise_add")
    Variable.__sub__ = _binary_creator("__sub__", "elementwise_sub")
    Variable.__rsub__ = _binary_creator("__rsub__", "elementwise_sub", True)
    Variable.__mul__ = _binary_creator("__mul__", "elementwise_mul")
    Variable.__rmul__ = _binary_creator("__rmul__", "elementwise_mul")
    Variable.__truediv__ = _binary_creator("__truediv__", "elementwise_div")
    Variable.__rtruediv__ = _binary_creator("__rtruediv__", "elementwise_div",
                                            True)
    Variable.__pow__ = _binary_creator("__pow__", "elementwise_pow")
    Variable.__lt__ = _binary_creator("__lt__", "less_than")
    Variable.__le__ = _binary_creator("__le__", "less_equal")
    Variable.__gt__ = _binary_creator("__gt__", "greater_than")
    Variable.__ge__ = _binary_creator("__ge__", "greater_equal")
    Variable.__neg__ = _neg
    Variable.astype = _astype
