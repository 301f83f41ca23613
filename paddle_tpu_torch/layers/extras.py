"""The layers the JAX package keeps in its ``layers/extras.py`` that the
port has: ``lod_reset``, ``row_conv``, ``sequence_pad`` and
``create_parameter``.  The rest of that file's surface (``im2sequence``
among it) is not ported yet."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["lod_reset", "row_conv", "sequence_pad", "create_parameter"]


def lod_reset(x, y=None, target_lod=None, name=None):
    """X with new lengths: those in ``y``, or the offsets ``target_lod``."""
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x}
    if y is not None:
        inputs["Y"] = y
    helper.append_op("lod_reset", inputs=inputs, outputs={"Out": out},
                     attrs={"target_lod": [int(t) for t in (target_lod or [])]})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[future_context_size + 1, d],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", inputs={"X": input, "Filter": w},
                     outputs={"Out": out})
    return helper.append_activation(out)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("sequence_pad",
                     inputs={"X": x, "PadValue": pad_value},
                     outputs={"Out": out, "Length": length},
                     attrs={"padded_length": int(maxlen or -1)})
    return out, length


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone learnable parameter."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape=list(shape), dtype=dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)
