"""Tensor creation layers and ``data``: each builds the same ops, attrs and
vars as its namesake in the JAX package."""
from __future__ import annotations

from ..core import unique_name
from ..core.dtypes import convert_dtype
from ..core.framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = ["data", "fill_constant", "fill_constant_batch_size_like", "create_tensor",
           "create_global_var", "cast", "assign", "zeros", "ones", "argmax", "argmin",
           "zeros_like", "increment", "expand", "assign_value"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable.  With ``append_batch_size`` the batch dim
    is prepended as -1, plus one dynamic padded axis per LoD level (the
    padded-ragged convention: a ragged var's per-row lengths are fed as
    ``<name>@SEQ_LEN``)."""
    if append_batch_size:
        shape = [-1] + [-1] * lod_level + list(shape)
    block = default_main_program().global_block
    if block.has_var(name):
        return block.var(name)
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "value": value})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0, name=None):
    helper = LayerHelper("fill_constant_batch_size_like", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant_batch_size_like", inputs={"Input": input},
                     outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "value": value, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def create_tensor(dtype, name=None, persistable=False):
    return default_main_program().current_block().create_var(
        name=name, dtype=dtype, persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """A var of the main program set to ``value`` by a ``fill_constant`` in
    the startup program."""
    name = name or unique_name.generate("global_var")
    var = default_main_program().global_block.create_var(
        name=name, shape=shape, dtype=dtype, persistable=persistable)
    startup = default_startup_program().global_block
    svar = startup.create_var(name=name, shape=shape, dtype=dtype, persistable=persistable)
    startup.append_op("fill_constant", outputs={"Out": svar},
                      attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                             "value": float(value)})
    return var


def cast(x, dtype):
    from . import nn
    return nn.cast(x, dtype)


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    return output


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def _arg_reduce(op_type, x, axis):
    from ..core.dtypes import DataType
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(DataType.INT64, True)
    helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    return _arg_reduce("arg_max", x, axis)


def argmin(x, axis=0):
    return _arg_reduce("arg_min", x, axis)


def expand(x, expand_times, name=None):
    """X tiled ``expand_times`` times along each dim."""
    helper = LayerHelper("expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("expand", inputs={"X": x}, outputs={"Out": out},
                     attrs={"expand_times": list(expand_times)})
    return out


def assign_value(values, shape, dtype="float32", name=None):
    """A constant tensor from literal values."""
    helper = LayerHelper("assign_value", name=name)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("assign_value", outputs={"Out": out},
                     attrs={"values": list(values), "shape": list(shape), "dtype": dtype})
    return out
