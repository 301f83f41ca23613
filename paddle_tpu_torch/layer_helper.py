"""LayerHelper: creates each parameter in BOTH the startup program (with
its initializer op) and the main program (declaration only), and appends
bias and activation ops."""
from __future__ import annotations

from typing import Optional

from .core import unique_name
from .core.framework import Parameter, Variable, default_main_program, default_startup_program
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if kwargs.get("name") is None:
            self.name = unique_name.generate(layer_type)
        else:
            self.name = kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    create_tmp_variable = create_variable_for_type_inference

    def create_parameter(self, attr: Optional[ParamAttr], shape, dtype,
                         is_bias: bool = False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        main_block = self.main_program.global_block
        param = main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            trainable=attr.trainable, regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate})
        sblock = self.startup_program.global_block
        if not sblock.has_var(attr.name):
            svar = sblock.create_var(name=attr.name, shape=shape, dtype=dtype,
                                     persistable=True)
            init(svar, sblock)
        return param

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def append_bias_op(self, input_var: Variable, dim_start=1) -> Variable:
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[dim_start:]
        b = self.create_parameter(
            ParamAttr._to_attr(bias_attr), shape=size, dtype=input_var.dtype,
            is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op("elementwise_add",
                       inputs={"X": input_var, "Y": b},
                       outputs={"Out": out},
                       attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act, inputs={"X": input_var}, outputs={"Out": out})
        return out
