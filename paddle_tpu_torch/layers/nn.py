"""Neural-network layer functions that append ops to the default program.
Each builds the same ops, attrs and parameters as its namesake in the
JAX package."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "dropout", "reshape", "scale",
           "elementwise_add", "mean", "fused_fc_softmax_ce"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer = mul + elementwise_add + activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        param_shape = [1]
        for d in inp.shape[num_flatten_dims:]:
            param_shape[0] *= d
        param_shape.append(size)
        w = helper.create_parameter(helper.param_attr, shape=param_shape,
                                    dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op("mul", inputs={"X": inp, "Y": w},
                         outputs={"Out": tmp},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) != 1:
        raise NotImplementedError("fc over several inputs needs the `sum` op, "
                                  "which is not ported yet")
    pre_act = helper.append_bias_op(mul_results[0], dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """``lookup_table`` over a [vocab, dim] parameter."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table", inputs={"W": w, "Ids": input}, outputs={"Out": out},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_shape = [int(d) for d in input.shape[begin_norm_axis:]]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, True)
    var = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(
        "dropout", inputs={"X": x}, outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape", inputs={"X": x}, outputs={"Out": out},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def fused_fc_softmax_ce(input, label, size, num_flatten_dims=1,
                        param_attr=None, bias_attr=None, vocab_chunks=0,
                        use_pallas=-1, name=None):
    """``fc(input, size)`` + hard-label softmax cross-entropy, fused so the
    [rows, size] logits never materialize (ops/fused_ce.py).  Creates the
    parameters ``fc`` would.  Returns the per-token loss shaped like
    ``label`` ([..., 1] float32).  ``vocab_chunks`` and ``use_pallas`` are
    recorded for ProgramDesc parity with the JAX package and not read."""
    helper = LayerHelper("fused_fc_softmax_ce", input=input,
                         param_attr=param_attr, bias_attr=bias_attr, name=name)
    d = 1
    for dim in input.shape[num_flatten_dims:]:
        d *= dim
    w = helper.create_parameter(helper.param_attr, shape=[d, size], dtype=input.dtype)
    inputs = {"X": input, "W": w, "Label": label}
    if helper.kwargs.get("bias_attr") is not False:
        inputs["Bias"] = helper.create_parameter(helper.bias_attr, shape=[size],
                                                 dtype=input.dtype, is_bias=True)
    loss = helper.create_variable_for_type_inference("float32")
    lse = helper.create_variable_for_type_inference("float32")
    helper.append_op("fused_fc_softmax_ce", inputs=inputs,
                     outputs={"Loss": loss, "LogSumExp": lse},
                     attrs={"vocab_chunks": vocab_chunks, "use_pallas": use_pallas,
                            "num_flatten_dims": num_flatten_dims})
    return loss
