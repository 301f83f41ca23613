"""Neural-network layer functions that append ops to the default program.
Each builds the same ops, attrs and parameters as its namesake in the
JAX package."""
from __future__ import annotations

from ..core.dtypes import DataType
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

# the names the JAX package's layers/nn.py exports, and the activations it
# registers (the activation family, ``maxout``); the other builders here
# (exp, abs, floor, elementwise_max, ...) are reached as layers.nn.<name>
__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "pool2d", "batch_norm", "layer_norm", "dropout",
           "softmax", "cross_entropy", "softmax_with_cross_entropy", "fused_fc_softmax_ce",
           "square_error_cost", "accuracy", "auc", "topk", "mean", "mul", "matmul",
           "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "relu",
           "sigmoid", "tanh", "sigmoid_cross_entropy_with_logits", "reshape", "transpose",
           "concat", "split", "cast", "scale",
           "clip", "clip_by_norm", "one_hot", "lrn", "log", "sqrt", "square", "prelu",
           "flatten", "stack", "squeeze", "unsqueeze", "gather", "pad", "maxout",
           "hard_sigmoid", "leaky_relu", "soft_relu", "elu", "relu6", "pow", "swish",
           "gelu", "logsigmoid", "softplus", "softsign", "tanh_shrink", "softshrink",
           "hard_shrink", "brelu", "stanh", "thresholded_relu", "mish", "silu", "exp_act",
           "fake_quantize_abs_max", "fake_quantize_range_abs_max", "fake_dequantize_max_abs",
           "cos_sim"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer = mul (one per input) + sum (over several
    inputs) + elementwise_add + activation."""
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
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None):
    """NCHW convolution with an OIHW filter drawn from N(0, sqrt(2 /
    (kh * kw * C_in))), a bias a channel (unless ``bias_attr=False``) and
    ``act``."""
    from ..initializer import NormalInitializer
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    filter_size, stride, padding, dilation = (
        [v, v] if isinstance(v, int) else v for v in (filter_size, stride, padding, dilation))
    num_channels = input.shape[1]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d", inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    return helper.append_activation(_append_channel_bias(helper, pre_bias))


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, param_attr=None,
                     bias_attr=None, act=None, name=None):
    """The transpose of ``conv2d`` with an (in, out, kh, kw) filter, a bias a
    channel and ``act``; ``output_size`` is accepted and not used, as in
    the JAX package."""
    helper = LayerHelper("conv2d_transpose", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    stride, padding, dilation, filter_size = (
        [v, v] if isinstance(v, int) else v for v in (stride, padding, dilation, filter_size))
    filter_shape = [input.shape[1], num_filters] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, shape=filter_shape, dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation})
    return helper.append_activation(_append_channel_bias(helper, pre_bias))


def _append_channel_bias(helper, pre_bias):
    """``pre_bias`` plus a [C] bias over axis 1, unless ``bias_attr`` is False."""
    if helper.kwargs.get("bias_attr") is False:
        return pre_bias
    num_filters = pre_bias.shape[1]
    b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                dtype=pre_bias.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(pre_bias.dtype)
    helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": b},
                     outputs={"Out": out}, attrs={"axis": 1})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    pool_size, pool_stride, pool_padding = (
        [v, v] if isinstance(v, int) else v for v in (pool_size, pool_stride, pool_padding))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None, name=None):
    """Batch normalization with a scale (1) and bias (0) a channel; the
    running mean (0) and variance (1) are persistable, non-trainable
    parameters that the op updates in place."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[c],
                                   dtype=input.dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout})
    return helper.append_activation(out)


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


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": input}, outputs={"Out": out},
                     attrs={"depth": depth})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels (writes ``k``: 1.0
    here, where the op's own default is 2.0)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("lrn", inputs={"X": input}, outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def _shape_layer(op_type, x, attrs, name, in_slot="X", out_slot="Out", dtype=None, **inputs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(op_type, inputs={in_slot: x, **inputs}, outputs={out_slot: out},
                     attrs=attrs)
    return out


def flatten(x, axis=1, name=None):
    return _shape_layer("flatten", x, {"axis": axis}, name)


def stack(x, axis=0, name=None):
    return _shape_layer("stack", x, {"axis": axis}, name, out_slot="Y", dtype=x[0].dtype)


def squeeze(input, axes, name=None):
    return _shape_layer("squeeze", input, {"axes": axes}, name)


def unsqueeze(input, axes, name=None):
    return _shape_layer("unsqueeze", input, {"axes": axes}, name)


def gather(input, index, name=None):
    return _shape_layer("gather", input, None, name, Index=index)


def pad(x, paddings, pad_value=0.0, name=None):
    return _shape_layer("pad", x, {"paddings": list(paddings), "pad_value": pad_value}, name)


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


def _unary_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


relu = _unary_layer("relu")
sigmoid = _unary_layer("sigmoid")
tanh = _unary_layer("tanh")
hard_sigmoid = _unary_layer("hard_sigmoid")
leaky_relu = _unary_layer("leaky_relu")
soft_relu = _unary_layer("soft_relu")
elu = _unary_layer("elu")
relu6 = _unary_layer("relu6")
swish = _unary_layer("swish")
gelu = _unary_layer("gelu")
logsigmoid = _unary_layer("logsigmoid")
softplus = _unary_layer("softplus")
softsign = _unary_layer("softsign")
tanh_shrink = _unary_layer("tanh_shrink")
softshrink = _unary_layer("softshrink")
hard_shrink = _unary_layer("hard_shrink")
brelu = _unary_layer("brelu")
stanh = _unary_layer("stanh")
thresholded_relu = _unary_layer("thresholded_relu")
mish = _unary_layer("mish")
silu = _unary_layer("silu")
exp_act = _unary_layer("exp_act")
maxout = _unary_layer("maxout")
log = _unary_layer("log")
sqrt = _unary_layer("sqrt")
square = _unary_layer("square")
pow = _unary_layer("pow")
softmax = _unary_layer("softmax")
exp = _unary_layer("exp")
abs = _unary_layer("abs")
ceil = _unary_layer("ceil")
floor = _unary_layer("floor")
cos = _unary_layer("cos")
sin = _unary_layer("sin")
round = _unary_layer("round")
reciprocal = _unary_layer("reciprocal")


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out},
                         attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_pow = _binary_layer("elementwise_pow")


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            if isinstance(dim, int):
                dim = [dim]
            attrs = {"dim": list(dim), "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(op_type, inputs={"X": input}, outputs={"Out": out}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
                            "alpha": alpha})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100, name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, name=None):
    """Per-row loss [..., 1] of softmax(logits) against ``label``; the
    softmax is an output of the op too (not returned)."""
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax_out, "Loss": loss},
                     attrs={"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out})
    return out


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost", inputs={"X": input, "Y": label},
                     outputs={"Out": out})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": list(perm)})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    in_shape = input.shape
    axis = dim if dim >= 0 else dim + len(in_shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = [in_shape[axis] // num] * num
    else:
        sections = list(num_or_sections)
        num = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype) for _ in range(num)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs={"axis": axis, "sections": sections, "num": 0})
    return outs


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"out_dtype": dtype})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": x}, outputs={"Out": out},
                     attrs={"max_norm": max_norm})
    return out


def topk(input, k, name=None):
    """(values, indices) of the ``k`` largest entries of the last dim."""
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(DataType.INT64, True)
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """``top_k`` of ``input``, then the share of rows whose top k hold the
    label (``accuracy``)."""
    helper = LayerHelper("accuracy", name=name)
    _, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", True)
    correct = correct or helper.create_variable_for_type_inference(DataType.INT32, True)
    total = total or helper.create_variable_for_type_inference(DataType.INT32, True)
    helper.append_op("accuracy",
                     inputs={"Out": input, "Indices": indices, "Label": label},
                     outputs={"Accuracy": acc, "Correct": correct, "Total": total})
    return acc


def auc(input, label, curve="ROC", num_thresholds=200, name=None):
    """The batch's ROC AUC over ``num_thresholds`` thresholds (the ``auc``
    op; the streaming AUC is ``metrics.Auc``)."""
    helper = LayerHelper("auc", name=name)
    out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("auc", inputs={"Predict": input, "Label": label}, outputs={"AUC": out},
                     attrs={"curve": curve, "num_thresholds": num_thresholds})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """max(0, x) + alpha * min(0, x) with a learned alpha (0.25 at start):
    one value (``all``), one a channel (``channel``) or one an element of
    a row (``element``)."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def fake_quantize_abs_max(x, bit_length=8, name=None):
    """Simulated-int quantization with the tensor's abs-max as its scale:
    Out = round(X / max|X| * (2^(bit_length-1) - 1)).  Returns (out,
    scale); differentiable through the straight-through estimator."""
    helper = LayerHelper("fake_quantize_abs_max", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    scale = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("fake_quantize_abs_max", inputs={"X": x},
                     outputs={"Out": out, "OutScale": scale},
                     attrs={"bit_length": int(bit_length)})
    return out, scale


def fake_quantize_range_abs_max(x, bit_length=8, window_size=10000, is_test=False, name=None):
    """Quantization-aware training's quantizer: the scale is the largest
    abs-max of the last ``window_size`` steps, held with the window and its
    step counter in persistable vars that the op reads and writes (the
    same vars on both sides).  Returns (out, scale)."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("fake_quantize_range_abs_max", name=name)
    dtype = x.dtype
    in_scale = helper.create_parameter(
        ParamAttr(name=None, trainable=False), shape=[1], dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    scales_buf = helper.create_parameter(
        ParamAttr(name=None, trainable=False), shape=[int(window_size)], dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    it = helper.create_parameter(
        ParamAttr(name=None, trainable=False), shape=[], dtype="int32",
        default_initializer=ConstantInitializer(0))
    for v in (in_scale, scales_buf, it):
        v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "fake_quantize_range_abs_max",
        inputs={"X": x, "InScale": in_scale, "InScales": scales_buf, "Iter": it},
        outputs={"Out": out, "OutScale": in_scale, "OutScales": scales_buf, "IterOut": it},
        attrs={"bit_length": int(bit_length), "window_size": int(window_size),
               "is_test": bool(is_test)})
    return out, in_scale


def fake_dequantize_max_abs(x, scale, max_range, name=None):
    """The inverse of the quantizers: Out = scale * X / max_range."""
    helper = LayerHelper("fake_dequantize_max_abs", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fake_dequantize_max_abs", inputs={"X": x, "Scale": scale},
                     outputs={"Out": out}, attrs={"max_range": float(max_range)})
    return out


def cos_sim(X, Y, name=None):
    """Cosine similarity along the last axis, Y broadcast against X: [N, 1]."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype, True)
    ynorm = helper.create_variable_for_type_inference(X.dtype, True)
    helper.append_op("cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out, "XNorm": xnorm, "YNorm": ynorm})
    return out
