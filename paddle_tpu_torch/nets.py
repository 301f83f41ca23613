"""Composite nets built from ``layers``, as the JAX package's ``nets``:
``simple_img_conv_pool``, ``img_conv_group``, ``sequence_conv_pool``,
``glu`` and ``scaled_dot_product_attention``."""
from __future__ import annotations

import math

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """``conv2d`` (with ``act``) then ``pool2d``."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   is_test=False):
    """One ``conv2d`` for each entry of ``conv_num_filter`` (each optionally
    followed by ``batch_norm`` and dropout; the activation goes after the
    batch_norm where there is one), then one ``pool2d``.  A scalar option
    applies to every conv."""
    assert isinstance(conv_num_filter, (list, tuple))

    def _ext(v):
        return v if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    conv_padding, conv_filter_size, param_attr, conv_with_batchnorm, \
        conv_batchnorm_drop_rate = (_ext(v) for v in (
            conv_padding, conv_filter_size, param_attr, conv_with_batchnorm,
            conv_batchnorm_drop_rate))
    tmp = input
    for i, num_filters in enumerate(conv_num_filter):
        tmp = layers.conv2d(input=tmp, num_filters=num_filters,
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i], param_attr=param_attr[i],
                            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act, is_test=is_test)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate, is_test=is_test)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_stride=pool_stride, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: a * sigmoid(b), ``input`` halved along ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """softmax(q k^T / sqrt(d)) v from program ops (``num_heads`` is not
    read, as in the JAX package); the fused attention kernel is
    ``flash_attention``'s."""
    d = queries.shape[-1]
    scaled_q = layers.scale(queries, scale=1.0 / math.sqrt(d))
    logits = layers.matmul(scaled_q, keys, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate > 0.0:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return layers.matmul(weights, values)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """``sequence_conv`` (with ``act``) then ``sequence_pool``: the text
    convolution of the understand_sentiment book model."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
