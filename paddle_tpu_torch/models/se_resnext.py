"""SE-ResNeXt, as the JAX package's ``models/se_resnext.py`` builds it:
a 7x7/2 stem and a 3x3/2 max pool, bottlenecks with a grouped 3x3
(cardinality 32) and a squeeze-excitation gate (reduction 16), stages
[3, 4, 6, 3] with filters [128, 256, 512, 1024] at depth 50, conv-bn 1x1
shortcuts where the shape changes, then a global average pool, dropout
(0.2) and a softmax ``fc``.  The gate is an [N, C] scale broadcast over H
and W by ``elementwise_mul(axis=0)``; the grouped 3x3 is one cuDNN
convolution with ``groups`` on the card."""
from .. import layers

_CONFIGS = {
    50: ([3, 4, 6, 3], 32),
    101: ([3, 4, 23, 3], 32),
}
_FILTERS = [128, 256, 512, 1024]
_REDUCTION = 16


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None, is_test=False):
    conv = layers.conv2d(input=x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _squeeze_excitation(x, num_channels, reduction_ratio):
    pool = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio, act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    return layers.elementwise_mul(x, excitation, axis=0)


def _shortcut(x, ch_out, stride, is_test=False):
    if x.shape[1] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, is_test=is_test)
    return x


def _bottleneck(x, num_filters, stride, cardinality, reduction_ratio, is_test=False):
    conv0 = _conv_bn(x, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride, groups=cardinality, act="relu",
                     is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, act=None, is_test=is_test)
    scale = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(x, num_filters * 2, stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(short, scale))


def se_resnext(input, class_dim=1000, depth=50, is_test=False, dropout_prob=0.2):
    """Softmax probabilities [N, class_dim] of an NCHW image batch."""
    stages, cardinality = _CONFIGS[depth]
    conv = _conv_bn(input, 64, 7, stride=2, act="relu", is_test=is_test)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for block, n in enumerate(stages):
        for i in range(n):
            conv = _bottleneck(conv, _FILTERS[block],
                               stride=2 if i == 0 and block != 0 else 1,
                               cardinality=cardinality, reduction_ratio=_REDUCTION,
                               is_test=is_test)
    pool = layers.pool2d(input=conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=dropout_prob, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def train_network(image, label, class_dim=1000, depth=50):
    """(mean cross-entropy, top-1 accuracy) of ``se_resnext``."""
    pred = se_resnext(image, class_dim=class_dim, depth=depth)
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    acc = layers.accuracy(input=pred, label=label)
    return loss, acc
