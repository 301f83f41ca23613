"""GoogLeNet (Inception v1) without its auxiliary classifiers, as the JAX
package's ``models/googlenet.py`` builds it (bench.py's GoogLeNet row):
each inception block concatenates a 1x1, a reduced 3x3, a reduced 5x5 and
a pooled 1x1 branch on channels."""
from .. import layers


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(x, num_filters=c1, filter_size=1, act="relu")
    b3 = layers.conv2d(x, num_filters=c3r, filter_size=1, act="relu")
    b3 = layers.conv2d(b3, num_filters=c3, filter_size=3, padding=1, act="relu")
    b5 = layers.conv2d(x, num_filters=c5r, filter_size=1, act="relu")
    b5 = layers.conv2d(b5, num_filters=c5, filter_size=5, padding=2, act="relu")
    bp = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1, pool_type="max")
    bp = layers.conv2d(bp, num_filters=proj, filter_size=1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """Softmax probabilities [N, class_dim] of an NCHW image batch."""
    x = layers.conv2d(input, num_filters=64, filter_size=7, stride=2, padding=3, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.conv2d(x, num_filters=64, filter_size=1, act="relu")
    x = layers.conv2d(x, num_filters=192, filter_size=3, padding=1, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 64, 96, 128, 16, 32, 32)      # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)    # 3b
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    x = _inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b
    x = layers.pool2d(x, global_pooling=True, pool_type="avg")
    x = layers.dropout(x, 0.4, is_test=is_test)
    return layers.fc(input=x, size=class_dim, act="softmax")


def train_network(image, label, class_dim=1000, is_test=False):
    """(mean cross-entropy, top-1 accuracy) of ``googlenet``."""
    predict = googlenet(image, class_dim=class_dim, is_test=is_test)
    avg_cost = layers.mean(layers.cross_entropy(input=predict, label=label))
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc
