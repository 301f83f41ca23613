"""AlexNet: five convolutions (the first two followed by ``lrn``), three
max pools and three ``fc`` layers with dropout, as the JAX package's
``models/alexnet.py`` builds it (bench.py's AlexNet row)."""
from .. import layers


def alexnet(input, class_dim=1000, is_test=False):
    """Softmax probabilities [N, class_dim] of an NCHW image batch."""
    conv1 = layers.conv2d(input, num_filters=64, filter_size=11, stride=4,
                          padding=2, act="relu")
    norm1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(norm1, pool_size=3, pool_stride=2, pool_type="max")
    conv2 = layers.conv2d(pool1, num_filters=192, filter_size=5, padding=2, act="relu")
    norm2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(norm2, pool_size=3, pool_stride=2, pool_type="max")
    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3, padding=1, act="relu")
    conv4 = layers.conv2d(conv3, num_filters=256, filter_size=3, padding=1, act="relu")
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3, padding=1, act="relu")
    pool5 = layers.pool2d(conv5, pool_size=3, pool_stride=2, pool_type="max")
    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(fc6, 0.5, is_test=is_test)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(fc7, 0.5, is_test=is_test)
    return layers.fc(input=drop7, size=class_dim, act="softmax")


def train_network(image, label, class_dim=1000, is_test=False):
    """(mean cross-entropy, top-1 accuracy) of ``alexnet``."""
    predict = alexnet(image, class_dim=class_dim, is_test=is_test)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return avg_cost, acc
