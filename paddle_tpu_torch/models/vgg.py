"""VGG16 with batch_norm and dropout, as the JAX package's
``models/vgg.py`` builds it through ``nets.img_conv_group``."""
from .. import layers, nets


def vgg16(input, class_dim=1000, is_test=False):
    def conv_block(ipt, num_filter, groups):
        return nets.img_conv_group(
            input=ipt, conv_num_filter=[num_filter] * groups,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            pool_size=2, pool_stride=2, pool_type="max", is_test=is_test)

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)

    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=4096, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=4096, act=None)
    return layers.fc(input=fc2, size=class_dim, act=None)


def train_network(image, label, class_dim=1000, is_test=False):
    """(mean softmax cross-entropy, top-1 accuracy) of ``vgg16``."""
    logits = vgg16(image, class_dim=class_dim, is_test=is_test)
    loss = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    return avg_loss, acc
