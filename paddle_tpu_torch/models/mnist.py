"""The MNIST models of the JAX package's ``models/mnist.py``: the
LeNet-5-style CNN (two conv + max-pool units and a classifier) and an
MLP."""
from .. import layers, nets


def cnn_model(image, class_dim=10, is_test=False):
    conv1 = nets.simple_img_conv_pool(input=image, filter_size=5,
                                      num_filters=20, pool_size=2,
                                      pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(input=conv1, filter_size=5,
                                      num_filters=50, pool_size=2,
                                      pool_stride=2, act="relu")
    return layers.fc(input=conv2, size=class_dim, act=None)


def mlp_model(image, class_dim=10, hidden=(128, 64)):
    t = image
    for h in hidden:
        t = layers.fc(input=t, size=h, act="relu")
    return layers.fc(input=t, size=class_dim, act=None)


def train_network(image, label, class_dim=10, is_test=False, model="cnn"):
    """(mean softmax cross-entropy, top-1 accuracy) of the CNN or the MLP."""
    if model == "cnn":
        logits = cnn_model(image, class_dim=class_dim, is_test=is_test)
    else:
        logits = mlp_model(image, class_dim=class_dim)
    loss = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    return avg_loss, acc
