from . import mnist, resnet, transformer, vgg  # noqa: F401
