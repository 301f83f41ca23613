from . import alexnet, googlenet, mnist, resnet, se_resnext, transformer, vgg  # noqa: F401
