from . import (alexnet, googlenet, machine_translation, mnist, resnet,  # noqa: F401
               se_resnext, stacked_lstm, transformer, vgg)
