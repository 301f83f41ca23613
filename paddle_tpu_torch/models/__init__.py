from . import (alexnet, googlenet, machine_translation, mnist, resnet,  # noqa: F401
               rnn_encoder_decoder, se_resnext, stacked_lstm, transformer, vgg)
