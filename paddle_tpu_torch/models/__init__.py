from . import (alexnet, deepfm, googlenet, machine_translation, mnist,  # noqa: F401
               resnet, rnn_encoder_decoder, se_resnext, stacked_lstm, transformer, vgg)
