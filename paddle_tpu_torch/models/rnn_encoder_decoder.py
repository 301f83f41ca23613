"""The book's RNN encoder-decoder (the reference's
``tests/test_dynamic_rnn.py::test_rnn_encoder_decoder_book`` graph),
trained through control flow.  The encoder is embedding -> fc 4H ->
``dynamic_lstm``, its last step pooled; the decoder is a ``DynamicRNN``
over the target whose body reads the step's word, the encoder's last state
(a static input, and the memory's initial value) and its memory, writes
fc(tanh) into the memory and emits fc to the vocabulary; softmax and
cross-entropy masked by ``sequence_mask``; Adam at a ``piecewise_decay``
rate (a ``Switch`` of ``conditional_block``s over the step counter).
Word and hidden widths default to the book NMT's 32, the vocabulary to its
``dict_size`` 30,000.  Ragged input: padded ids [N, T, 1] with
``@SEQ_LEN`` lengths."""
from __future__ import annotations

import numpy as np

from .. import layers as _layers
from .. import optimizer as _optimizer

DICT_SIZE, WORD_DIM, HIDDEN_DIM = 30000, 32, 32


def train_network(batch, max_len, boundaries, rates, dict_size=DICT_SIZE, word_dim=WORD_DIM,
                  hidden_dim=HIDDEN_DIM, pkg=None):
    """The training program over feeds ``src``, ``trg`` (ids [batch,
    max_len, 1] with lengths) and ``lbl``; returns [loss, rate].  ``pkg``:
    the package whose ``layers`` and ``optimizer`` build it, this one by
    default (a package with the same layer API builds the same program)."""
    layers = _layers if pkg is None else pkg.layers
    adam = (_optimizer if pkg is None else pkg.optimizer).Adam
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = layers.data(name="lbl", shape=[1], dtype="int64")
    src_emb = layers.reshape(layers.embedding(input=src, size=[dict_size, word_dim]),
                             shape=[0, 0, word_dim])
    enc_proj = layers.fc(input=src_emb, size=hidden_dim * 4, num_flatten_dims=2)
    enc_seq, _ = layers.dynamic_lstm(input=enc_proj, size=hidden_dim * 4, use_peepholes=False)
    enc_last = layers.sequence_pool(input=enc_seq, pool_type="last")
    trg_emb = layers.reshape(layers.embedding(input=trg, size=[dict_size, word_dim]),
                             shape=[0, 0, word_dim])
    drnn = layers.DynamicRNN()
    with drnn.block():
        step = drnn.step_input(trg_emb)
        context = drnn.static_input(enc_last)
        prev = drnn.memory(init=enc_last)
        h = layers.fc(input=layers.concat([step, prev, context], axis=1), size=hidden_dim,
                      act="tanh")
        drnn.update_memory(prev, h)
        drnn.output(layers.fc(input=h, size=dict_size))
    probs = layers.softmax(drnn())
    ce = layers.cross_entropy(input=layers.reshape(probs, shape=[-1, dict_size]),
                              label=layers.reshape(lbl, shape=[-1, 1]))
    ce = layers.reshape(ce, shape=[batch, max_len])
    mask = layers.cast(layers.sequence_mask(layers.sequence_length(trg_emb), maxlen=max_len,
                                            dtype="int64"), "float32")
    loss = layers.reduce_sum(ce * mask) / layers.reduce_sum(mask)
    lr = layers.piecewise_decay(boundaries=boundaries, values=rates)
    adam(learning_rate=lr).minimize(loss)
    return [loss, lr]


def synthetic_feed(seed, batch, max_len, dict_size=DICT_SIZE, low=2):
    """Source ids, the target (source + 1) and the label (source + 2) as
    numpy arrays, lengths in [low, max_len] from the seed, the targets'
    equal to the sources'."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, dict_size, (batch, max_len, 1)).astype(np.int64)
    lens = rng.randint(low, max_len + 1, (batch,)).astype(np.int32)
    return {"src": src, "src@SEQ_LEN": lens, "trg": (src + 1) % dict_size,
            "trg@SEQ_LEN": lens, "lbl": (src + 2) % dict_size}
