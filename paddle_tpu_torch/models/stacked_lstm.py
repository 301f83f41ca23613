"""Stacked dynamic-LSTM text classifier (the reference's
benchmark/fluid/models/stacked_dynamic_lstm.py: IMDB sentiment,
embedding -> [fc 4H -> LSTM] x depth -> max pool over time -> fc), as the
JAX package's ``models/stacked_lstm.py`` builds it.  Ragged input: padded
ids [N, T, 1] with ``@SEQ_LEN`` lengths."""
from .. import layers


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3):
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    if len(emb.shape) > 3:                    # ids [N,T,1] -> emb [N,T,1,E]
        emb = layers.reshape(emb, shape=[0, 0, emb_dim])

    fc1 = layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=layers.concat(inputs, axis=2),
                       size=hid_dim * 4, num_flatten_dims=2)
        lstm, _cell = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                          is_reverse=False)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")

    prediction = layers.fc(input=layers.concat([fc_last, lstm_last], axis=1),
                           size=class_dim, act=None)
    return prediction


def train_network(data, label, dict_dim, class_dim=2, emb_dim=128,
                  hid_dim=512, stacked_num=3):
    logits = stacked_lstm_net(data, dict_dim, class_dim, emb_dim, hid_dim,
                              stacked_num)
    loss = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    return avg_loss, acc
