"""DeepFM, the CTR model (BASELINE.json's fifth config: a sparse
``lookup_table``), built as the JAX package's ``models/deepfm.py`` builds
it: FM first- and second-order terms and a ReLU MLP over the per-field
embeddings and the dense features, trained by
``sigmoid_cross_entropy_with_logits``.  With ``is_sparse=True`` (the
default) the tables' gradients are SelectedRows, so the optimizer touches
only each batch's rows, which a CTR vocabulary needs.

``CRITEO_VOCAB`` holds the 26 categorical fields' cardinalities of the
Criteo Kaggle (Display Advertising Challenge) data set as the DLRM and
TorchRec examples publish them; :func:`synthetic_feed` draws a batch
from a seed (Zipf(1.3) ids clipped to each field's cardinality, dense
features uniform in [0, 1), labels Bernoulli(0.25)), so nothing is read.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..param_attr import ParamAttr

CRITEO_VOCAB = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
                3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
                142572)
CRITEO_DENSE = 13
ZIPF_A = 1.3


def deepfm(sparse_ids, dense_input, vocab_sizes, embed_dim=16, hidden=(400, 400, 400),
           is_test=False, shard_tables=False, is_sparse=True):
    """sparse_ids: one int64 ``[N, 1]`` Variable a field; dense_input: a
    float ``[N, num_dense]`` Variable; returns the ``[N, 1]`` logits.
    ``shard_tables`` splits each ``fm_emb_<i>`` table's rows over the mesh's
    ``data`` axis (``set_sharding(["data", None])``, as the JAX model
    does; the ``fm_w1_<i>`` tables keep the layout's rule): under a mesh
    each rank holds its rows, and a vocabulary the axis does not divide
    raises when the table is placed."""
    first_order_terms = []
    embeddings = []  # [N, embed_dim] a field
    for i, (ids, vocab) in enumerate(zip(sparse_ids, vocab_sizes)):
        first_order_terms.append(layers.embedding(
            input=ids, size=[vocab, 1], is_sparse=is_sparse,
            param_attr=ParamAttr(name=f"fm_w1_{i}")))
        embeddings.append(layers.embedding(
            input=ids, size=[vocab, embed_dim], is_sparse=is_sparse,
            param_attr=ParamAttr(name=f"fm_emb_{i}")))
        if shard_tables:
            from ..core.framework import default_main_program
            default_main_program().global_block.var(f"fm_emb_{i}").set_sharding(["data", None])

    first_order = _sum_list(first_order_terms)

    # second order: 0.5 * ((sum e)^2 - sum(e^2)), summed over embed_dim
    stacked = layers.stack(embeddings, axis=1)        # [N, F, D]
    sum_e = layers.reduce_sum(stacked, dim=1)         # [N, D]
    sum_sq = layers.square(sum_e)
    sq_sum = layers.reduce_sum(layers.square(stacked), dim=1)
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True),
        scale=0.5)

    # the deep part over the concatenated field embeddings and the dense features
    flat = layers.reshape(stacked, shape=[0, len(sparse_ids) * embed_dim])
    t = layers.concat([flat, dense_input], axis=1)
    for h in hidden:
        t = layers.fc(input=t, size=h, act="relu")
        if not is_test:
            t = layers.dropout(x=t, dropout_prob=0.5, is_test=is_test)
    deep_out = layers.fc(input=t, size=1, act=None)
    return layers.elementwise_add(layers.elementwise_add(first_order, second_order), deep_out)


def _sum_list(vs):
    out = vs[0]
    for v in vs[1:]:
        out = layers.elementwise_add(out, v)
    return out


def train_network(sparse_ids, dense_input, label, vocab_sizes, embed_dim=16, is_test=False,
                  shard_tables=False):
    logits = deepfm(sparse_ids, dense_input, vocab_sizes, embed_dim=embed_dim,
                    is_test=is_test, shard_tables=shard_tables)
    avg_loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(x=logits, label=label))
    return avg_loss, logits


def data_layers(n_fields, num_dense=CRITEO_DENSE):
    """The feeds: ``C{i}`` int64 ``[N, 1]`` a field, ``dense`` float32
    ``[N, num_dense]`` and ``label`` float32 ``[N, 1]``."""
    ids = [layers.data(name=f"C{i}", shape=[1], dtype="int64") for i in range(n_fields)]
    dense = layers.data(name="dense", shape=[num_dense], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="float32")
    return ids, dense, label


def synthetic_feed(seed, batch, vocab_sizes=CRITEO_VOCAB, num_dense=CRITEO_DENSE):
    """One batch for :func:`data_layers` from ``seed``: field i's ids are
    Zipf(1.3) draws minus 1, clipped to ``vocab_sizes[i] - 1``; dense
    features uniform in [0, 1); labels Bernoulli(0.25)."""
    rng = np.random.default_rng(seed)
    feed = {f"C{i}": np.minimum(rng.zipf(ZIPF_A, size=(batch, 1)) - 1, v - 1).astype(np.int64)
            for i, v in enumerate(vocab_sizes)}
    feed["dense"] = rng.random((batch, num_dense), dtype=np.float32)
    feed["label"] = (rng.random((batch, 1)) < 0.25).astype(np.float32)
    return feed
