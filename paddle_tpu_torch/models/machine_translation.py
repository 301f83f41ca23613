"""Seq2seq machine translation: a GRU encoder-decoder (the reference's
book chapter 8, tests/book/test_machine_translation.py), as the JAX
package's ``models/machine_translation.py`` builds its training network:
the encoder is embedding -> fc 3H -> ``dynamic_gru``, its last step the
decoder's initial state; the decoder is teacher-forced.  ``infer_network``
decodes with beam search: ``max_len`` unrolled steps of gru_unit +
``beam_search`` over dense [N, B] lanes (ops/beam_search_ops.py), all in
one program.  The train and infer programs share parameters by name."""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

START_ID, END_ID = 0, 1


def encoder(src_ids, src_dict_size, word_dim=32, hidden_dim=32):
    """src_ids [N, T, 1] -> (whole sequence [N, T, H], last state [N, H])."""
    emb = layers.embedding(src_ids, size=[src_dict_size, word_dim],
                           param_attr=ParamAttr(name="src_emb"))
    proj = layers.fc(emb, size=hidden_dim * 3, num_flatten_dims=2,
                     param_attr=ParamAttr(name="enc_fc.w"),
                     bias_attr=ParamAttr(name="enc_fc.b"))
    seq = layers.dynamic_gru(proj, size=hidden_dim,
                             param_attr=ParamAttr(name="enc_gru.w"),
                             bias_attr=ParamAttr(name="enc_gru.b"))
    last = layers.sequence_pool(seq, pool_type="last")
    return seq, last


def _decoder_step_params():
    return dict(
        fc_w=ParamAttr(name="dec_fc.w"), fc_b=ParamAttr(name="dec_fc.b"),
        gru_w=ParamAttr(name="dec_gru.w"), gru_b=ParamAttr(name="dec_gru.b"),
        out_w=ParamAttr(name="out_fc.w"), out_b=ParamAttr(name="out_fc.b"))


def train_network(src_ids, trg_ids, label, src_dict_size, trg_dict_size,
                  word_dim=32, hidden_dim=32):
    """Teacher-forced training loss.  trg_ids [N, T, 1] starts with <s>;
    label [N, T, 1] is trg shifted left (ends with <e>).  The loss is the
    mean over the real target tokens: ``sequence_pool(sum)`` zeroes the
    steps past each row's length, and the divisor is the token count."""
    p = _decoder_step_params()
    _, enc_last = encoder(src_ids, src_dict_size, word_dim, hidden_dim)
    trg_emb = layers.embedding(trg_ids, size=[trg_dict_size, word_dim],
                               param_attr=ParamAttr(name="trg_emb"))
    proj = layers.fc(trg_emb, size=hidden_dim * 3, num_flatten_dims=2,
                     param_attr=p["fc_w"], bias_attr=p["fc_b"])
    dec = layers.dynamic_gru(proj, size=hidden_dim, h_0=enc_last,
                             param_attr=p["gru_w"], bias_attr=p["gru_b"])
    logits = layers.fc(dec, size=trg_dict_size, num_flatten_dims=2,
                       param_attr=p["out_w"], bias_attr=p["out_b"])
    loss = layers.softmax_with_cross_entropy(logits=logits, label=label)
    per_seq = layers.sequence_pool(loss, pool_type="sum")        # [N, 1]
    tokens = layers.cast(
        layers.reduce_sum(layers.sequence_length(loss)), "float32")
    avg = layers.reduce_sum(per_seq) / tokens
    return avg


def infer_network(src_ids, src_dict_size, trg_dict_size, word_dim=32,
                  hidden_dim=32, beam_size=4, max_len=12):
    """Beam-search decode; returns (sentence_ids [N, B, T],
    sentence_scores [N, B])."""
    p = _decoder_step_params()
    _, enc_last = encoder(src_ids, src_dict_size, word_dim, hidden_dim)

    # fan out to beam lanes: hidden [N*B, H]
    hid = layers.expand(layers.unsqueeze(enc_last, axes=[1]),
                        expand_times=[1, beam_size, 1])
    hidden = layers.reshape(hid, shape=[-1, hidden_dim])

    pre_ids = layers.fill_constant_batch_size_like(
        enc_last, shape=[-1, beam_size], dtype="int64", value=START_ID)
    # lane 0 active, the others at -1e9, so step 1 fans out from one beam
    lane_bias = layers.assign_value(
        values=[0.0] + [-1e9] * (beam_size - 1), shape=[beam_size],
        dtype="float32")
    zeros = layers.fill_constant_batch_size_like(
        enc_last, shape=[-1, beam_size], dtype="float32", value=0.0)
    pre_scores = layers.elementwise_add(zeros, lane_bias, axis=1)

    ids_array = layers.create_array("int64")
    parents_array = layers.create_array("int32")
    for t in range(max_len):
        step_ids = layers.reshape(pre_ids, shape=[-1, 1])   # [N*B, 1]
        emb = layers.embedding(step_ids, size=[trg_dict_size, word_dim],
                               param_attr=ParamAttr(name="trg_emb"))
        proj = layers.fc(emb, size=hidden_dim * 3,
                         param_attr=p["fc_w"], bias_attr=p["fc_b"])
        hidden, _, _ = layers.gru_unit(proj, hidden, size=hidden_dim * 3,
                                       param_attr=p["gru_w"],
                                       bias_attr=p["gru_b"])
        logits = layers.fc(hidden, size=trg_dict_size,
                           param_attr=p["out_w"], bias_attr=p["out_b"])
        logp = layers.log(layers.softmax(logits))
        logp3 = layers.reshape(logp, shape=[-1, beam_size, trg_dict_size])
        sel_ids, sel_scores, parents, (hidden,) = layers.beam_search(
            pre_ids, pre_scores, logp3, beam_size, END_ID, states=[hidden])
        i_var = layers.fill_constant(shape=[1], dtype="int64", value=t)
        layers.array_write(sel_ids, i_var, ids_array)
        layers.array_write(parents, i_var, parents_array)
        pre_ids, pre_scores = sel_ids, sel_scores

    return layers.beam_search_decode(ids_array, parents_array, pre_scores,
                                     END_ID)
