"""Transformer encoder-decoder for NMT: multi-head attention through the
flash-attention op, position-wise FFN, post residual-norm and learned
position embeddings.  Ragged source and target batches mask keys through
their @SEQ_LEN lengths; the decoder self-attention is causal.  Builds the
same program as the JAX package's ``transformer``."""
from .. import layers
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def _ffn(x, d_model, d_inner, is_test=False, dropout_rate=0.0):
    h = layers.fc(input=x, size=d_inner, num_flatten_dims=2, act="relu")
    if dropout_rate:
        h = layers.dropout(h, dropout_prob=dropout_rate, is_test=is_test)
    return layers.fc(input=h, size=d_model, num_flatten_dims=2)


def _add_norm(x, y, is_test=False, dropout_rate=0.0):
    if dropout_rate:
        y = layers.dropout(y, dropout_prob=dropout_rate, is_test=is_test)
    return layers.layer_norm(layers.elementwise_add(x, y), begin_norm_axis=2)


def encoder_layer(x, d_model, n_head, d_inner, is_test=False,
                  dropout_rate=0.0):
    att = layers.multi_head_attention(x, x, x, d_model, n_head,
                                      is_test=is_test,
                                      dropout_rate=dropout_rate)
    x = _add_norm(x, att, is_test, dropout_rate)
    return _add_norm(x, _ffn(x, d_model, d_inner, is_test, dropout_rate),
                     is_test, dropout_rate)


def decoder_layer(x, enc_out, d_model, n_head, d_inner, is_test=False,
                  dropout_rate=0.0):
    self_att = layers.multi_head_attention(x, x, x, d_model, n_head,
                                           causal=True, is_test=is_test,
                                           dropout_rate=dropout_rate)
    x = _add_norm(x, self_att, is_test, dropout_rate)
    cross = layers.multi_head_attention(x, enc_out, enc_out, d_model,
                                        n_head, is_test=is_test,
                                        dropout_rate=dropout_rate)
    x = _add_norm(x, cross, is_test, dropout_rate)
    return _add_norm(x, _ffn(x, d_model, d_inner, is_test, dropout_rate),
                     is_test, dropout_rate)


def _embed(ids, vocab, d_model, max_len, scope_name):
    emb = layers.embedding(input=ids, size=[vocab, d_model],
                           param_attr=ParamAttr(name=f"{scope_name}_emb"))
    if len(emb.shape) > 3:
        emb = layers.reshape(emb, shape=[0, 0, d_model])
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    pos_emb = layers.embedding(
        input=_position_ids_like(ids, max_len), size=[max_len, d_model],
        param_attr=ParamAttr(name=f"{scope_name}_pos_emb"))
    return layers.elementwise_add(emb, pos_emb)


def _position_ids_like(ids, max_len):
    """[N, T] int32 position ids 0..T-1."""
    helper = LayerHelper("position_ids")
    out = helper.create_tmp_variable("int32")
    helper.append_op("position_ids", inputs={"X": ids},
                     outputs={"Out": out}, attrs={"max_len": max_len})
    return out


def transformer_body(src_ids, trg_ids, src_vocab, trg_vocab, max_len=256,
                     n_layer=2, d_model=128, n_head=4, d_inner=512,
                     dropout_rate=0.0, is_test=False):
    """Encoder+decoder stack; returns decoder states [N, T_trg, d_model]."""
    enc = _embed(src_ids, src_vocab, d_model, max_len, "src")
    for _ in range(n_layer):
        enc = encoder_layer(enc, d_model, n_head, d_inner, is_test,
                            dropout_rate)
    dec = _embed(trg_ids, trg_vocab, d_model, max_len, "trg")
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, d_model, n_head, d_inner, is_test,
                            dropout_rate)
    return dec


def transformer(src_ids, trg_ids, src_vocab, trg_vocab, max_len=256,
                n_layer=2, d_model=128, n_head=4, d_inner=512,
                dropout_rate=0.0, is_test=False):
    """Decoder states projected to logits [N, T_trg, trg_vocab]."""
    dec = transformer_body(src_ids, trg_ids, src_vocab, trg_vocab, max_len,
                           n_layer, d_model, n_head, d_inner, dropout_rate,
                           is_test)
    return layers.fc(input=dec, size=trg_vocab, num_flatten_dims=2)


def train_network(src_ids, trg_ids, labels, src_vocab, trg_vocab,
                  weights=None, max_len=256, n_layer=2, d_model=128,
                  n_head=4, d_inner=512, dropout_rate=0.0,
                  fuse_final_ce=False):
    """labels: [N, T_trg, 1] int64 next tokens.  Returns (avg_loss, logits).

    ``fuse_final_ce=True`` replaces the final projection fc + softmax CE
    with the fused op (ops/fused_ce.py), and the returned logits are None.
    The unfused head (``softmax_with_cross_entropy``) and the per-token
    ``weights`` (``elementwise_mul``, ``reduce_sum``) are not ported yet."""
    if not fuse_final_ce:
        raise NotImplementedError("train_network(fuse_final_ce=False) needs "
                                  "softmax_with_cross_entropy, not ported yet")
    if weights is not None:
        raise NotImplementedError("train_network(weights=...) needs "
                                  "elementwise_mul and reduce_sum, not ported yet")
    dec = transformer_body(src_ids, trg_ids, src_vocab, trg_vocab, max_len,
                           n_layer, d_model, n_head, d_inner, dropout_rate)
    loss = layers.fused_fc_softmax_ce(dec, labels, trg_vocab, num_flatten_dims=2)
    return layers.mean(loss), None
