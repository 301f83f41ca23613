"""Sequence and recurrent layers (the reference's layers/nn.py:
``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``, ``sequence_conv``,
``sequence_pool`` and the other ``sequence_*`` layers, the ``gru_unit``
and ``lstm_unit`` cells), and the attention layers ``flash_attention`` and
``multi_head_attention``.  Ragged inputs are padded ``[N, T, ...]`` with
``@SEQ_LEN`` lengths (ops/sequence_ops.py).  ``beam_search`` and
``beam_search_decode`` are the dense-lane decoding layers
(ops/beam_search_ops.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru",
           "sequence_conv", "sequence_pool",
           "sequence_softmax", "sequence_expand", "sequence_expand_as",
           "sequence_first_step", "sequence_last_step", "sequence_reshape",
           "sequence_mask", "sequence_length", "flash_attention",
           "multi_head_attention",
           "gru_unit", "lstm_unit", "beam_search", "beam_search_decode"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: [N, T, 4*hidden] (an ``fc`` of size 4*hidden first, the
    reference's contract); returns (hidden [N, T, H], cell [N, T, H])."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_size = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[hidden_size, 4 * hidden_size],
                                     dtype=dtype)
    bias_size = 7 * hidden_size if use_peepholes else 4 * hidden_size
    bias = helper.create_parameter(helper.bias_attr, shape=[1, bias_size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": hidden, "Cell": cell},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None):
    """input: [N, T, 3*size]; returns hidden [N, T, size]."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op("dynamic_gru", inputs=inputs,
                     outputs={"Hidden": hidden},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return hidden


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = input.shape[-1]
    filter_param = helper.create_parameter(
        helper.param_attr, shape=[filter_size * d, num_filters],
        dtype="float32")
    out = helper.create_tmp_variable("float32")
    helper.append_op("sequence_conv",
                     inputs={"X": input, "Filter": filter_param},
                     outputs={"Out": out},
                     attrs={"contextLength": filter_size,
                            "contextStart": -((filter_size - 1) // 2),
                            "contextStride": filter_stride})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


def _seq_unary(op_type, out_slot="Out"):
    def layer(input, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable("float32")
        helper.append_op(op_type, inputs={"X": input},
                         outputs={out_slot: out}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


def sequence_pool(input, pool_type, name=None):
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("sequence_pool", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooltype": pool_type.upper()})
    return out


sequence_softmax = _seq_unary("sequence_softmax")
sequence_first_step = _seq_unary("sequence_first_step")
sequence_last_step = _seq_unary("sequence_last_step")


def sequence_reshape(input, new_dim, name=None):
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("sequence_reshape", inputs={"X": input},
                     outputs={"Out": out}, attrs={"new_dim": new_dim})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("sequence_expand", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("sequence_expand_as", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def flash_attention(q, k, v, num_heads=1, causal=False, use_ring=False,
                    ring_seq_axis="seq", ring_batch_axis="data", name=None):
    """Fused blockwise attention.  q/k/v: [N, T, H*D].  Ragged keys are
    masked by k's @SEQ_LEN lengths.  The ring attrs are recorded for
    ProgramDesc parity with the JAX package; the port runs on one device,
    where the JAX package also takes the local kernel."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("flash_attention", inputs={"Q": q, "K": k, "V": v},
                     outputs={"Out": out},
                     attrs={"num_heads": num_heads, "causal": causal,
                            "use_ring": use_ring,
                            "ring_seq_axis": ring_seq_axis,
                            "ring_batch_axis": ring_batch_axis})
    return out


def multi_head_attention(queries, keys, values, d_model, n_head=1,
                         causal=False, dropout_rate=0.0, is_test=False,
                         use_ring_attention=False, name=None):
    """q/k/v projections + flash attention + output projection, each
    projection with its own bias-free weight."""
    from . import nn

    def proj_attr(suffix):
        if name is None:
            return None
        return ParamAttr(name=f"{name}_{suffix}.w")

    q = nn.fc(input=queries, size=d_model, num_flatten_dims=2,
              bias_attr=False, param_attr=proj_attr("q"))
    k = nn.fc(input=keys, size=d_model, num_flatten_dims=2, bias_attr=False,
              param_attr=proj_attr("k"))
    v = nn.fc(input=values, size=d_model, num_flatten_dims=2,
              bias_attr=False, param_attr=proj_attr("v"))
    ctx_out = flash_attention(q, k, v, num_heads=n_head, causal=causal,
                              use_ring=use_ring_attention)
    if dropout_rate:
        ctx_out = nn.dropout(ctx_out, dropout_prob=dropout_rate,
                             is_test=is_test)
    return nn.fc(input=ctx_out, size=d_model, num_flatten_dims=2,
                 bias_attr=False, param_attr=proj_attr("out"))


def sequence_length(x, name=None):
    """int32 [N] lengths of a padded LoD var (its @SEQ_LEN side channel)."""
    helper = LayerHelper("sequence_length", name=name)
    out = helper.create_tmp_variable("int32")
    helper.append_op("sequence_length", inputs={"X": x},
                     outputs={"Out": out})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None,
                  maxlen_like=None):
    """[N, maxlen] validity mask from lengths ``x``.  ``maxlen`` may be an
    int, or ``maxlen_like`` a [N, T, ...] var whose T is read when the
    program runs."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_tmp_variable(dtype)
    inputs = {"X": x}
    if maxlen_like is not None:
        inputs["MaxLenLike"] = maxlen_like
    helper.append_op("sequence_mask", inputs=inputs, outputs={"Y": out},
                     attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step: input [N, 3H] is the projected x, hidden [N, H] the
    previous state; returns (new_hidden, reset_hidden_prev, gate).
    ``size`` is 3*H, as in the reference's API."""
    h = size // 3
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    weight = helper.create_parameter(helper.param_attr, shape=[h, 3 * h],
                                     dtype="float32")
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * h],
                                   dtype="float32", is_bias=True)
    hidden_out = helper.create_tmp_variable("float32")
    reset = helper.create_tmp_variable("float32")
    gate = helper.create_tmp_variable("float32")
    helper.append_op("gru_unit",
                     inputs={"Input": input, "HiddenPrev": hidden,
                             "Weight": weight, "Bias": bias},
                     outputs={"Hidden": hidden_out,
                              "ResetHiddenPrev": reset, "Gate": gate},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return hidden_out, reset, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc projects concat([x_t, hidden]) to the 4H
    gates, then the cell update; returns (hidden, cell).  (The JAX
    package's layer looks ``concat`` up in its ``layers.tensor``, which has
    none, and raises; this one takes ``layers.nn.concat``.)"""
    from . import nn as _nn
    h = cell_t_prev.shape[-1]
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    cat = _nn.concat([x_t, hidden_t_prev], axis=-1)
    gates = _nn.fc(cat, size=4 * h, param_attr=param_attr,
                   bias_attr=bias_attr)
    cell = helper.create_tmp_variable("float32")
    hidden = helper.create_tmp_variable("float32")
    helper.append_op("lstm_unit",
                     inputs={"X": gates, "C_prev": cell_t_prev},
                     outputs={"C": cell, "H": hidden},
                     attrs={"forget_bias": float(forget_bias)})
    return hidden, cell


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, states=None,
                name=None):
    """One beam-selection step (the reference's ``beam_search`` op, in the
    dense-lane form): pre_ids / pre_scores [N, B], scores = log-probs
    [N, B, V]; returns (selected_ids, selected_scores, parent_idx), each
    [N, B].  ``states``: optional flat-lane [N*B, ...] decoder states to
    re-gather by parent; the returned tuple then ends with the list of
    gathered states."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_tmp_variable(pre_ids.dtype)
    sel_scores = helper.create_tmp_variable("float32")
    parents = helper.create_tmp_variable("int32")
    inputs = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    outputs = {"selected_ids": sel_ids, "selected_scores": sel_scores,
               "parent_idx": parents}
    new_states = None
    if states:
        inputs["States"] = list(states)
        new_states = [helper.create_tmp_variable(s.dtype) for s in states]
        for s, ns in zip(states, new_states):
            ns.desc.shape = s.shape
        outputs["SelectedStates"] = new_states
    helper.append_op("beam_search", inputs=inputs, outputs=outputs,
                     attrs={"beam_size": int(beam_size), "end_id": int(end_id)})
    if new_states is not None:
        return sel_ids, sel_scores, parents, new_states
    return sel_ids, sel_scores, parents


def beam_search_decode(ids, parent_idx, scores, end_id, name=None):
    """Backtrack the per-step beam arrays into sentences (the reference's
    ``beam_search_decode`` op).  ids / parent_idx: tensor arrays written
    with ``array_write`` each step; returns (sentence_ids [N, B, T],
    sentence_scores [N, B])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_tmp_variable("int64")
    sent_scores = helper.create_tmp_variable("float32")
    helper.append_op("beam_search_decode",
                     inputs={"Ids": ids, "ParentIdx": parent_idx, "Scores": scores},
                     outputs={"SentenceIds": sent_ids, "SentenceScores": sent_scores},
                     attrs={"end_id": int(end_id)})
    return sent_ids, sent_scores


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection (the ``lstmp`` op): input
    [N, T, 4*hidden] (an fc of 4*hidden first), the recurrence over the
    projected state [N, proj_size].  Returns (projection [N, T, P],
    cell [N, T, H])."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_size = size // 4
    weight = helper.create_parameter(
        helper.param_attr_for("w"), shape=[proj_size, 4 * hidden_size],
        dtype=dtype)
    proj_weight = helper.create_parameter(
        helper.param_attr_for("proj"), shape=[hidden_size, proj_size],
        dtype=dtype)
    bias_size = 7 * hidden_size if use_peepholes else 4 * hidden_size
    bias = helper.create_parameter(helper.bias_attr, shape=[1, bias_size],
                                   dtype=dtype, is_bias=True)
    proj = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "ProjWeight": proj_weight,
              "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstmp", inputs=inputs,
                     outputs={"Projection": proj, "Cell": cell},
                     attrs={"use_peepholes": use_peepholes,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return proj, cell
