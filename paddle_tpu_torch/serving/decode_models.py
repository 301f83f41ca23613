"""The decode models of :class:`DecodeEngine`, as the JAX package's
``serving/decode_models.py`` defines them: three tiny autoregressive
families covering the three op substrates the engine is specified
against, shared by the tests, ``chip_smoke.py`` and
``paddle_tpu_torch/tools/decode_smoke.py``:

* :func:`gru_lm` — ``rnn_ops``-style: a GRU language model whose decoder
  state is a fixed ``[N, H]`` hidden (no sequence axis — the degenerate
  slot shape).  Prefill unrolls ``gru_unit`` over the prompt bucket with
  per-step carry masks, so ragged prompts produce exactly the state a
  step-by-step replay would.
* :func:`attention_lm` — ``attention_ops``-style: single-layer causal
  attention over a paged K/V cache.  The decode step is built ONCE with
  a dynamic cache axis (``[N, -1, H]``) and a ``pos`` feed: each new
  token's K/V row is scattered into the cache at ``pos`` via a
  sequence-mask one-hot, and attention masks to ``pos + 1``: one cache
  entry per (batch-bucket x slot-bucket) signature, never per length.
  Its prefill runs ``flash_attention(causal=True)``, which launches the
  flash kernel on the card.
* :func:`beam_gru_lm` — ``beam_search_ops``-style: the GRU model decoded
  with dense-lane beam search; the token lane is ``[N, beam]`` and the
  per-lane hidden rides the engine's state plumbing flattened to
  ``[N, beam*H]``, re-gathered by parent each step via the
  ``beam_search`` op's SelectedStates.

Every family returns ``(prefill_func, step_func, reference_func)``:
the first two are the engine's model contract; ``reference_func(T, G)``
builds the one-shot full-sequence program (prompt ``[N, T]`` in, all
``G`` generated tokens out, the whole loop unrolled in one graph) that
the parity tests compare against token-for-token.
"""
from __future__ import annotations

import numpy as np

VOCAB = 43
EMB = 12
HID = 16


def _p(name):
    from ..param_attr import ParamAttr
    return ParamAttr(name=name)


# --------------------------------------------------------------- GRU LM
def _gru_step_math(layers, tok_2d, h):
    """Shared per-token math: embed -> project -> gru_unit -> logits.
    ``tok_2d`` is int64 [rows, 1]; returns (h_new, logits)."""
    emb = layers.embedding(tok_2d, size=[VOCAB, EMB],
                           param_attr=_p("dec_emb"))
    proj = layers.fc(emb, size=3 * HID, bias_attr=False,
                     param_attr=_p("dec_proj"))
    h_new, _, _ = layers.gru_unit(proj, h, size=3 * HID,
                                  param_attr=_p("dec_gru"),
                                  bias_attr=_p("dec_gru_b"))
    logits = layers.fc(h_new, size=VOCAB, bias_attr=False,
                       param_attr=_p("dec_out"))
    return h_new, logits


def _gru_prompt_state(layers, ids, lens, max_len):
    """Hidden state after consuming a ragged prompt: unrolled gru_unit
    with per-step carry masks (columns of the length mask), bit-equal to
    stepping the prompt token-by-token."""
    mask = layers.cast(layers.sequence_mask(lens, maxlen=max_len,
                                            dtype="float32"), "float32")
    cols = layers.split(mask, max_len, dim=1) if max_len > 1 else [mask]
    h = layers.fill_constant_batch_size_like(ids, shape=[1, HID],
                                             dtype="float32", value=0.0)
    tok_cols = layers.split(ids, max_len, dim=1) if max_len > 1 else [ids]
    logits = None
    for t in range(max_len):
        h_new, logits_t = _gru_step_math(layers, tok_cols[t], h)
        m = cols[t]
        h = layers.elementwise_add(
            layers.elementwise_mul(h_new, m),
            layers.elementwise_mul(h, layers.scale(m, scale=-1.0,
                                                   bias=1.0)))
        # logits of the LAST VALID step: same carry trick
        logits = logits_t if logits is None else layers.elementwise_add(
            layers.elementwise_mul(logits_t, m),
            layers.elementwise_mul(logits, layers.scale(m, scale=-1.0,
                                                        bias=1.0)))
    return h, logits


def gru_lm(seed_note: str = ""):
    """(prefill_func, step_func, reference_func) for the greedy GRU LM."""
    from .. import layers

    def prefill_func(max_len):
        ids = layers.data(name="ids", shape=[max_len], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int32")
        h, logits = _gru_prompt_state(layers, ids, lens, max_len)
        tok0 = layers.argmax(logits, axis=1)
        return (ids, lens), (tok0, [h])

    def step_func():
        token = layers.data(name="token", shape=[1], dtype="int64")
        h = layers.data(name="h", shape=[HID], dtype="float32")
        h_new, logits = _gru_step_math(layers, token, h)
        nxt = layers.argmax(logits, axis=1)
        return (token, None, [h]), (nxt, [h_new])

    def reference_func(max_len, gen):
        """One-shot program: prompt in, [N, gen] generated tokens out."""
        ids = layers.data(name="ids", shape=[max_len], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int32")
        h, logits = _gru_prompt_state(layers, ids, lens, max_len)
        toks = []
        tok = layers.argmax(logits, axis=1)
        for _ in range(gen):
            toks.append(layers.reshape(tok, shape=[-1, 1]))
            h, logits = _gru_step_math(layers, toks[-1], h)
            tok = layers.argmax(logits, axis=1)
        return (ids, lens), layers.concat(toks, axis=1)

    return prefill_func, step_func, reference_func


# ------------------------------------------------------- attention KV LM
def _qkv(layers, emb3):
    q = layers.fc(emb3, size=HID, bias_attr=False, num_flatten_dims=2,
                  param_attr=_p("att_q"))
    k = layers.fc(emb3, size=HID, bias_attr=False, num_flatten_dims=2,
                  param_attr=_p("att_k"))
    v = layers.fc(emb3, size=HID, bias_attr=False, num_flatten_dims=2,
                  param_attr=_p("att_v"))
    return q, k, v


def attention_lm():
    """(prefill_func, step_func, reference_func) for the greedy causal
    attention LM with a paged K/V cache decode step."""
    from .. import layers

    def prefill_func(max_len):
        ids = layers.data(name="ids", shape=[max_len], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int32")
        emb = layers.embedding(ids, size=[VOCAB, EMB],
                               param_attr=_p("att_emb"))
        q, k, v = _qkv(layers, emb)
        out = layers.flash_attention(q, k, v, num_heads=1, causal=True)
        lensf = layers.cast(lens, "float32")
        lm1 = layers.cast(layers.scale(lensf, bias=-1.0), "int32")
        sel = layers.elementwise_sub(
            layers.sequence_mask(lens, maxlen=max_len, dtype="float32"),
            layers.sequence_mask(lm1, maxlen=max_len, dtype="float32"))
        last = layers.squeeze(
            layers.matmul(layers.unsqueeze(sel, axes=[1]), out), axes=[1])
        logits = layers.fc(last, size=VOCAB, bias_attr=False,
                           param_attr=_p("att_out"))
        tok0 = layers.argmax(logits, axis=1)
        return (ids, lens), (tok0, [k, v])

    def step_func():
        token = layers.data(name="token", shape=[1], dtype="int64")
        pos = layers.data(name="pos", shape=[1], dtype="int32")
        k_cache = layers.data(name="k_cache", shape=[-1, HID],
                              dtype="float32")
        v_cache = layers.data(name="v_cache", shape=[-1, HID],
                              dtype="float32")
        emb = layers.embedding(token, size=[VOCAB, EMB],
                               param_attr=_p("att_emb"))
        emb3 = layers.unsqueeze(emb, axes=[1])
        q3, k3, v3 = _qkv(layers, emb3)
        q = layers.squeeze(q3, axes=[1])
        k_t, v_t = layers.squeeze(k3, axes=[1]), layers.squeeze(v3,
                                                                axes=[1])
        posf = layers.cast(pos, "float32")
        pos1 = layers.cast(layers.scale(posf, bias=1.0), "int32")
        sm1 = layers.sequence_mask(pos1, maxlen_like=k_cache,
                                   dtype="float32")
        sm0 = layers.sequence_mask(pos, maxlen_like=k_cache,
                                   dtype="float32")
        wm = layers.unsqueeze(layers.elementwise_sub(sm1, sm0), axes=[2])
        keep = layers.scale(wm, scale=-1.0, bias=1.0)
        k_new = layers.elementwise_add(
            layers.elementwise_mul(k_cache, keep),
            layers.matmul(wm, layers.unsqueeze(k_t, axes=[1])))
        v_new = layers.elementwise_add(
            layers.elementwise_mul(v_cache, keep),
            layers.matmul(wm, layers.unsqueeze(v_t, axes=[1])))
        scores = layers.squeeze(
            layers.matmul(layers.unsqueeze(q, axes=[1]), k_new,
                          transpose_y=True,
                          alpha=float(1.0 / np.sqrt(HID))), axes=[1])
        neg = layers.scale(sm1, scale=1e9, bias=-1e9)
        probs = layers.softmax(layers.elementwise_add(scores, neg))
        ctx = layers.squeeze(
            layers.matmul(layers.unsqueeze(probs, axes=[1]), v_new),
            axes=[1])
        logits = layers.fc(ctx, size=VOCAB, bias_attr=False,
                           param_attr=_p("att_out"))
        nxt = layers.argmax(logits, axis=1)
        return (token, pos, [k_cache, v_cache]), (nxt, [k_new, v_new])

    def reference_func(max_len, gen):
        # The sequential reference for this family is the engine's own
        # programs run one request at a time (see the tests): the prompt
        # bucket's flash-attention prefill is the one-shot prefix.
        raise NotImplementedError(
            "attention_lm parity uses the solo-request reference")

    return prefill_func, step_func, reference_func


# ------------------------------------------------------------ beam GRU
BEAM = 3
_NEG_INF = -1e9


def beam_gru_lm():
    """(prefill_func, step_func, reference_func) for dense-lane beam
    decode over the GRU LM: token lane [N, BEAM]; states are the lane
    scores [N, BEAM] and the flattened per-lane hidden [N, BEAM*H]."""
    from .. import layers

    def _lane_step(tok, scores_in, h_flat):
        """One beam step: returns (sel_ids, sel_scores, h_sel_flat)."""
        h = layers.reshape(h_flat, shape=[-1, HID])     # [N*B, H]
        tok_flat = layers.reshape(tok, shape=[-1, 1])   # [N*B, 1]
        h_new, logits = _gru_step_math(layers, tok_flat, h)
        logp = layers.log(layers.softmax(logits))       # [N*B, V]
        logp3 = layers.reshape(logp, shape=[-1, BEAM, VOCAB])
        sel_ids, sel_scores, _parents, (h_sel,) = layers.beam_search(
            pre_ids=tok, pre_scores=scores_in, scores=logp3,
            beam_size=BEAM, end_id=0, states=[h_new])
        return sel_ids, sel_scores, layers.reshape(h_sel,
                                                   shape=[-1, BEAM * HID])

    def _lane_init(layers_, ids, lens, max_len):
        """Prompt state expanded to BEAM lanes + init lane scores."""
        h, logits = _gru_prompt_state(layers_, ids, lens, max_len)
        h_lanes = layers_.concat([h] * BEAM, axis=1)    # [N, B*H]
        init = [0.0] + [_NEG_INF] * (BEAM - 1)
        scores0 = layers_.elementwise_add(
            layers_.fill_constant_batch_size_like(ids, shape=[1, BEAM],
                                                  dtype="float32",
                                                  value=0.0),
            layers_.assign_value(init, shape=[1, BEAM], dtype="float32"))
        # first lane selection straight from the prompt logits
        logp = layers_.log(layers_.softmax(logits))     # [N, V]
        logp_l = layers_.concat([layers_.unsqueeze(logp, axes=[1])]
                                * BEAM, axis=1)         # [N, B, V]
        # pre_ids must not be the end token — an end-id lane would be
        # frozen by beam_search before the first real selection
        last = layers_.fill_constant_batch_size_like(
            ids, shape=[1, BEAM], dtype="int64", value=1)
        sel_ids, sel_scores, _parents, (h_sel,) = layers_.beam_search(
            pre_ids=last, pre_scores=scores0, scores=logp_l,
            beam_size=BEAM, end_id=0,
            states=[layers_.reshape(h_lanes, shape=[-1, HID])])
        return sel_ids, sel_scores, layers_.reshape(
            h_sel, shape=[-1, BEAM * HID])

    def prefill_func(max_len):
        ids = layers.data(name="ids", shape=[max_len], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int32")
        tok0, scores0, h0 = _lane_init(layers, ids, lens, max_len)
        return (ids, lens), (tok0, [scores0, h0])

    def step_func():
        token = layers.data(name="token", shape=[BEAM], dtype="int64")
        scores = layers.data(name="pre_scores", shape=[BEAM],
                             dtype="float32")
        h_flat = layers.data(name="h_lanes", shape=[BEAM * HID],
                             dtype="float32")
        sel_ids, sel_scores, h_sel = _lane_step(token, scores, h_flat)
        return (token, None, [scores, h_flat]), (sel_ids,
                                                 [sel_scores, h_sel])

    def reference_func(max_len, gen):
        """One-shot beam program: [N, gen, BEAM] selected ids out."""
        ids = layers.data(name="ids", shape=[max_len], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int32")
        tok, scores, h = _lane_init(layers, ids, lens, max_len)
        steps = [layers.unsqueeze(tok, axes=[1])]
        for _ in range(gen - 1):
            tok, scores, h = _lane_step(tok, scores, h)
            steps.append(layers.unsqueeze(tok, axes=[1]))
        return (ids, lens), layers.concat(steps, axis=1)

    return prefill_func, step_func, reference_func
