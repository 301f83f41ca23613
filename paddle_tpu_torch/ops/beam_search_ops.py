"""Beam search ops for seq2seq decoding, as the JAX package's
``ops/beam_search_ops.py`` defines them: beams are a dense [N, B] lane
dimension that never shrinks, and a finished lane keeps proposing only
``end_id`` at its frozen score.

Step op ``beam_search``:
  inputs  pre_ids    [N, B]     int   last selected token per lane
          pre_scores [N, B]     float accumulated log-prob per lane
          scores     [N, B, V]  float log-probs for the next token
          States     optional flat-lane [N*B, ...] decoder states
  attrs   beam_size, end_id
  outputs selected_ids [N, B], selected_scores [N, B],
          parent_idx   [N, B]  (which source lane each new lane extends),
          SelectedStates: each state re-gathered by ``n*B + parent``

Decode op ``beam_search_decode``:
  inputs  Ids / ParentIdx: tensor arrays of [N, B] per step, Scores [N, B]
  outputs SentenceIds [N, B, T] (end_id-padded), SentenceScores [N, B],
          and the lengths ``@SEQ_LEN`` (B per source) and ``@SEQ_LEN@1``
          (tokens up to and including the first end_id).

The selection breaks ties as ``jax.lax.top_k`` does: of equal values the
lower flat index comes first.  ``torch.topk`` promises no order among
ties (and the CPU and CUDA orders differ), and the lanes seeded at
``NEG_INF`` make real ties: ``-1e9 + logp`` rounds back to ``-1e9`` in
float32 for any |logp| < 32, and a frozen lane proposes V-1 equal
``NEG_INF`` values.  So a step selects with ``_top_k_lower_index_first``:
``torch.topk`` finds the B-th largest value, every element above it is
taken and, of the elements equal to it, the ones of lowest index (a
second ``topk`` over a key unique to each element); the B taken are then
ordered by value, ties by index.  Nothing is read on the
host: a program holding these ops records into one CUDA graph."""
from __future__ import annotations

import torch

from ..core.lower import TensorArrayVal
from ..core.registry import mark_no_gradient, register_infer_shape, register_lowering
from ..lod import seq_len_name
from .common import in_dtype, in_shape, set_out_shape

NEG_INF = -1e9


def _top_k_lower_index_first(flat, k: int):
    """(values, indices) of the ``k`` largest of each row of ``flat``
    [N, M], in ``jax.lax.top_k``'s order: descending, equal values by
    ascending index.  The first ``topk`` finds the k-th largest value; the
    second picks, by a key unique to each element, every element above it
    (key M + (M - index)) and then the elements equal to it of lowest
    index (key M - index), which are exactly the k wanted; a stable sort of
    those k orders them.  The keys stay below 2**24, exact in float32."""
    m = flat.shape[1]
    thr = torch.topk(flat, k, dim=1).values[:, k - 1:k]
    pos = torch.arange(m, 0, -1, device=flat.device, dtype=torch.float32)
    key = torch.where(flat > thr, pos + m, torch.where(flat == thr, pos, torch.zeros_like(pos)))
    idx = torch.topk(key, k, dim=1).indices
    vals = torch.gather(flat, 1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def beam_search_step(pre_ids, pre_scores, logp, beam_size: int, end_id: int):
    """One beam selection: (ids [N, B] in ``pre_ids``' dtype, scores
    [N, B], parents [N, B] int32)."""
    n, b, v = logp.shape
    finished = pre_ids == end_id                                     # [N, B]
    # live lanes extend by the token's log-prob; a finished lane proposes
    # only end_id, its accumulated score frozen
    ext = pre_scores[:, :, None] + logp
    onehot_end = torch.arange(v, device=logp.device)[None, None, :] == end_id
    frozen = torch.where(onehot_end, pre_scores[:, :, None],
                         torch.full((), NEG_INF, dtype=logp.dtype, device=logp.device))
    total = torch.where(finished[:, :, None], frozen, ext)         # [N, B, V]
    flat = total.reshape(n, b * v)
    sel_scores, flat_idx = _top_k_lower_index_first(flat, beam_size)
    parents = torch.div(flat_idx, v, rounding_mode="floor").to(torch.int32)
    ids = (flat_idx % v).to(pre_ids.dtype)
    return ids, sel_scores, parents


@register_lowering("beam_search")
def _beam_search(ctx, op):
    pre_ids = ctx.read_slot(op, "pre_ids")
    pre_scores = ctx.read_slot(op, "pre_scores")
    logp = ctx.read_slot(op, "scores")
    ids, scores, parents = beam_search_step(pre_ids, pre_scores, logp,
                                            int(op.attr("beam_size")), int(op.attr("end_id")))
    ctx.write_slot(op, "selected_ids", ids)
    ctx.write_slot(op, "selected_scores", scores)
    ctx.write_slot(op, "parent_idx", parents)
    # the decoder states' re-gather: SelectedStates[i][n*B+b] =
    # States[i][n*B+parent]
    state_in, state_out = op.input("States"), op.output("SelectedStates")
    if state_in and state_out:
        n, b = parents.shape
        flat_parent = (torch.arange(n, device=parents.device)[:, None] * b
                       + parents).reshape(-1)
        for sname, oname in zip(state_in, state_out):
            ctx.write(oname, torch.index_select(ctx.read(sname), 0, flat_parent))


mark_no_gradient("beam_search")


@register_infer_shape("beam_search")
def _beam_search_shape(block, op):
    ps = in_shape(block, op, "pre_ids")
    beam = int(op.attr("beam_size"))
    out = (ps[0], beam) if len(ps) >= 1 else (beam,)
    set_out_shape(block, op, "selected_ids", out, in_dtype(block, op, "pre_ids"))
    set_out_shape(block, op, "selected_scores", out, in_dtype(block, op, "pre_scores"))
    set_out_shape(block, op, "parent_idx", out)


def beam_search_backtrack(step_ids, step_parents, end_id: int):
    """step_ids / step_parents [T, N, B] -> sentences [N, B, T]: follow
    the parent pointers from the last step back, a Python loop of T
    device steps, then pad everything after the first end_id with
    end_id."""
    t, n, b = step_ids.shape
    lane = torch.arange(b, device=step_ids.device).expand(n, b)
    toks = [None] * t
    for s in range(t - 1, -1, -1):
        toks[s] = torch.gather(step_ids[s], 1, lane)
        lane = torch.gather(step_parents[s], 1, lane).long()
    sent = torch.stack(toks, dim=-1)                                # [N, B, T]
    seen_end = torch.cumsum((sent == end_id).to(torch.int32), dim=-1)
    return torch.where(seen_end > 1, torch.full_like(sent, end_id), sent)


@register_lowering("beam_search_decode")
def _beam_search_decode(ctx, op):
    """The backtrack, and the 2-level lengths the reference encodes as a
    2-level LoD (B hypotheses a source, true tokens a hypothesis)."""
    ids_arr = ctx.read_slot(op, "Ids")
    parents_arr = ctx.read_slot(op, "ParentIdx")
    scores = ctx.read_slot(op, "Scores")
    end_id = int(op.attr("end_id"))
    if isinstance(ids_arr, TensorArrayVal):
        step_ids, step_parents = torch.stack(list(ids_arr)), torch.stack(list(parents_arr))
    else:
        step_ids, step_parents = ids_arr, parents_arr
    sent = beam_search_backtrack(step_ids, step_parents, end_id)
    ctx.write_slot(op, "SentenceIds", sent)
    ctx.write_slot(op, "SentenceScores", scores)
    out_names = op.output("SentenceIds")
    if out_names and out_names[0]:
        n, b, t = sent.shape
        # tokens before the first end_id, plus the end_id itself; t where
        # there is none
        before = (torch.cumsum((sent == end_id).to(torch.int32), dim=-1) == 0).sum(-1)
        tok_lens = torch.clamp(before + 1, max=t).to(torch.int32)
        ctx.write(seq_len_name(out_names[0], 0),
                  torch.full((n,), b, dtype=torch.int32, device=sent.device))
        ctx.write(seq_len_name(out_names[0], 1), tok_lens)


mark_no_gradient("beam_search_decode")
