"""Beam search on the CPU against the JAX package.

* ``beam_search_step``: the JAX golden cases (``tests/test_machine_
  translation.py``), random steps, and constructed ties (equal lane scores,
  lanes at -1e9 whose extensions round back to -1e9, frozen lanes
  proposing V-1 equal -1e9 values): ids, scores and parents equal to the
  JAX step's, whose ``jax.lax.top_k`` takes the lower flat index first
  (the port's ``_top_k_lower_index_first``); a control that takes the
  first B of the row in another order picks other lanes on the same row;
* ``beam_search_backtrack`` and the ``beam_search_decode`` op's outputs and
  lengths (``@SEQ_LEN``, ``@SEQ_LEN@1``) equal to the JAX lowering's;
* machine translation's ``infer_network`` at dict 30, word 16, hidden 16,
  beam 3, max_len 8, batch 4 of the synthetic wmt16: equal ProgramDescs
  under ``unique_name.guard()``, the JAX parameters carried across,
  SentenceIds equal and SentenceScores within ``SCORE_ATOL``;
* the synthetic ``wmt16`` / ``wmt14`` readers equal to the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.dataset.wmt14 as jax_wmt14
import paddle_tpu.dataset.wmt16 as jax_wmt16
import paddle_tpu.models.machine_translation  # noqa: F401
import paddle_tpu_torch as pt
import paddle_tpu_torch.models.machine_translation  # noqa: F401
from paddle_tpu.ops.beam_search_ops import beam_search_backtrack as jax_backtrack
from paddle_tpu.ops.beam_search_ops import beam_search_step as jax_step
from paddle_tpu_torch.dataset import wmt14, wmt16
from paddle_tpu_torch.ops.beam_search_ops import NEG_INF, beam_search_backtrack, beam_search_step

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_cnn_ops import build_both, start_both

DICT, WORD, HID, BEAM, MAX_LEN, BATCH = 30, 16, 16, 3, 8, 4
# float32 through an 8-step decode: XLA and torch sum the fc and softmax in
# other orders
SCORE_ATOL = 1e-5


def _both_steps(pre_ids, pre_scores, logp, beam, end_id):
    got = beam_search_step(torch.from_numpy(pre_ids), torch.from_numpy(pre_scores),
                           torch.from_numpy(logp), beam, end_id)
    want = jax_step(jnp.asarray(pre_ids), jnp.asarray(pre_scores), jnp.asarray(logp),
                    beam, end_id)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_steps_equal(got, want):
    for g, w, what in zip(got, want, ("ids", "scores", "parents")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert got[2].dtype == np.int32 and want[2].dtype == np.int32


# -------------------------------------------------------------- golden


def test_beam_search_step_golden():
    """tests/test_machine_translation.py's case: scores accumulate, a
    finished lane freezes."""
    pre_ids = torch.tensor([[5, 1]], dtype=torch.int32)   # lane 1 finished (end=1)
    pre_scores = torch.tensor([[-1.0, -0.5]])
    logp = torch.log(torch.tensor([[[0.1, 0.2, 0.7], [0.5, 0.4, 0.1]]]))
    ids, scores, parents = beam_search_step(pre_ids, pre_scores, logp, beam_size=2, end_id=1)
    assert float(scores[0, 0]) == -0.5 and int(ids[0, 0]) == 1
    np.testing.assert_allclose(float(scores[0, 1]), -1.0 + np.log(0.7), rtol=1e-6)
    assert int(ids[0, 1]) == 2 and int(parents[0, 1]) == 0
    assert ids.dtype == torch.int32 and parents.dtype == torch.int32


def test_beam_search_backtrack_golden():
    ids = torch.tensor([[[7, 8]], [[4, 5]], [[2, 3]]], dtype=torch.int32)
    parents = torch.tensor([[[0, 1]], [[1, 1]], [[0, 1]]], dtype=torch.int32)
    sent = beam_search_backtrack(ids, parents, end_id=1)
    np.testing.assert_array_equal(sent[0, 0].numpy(), [8, 4, 2])
    np.testing.assert_array_equal(sent[0, 1].numpy(), [8, 5, 3])


# ------------------------------------------------- the step against JAX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_steps_equal_the_jax_step(seed):
    rng = np.random.default_rng(seed)
    n, b, v, end = 5, 4, 11, 1
    pre_ids = rng.integers(0, v, (n, b)).astype(np.int32)
    pre_ids[rng.random((n, b)) < 0.3] = end
    pre_scores = rng.normal(-3.0, 1.0, (n, b)).astype(np.float32)
    logits = rng.normal(0.0, 2.0, (n, b, v)).astype(np.float32)
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    got, want = _both_steps(pre_ids, pre_scores, logp, b, end)
    _assert_steps_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_of_many_ties_equal_lax_top_k(seed):
    """Integer-valued rows (each value shared by many elements) through
    the selection alone, against ``jax.lax.top_k``'s values and indices."""
    import jax
    from paddle_tpu_torch.ops.beam_search_ops import _top_k_lower_index_first
    rng = np.random.default_rng(seed)
    flat = rng.integers(-4, 4, (6, 97)).astype(np.float32)
    for k in (1, 3, 8):
        vals, idx = _top_k_lower_index_first(torch.from_numpy(flat), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(flat), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_ties_take_the_lower_flat_index_as_lax_top_k_does():
    """Equal lane scores over equal rows, lanes at -1e9 (|logp| < 32, so
    -1e9 + logp rounds back to -1e9 in float32), and a frozen lane whose
    V-1 non-end proposals are all -1e9."""
    n, b, v, end = 3, 4, 6, 1
    assert np.float32(NEG_INF) + np.float32(-5.0) == np.float32(NEG_INF)
    row = np.log(np.array([0.1, 0.3, 0.1, 0.3, 0.1, 0.1], np.float32))
    logp = np.broadcast_to(row, (n, b, v)).copy()
    pre_ids = np.zeros((n, b), np.int32)
    pre_scores = np.zeros((n, b), np.float32)
    # source 0: every lane equal -> the first B of a 4-way tie per token
    # source 1: the step-1 lane bias, lanes 1.. at -1e9
    pre_scores[1, 1:] = NEG_INF
    # source 2: every lane at -1e9, lane 2 finished: all B*V proposals
    # are -1e9
    pre_scores[2] = NEG_INF
    pre_ids[2, 2] = end
    got, want = _both_steps(pre_ids, pre_scores, logp, b, end)
    _assert_steps_equal(got, want)
    # the ties are real: source 0's first two picks share one score, as do
    # source 1's last two; source 2 takes flat indices 0..B-1
    assert got[1][0, 0] == got[1][0, 1] and got[1][1, 2] == got[1][1, 3]
    np.testing.assert_array_equal(got[2][1], [0, 0, 0, 0])
    assert (got[1][2] == np.float32(NEG_INF)).all()
    np.testing.assert_array_equal(got[2][2], [0, 0, 0, 0])
    np.testing.assert_array_equal(got[0][2], [0, 1, 2, 3])
    # control: the first B of the same row reversed before an (equally
    # valid) descending order picks other lanes, so the order matters
    flat = torch.from_numpy(logp[0].reshape(-1) + 0.0)
    rev = torch.flip(flat, [0])
    _, idx = torch.sort(rev, descending=True, stable=True)
    picked = (flat.numel() - 1 - idx[:b]).numpy()
    assert not np.array_equal(picked, got[2][0] * v + got[0][0])


# ----------------------------------------- backtrack and decode against JAX


def test_backtrack_equals_the_jax_backtrack():
    rng = np.random.default_rng(5)
    t, n, b, end = 7, 3, 4, 1
    ids = rng.integers(0, 6, (t, n, b)).astype(np.int32)
    parents = rng.integers(0, b, (t, n, b)).astype(np.int32)
    got = beam_search_backtrack(torch.from_numpy(ids), torch.from_numpy(parents), end).numpy()
    want = np.asarray(jax_backtrack(jnp.asarray(ids), jnp.asarray(parents), end))
    np.testing.assert_array_equal(got, want)
    assert (got == end).any() and (got != end).any()


def _decode_program(pkg, t, n, b):
    ids = pkg.layers.data(name="ids", shape=[n, b], dtype="int32", append_batch_size=False)
    ids.desc.shape = (t, n, b)
    par = pkg.layers.data(name="par", shape=[n, b], dtype="int32", append_batch_size=False)
    par.desc.shape = (t, n, b)
    sc = pkg.layers.data(name="sc", shape=[n, b], dtype="float32", append_batch_size=False)
    return pkg.layers.beam_search_decode(ids, par, sc, end_id=1)


def test_decode_op_and_its_lengths_equal_the_jax_lowering():
    t, n, b = 6, 3, 4
    rng = np.random.default_rng(9)
    feed = {"ids": rng.integers(0, 5, (t, n, b)).astype(np.int32),
            "par": rng.integers(0, b, (t, n, b)).astype(np.int32),
            "sc": rng.normal(size=(n, b)).astype(np.float32)}
    (jm, js, (jid, jsc)), (tm, ts, (tid, tsc)) = build_both(
        lambda pkg: _decode_program(pkg, t, n, b))
    names = [jid.name, jsc.name, jid.name + "@SEQ_LEN", jid.name + "@SEQ_LEN@1"]
    want = fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed, fetch_list=names,
                                                scope=fluid.Scope())
    got = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=names, scope=pt.Scope())
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    assert (got[3] < t).any() and (got[3] == t).any()


# ------------------------------------------------------ the book's decoder


def _pad_batch(seqs, pad=1):
    n, t = len(seqs), max(len(s) for s in seqs)
    out = np.full((n, t, 1), pad, np.int64)
    lens = np.zeros((n,), np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s), 0] = s
        lens[i] = len(s)
    return out, lens


def _infer(pkg):
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    return pkg.models.machine_translation.infer_network(
        src, DICT, DICT, word_dim=WORD, hidden_dim=HID, beam_size=BEAM, max_len=MAX_LEN)


def test_infer_network_equals_the_jax_decoder():
    jside, tside = build_both(_infer)
    types = [o.type for o in tside[0].desc.block(0).ops]
    assert types.count("beam_search") == MAX_LEN and types.count("beam_search_decode") == 1
    assert types.count("array_write") == 2 * MAX_LEN
    jexe, jscope, texe, tscope, state = start_both(jside, tside)
    assert {"src_emb", "trg_emb", "dec_gru.w", "out_fc.w"} <= set(state)
    batch = next(iter(fluid.batch(jax_wmt16.test(DICT, DICT), BATCH)()))
    src, lens = _pad_batch([s[0] for s in batch])
    feed = {"src": src, "src@SEQ_LEN": lens}
    jid, jsc = jside[2]
    names = [jid.name, jsc.name, jid.name + "@SEQ_LEN@1"]
    want = jexe.run(jside[0], feed=feed, fetch_list=names, scope=jscope)
    got = texe.run(tside[0], feed=feed, fetch_list=names, scope=tscope)
    assert got[0].shape == (BATCH, BEAM, MAX_LEN) and got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    # beams best-first, every id in the dictionary
    assert (np.diff(got[1], axis=1) <= 1e-6).all()
    assert got[0].min() >= 0 and got[0].max() < DICT


def test_infer_network_writes_each_step_into_the_arrays():
    """One replayable program: no op of the decoder reads a value on the
    host, so ``graph_blockers`` names nothing."""
    from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _infer(pt)
    state_in, state_out = analyze_state(main.desc.block(0), ["src", "src@SEQ_LEN"])
    assert "trg_emb" in state_in and state_out == []
    assert graph_blockers(main, state_in, state_out) == []


# ---------------------------------------------------------------- readers


@pytest.mark.parametrize("split", ["train", "test", "validation"])
def test_wmt16_equals_the_jax_reader(split):
    want = list(getattr(jax_wmt16, split)(40, 50)())
    got = list(getattr(wmt16, split)(40, 50)())
    assert got == want and len(got) in (2000, 200)
    assert wmt16.get_dict("de", 10, reverse=True) == jax_wmt16.get_dict("de", 10, reverse=True)


@pytest.mark.parametrize("split", ["train", "test", "gen"])
def test_wmt14_equals_the_jax_reader(split):
    assert list(getattr(wmt14, split)(60)()) == list(getattr(jax_wmt14, split)(60)())
    assert wmt14.get_dict(12) == jax_wmt14.get_dict(12)
    assert wmt14.fetch() is None and wmt16.fetch() is None
