"""The sequence slice's models on the CPU against the JAX package.

* bench.py's LSTM row (``models/stacked_lstm.train_network`` at batch 64,
  dict 30,000, emb 128, hidden 256, ``stacked_num=2``, ``Adam(0.002)``):
  both packages build equal ProgramDescs, before and after ``amp-bf16``
  (the port's pass repairs stale casts behind gradient merges; this
  program has none, so the rewrites are equal op for op);
* the same net at a small size (dict 64, emb 16, hidden 16, batch 4, T 7,
  a zero-length row): one Adam step's loss, every gradient and every
  parameter against the JAX ``Executor`` from the same state, in float32
  (within ``F32_RTOL``) and in bf16 (the port's rewrite run by both; within
  the norm-relative gates below), the bf16 generic grad of ``dynamic_lstm``
  running in bf16;
* machine translation's ``train_network`` (a ``dynamic_gru`` encoder whose
  last step is the decoder's ``h_0``, ``sequence_pool`` last and sum,
  ``sequence_length``) the same way in float32;
* the sentiment convolution net (``nets.sequence_conv_pool`` x 2,
  ``Adagrad``) trains to ``tests/test_understand_sentiment.py``'s bar;
* a ``Trainer`` epoch over ragged batches of the synthetic imdb reader
  against the JAX ``Trainer`` from the same state: the pow2 buckets, equal
  events, losses and parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.dataset.imdb  # noqa: F401
import paddle_tpu.models.machine_translation  # noqa: F401
import paddle_tpu.models.stacked_lstm  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu.passes import PassPipeline as JaxPassPipeline
from paddle_tpu_torch.core.desc import grad_var_name
from paddle_tpu_torch.passes import PassPipeline

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_amp_bf16 import _assert_differs_only_at_stale_reads, _ops, _to_jax, stale_reads
from test_torch_cnn_ops import build_both, start_both

# bench.py's bench_lstm on the accelerator (bench.py:1510-1539)
BENCH = dict(batch=64, seq=80, dict_dim=30000, emb_dim=128, hid_dim=256, stacked_num=2)
LR = 0.002
SMALL = dict(dict_dim=64, emb_dim=16, hid_dim=16, stacked_num=2)
N, T = 4, 7
LENS = np.array([7, 3, 0, 5], np.int32)
# float32: XLA and torch sum in other orders.  Adam's first step moves an
# element by about lr * sign(g) and divides by sqrt(m2), which magnifies a
# last-bit difference of a tiny gradient: each parameter's change is held
# to F32_RTOL of the parameter's largest magnitude (measured at most 3e-7
# of it), the loss and each gradient to F32_RTOL of their largest.
F32_RTOL = 1e-5
# bf16, the port against the JAX Executor on the same rewritten desc: both
# round at the ops the desc names, but XLA keeps fused elementwise chains
# in float32 where torch rounds every op, and a bf16 tie under the max pool
# routes a gradient to other steps.  Measured over seeds 0-2 of this net:
# the loss within 6e-5 relative; a gradient up to 0.17 norm-relative from
# JAX's, where the two bf16 runs are themselves up to 0.32 from float32.
# The gate is tests/test_torch_amp_bf16.py's GRAD_NREL.  Adam then moves
# each parameter by about lr whatever its gradient's size, so two bf16
# runs end within 2 * lr of each other.
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_NREL = 0.2
BF16_PARAM_ATOL = 2 * LR


def _stacked(pkg, opt=True, **kw):
    kw = {**SMALL, **kw}
    data = pkg.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss, acc = pkg.models.stacked_lstm.train_network(data, label, **kw)
    if opt:
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return [loss, acc]


def _stacked_feed(seed=0, dict_dim=SMALL["dict_dim"]):
    rng = np.random.default_rng(seed)
    return {"words": rng.integers(0, dict_dim, (N, T, 1)).astype(np.int64),
            "words@SEQ_LEN": LENS,
            "label": rng.integers(0, 2, (N, 1)).astype(np.int64)}


def _nrel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _params(main):
    return [p.name for p in main.global_block.all_parameters()]


# ------------------------------------------------------- the bench program

def _bench(pkg):
    return _stacked(pkg, **{k: v for k, v in BENCH.items() if k not in ("batch", "seq")})


def test_bench_lstm_program_equals_jax_before_and_after_amp():
    (jm, _, jout), (tm, _, tout) = build_both(_bench)
    types = [o.type for o in tm.desc.block(0).ops]
    assert types.count("dynamic_lstm") == 2 and types.count("dynamic_lstm_grad") == 2
    assert types.count("sequence_pool") == 2 and types.count("adam") == len(_params(tm))
    a, _ = JaxPassPipeline(["amp-bf16"], verify="off").run(jm, fetch_list=[jout[0].name])
    b, res = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tout[0].name])
    assert res.passes[0].changed
    if stale_reads(_ops(a)):
        _assert_differs_only_at_stale_reads(_ops(a), _ops(b))
    else:
        assert _ops(a) == _ops(b)
    assert stale_reads(_ops(b)) == []
    blk = b.desc.block(0)
    for o in blk.ops:
        if o.type in ("dynamic_lstm", "dynamic_lstm_grad"):
            assert {blk.find_var(n).dtype.value for s in ("Input", "Weight", "Bias")
                    for n in o.input(s)} == {"bfloat16"}, o.type
    assert len(types) == 47 and len(_ops(b)) == 78
    assert sum(o["type"] == "cast" for o in _ops(b)) == 31


def test_bench_lstm_kernel_tier_rewrites_the_embedding_and_adam():
    """The kernel tier (on by default on a CUDA place) takes the [30000,
    128] table's gather and scatter (K2, K3) and the large parameters'
    updates (K6), as on the card."""
    (_, _, _), (tm, _, tout) = build_both(_bench)
    feed = {"words": np.zeros((BENCH["batch"], BENCH["seq"], 1), np.int64),
            "words@SEQ_LEN": np.full((BENCH["batch"],), BENCH["seq"], np.int32),
            "label": np.zeros((BENCH["batch"], 1), np.int64)}
    exe = pt.Executor(pt.CPUPlace(), kernels=True)
    run = exe._apply_passes(tm, list(feed), [tout[0].name])
    types = [o.type for o in run.desc.block(0).ops]
    assert types.count("pallas_gather") == 1 and types.count("pallas_scatter_add") == 1
    # the parameters under optimizer_min_numel stay ``adam``: one K6 launch
    # updates both types together
    assert types.count("pallas_adam") == 5
    assert types.count("pallas_adam") + types.count("adam") == len(_params(tm)) == 11


# -------------------------------------------------- one step, small size

def _step(build, feed, amp=False):
    """One Adam step of ``build`` in both packages from the JAX startup's
    state; returns (fetch names, JAX fetches, port fetches, JAX scope, port
    scope, the start state, the port program run)."""
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    tm, tl = port_side[0], port_side[2][0]
    fetch = [tl.name] + [grad_var_name(p) for p in _params(tm)]
    prog = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=fetch)[0] if amp else tm
    jprog = _to_jax(prog) if amp else jax_side[0]
    ref = [np.asarray(r, np.float32) for r in jexe.run(jprog, feed=feed, fetch_list=fetch,
                                                       scope=jscope)]
    got = texe.run(prog, feed=feed, fetch_list=fetch, scope=tscope)
    return fetch, ref, got, jscope, tscope, state, prog


def _assert_step_f32(fetch, ref, got, jscope, tscope, state, params=True):
    np.testing.assert_allclose(got[0], ref[0], rtol=F32_RTOL)
    for n, g, r in zip(fetch[1:], got[1:], ref[1:]):
        assert np.isfinite(g).all(), n
        assert np.abs(g - r).max() <= F32_RTOL * max(np.abs(r).max(), 1e-30), n
    if not params:
        return
    moved = 0
    for n, start in state.items():
        ref_p = np.asarray(jscope.find_var(n))
        have, want = tscope.find_var(n).numpy() - start, ref_p - start
        assert np.abs(have - want).max() <= F32_RTOL * max(np.abs(ref_p).max(), 1e-30), n
        moved += bool(np.abs(want).max() > 0)
    assert moved > len(state) // 2


def test_stacked_lstm_adam_step_float32_matches_jax():
    _assert_step_f32(*_step(_stacked, _stacked_feed())[:6])


def test_stacked_lstm_adam_step_bf16_matches_jax():
    fetch, ref, got, jscope, tscope, state, prog = _step(_stacked, _stacked_feed(), amp=True)
    np.testing.assert_allclose(got[0], ref[0], rtol=BF16_LOSS_RTOL)
    for n, g, r in zip(fetch[1:], got[1:], ref[1:]):
        assert np.isfinite(g).all() and _nrel(g, r) <= BF16_GRAD_NREL, (n, _nrel(g, r))
    for n in _params(prog):
        have = tscope.find_var(n).float().numpy()
        assert np.abs(have - np.asarray(jscope.find_var(n))).max() <= BF16_PARAM_ATOL, n
        assert not np.array_equal(have, state[n]) or n.startswith("fc_2.w_1"), n


def test_bf16_dynamic_lstm_grad_runs_in_bf16():
    """The generic grad of a bf16 ``dynamic_lstm`` re-runs the recurrence
    in bf16 (as the JAX vjp of the bf16 scan): its gradients are bf16
    tensors, and so are the forward's hidden and cell."""
    jax_side, port_side = build_both(_stacked)
    _, _, texe, tscope, _ = start_both(jax_side, port_side)
    tm, tl = port_side[0], port_side[2][0]
    prog = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tl.name])[0]
    blk = prog.desc.block(0)
    grads = [o for o in blk.ops if o.type == "dynamic_lstm_grad"]
    fwd = [o for o in blk.ops if o.type == "dynamic_lstm"]
    names = [n for o in grads for s in ("Input@GRAD_SLOT", "Weight@GRAD_SLOT", "Bias@GRAD_SLOT")
             for n in o.output(s)] + [o.output(s)[0] for o in fwd for s in ("Hidden", "Cell")]
    fetch = [tl.name] + names
    prog = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=fetch)[0]
    outs = texe.run(prog, feed=_stacked_feed(2), fetch_list=fetch, scope=tscope,
                    return_numpy=False)
    assert len(names) == 10
    for n, t in zip(names, outs[1:]):
        assert t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all(), n


# ------------------------------------------------------ machine translation

MT = dict(src_dict_size=40, trg_dict_size=30, word_dim=8, hidden_dim=8)


def _mt(pkg):
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = pkg.layers.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
    avg = pkg.models.machine_translation.train_network(src, trg, lbl, **MT)
    pkg.optimizer.Adam(learning_rate=LR).minimize(avg)
    return [avg]


def _mt_feed(seed=3):
    rng = np.random.default_rng(seed)
    trg_lens = np.array([5, 2, 6, 1], np.int32)
    return {"src": rng.integers(2, MT["src_dict_size"], (N, 8, 1)).astype(np.int64),
            "src@SEQ_LEN": np.array([8, 3, 0, 6], np.int32),
            "trg": rng.integers(2, MT["trg_dict_size"], (N, 6, 1)).astype(np.int64),
            "trg@SEQ_LEN": trg_lens,
            "lbl": rng.integers(2, MT["trg_dict_size"], (N, 6, 1)).astype(np.int64),
            "lbl@SEQ_LEN": trg_lens}


def test_machine_translation_adam_step_matches_jax():
    fetch, ref, got, jscope, tscope, state, prog = _step(_mt, _mt_feed())
    types = [o.type for o in prog.desc.block(0).ops]
    assert types.count("dynamic_gru") == 2 and "sequence_length" in types
    assert [o.attr("pooltype") for o in prog.desc.block(0).ops
            if o.type == "sequence_pool"] == ["LAST", "SUM"]
    _assert_step_f32(fetch, ref, got, jscope, tscope, state)


def test_machine_translation_infer_network_builds_the_jax_ops():
    """``infer_network`` and ``layers.beam_search`` (items 10 and 13 of the
    port's roadmap, ported) build the JAX package's ops: equal ProgramDescs
    under ``unique_name.guard()`` (``build_both``); the decode itself is
    held against the JAX package in tests/test_torch_beam_search.py."""
    def infer(pkg):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        return pkg.models.machine_translation.infer_network(src, 40, 30, beam_size=2,
                                                            max_len=3)
    _, (tm, _, (ids, scores)) = build_both(infer)
    types = [o.type for o in tm.desc.block(0).ops]
    assert types.count("beam_search") == 3 and types[-1] == "beam_search_decode"

    def step(pkg):
        pre = pkg.layers.data(name="pre", shape=[4], dtype="int64")
        sc = pkg.layers.data(name="sc", shape=[4], dtype="float32")
        lp = pkg.layers.data(name="lp", shape=[4, 7], dtype="float32")
        st = pkg.layers.data(name="st", shape=[5], dtype="float32")
        return pkg.layers.beam_search(pre, sc, lp, 4, 1, states=[st])
    _, (tm, _, out) = build_both(step)
    assert [o.type for o in tm.desc.block(0).ops] == ["beam_search"]
    assert len(out) == 4 and out[3][0].shape == out[3][0].block.var("st").shape


# ------------------------------------------------------- the sentiment net

SENT_EMB, SENT_HID, SENT_BATCH, SENT_LEN, SENT_DICT = 16, 16, 32, 40, 600


def _convolution_net(pkg):
    """tests/test_understand_sentiment.py's convolution_net."""
    data = pkg.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    emb = pkg.layers.embedding(input=data, size=[SENT_DICT, SENT_EMB])
    emb = pkg.layers.reshape(emb, shape=[0, 0, SENT_EMB])
    conv_3 = pkg.nets.sequence_conv_pool(input=emb, num_filters=SENT_HID, filter_size=3,
                                         act="tanh", pool_type="sqrt")
    conv_4 = pkg.nets.sequence_conv_pool(input=emb, num_filters=SENT_HID, filter_size=4,
                                         act="tanh", pool_type="sqrt")
    prediction = pkg.layers.fc(input=[conv_3, conv_4], size=2, act="softmax")
    cost = pkg.layers.mean(pkg.layers.cross_entropy(input=prediction, label=label))
    acc = pkg.layers.accuracy(input=prediction, label=label)
    pkg.optimizer.Adagrad(learning_rate=0.05).minimize(cost)
    return [cost, acc]


def _sentiment_batches(reader, n_batches):
    """tests/test_understand_sentiment.py's batches: 32 rows padded to 40."""
    out, cur = [], []
    for words, lbl in reader():
        cur.append((words, lbl))
        if len(cur) == SENT_BATCH:
            lens = np.array([min(len(w), SENT_LEN) for w, _ in cur], np.int32)
            data = np.zeros((SENT_BATCH, SENT_LEN, 1), np.int64)
            for i, (w, _) in enumerate(cur):
                data[i, :lens[i], 0] = w[:lens[i]]
            out.append({"words": data, "words@SEQ_LEN": lens,
                        "label": np.array([[l] for _, l in cur], np.int64)})
            cur = []
            if len(out) == n_batches:
                break
    return out


def test_sentiment_conv_net_trains_as_the_jax_books_test():
    """Equal ProgramDescs, one Adagrad step against the JAX Executor, then
    the book test's bar: 3 epochs of 50 batches, the loss falls and the
    held-out accuracy is above 0.8."""
    batches = _sentiment_batches(pt.dataset.sentiment.train(1600), 50)
    fetch, ref, got, jscope, tscope, state, prog = _step(_convolution_net, batches[0])
    # Adagrad's first step moves an element by lr * g / sqrt(g * g + eps),
    # which a last-bit difference of a tiny g moves too: the step is held
    # by its loss and gradients
    _assert_step_f32(fetch, ref, got, jscope, tscope, state, params=False)
    exe = pt.Executor(pt.CPUPlace())
    cost = prog.global_block.var(fetch[0])
    acc = [o.output("Accuracy")[0] for o in prog.desc.block(0).ops if o.type == "accuracy"][0]
    first = float(got[0])
    for _ in range(3):
        for feed in batches:
            (c,) = exe.run(prog, feed=feed, fetch_list=[cost], scope=tscope)
    test_prog = prog.clone(for_test=True)
    accs = [float(exe.run(test_prog, feed=f, fetch_list=[acc], scope=tscope)[0])
            for f in _sentiment_batches(pt.dataset.sentiment.test(320), 10)]
    assert float(c) < first, (first, float(c))
    assert float(np.mean(accs)) > 0.8, accs


# ------------------------------------------------- a Trainer over imdb

IMDB_BATCH, IMDB_BATCHES = 8, 4
# tests/test_torch_trainer.py's per-element gate on parameters after
# several Adam steps
TRAINER_PARAM_ATOL, TRAINER_PARAM_RTOL = 5e-5, 1e-4
IMDB_SMALL = dict(SMALL, dict_dim=5148)


def _imdb_train_func(pkg):
    def train_func():
        return _stacked(pkg, opt=False, **IMDB_SMALL)[0]
    return train_func


def _imdb_reader(pkg):
    samples = list(pkg.dataset.imdb.train()())[:IMDB_BATCH * IMDB_BATCHES]
    return lambda: iter(samples)


class _Rec:
    def __init__(self):
        self.events, self.losses, self.shapes = [], [], []

    def __call__(self, ev):
        self.events.append((type(ev).__name__, ev.epoch, getattr(ev, "step", None)))
        if type(ev).__name__ == "EndStepEvent":
            self.losses.append(float(np.asarray(ev.metrics[0])))


def test_trainer_epoch_over_ragged_imdb_batches_matches_the_jax_trainer():
    """One epoch of 4 batches of 8 imdb reviews (8-63 words: the pow2
    buckets 32 and 64), through both Trainers from the same state: equal
    events, losses within 1e-5, parameters within the Trainer tests' gate;
    the port builds one cache entry per bucket."""
    with fluid.unique_name.guard():
        jtr = fluid.Trainer(_imdb_train_func(fluid), lambda: fluid.optimizer.Adam(LR))
    with pt.unique_name.guard():
        ttr = pt.Trainer(_imdb_train_func(pt), lambda: pt.optimizer.Adam(LR), place=pt.CPUPlace())
    persist = [v.name for v in jtr.train_program.list_vars() if v.persistable]
    start = {n: np.asarray(jtr.scope.find_var(n)) for n in persist}
    for n, a in start.items():
        t = ttr.scope.find_var(n)
        t.copy_(torch.from_numpy(np.array(a)).reshape(t.shape))
    jrec, trec = _Rec(), _Rec()
    jtr.train(1, jrec, reader=fluid.batch(_imdb_reader(fluid), IMDB_BATCH),
              feed_order=["words", "label"])
    ttr.train(1, trec, reader=pt.batch(_imdb_reader(pt), IMDB_BATCH),
              feed_order=["words", "label"])
    assert trec.events == jrec.events and len(trec.losses) == IMDB_BATCHES
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=F32_RTOL)
    for n in [p.name for p in ttr.train_program.global_block.all_parameters()]:
        ref = np.asarray(jtr.scope.find_var(n))
        got = ttr.scope.find_var(n).numpy()
        assert (np.abs(got - ref) <= TRAINER_PARAM_ATOL + TRAINER_PARAM_RTOL * np.abs(ref)).all(), n
        assert not np.array_equal(got, start[n]), n
    lens = [len(w) for w, _ in _imdb_reader(pt)()]
    buckets = {1 << (max(lens[i:i + IMDB_BATCH]) - 1).bit_length()
               for i in range(0, len(lens), IMDB_BATCH)}
    entries = [e for e in ttr.exe.cache_info()["entries"] if "words" in e["feeds"]]
    assert len(entries) == len(buckets) and buckets <= {32, 64}


# ------------------------------------------------------------ the analysis

def _analysis_programs():
    """name -> (JAX program, port program, fetch names, feed shapes): the
    new programs as built, and the bench program as the card runs it (the
    kernel tier and amp-bf16, the port's rewrite parsed by the JAX
    package)."""
    out = {}
    b, t = BENCH["batch"], BENCH["seq"]
    fs_lstm = {"words": (b, t, 1), "words@SEQ_LEN": (b,), "label": (b, 1)}
    fs_mt = {k: v.shape for k, v in _mt_feed().items()}
    fs_sent = {"words": (SENT_BATCH, SENT_LEN, 1), "words@SEQ_LEN": (SENT_BATCH,),
               "label": (SENT_BATCH, 1)}
    for name, build, fs in (("stacked_lstm", _bench, fs_lstm), ("machine_translation", _mt, fs_mt),
                            ("sentiment", _convolution_net, fs_sent)):
        (jm, _, jout), (tm, _, tout) = build_both(build)
        out[name] = (jm, tm, [v.name for v in tout], fs)
    _, tm, fetch, fs = out["stacked_lstm"]
    run = pt.Executor(pt.CPUPlace(), amp=pt.amp.AmpConfig(), kernels=True)._apply_passes(
        tm, list(fs), fetch)
    assert run is not tm
    out["stacked_lstm_bf16_kernels"] = (_to_jax(run), run, fetch, fs)
    return out


@pytest.mark.parametrize("name", ["stacked_lstm", "stacked_lstm_bf16_kernels",
                                  "machine_translation", "sentiment"])
def test_the_verifier_and_the_planner_read_the_new_programs_as_jax(name):
    """0 errors and 0 warnings from the port's verifier, the JAX verifier's
    findings; ``plan_memory``'s peak, its op and breakdown equal to the JAX
    planner's (the ``@SEQ_LEN`` channels and the two-output recurrences
    are the new cases)."""
    from paddle_tpu.analysis import memory as jax_memory
    from paddle_tpu.analysis import verifier as jax_verifier
    from paddle_tpu_torch import analysis
    jprog, tprog, fetch, fs = _analysis_programs()[name]
    res = analysis.verify(tprog, fetch_list=fetch)
    assert res.counts()["error"] == res.counts()["warning"] == 0, res.format()

    def rows(r):
        return sorted((d.code, d.severity, d.var or "", d.op_type or "", d.block_idx,
                       -1 if d.op_index is None else d.op_index) for d in r.diagnostics)
    assert rows(res) == rows(jax_verifier.verify(jprog, fetch_list=fetch))
    mine = analysis.plan_memory(tprog, fetch_list=fetch, feed_shapes=fs)
    theirs = jax_memory.plan_memory(jprog, fetch_list=fetch, feed_shapes=fs)
    assert mine.peak_bytes > 0
    assert (mine.peak_bytes, mine.peak_op_index, mine.peak_op_type) == \
        (theirs.peak_bytes, theirs.peak_op_index, theirs.peak_op_type)
