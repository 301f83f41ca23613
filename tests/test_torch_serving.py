"""The PyTorch/CUDA port's serving slice against the JAX package.

A 2+2-layer transformer (vocab 1000, d_model 64, 4 heads, d_inner 256,
max_len 32) is built by both packages under ``unique_name.guard()``: the
ProgramDescs must be equal op for op, and with the JAX parameters carried
across the port's ``Inferencer(place=CPUPlace())`` must give the JAX
``Inferencer``'s logits within ``LOGIT_ATOL`` on ragged batches.  Then the
port's batching engine and ``ServingSession`` under concurrent callers.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.serving import (BatchingEngine, RequestTimeout,
                                      ServingClosed, ServingNonFinite,
                                      ServingOverloaded)

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER = 1000, 64, 4, 256, 32, 2
# float32 through 4 layers, different summation orders (XLA vs torch CPU)
LOGIT_ATOL = 1e-4


def _model(pkg, mod):
    def infer_func():
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        return mod.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                               d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                               is_test=True)
    return infer_func


def _feed(rs, rows, src_lens=None, trg_lens=None):
    feed = {}
    for name, lens in (("src", src_lens), ("trg", trg_lens)):
        lens = rs.randint(1, T + 1, rows) if lens is None else np.asarray(lens)
        ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        ids[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens.astype(np.int32)
    return feed


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


@pytest.fixture(scope="module")
def inferencers():
    """(JAX Inferencer, port Inferencer on the CPU with the JAX weights)."""
    jax_inf = fluid.Inferencer(infer_func=_model(fluid, jax_transformer))
    pt_inf = pt.Inferencer(_model(pt, pt_transformer), place=pt.CPUPlace())
    params = {v.name: np.asarray(jax_inf.scope.find_var(v.name))
              for v in jax_inf.inference_program.list_vars() if v.persistable}
    pt.params_from_numpy(params, pt_inf.scope, "cpu")
    return jax_inf, pt_inf


# ------------------------------------------------------------ the program


def test_program_descs_equal_op_for_op():
    progs = {}
    for pkg, mod in ((fluid, jax_transformer), (pt, pt_transformer)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            _model(pkg, mod)()
        progs[pkg.__name__] = (main, startup)
    (jm, js), (tm, ts) = progs["paddle_tpu"], progs["paddle_tpu_torch"]
    for a, b in ((jm, tm), (js, ts)):
        da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
        assert [o["type"] for o in da["blocks"][0]["ops"]] == \
            [o["type"] for o in db["blocks"][0]["ops"]]
        assert da == db
        assert a.desc.fingerprint() == b.desc.fingerprint()
    types = {o.type for o in tm.desc.block(0).ops}
    assert types == {"mul", "elementwise_add", "layer_norm", "flash_attention",
                     "lookup_table", "relu", "scale", "position_ids"}
    assert {o.type for o in ts.desc.block(0).ops} == {"uniform_random", "fill_constant"}


def test_serialized_program_parses_in_the_port():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _model(fluid, jax_transformer)()
    from paddle_tpu_torch.core.desc import ProgramDesc
    parsed = ProgramDesc.parse(main.desc.serialize())
    assert parsed.serialize() == main.desc.serialize()
    assert parsed.fingerprint() == main.desc.fingerprint()


# --------------------------------------------------- the slice end to end


@pytest.mark.parametrize("rows,src_lens,trg_lens", [
    (3, [32, 5, 0], [7, 32, 1]),       # a padded row with no source keys
    (2, None, None),
])
def test_inferencer_matches_jax_inferencer(inferencers, rows, src_lens, trg_lens):
    jax_inf, pt_inf = inferencers
    assert pt_inf.feed_names == jax_inf.feed_names
    feed = _feed(np.random.RandomState(rows), rows, src_lens, trg_lens)
    (ref,) = jax_inf.infer(feed)
    (got,) = pt_inf.infer(feed)
    assert got.shape == (rows, T, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_startup_initializes_every_parameter_as_its_init_op_says():
    inf = pt.Inferencer(_model(pt, pt_transformer), place=pt.CPUPlace())
    init = {o.output("Out")[0]: o for o in inf.startup_program.desc.block(0).ops}
    params = [v for v in inf.inference_program.list_vars() if v.persistable]
    assert params and {v.name for v in params} == set(init)
    for v in params:
        val, op = inf.scope.find_var(v.name), init[v.name]
        assert tuple(val.shape) == v.shape and val.dtype == torch.float32
        if op.type == "fill_constant":
            assert torch.all(val == op.attr("value"))
        else:                                           # xavier uniform
            assert op.type == "uniform_random"
            assert op.attr("min") <= val.min().item() < val.max().item() <= op.attr("max")


def test_async_fetch_handles(inferencers):
    _, pt_inf = inferencers
    feed = _feed(np.random.RandomState(9), 2)
    (h,) = pt_inf.infer(feed, sync=False)
    assert h.ready() and h.shape == (2, T, VOCAB)
    np.testing.assert_array_equal(np.asarray(h), pt_inf.infer(feed)[0])


def test_warmup_runs_each_bucket_and_rejects_dynamic_dims(inferencers):
    _, pt_inf = inferencers
    with pytest.raises(ValueError, match="dynamic non-batch dims"):
        pt_inf.warmup((1, 2))
    specs = {"src": ((T, 1), "int64"), "trg": ((T, 1), "int64"),
             "src@SEQ_LEN": ((), "int32"), "trg@SEQ_LEN": ((), "int32")}
    report = pt_inf.warmup((1, 2, 4), feed_specs=specs)
    assert [r["batch_size"] for r in report] == [1, 2, 4]


# ------------------------------------------------------------- serving


def test_session_demux_bit_identical_to_sequential_batches(inferencers):
    """4 client threads through one session: each request's rows are
    bit-identical to the same rows of a sequential infer of the batch the
    engine dispatched them in (same shape, same batch-mates)."""
    _, pt_inf = inferencers
    rs = np.random.RandomState(11)
    reqs = [_feed(rs, 1 + i % 2) for i in range(16)]
    slices, answers, errors = [None] * 16, [None] * 16, []
    barrier = threading.Barrier(4)
    with pt.ServingSession(inferencer=pt_inf, max_batch_size=8, max_wait_ms=20.0,
                           warmup=False) as sess:
        def client(t):
            try:
                barrier.wait(timeout=10)
                for i in range(4 * t, 4 * t + 4):
                    slices[i] = sess.engine.submit(reqs[i]).result(timeout=30)
                    answers[i] = slices[i].materialize(timeout=30)[0]
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stats = sess.stats()
    assert not errors and not any(th.is_alive() for th in threads)
    assert stats["requests_dispatched"] == 16 and stats["coalesce_ratio"] > 1.0
    by_batch = {}
    for i, sl in enumerate(slices):
        by_batch.setdefault(sl.batch_seq, []).append(i)
    assert len(by_batch) == stats["batches"]
    for idx in by_batch.values():
        idx.sort(key=lambda i: slices[i].start)
        bucket = slices[idx[0]].bucket
        feed = {n: np.concatenate([reqs[i][n] for i in idx]) for n in reqs[0]}
        rows = sum(reqs[i]["src"].shape[0] for i in idx)
        feed = {n: np.concatenate([a, np.zeros((bucket - rows,) + a.shape[1:], a.dtype)])
                for n, a in feed.items()}
        (ref,) = pt_inf.infer(feed)
        for i in idx:
            np.testing.assert_array_equal(answers[i], ref[slices[i].start:slices[i].stop])


def test_session_infer_threads_match_sequential(inferencers):
    """``ServingSession.infer`` from 4 threads: each caller gets its own
    rows, equal to a sequential infer of just those rows (a different
    batch shape, so compared to float32 rounding)."""
    _, pt_inf = inferencers
    rs = np.random.RandomState(12)
    reqs = [_feed(rs, 1 + i % 2) for i in range(12)]
    expected = [pt_inf.infer(r)[0] for r in reqs]
    results, errors = [None] * 12, []
    with pt.ServingSession(inferencer=pt_inf, max_batch_size=8, max_wait_ms=10.0,
                           warmup=False) as sess:
        def client(t):
            try:
                for i in range(3 * t, 3 * t + 3):
                    (results[i],) = sess.infer(reqs[i], timeout=30)
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    assert not errors
    for got, want in zip(results, expected):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_session_builds_inferencer_and_warms_declared_feeds():
    def infer_func():
        x = pt.layers.data(name="x", shape=[4])
        return pt.layers.fc(input=x, size=3, act="relu")

    with pt.ServingSession(infer_func=infer_func, place=pt.CPUPlace(),
                           max_batch_size=4) as sess:
        assert [r["batch_size"] for r in sess.warmup_report] == [1, 2, 4]
        (out,) = sess.infer({"x": np.ones((3, 4), np.float32)})
        assert out.shape == (3, 3) and (out >= 0).all()


# ------------------------------------------------------------- the engine


def _echo_runner(feed):
    return [feed["x"] * 2.0]


def test_engine_pads_to_buckets_and_demuxes():
    with BatchingEngine(_echo_runner, max_batch_size=8, max_wait_ms=50.0) as eng:
        futs = [eng.submit({"x": np.full((r, 2), i, np.float32)})
                for i, r in enumerate((1, 2, 1))]
        slices = [f.result(timeout=10) for f in futs]
        for i, (sl, r) in enumerate(zip(slices, (1, 2, 1))):
            np.testing.assert_array_equal(sl.materialize()[0], np.full((r, 2), 2.0 * i))
        stats = eng.stats()
    assert {sl.bucket for sl in slices} <= {1, 2, 4, 8}
    assert stats["rows_dispatched"] == 4 and stats["requests_dispatched"] == 3


def test_engine_rejects_oversize_and_mismatched_requests():
    with BatchingEngine(_echo_runner, max_batch_size=2, feed_names=["x"]) as eng:
        with pytest.raises(ValueError, match="do not match"):
            eng.submit({"y": np.zeros((1, 2))})
        with pytest.raises(ValueError, match="inconsistent row counts"):
            eng.submit({"x": np.zeros((1, 2)), "x@SEQ_LEN": np.zeros(2)})
        with pytest.raises(Exception, match="exceeds max_batch_size"):
            eng.submit({"x": np.zeros((3, 2))})


def test_engine_admission_control_and_deadlines():
    entered, gate = threading.Event(), threading.Event()

    def slow_runner(feed):
        entered.set()
        gate.wait(timeout=10)
        return [feed["x"]]

    eng = BatchingEngine(slow_runner, max_batch_size=1, max_wait_ms=0.0,
                         max_queue=1)
    try:
        first = eng.submit({"x": np.zeros((1, 1))})
        assert entered.wait(timeout=10)          # dispatcher now blocked
        expiring = eng.submit({"x": np.zeros((1, 1))}, timeout=0.01)
        with pytest.raises(ServingOverloaded):
            eng.submit({"x": np.zeros((1, 1))})
        time.sleep(0.05)                         # expiring's deadline lapses
        gate.set()
        first.result(timeout=10)
        with pytest.raises(RequestTimeout):
            expiring.result(timeout=10)
        assert eng.stats()["requests_rejected"] == 1
        assert eng.stats()["requests_expired"] == 1
    finally:
        gate.set()
        eng.close()
    with pytest.raises(ServingClosed):
        eng.submit({"x": np.zeros((1, 1))})


def test_engine_nan_guard_is_per_request():
    def runner(feed):
        return [np.where(feed["x"] < 0, np.nan, feed["x"])]

    good = []
    with BatchingEngine(runner, max_batch_size=4, max_wait_ms=50.0,
                        nan_guard=True) as eng:
        th = threading.Thread(
            target=lambda: good.append(eng.infer({"x": np.ones((1, 1))})))
        th.start()
        with pytest.raises(ServingNonFinite):
            eng.infer({"x": -np.ones((1, 1))})
        th.join(timeout=10)
        assert eng.stats()["requests_nonfinite"] == 1
    np.testing.assert_array_equal(good[0][0], np.ones((1, 1)))
