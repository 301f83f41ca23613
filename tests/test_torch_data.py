"""The port's data path on the CPU against the JAX package: the reader
decorators, ``lod``, ``DataFeeder`` and the ``FeedStager``.

Each reader decorator of ``paddle_tpu_torch.reader`` is run beside
``paddle_tpu.reader``'s on the same seeded readers and must yield the
same items (``compose``'s alignment error, ``buffered``'s and the thread
readers' error relay included).  ``lod`` and ``DataFeeder`` must make
bit-equal arrays in equal dtypes, and equal ``@SEQ_LEN`` channels, from
the same ragged rows, with and without buckets.  The ``FeedStager`` on
the CPU: order, ``close``, an error in ``convert`` or in the feeds
relayed to the consumer, and its reuse cache's hits and misses.
"""
import random
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.reader as jax_reader
import paddle_tpu_torch as pt
import paddle_tpu_torch.reader as pt_reader
from paddle_tpu import lod as jax_lod
from paddle_tpu.core.staging import COUNTERS as JAX_COUNTERS
from paddle_tpu.data_feeder import bucketed_len as jax_bucketed_len
from paddle_tpu.reader.decorator import batch as jax_batch
from paddle_tpu_torch import lod as pt_lod
from paddle_tpu_torch.core.staging import COUNTERS, FeedStager, StagedBatch, stager_stats
from paddle_tpu_torch.data_feeder import bucketed_len as pt_bucketed_len

PKGS = [(jax_reader, jax_batch), (pt_reader, pt_reader.batch)]


def _numbers(n=23, seed=0):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield int(rs.randint(0, 1000))
    return reader


def _rows(n=10, seed=1):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield (rs.randint(0, 50, rs.randint(1, 6)).tolist(), float(rs.rand()))
    return reader


def _failing(n_ok=4):
    def reader():
        for i in range(n_ok):
            yield i
        raise KeyError("the reader broke")
    return reader


def _both(make):
    """``make(reader_module, batch)`` run in each package: the two lists."""
    return [list(make(mod, batch)()) for mod, batch in PKGS]


def _seeded_shuffle(mod, batch):
    def reader():
        random.seed(7)
        yield from mod.shuffle(_numbers(), buf_size=5)()
    return reader


CASES = {
    "map_readers": lambda mod, batch: mod.map_readers(lambda a, b: a * 1000 + b, _numbers(),
                                                      _numbers(seed=3)),
    "shuffle": _seeded_shuffle,
    "chain": lambda mod, batch: mod.chain(_numbers(5), _numbers(7, seed=2)),
    "compose": lambda mod, batch: mod.compose(_numbers(6), _rows(6)),
    "compose_unchecked": lambda mod, batch: mod.compose(_numbers(6), _numbers(4),
                                                        check_alignment=False),
    "buffered": lambda mod, batch: mod.buffered(_rows(), 3),
    "firstn": lambda mod, batch: mod.firstn(_numbers(), 9),
    "cache": lambda mod, batch: mod.cache(_rows()),
    "xmap_readers_ordered": lambda mod, batch: mod.xmap_readers(lambda x: x * 2, _numbers(),
                                                                process_num=3, buffer_size=4,
                                                                order=True),
    "batch": lambda mod, batch: batch(_numbers(), 4),
    "batch_drop_last": lambda mod, batch: batch(_numbers(), 4, drop_last=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_decorator_yields_the_jax_packages_items(case):
    got_jax, got_pt = _both(CASES[case])
    assert got_pt == got_jax and got_pt


@pytest.mark.parametrize("case", ["xmap_unordered", "multiprocess_reader"])
def test_thread_readers_yield_the_jax_packages_items_in_some_order(case):
    def make(mod, batch):
        if case == "xmap_unordered":
            return mod.xmap_readers(lambda x: x + 1, _numbers(), process_num=4, buffer_size=2)
        return mod.multiprocess_reader([_numbers(9), _numbers(5, seed=4)], queue_size=3)
    got_jax, got_pt = _both(make)
    assert sorted(got_pt) == sorted(got_jax) and got_pt


def test_cache_reads_its_reader_once():
    calls = []

    def reader():
        calls.append(1)
        yield from range(3)
    cached = pt_reader.cache(reader)
    assert list(cached()) == list(cached()) == [0, 1, 2] and calls == [1]


def test_compose_raises_on_misaligned_readers_as_the_jax_package_does():
    errors = []
    for mod, _ in PKGS:
        with pytest.raises(mod.decorator.ComposeNotAligned, match="not aligned") as e:
            list(mod.compose(_numbers(6), _numbers(4))())
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", ["buffered", "xmap_readers", "multiprocess_reader"])
def test_a_readers_error_reaches_the_consumer(case):
    """The items before the error arrive (all of them, for the ordered
    ``buffered``), then the reader's own exception is raised."""
    for mod, _ in PKGS:
        if case == "buffered":
            r = mod.buffered(_failing(), 2)
        elif case == "xmap_readers":
            r = mod.xmap_readers(lambda x: 1 // (x - 2), lambda: iter(range(6)),
                                 process_num=1, buffer_size=2, order=True)
        else:
            r = mod.multiprocess_reader([_failing()], queue_size=2)
        got = []
        with pytest.raises((KeyError, ZeroDivisionError)):
            for item in r():
                got.append(item)
        if case == "buffered":
            assert got == [0, 1, 2, 3]


# ------------------------------------------------------------------ lod


def _nested(seed, lod_level):
    rs = np.random.RandomState(seed)
    if lod_level == 1:
        return [rs.randn(rs.randint(0, 5), 3).astype(np.float32) for _ in range(4)]
    return [[rs.randn(rs.randint(1, 4)).astype(np.float32) for _ in range(rs.randint(0, 4))]
            for _ in range(5)]


@pytest.mark.parametrize("lod_level", [1, 2])
def test_lod_round_trip_bit_equal_to_the_jax_package(lod_level):
    rows = _nested(lod_level, lod_level)
    pj, lj = jax_lod.from_nested(rows, lod_level)
    pp, lp = pt_lod.from_nested(rows, lod_level)
    assert pp.dtype == pj.dtype and np.array_equal(pp, pj)
    assert len(lp) == len(lj) == lod_level
    for a, b in zip(lp, lj):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    back = pt_lod.to_nested(pp, lp)
    ref = jax_lod.to_nested(pj, lj)

    def flat(x):
        return [flat(y) for y in x] if isinstance(x, list) else np.asarray(x).tolist()
    assert flat(back) == flat(ref) == flat(rows)
    assert [pt_lod.seq_len_name("x", k) for k in range(3)] == \
        [jax_lod.seq_len_name("x", k) for k in range(3)] == ["x@SEQ_LEN", "x@SEQ_LEN@1",
                                                              "x@SEQ_LEN@2"]


@pytest.mark.parametrize("n", [0, 1, 3, 8, 9, 100, 300])
@pytest.mark.parametrize("buckets", [None, "pow2", [4, 16, 64]])
def test_bucketed_len_matches_the_jax_package(n, buckets):
    assert pt_bucketed_len(n, buckets) == jax_bucketed_len(n, buckets)


# ----------------------------------------------------------- DataFeeder


def _feeder_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        words = pkg.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        img = pkg.layers.data(name="img", shape=[2, 3], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        nested = pkg.layers.data(name="nested", shape=[1], dtype="float32", lod_level=2)
    return main, [words, x, img, label, nested]


def _minibatch(seed, rows=5):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(rows):
        out.append((rs.randint(0, 100, (rs.randint(1, 12), 1)).tolist(),
                    rs.randn(6).astype(np.float32),
                    rs.randn(6).tolist(),                      # flat, reshaped to [2, 3]
                    int(rs.randint(0, 10)),
                    [rs.randn(rs.randint(1, 5)).tolist() for _ in range(rs.randint(1, 4))]))
    return out


@pytest.mark.parametrize("buckets", [None, "pow2", [4, 16]])
@pytest.mark.parametrize("seed", [0, 1])
def test_data_feeder_makes_the_jax_packages_arrays(buckets, seed):
    feeds = []
    for pkg in (fluid, pt):
        main, vars_ = _feeder_program(pkg)
        feeder = pkg.DataFeeder(feed_list=vars_, program=main, seq_len_buckets=buckets)
        feeds.append(feeder.feed(_minibatch(seed)))
        if buckets is not None:
            assert main.global_block.var("words").desc.attrs["seq_len_buckets"] == \
                (buckets if isinstance(buckets, str) else list(buckets))
    fj, fp = feeds
    assert sorted(fp) == sorted(fj)
    assert {"words@SEQ_LEN", "nested@SEQ_LEN", "nested@SEQ_LEN@1"} <= set(fp)
    for k in fj:
        a, b = np.asarray(fj[k]), fp[k]
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype and b.shape == a.shape, k
        assert np.array_equal(a, b), k
    assert fp["words"].dtype == np.int64          # narrowed by the executor, not here
    if buckets == "pow2":
        assert fp["words"].shape[1] in (1, 2, 4, 8, 16)


def test_data_feeder_fast_path_counts_as_the_jax_package_does():
    rs = np.random.RandomState(3)
    rows = [(rs.randn(6).astype(np.float32),) for _ in range(4)]
    moved = []
    for pkg, counters in ((fluid, JAX_COUNTERS), (pt, COUNTERS)):
        main, vars_ = _feeder_program(pkg)
        before = counters.get("feed_fastpath_hits")
        out = pkg.DataFeeder(feed_list=[vars_[1]], program=main).feed(rows)
        moved.append(counters.get("feed_fastpath_hits") - before)
        assert np.array_equal(out["x"], np.stack([r[0] for r in rows]))
    assert moved == [1, 1]


# ------------------------------------------------------------ FeedStager


def _host_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"ids": rs.randint(0, 100, (4, 8)).astype(np.int64),
             "x": rs.randn(4, 3).astype(np.float32)} for _ in range(n)]


def _identity_convert(name, value):
    t = torch.from_numpy(value)
    return t, torch.int32 if t.dtype == torch.int64 else t.dtype


def test_stager_keeps_order_and_coerces_on_its_thread():
    feeds = _host_feeds(7)
    threads = []

    def convert(name, value):
        threads.append(threading.current_thread().name)
        return _identity_convert(name, value)
    before = COUNTERS.get("staged_batches")
    stager = FeedStager(convert, iter(feeds), depth=2)
    got = list(stager)
    assert COUNTERS.get("staged_batches") - before == 7
    assert [b.seq for b in got] == list(range(7))
    assert all(isinstance(b, StagedBatch) and b.event is None and not b.donatable for b in got)
    for b, f in zip(got, feeds):
        assert b["ids"].dtype == torch.int32 and b["x"].dtype == torch.float32
        assert np.array_equal(b["ids"].numpy(), f["ids"]) and np.array_equal(b["x"].numpy(),
                                                                              f["x"])
        assert b.nbytes == 4 * 8 * 4 + 4 * 3 * 4
    assert set(threads) == {"paddle_tpu_torch-feed-stager"}


def test_stager_close_stops_the_thread_mid_stream():
    def endless():
        while True:
            yield {"x": np.zeros((2, 2), np.float32)}
    stager = FeedStager(_identity_convert, endless(), depth=2)
    first = next(stager)
    assert first.seq == 0 and stager_stats()["stagers"] >= 1
    stager.close()
    assert not stager._thread.is_alive() and stager.bytes_in_flight == 0
    stager.close()        # again: harmless


@pytest.mark.parametrize("where", ["convert", "feeds"])
def test_stager_relays_an_error_to_the_consumer(where):
    def convert(name, value):
        if where == "convert" and value.shape[0] == 3:
            raise ValueError("cannot convert this batch")
        return _identity_convert(name, value)

    def feeds():
        for n in (1, 2, 3, 4):
            if where == "feeds" and n == 3:
                raise ValueError("the reader broke")
            yield {"x": np.zeros((n, 2), np.float32)}
    stager = FeedStager(convert, feeds(), depth=1)
    got = []
    with pytest.raises(ValueError):
        for b in stager:
            got.append(b["x"].shape[0])
    assert got == [1, 2]


def test_stager_reuses_a_host_object_fed_again():
    pool = _host_feeds(2, seed=5)
    feeds = [pool[0], pool[1], pool[0], pool[1], pool[0]]
    before = COUNTERS.snapshot()
    got = list(FeedStager(_identity_convert, iter(feeds), depth=2))
    after = COUNTERS.snapshot()
    moved = {k: after[k] - before[k] for k in ("reused_buffers", "buffer_reuse_misses")}
    # 2 feed names: the pool's two dicts convert once each, then 3 refeeds hit
    assert moved == {"reused_buffers": 6, "buffer_reuse_misses": 4}
    assert got[2]["ids"] is got[0]["ids"] and got[4]["x"] is got[0]["x"]
    assert got[3]["ids"] is got[1]["ids"]


def test_stager_without_reuse_converts_every_batch_and_marks_it_donatable():
    pool = _host_feeds(1)
    before = COUNTERS.snapshot()
    got = list(FeedStager(_identity_convert, iter([pool[0]] * 3), depth=2, reuse=False))
    after = COUNTERS.snapshot()
    assert after["reused_buffers"] == before["reused_buffers"]
    assert after["buffer_reuse_misses"] == before["buffer_reuse_misses"]
    assert all(b.donatable for b in got) and got[1]["ids"] is not got[0]["ids"]


def test_stager_refuses_a_depth_below_one():
    with pytest.raises(ValueError, match="depth"):
        FeedStager(_identity_convert, iter(()), depth=0)


def _scale_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3])
        ids = pt.layers.data(name="ids", shape=[8], dtype="int64")
        y = pt.layers.scale(x, scale=2.0)
    return main, y, ids


def test_stage_feeds_coerces_as_run_does_and_run_pipelined_matches_run():
    main, y, ids = _scale_program()
    exe = pt.Executor(pt.CPUPlace())
    feeds = _host_feeds(4, seed=2)
    staged = list(exe.stage_feeds(main, iter(feeds)))
    assert [b["ids"].dtype for b in staged] == [torch.int32] * 4
    assert all(b["x"].dtype == torch.float32 for b in staged)
    want = [exe.run(main, feed=f, fetch_list=[y, ids]) for f in feeds]
    got = [[np.asarray(h) for h in hs]
           for hs in exe.run_pipelined(main, iter(feeds), fetch_list=[y, ids], depth=2)]
    assert len(got) == 4
    for (wy, wi), (gy, gi) in zip(want, got):
        assert np.array_equal(wy, gy) and np.array_equal(wi, gi) and gi.dtype == np.int32
    # the staged batches and the numpy feeds share one cache entry
    assert exe.cache_info()["executables"] == 1


def test_run_pipelined_with_donate_feeds_turns_reuse_off():
    main, y, _ = _scale_program()
    exe = pt.Executor(pt.CPUPlace())
    pool = _host_feeds(1, seed=4)
    before = COUNTERS.snapshot()
    outs = [np.asarray(h[0]) for h in exe.run_pipelined(main, iter([pool[0]] * 3),
                                                        fetch_list=[y], donate_feeds=True)]
    after = COUNTERS.snapshot()
    assert after["reused_buffers"] == before["reused_buffers"]
    assert all(np.array_equal(o, 2.0 * pool[0]["x"]) for o in outs)


def test_stagers_under_thread_switching_lose_no_batch_and_no_byte():
    """Eight stagers, each with its own consumer thread, with the switch
    interval shortened: each consumer gets its batches in order, the
    staged-batch counter moves by the total, and no stager is left with
    bytes in flight (a lost update to either would show)."""
    import sys
    n_stagers, n_batches = 8, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = COUNTERS.get("staged_batches")
        stagers = [FeedStager(_identity_convert, iter(_host_feeds(n_batches, seed=s)), depth=2)
                   for s in range(n_stagers)]
        seqs = [[] for _ in stagers]

        def consume(i):
            seqs[i] = [b.seq for b in stagers[i]]
        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n_stagers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(s == list(range(n_batches)) for s in seqs)
    assert COUNTERS.get("staged_batches") - before == n_stagers * n_batches
    assert all(s.bytes_in_flight == 0 for s in stagers)
