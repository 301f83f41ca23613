"""The port's embedding subsystem (``paddle_tpu_torch.embedding``) against
the JAX package's, on the CPU.

* ``sharded_table``: the ProgramDesc equal to the JAX package's, the
  ``layout_role`` stamp on the table, its Adam slots' ``slot_of``, the
  argument checks; sparse SGD bit-equal to dense over 3 steps (a mean
  over a power-of-two batch and a power-of-two rate keep every update
  exact) and to the JAX package's table;
* ``plan_table``: the budget arithmetic equal to the JAX package's, a
  mesh or layout raising (ROADMAP item 12); ``Executor(memory_budget=)``
  M501-refusing the table's step; the step's memory plan sizing every
  var; the op types' infer-shape rules;
* ``RowPrefetcher``: its counters and JSONL records, riding the
  ``FeedStager``'s thread (``stage_feeds(on_batch=)``), and through the
  ``Trainer`` (pipelined and synchronous), whose ``dispatch=`` still
  raises naming item 11;
* ``RowCache``: hits, misses, evictions, ``warm`` and one batched fetch,
  the budget-keyed capacity; ``Inferencer.attach_row_cache`` /
  ``lookup_rows`` and ``ServingSession(embedding_cache=)`` serving the
  trained table's rows, ``stats()["embedding"]``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import embedding
from paddle_tpu_torch.embedding import RowCache, RowPrefetcher

from _torch_validate import _no_port_validate_findings  # noqa: F401

ROWS, DIM = 64, 8


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _table_net(pkg, is_sparse=True, name="user_table", rows=ROWS, dim=DIM, optimizer=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
        emb = pkg.embedding.sharded_table(ids, name, rows=rows, dim=dim, is_sparse=is_sparse)
        loss = pkg.layers.mean(emb)
        (optimizer(pkg) if optimizer else pkg.optimizer.SGD(0.5)).minimize(loss)
    return main, startup, loss


def _train(pkg, is_sparse, steps=3, name="user_table", start=None):
    """3 SGD steps on seeded batches; ``start`` (an array) replaces the
    startup's table first.  Returns (table, main, scope)."""
    main, startup, loss = _table_net(pkg, is_sparse, name=name)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    if start is not None:
        pt.params_from_numpy({name: start}, scope, "cpu")
    rng = np.random.RandomState(3)
    for _ in range(steps):
        ids = rng.randint(0, ROWS, (8, 1)).astype(np.int64)
        exe.run(main, feed={"ids": ids}, fetch_list=[loss], scope=scope)
    return np.array(np.asarray(scope.find_var(name)), np.float32), main, scope


# ------------------------------------------------------------ the table

@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sharded_table_program_and_stamps(opt):
    """Equal main and startup ProgramDescs; the table carries the
    embedding layout role, and Adam's moments name it in ``slot_of``."""
    make = None if opt == "sgd" else (lambda pkg: pkg.optimizer.Adam(learning_rate=0.1))
    jm, js, _ = _table_net(fluid, optimizer=make)
    tm, ts, _ = _table_net(pt, optimizer=make)
    assert _scrub(jm.desc.to_dict()) == _scrub(tm.desc.to_dict())
    assert _scrub(js.desc.to_dict()) == _scrub(ts.desc.to_dict())
    block = tm.desc.block(0)
    assert block.vars["user_table"].attrs["layout_role"] == "embedding"
    assert block.vars["user_table@GRAD"].type == "selected_rows"
    slots = [n for n, vd in block.vars.items()
             if vd.attrs.get("slot_of") == "user_table" and vd.shape == (ROWS, DIM)]
    assert len(slots) == (2 if opt == "adam" else 0)


def test_sharded_table_validates_args():
    with pytest.raises(ValueError):
        _table_net(pt, rows=0)
    with pytest.raises(ValueError):
        _table_net(pt, dim=-1)


def test_sparse_train_bit_identical_to_dense_and_to_jax():
    """A mean over a power-of-two batch and a power-of-two rate keep every
    update exact: from the JAX startup's table, the port's sparse table
    equals its dense one and the JAX package's sparse table bit for bit."""
    start, _, _ = _train(fluid, True, steps=0)
    w_jax, _, _ = _train(fluid, True)
    w_dense, _, _ = _train(pt, False, start=start)
    w_sparse, _, _ = _train(pt, True, start=start)
    np.testing.assert_array_equal(w_dense, w_sparse)
    np.testing.assert_array_equal(w_sparse, w_jax)
    assert not np.array_equal(w_sparse, start)


# --------------------------------------------------------- plan_table

def test_plan_table_budget_math_against_jax():
    for kw in ({"slots": 2, "budget": "1MiB"}, {"slots": 2, "budget": 1024},
               {"slots": 0}, {"slots": 1, "budget": 1024 * 16 * 4, "dtype": "bfloat16"}):
        want = fluid.embedding.plan_table("t", 1024, 16, **kw)
        got = embedding.plan_table("t", 1024, 16, **kw)
        assert got == want, kw
    plan = embedding.plan_table("t", 1024, 16, slots=2, budget="1MiB")
    assert plan["total_bytes"] == 3 * 1024 * 16 * 4 == plan["per_device_bytes"]
    assert plan["fits"] is True
    assert embedding.plan_table("t", 1024, 16, slots=2, budget=1024)["fits"] is False


def test_plan_table_mesh_waits_for_item_12():
    with pytest.raises(NotImplementedError, match="item 12"):
        embedding.plan_table("t", 1024, 16, slots=1, mesh={"fsdp": 4})
    with pytest.raises(NotImplementedError, match="item 12"):
        embedding.plan_table("t", 1024, 16, layout=object())


def test_executor_budget_refuses_oversize_table():
    """``Executor(memory_budget=)`` M501-refuses the step of a table that
    does not fit (64 x 8 x 4 bytes = 2 KiB against 1 KiB)."""
    from paddle_tpu_torch.analysis import PredictedOOMError
    main, startup, loss = _table_net(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    exe = pt.Executor(pt.CPUPlace(), memory_budget=1024)
    with pytest.raises(PredictedOOMError) as ei:
        exe.run(main, feed={"ids": np.zeros((8, 1), np.int64)}, fetch_list=[loss], scope=scope)
    assert ei.value.diagnostic.code == "M501"


def test_embedding_program_fully_sized():
    """The static memory planner sizes every var of a sharded_table
    training program (no M504 gap), as the JAX package's does."""
    from paddle_tpu.analysis import plan_memory as jax_plan
    from paddle_tpu_torch.analysis import plan_memory
    plans = []
    for pkg, plan_fn in ((fluid, jax_plan), (pt, plan_memory)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            ids = pkg.layers.data(name="ids", shape=[6, 1], dtype="int64",
                                  append_batch_size=False)
            loss = pkg.layers.mean(pkg.embedding.sharded_table(ids, "tbl", rows=16, dim=4))
            pkg.optimizer.SGD(0.5).minimize(loss)
        plans.append(plan_fn(main, batch=6))
    assert not plans[1].unsized, plans[1].unsized
    assert plans[1].peak_bytes == plans[0].peak_bytes


def test_embedding_ops_have_shape_rules():
    from paddle_tpu_torch.core.registry import OPS
    for t in ("row_prefetch", "gather_rows"):
        assert OPS.get(t).infer_shape is not None and OPS.get(t).lower is not None


# ------------------------------------------------------ RowPrefetcher

def test_row_prefetcher_counters():
    from paddle_tpu_torch import telemetry
    telemetry.reset_scope(embedding.EMBEDDING_SCOPE)
    pf = RowPrefetcher({"ids": "tbl"})
    pf.on_batch({"ids": np.array([[1], [3], [3], [7]], np.int64),
                 "x": np.zeros((4, 2), np.float32)})
    pf.on_batch({"ids": np.array([[3], [3]], np.int64)})
    snap = telemetry.REGISTRY.snapshot(scope=embedding.EMBEDDING_SCOPE)
    assert snap["prefetch_batches"] == 2
    assert snap["prefetch_ids_seen"] == 6
    assert snap["prefetch_ids_unique"] == 4
    assert 0 < snap["prefetch_dedup_ratio"] < 1
    assert pf.last["tbl"].tolist() == [3]
    s = pf.stats()
    assert s["batches"] == 2 and s["ids_unique"] == 4
    with pytest.raises(ValueError):
        RowPrefetcher({})


def test_row_prefetcher_rides_feed_stager():
    """The dedup runs on the stager's thread and each staged batch carries
    its unique id set; the batches keep their order and values."""
    import threading
    main, startup, loss = _table_net(pt)
    exe = pt.Executor(pt.CPUPlace())
    threads = []
    pf = RowPrefetcher({"ids": "user_table"})
    real = pf.on_batch

    def on_batch(feed, staged=None):
        threads.append(threading.current_thread().name)
        real(feed, staged)

    feeds = [{"ids": np.array([[1], [1], [2], [k]], np.int64)} for k in (2, 5, 9)]
    staged = list(exe.stage_feeds(main, feeds, on_batch=on_batch))
    assert [b.prefetched["user_table"].tolist() for b in staged] == [[1, 2], [1, 2, 5],
                                                                      [1, 2, 9]]
    assert [b["ids"].reshape(-1).tolist()[-1] for b in staged] == [2, 5, 9]
    assert set(threads) == {"paddle_tpu_torch-feed-stager"}
    assert pf.stats()["batches"] == 3


@pytest.mark.parametrize("pipeline", [True, False])
def test_trainer_prefetcher(pipeline):
    pf = RowPrefetcher({"ids": "user_table"})

    def train_func():
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        return pt.layers.mean(pt.embedding.sharded_table(ids, "user_table", rows=16, dim=4))

    def reader():
        for k in range(3):
            yield [(np.array([3], np.int64),), (np.array([k], np.int64),)]

    with pt.unique_name.guard():
        t = pt.Trainer(train_func=train_func, optimizer_func=lambda: pt.optimizer.SGD(0.5),
                       place=pt.CPUPlace(), pipeline=pipeline, prefetcher=pf)
    before = t.scope.find_var("user_table").clone()
    t.train(num_epochs=1, event_handler=lambda ev: None, reader=reader, feed_order=["ids"])
    assert pf.stats()["batches"] == 3 and pf.stats()["ids_seen"] == 6
    assert pf.last["user_table"].tolist() == [2, 3]
    after = t.scope.find_var("user_table")
    assert torch.equal(after[4:], before[4:]) and not torch.equal(after[3], before[3])


def test_trainer_dispatch_still_raises_naming_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.Trainer(train_func=lambda: None, optimizer_func=lambda: None,
                   place=pt.CPUPlace(), dispatch=object())


# ------------------------------------------------------------ RowCache

def test_row_cache_hit_miss_evict():
    from paddle_tpu_torch import telemetry
    telemetry.reset_scope(embedding.EMBEDDING_SCOPE)
    store = np.arange(64, dtype=np.float32).reshape(16, 4)
    fetch = lambda ids: store[np.asarray(ids)]   # noqa: E731
    c = RowCache(capacity_rows=3, table="t")
    np.testing.assert_array_equal(c.lookup([1, 2, 1], fetch), store[[1, 2, 1]])
    np.testing.assert_array_equal(c.lookup([1, 2], fetch), store[[1, 2]])
    c.lookup([3, 4], fetch)
    s = c.stats()
    assert s["hits"] == 2 and s["misses"] == 4
    assert s["evictions"] == 1 and s["cached_rows"] == 3 and s["inserts"] == 4
    assert 0 < s["hit_rate"] < 1 and len(c) == 3
    snap = telemetry.REGISTRY.snapshot(scope=embedding.EMBEDDING_SCOPE)
    assert snap["cache_hits"] == 2 and snap["cache_misses"] == 4
    c.invalidate([3])
    assert len(c) == 2
    c.invalidate()
    assert len(c) == 0


def test_row_cache_warm_and_single_fetch():
    store = np.arange(32, dtype=np.float32).reshape(8, 4)
    calls = []

    def fetch(ids):
        calls.append(np.asarray(ids).tolist())
        return store[np.asarray(ids)]

    c = RowCache(capacity_rows=8, table="t")
    assert c.warm([0, 1, 2], fetch) == 3
    np.testing.assert_array_equal(c.lookup([0, 1, 2, 5, 5], fetch), store[[0, 1, 2, 5, 5]])
    assert calls == [[0, 1, 2], [5]]


def test_row_cache_capacity_budget_against_jax():
    for args, kw in (((1000, 16), dict(budget="4KiB", fraction=0.5)),
                     ((10, 16), dict(budget="1GiB")), ((500, 3), dict(budget=10_000))):
        got = RowCache.for_table(*args, table="t", **kw).capacity_rows
        assert got == fluid.embedding.RowCache.for_table(*args, table="t", **kw).capacity_rows
    assert RowCache.for_table(1000, 16, budget="4KiB", fraction=0.5).capacity_rows == 32
    with pytest.raises(ValueError):
        RowCache(capacity_rows=0)


def test_inferencer_row_cache_and_serving_session(tmp_path):
    """``ServingSession(embedding_cache=)`` serves ``lookup_rows`` through
    the LRU (hits on the second call), equal to the trained table; a
    served ``infer`` returns the same rows; ``stats()["embedding"]``."""
    from paddle_tpu_torch import telemetry
    telemetry.reset_scope(embedding.EMBEDDING_SCOPE)

    def train_func():
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        return pt.layers.mean(pt.embedding.sharded_table(ids, "user_table", rows=32, dim=4))

    def infer_func():
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        return pt.embedding.sharded_table(ids, "user_table", rows=32, dim=4)

    def reader():
        yield [(np.array([1], np.int64),), (np.array([2], np.int64),)]

    with pt.unique_name.guard():
        t = pt.Trainer(train_func=train_func, optimizer_func=lambda: pt.optimizer.SGD(0.5),
                       place=pt.CPUPlace())
    t.train(num_epochs=1, event_handler=lambda ev: None, reader=reader, feed_order=["ids"])
    path = str(tmp_path / "model")
    t.save_params(path)
    table = t.scope.find_var("user_table").numpy().copy()

    sess = pt.ServingSession(infer_func=infer_func, param_path=path, place=pt.CPUPlace(),
                             max_batch_size=4,
                             embedding_cache={"user_table": {"capacity_rows": 8}})
    try:
        np.testing.assert_array_equal(sess.lookup_rows("user_table", [1, 2, 3]),
                                      table[[1, 2, 3]])
        np.testing.assert_array_equal(sess.lookup_rows("user_table", [2, 3, 4]),
                                      table[[2, 3, 4]])
        st = sess.stats()["embedding"]["user_table"]
        assert st["hits"] == 2 and st["misses"] == 4 and st["hit_rate"] > 0
        out = sess.infer({"ids": np.array([[5]], np.int64)})
        np.testing.assert_array_equal(np.asarray(out[0])[0], table[5])
    finally:
        sess.close()
    inf = pt.Inferencer(infer_func=infer_func, param_path=path, place=pt.CPUPlace())
    np.testing.assert_array_equal(inf.lookup_rows("user_table", [7, 7]), table[[7, 7]])
    assert inf.row_cache_stats() == {}
    cache = inf.attach_row_cache("user_table", budget="4KiB", fraction=0.25)
    assert cache.capacity_rows == 32
    with pytest.raises(KeyError):
        inf.attach_row_cache("no_such_table")
