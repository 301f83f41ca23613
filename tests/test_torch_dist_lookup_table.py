"""The port's distributed lookup table against the JAX package, on the CPU:
``tests/test_dist_lookup_table.py``'s seven cases, each held against the
JAX package (embedding rows sharded across pservers, reference
doc/fluid/design/dist_train/distributed_lookup_table_design.md; the
forward prefetches only the batch's rows from their owning shards, the
backward pushes merged (ids, rows) SGD updates).  Clusters of both
packages start from the same state (the JAX servers' scopes carried into
the port's); losses within rtol 1e-4 / atol 1e-6, the JAX test's gate."""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.distributed import pserver as jps
from paddle_tpu.transpiler import distribute_transpiler as jdt
from paddle_tpu_torch.distributed import pserver as tps
from paddle_tpu_torch.transpiler import distribute_transpiler as tdt

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_pserver import CPU, _point, _same, _start, _stop

VOCAB, DIM = 40, 8
RTOL, ATOL = 1e-4, 1e-6      # tests/test_dist_lookup_table.py:121
PHS = ["127.0.0.1:0", "127.0.0.1:1"]


def _net(pkg, is_distributed=True, padding_idx=None, opt="sgd"):
    layers = pkg.layers
    ids = layers.data(name="ids", shape=[1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="float32")
    emb = layers.embedding(ids, size=[VOCAB, DIM], is_distributed=is_distributed,
                           padding_idx=padding_idx)
    emb = layers.reshape(emb, shape=[-1, DIM])
    pred = layers.fc(input=emb, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=label))
    if opt == "adam":
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    else:
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _shared(pkg):
    layers = pkg.layers
    ids_a = layers.data(name="ids_a", shape=[1], dtype="int64")
    ids_b = layers.data(name="ids_b", shape=[1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="float32")
    attr = pkg.ParamAttr(name="shared_table")
    ea = layers.reshape(layers.embedding(ids_a, size=[VOCAB, DIM], is_distributed=True,
                                         param_attr=attr), shape=[-1, DIM])
    eb = layers.reshape(layers.embedding(ids_b, size=[VOCAB, DIM], is_distributed=True,
                                         param_attr=attr), shape=[-1, DIM])
    pred = layers.fc(input=layers.concat([ea, eb], axis=1), size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=label))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = build(pkg)
    return main, startup, loss


def _transpile(dt, main, startup, eps=PHS):
    t = dt.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, pservers=",".join(eps), trainers=1,
                startup_program=startup)
    return t


def _clusters(build):
    """Both packages' clusters of two pservers (the port's from the JAX
    servers' state): for each, (transpiler, trainer program pointed at its
    servers, executor, scope, loss, servers)."""
    out = []
    for pkg, dt, ps_mod in ((fluid, jdt, jps), (pt, tdt, tps)):
        main, startup, loss = _build(pkg, build)
        t = _transpile(dt, main, startup)
        if pkg is fluid:
            servers, real = _start(jps, fluid.Executor, t, PHS, 1)
            exe, scope = fluid.Executor(), fluid.Scope()
        else:
            servers, real = _start(tps, pt.Executor, t, PHS, 1, place=CPU, carry=out[0][5])
            exe, scope = pt.Executor(CPU), pt.Scope()
        exe.run(startup, scope=scope)
        out.append((t, _point(t.get_trainer_program(), real), exe, scope, loss, servers))
    return out


def _stop_all(clusters):
    for (_, _, _, _, _, servers), cls in zip(clusters, (jps.PServerClient, tps.PServerClient)):
        _stop(servers, cls)


def _steps(cluster, feeds):
    _, prog, exe, scope, loss, _ = cluster
    return [float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]) for f in feeds]


def _feeds(n, seed, pad=False):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, 8, 1)).astype(np.int64)
    if pad:
        ids[:, :3] = 0
    lbl = rs.rand(n, 8, 1).astype(np.float32)
    return [{"ids": ids[i], "label": lbl[i]} for i in range(n)]


def test_transpiled_program_structure_equals_the_jax_transpilers():
    (jm, js, _), (tm, ts, _) = _build(fluid, _net), _build(pt, _net)
    jt, tt = _transpile(jdt, jm, js, ["a:1", "b:2"]), _transpile(tdt, tm, ts, ["a:1", "b:2"])
    jp, tp = jt.get_trainer_program(), tt.get_trainer_program()
    _same(jp, tp)
    types = [op.type for op in tp.desc.block(0).ops]
    assert "distributed_lookup_table" in types and "distributed_table_push" in types
    assert "lookup_table" not in types and "lookup_table_grad" not in types
    table = next(iter(tt.table_meta))
    assert all(op.attrs["param_name"] != table for op in tp.desc.block(0).ops
               if op.type == "recv")
    assert tt.table_meta == jt.table_meta
    meta = tt.get_pserver_program("a:1")._pserver_meta
    assert meta["tables"] == jt.get_pserver_program("a:1")._pserver_meta["tables"]
    assert meta["tables"][table]["num_shards"] == 2
    assert meta["tables"][table]["lr"] == pytest.approx(0.1)


def test_distributed_table_matches_the_jax_cluster_and_local_training():
    """1 trainer + 2 pservers with a sharded table: the port's losses against
    the JAX cluster's and the port's local training's; every touched row
    moved on its shard, every untouched row bit-identical."""
    feeds = _feeds(4, 7)
    main, startup, loss = _build(pt, lambda pkg: _net(pkg, is_distributed=False))
    tdt._stamp_init_seeds(startup)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    local = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]) for f in feeds]
    clusters = _clusters(_net)
    try:
        jl, tl = _steps(clusters[0], feeds), _steps(clusters[1], feeds)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        t, servers = clusters[1][0], clusters[1][5]
        table = next(iter(t.table_meta))
        touched = set(np.unique(np.concatenate([f["ids"].reshape(-1) for f in feeds])).tolist())
        start = np.asarray(clusters[0][5][0][1].scope.find_var(table))  # the JAX startup's
        for s, (_, ps) in enumerate(servers):
            shard = ps.tables[table]["shard"].numpy()
            for local_row in range(shard.shape[0]):
                gid = s + local_row * 2
                same = np.array_equal(shard[local_row], start[gid])
                assert same != (gid in touched), gid
    finally:
        _stop_all(clusters)
    # against local training from the same stamped startup (a cluster of
    # the port alone)
    main2, startup2, loss2 = _build(pt, _net)
    t = _transpile(tdt, main2, startup2)
    servers, real = _start(tps, pt.Executor, t, PHS, 1, place=CPU)
    try:
        prog = _point(t.get_trainer_program(), real)
        tr, tscope = pt.Executor(CPU), pt.Scope()
        tr.run(startup2, scope=tscope)
        dist = [float(tr.run(prog, feed=f, fetch_list=[loss2], scope=tscope)[0]) for f in feeds]
        np.testing.assert_allclose(dist, local, rtol=RTOL, atol=ATOL)
    finally:
        _stop(servers, tps.PServerClient)


def test_prefetch_returns_the_jax_servers_rows():
    clusters = _clusters(_net)
    try:
        ids = np.array([0, 1, 5, 17, 38], np.int64)
        t = clusters[1][0]
        table = next(iter(t.table_meta))
        got = {}
        for (_, prog, *_), cls, name in zip(clusters, (jps.PServerClient, tps.PServerClient),
                                            ("jax", "port")):
            eps = next(op.attrs["endpoints"] for op in prog.desc.block(0).ops
                       if op.type == "distributed_lookup_table")
            rows = np.zeros((len(ids), DIM), np.float32)
            for s, ep in enumerate(eps):
                m = (ids % 2) == s
                rows[m] = cls.for_endpoint(ep).prefetch_rows(table, ids[m])
            got[name] = rows
        full = np.asarray(clusters[0][5][0][1].scope.find_var(table))
        np.testing.assert_array_equal(got["port"], got["jax"])
        np.testing.assert_array_equal(got["port"], full[ids])
    finally:
        _stop_all(clusters)


def test_non_sgd_table_optimizer_rejected():
    main, startup, _ = _build(pt, lambda pkg: _net(pkg, opt="adam"))
    with pytest.raises(ValueError, match="SGD"):
        _transpile(tdt, main, startup, ["a:1"])


def test_padding_idx_parity():
    """padding_idx rows stay zero in the forward and take no push: the
    port's cluster against the JAX cluster with pads in every batch, and the
    pad row unchanged on its shard."""
    feeds = _feeds(4, 11, pad=True)
    clusters = _clusters(lambda pkg: _net(pkg, padding_idx=0))
    try:
        jl, tl = _steps(clusters[0], feeds), _steps(clusters[1], feeds)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        table = next(iter(clusters[1][0].table_meta))
        start = np.asarray(clusters[0][5][0][1].scope.find_var(table))
        np.testing.assert_array_equal(clusters[1][5][0][1].tables[table]["shard"][0].numpy(),
                                      start[0])
    finally:
        _stop_all(clusters)


def test_shared_table_two_lookups():
    """The same distributed table looked up twice (tied embeddings): the
    sum over the two replaced grads is pruned as in the JAX package, and
    the port trains as the JAX cluster does."""
    clusters = _clusters(_shared)
    try:
        types = [op.type for op in clusters[1][1].desc.block(0).ops]
        assert types.count("distributed_lookup_table") == 2
        assert types.count("distributed_table_push") == 2
        jp = clusters[0][0].get_trainer_program()
        _same(jp, clusters[1][0].get_trainer_program())
        rs = np.random.RandomState(2)
        feeds = [{"ids_a": rs.randint(0, VOCAB, (8, 1)).astype(np.int64),
                  "ids_b": rs.randint(0, VOCAB, (8, 1)).astype(np.int64),
                  "label": rs.rand(8, 1).astype(np.float32)} for _ in range(6)]
        jl, tl = _steps(clusters[0], feeds), _steps(clusters[1], feeds)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
        assert np.isfinite(tl).all() and tl[-1] < tl[0]
    finally:
        _stop_all(clusters)


def test_trainer_startup_drops_table_init():
    (jm, js, _), (tm, ts, _) = _build(fluid, _net), _build(pt, _net)
    jt, tt = _transpile(jdt, jm, js, ["a:1", "b:2"]), _transpile(tdt, tm, ts, ["a:1", "b:2"])
    _same(js, ts)
    table = next(iter(tt.table_meta))
    assert not [op for op in ts.desc.block(0).ops if table in op.output_names()]
    jps_start = jt.get_startup_program("a:1", jt.get_pserver_program("a:1"))
    tps_start = tt.get_startup_program("a:1", tt.get_pserver_program("a:1"))
    _same(jps_start, tps_start)
    assert [op for op in tps_start.desc.block(0).ops if table in op.output_names()]
    scope = pt.Scope()
    pt.Executor(CPU).run(ts, scope=scope)
    assert scope.find_var(table) is None
    assert isinstance(scope.find_var(next(n for n in tt.param_endpoint)), torch.Tensor)
