"""The port's parameter-server training against the JAX package, on the CPU.

* the ``DistributeTranspiler``'s trainer, pserver and startup programs equal
  the JAX transpiler's op for op (``callsite`` scrubbed) for
  ``tests/test_dist_pserver.py``'s MLP, the same with ``slice_var_up``
  (``tests/test_dist_slice.py``), a noam ``lr_program`` and a small
  transformer (1 layer, d_model 32);
* in-process clusters (servers on threads at ``127.0.0.1:0``) of both
  packages from the same parameters and feeds, one and two trainers
  (the second trainer reaches the server as ``localhost``, so each has a
  client of its own): losses within ``RTOL`` (``tests/test_dist_pserver.py``
  holds its parity at 1e-5) and the servers' parameters within ``ATOL``;
* against the port's own local step, one trainer: bit-equal (Adam, a
  schedule, sliced Momentum);
* the server's arithmetic bit-equal to the JAX server's: the sync average
  for 1, 2 and 3 trainers, the table push;
* the round and barrier semantics, async mode, ``send_grads``' single
  round trip, ``listen_and_serv``'s raise; the executor's split (which ops
  run before the step and which after; a server op in the middle named by
  ``graph_blockers``); one ``run_pserver`` cluster of ``pserver_runner
  --cpu`` processes; the env contract; the master's cases of
  ``tests/test_elastic.py`` and the transport's functional cases of
  ``tests/test_transport_throughput.py`` (its throughput floors are not
  copied: a timing gate is unsteady under parallel workers).
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.distributed import pserver as jps
from paddle_tpu.transpiler import distribute_transpiler as jdt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.distributed import pserver as tps
from paddle_tpu_torch.transpiler import distribute_transpiler as tdt

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "paddle_tpu_torch", "tools", "pserver_runner.py")
RTOL = 1e-5          # losses, port against the JAX cluster
ATOL = 2e-6          # the servers' parameters after the steps, float32
CPU = pt.CPUPlace()


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _same(a, b):
    assert _scrub(a.desc.to_dict()) == _scrub(b.desc.to_dict())


# ------------------------------------------------------------------ models
def _mlp(pkg, opt="sgd"):
    layers = pkg.layers
    x = layers.data(name="x", shape=[5], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=8, act="relu", param_attr=pkg.ParamAttr(name="w1"),
                  bias_attr=pkg.ParamAttr(name="b1"))
    pred = layers.fc(input=h, size=1, param_attr=pkg.ParamAttr(name="w2"),
                     bias_attr=pkg.ParamAttr(name="b2"))
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    if opt == "adam":
        pkg.optimizer.Adam(learning_rate=0.05).minimize(loss)
    elif opt == "noam":
        lr = layers.learning_rate_scheduler.noam_decay(16, 4)
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    else:
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def _sliced(pkg):
    layers = pkg.layers
    x = layers.data(name="x", shape=[6], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=64, act="relu", param_attr=pkg.ParamAttr(name="w1"),
                  bias_attr=pkg.ParamAttr(name="b1"))
    pred = layers.fc(input=h, size=300, param_attr=pkg.ParamAttr(name="w2"),
                     bias_attr=pkg.ParamAttr(name="b2"))
    out = layers.fc(input=pred, size=1, param_attr=pkg.ParamAttr(name="w3"),
                    bias_attr=pkg.ParamAttr(name="b3"))
    loss = layers.mean(layers.square_error_cost(input=out, label=y))
    pkg.optimizer.MomentumOptimizer(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


def _transformer(pkg):
    layers = pkg.layers
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = layers.data(name="lbl", shape=[8, 1], dtype="int64")
    import importlib
    transformer = importlib.import_module(pkg.__name__ + ".models.transformer")
    loss, _ = transformer.train_network(src, trg, lbl, 50, 50, max_len=8, n_layer=1,
                                        d_model=32, n_head=4, d_inner=64,
                                        fuse_final_ce=True)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


MODELS = {"mlp": _mlp, "adam": lambda pkg: _mlp(pkg, "adam"),
          "noam": lambda pkg: _mlp(pkg, "noam"), "sliced": _sliced,
          "transformer": _transformer}


def _feed(model, step, rows=8):
    rs = np.random.RandomState(100 + step)
    if model == "transformer":
        f = {}
        for n in ("src", "trg"):
            f[n] = rs.randint(1, 50, (rows, 8, 1)).astype(np.int64)
            f[n + "@SEQ_LEN"] = np.full(rows, 8, np.int32)
        f["lbl"] = rs.randint(1, 50, (rows, 8, 1)).astype(np.int64)
        return f
    width = 6 if model == "sliced" else 5
    x = rs.rand(rows, width).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}


def _build(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = MODELS[model](pkg)
    return main, startup, loss


def _transpile(pkg_dt, main, startup, endpoints, trainers=1, trainer_id=0, sliced=False):
    cfg = pkg_dt.DistributeTranspilerConfig()
    if sliced:
        cfg.slice_var_up = True
        cfg.min_block_size = 4096
    t = pkg_dt.DistributeTranspiler(cfg)
    t.transpile(trainer_id=trainer_id, program=main, pservers=",".join(endpoints),
                trainers=trainers, startup_program=startup)
    return t


# --------------------------------------------------------- program parity
@pytest.mark.parametrize("model", ["mlp", "sliced", "noam", "transformer"])
def test_transpiled_programs_equal_the_jax_transpilers(model):
    eps = ["127.0.0.1:6174", "127.0.0.1:6175"]
    jm, js, _ = _build(fluid, model)
    tm, ts, _ = _build(pt, model)
    _same(jm, tm)
    jt = _transpile(jdt, jm, js, eps, 2, 1, sliced=model == "sliced")
    tt = _transpile(tdt, tm, ts, eps, 2, 1, sliced=model == "sliced")
    assert jt.param_endpoint == tt.param_endpoint and jt.slices == tt.slices
    _same(jt.get_trainer_program(), tt.get_trainer_program())
    _same(js, ts)                                   # the seeds the transpile stamps
    for ep in eps:
        jp, tp = jt.get_pserver_program(ep), tt.get_pserver_program(ep)
        _same(jp, tp)
        jmeta, tmeta = jp._pserver_meta, tp._pserver_meta
        for k in ("endpoint", "params", "trainers", "sync_mode", "slices", "tables"):
            assert jmeta[k] == tmeta[k], k
        assert sorted(jmeta["optimize_programs"]) == sorted(tmeta["optimize_programs"])
        for unit, (jprog, jgrad) in jmeta["optimize_programs"].items():
            tprog, tgrad = tmeta["optimize_programs"][unit]
            assert jgrad == tgrad
            _same(jprog, tprog)
        assert (jmeta["lr_program"] is None) == (tmeta["lr_program"] is None)
        if jmeta["lr_program"] is not None:
            _same(jmeta["lr_program"], tmeta["lr_program"])
        _same(jt.get_startup_program(ep, jp), tt.get_startup_program(ep, tp))
    if model == "noam":
        assert tt.get_pserver_program(eps[0])._pserver_meta["lr_program"] is not None


# ------------------------------------------------------------- clusters
def _start(pkg_ps, exe_cls, t, placeholders, trainers, place=None, carry=None):
    """Servers on threads for each placeholder endpoint: (servers, the
    real endpoint of each placeholder).  ``carry``: the JAX servers, whose
    scopes' state the port's servers start from."""
    servers, real = [], {}
    for i, ph in enumerate(placeholders):
        pp = t.get_pserver_program(ph)
        scope = (pt.Scope() if place is not None else fluid.Scope())
        exe = exe_cls(place) if place is not None else exe_cls()
        exe.run(t.get_startup_program(ph, pp), scope=scope)
        meta = pp._pserver_meta
        if carry is not None:
            src = carry[i][1].scope
            params_from_numpy({n: np.asarray(src.find_var(n)) for n, v in scope._vars.items()
                               if isinstance(v, torch.Tensor) and src.find_var(n) is not None},
                              scope, "cpu")
        if meta.get("slices"):
            pkg_ps.slice_param_blocks(scope, meta["slices"])
        kw = {"place": place} if place is not None else {}
        ps = pkg_ps.ParameterServer(meta["params"], meta["optimize_programs"], scope, trainers,
                                    True, lr_program=meta.get("lr_program"),
                                    tables=pkg_ps.slice_table_shards(scope, meta["tables"]), **kw)
        srv, addr = pkg_ps.serve_pserver(ps, "127.0.0.1", 0)
        servers.append((srv, ps))
        real[ph] = f"{addr[0]}:{addr[1]}"
    return servers, real


def _point(prog, real, host="127.0.0.1"):
    for op in prog.desc.block(0).ops:
        if "endpoint" in op.attrs:
            op.attrs["endpoint"] = real[op.attrs["endpoint"]].replace("127.0.0.1", host)
        if "endpoints" in op.attrs:
            op.attrs["endpoints"] = [real[e].replace("127.0.0.1", host)
                                     for e in op.attrs["endpoints"]]
    return prog


def _stop(servers, client_cls):
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()
    client_cls.reset_all()


def _run_trainers(pkg, dt, model, real, placeholders, trainers, steps):
    """Each trainer on a thread of its own (trainer i reaches the servers as
    ``localhost`` when i is odd; the programs are built first, on this
    thread: building is not thread-safe): its losses."""
    runs = []
    for i in range(trainers):
        main, startup, loss = _build(pkg, model)
        t = _transpile(dt, main, startup, placeholders, trainers, i, sliced=model == "sliced")
        prog = _point(t.get_trainer_program(), real, "localhost" if i % 2 else "127.0.0.1")
        if pkg is pt:
            exe, scope = pt.Executor(CPU), pt.Scope()
        else:
            exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope, prog, loss))
    losses = [None] * trainers
    errors = []

    def trainer(i):
        exe, scope, prog, loss = runs[i]
        try:
            out = []
            for s in range(steps):
                f = _feed(model, s, 8 * trainers)
                f = {k: v[i * 8:(i + 1) * 8] for k, v in f.items()}
                out.append(float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]))
            losses[i] = out
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
    threads = [threading.Thread(target=trainer, args=(i,)) for i in range(trainers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    return losses


@pytest.mark.parametrize("model,trainers", [("adam", 1), ("noam", 1), ("mlp", 2)])
def test_cluster_matches_the_jax_cluster(model, trainers):
    """Both packages' clusters (two pservers) from the same parameters and
    feeds: each trainer's losses within RTOL, the servers' parameters
    within ATOL after the steps."""
    phs = ["127.0.0.1:1", "127.0.0.1:2"]
    steps = 3
    jm, js, _ = _build(fluid, model)
    jt = _transpile(jdt, jm, js, phs, trainers)
    jservers, jreal = _start(jps, fluid.Executor, jt, phs, trainers)
    tm, ts, _ = _build(pt, model)
    tt = _transpile(tdt, tm, ts, phs, trainers)
    tservers, treal = _start(tps, pt.Executor, tt, phs, trainers, place=CPU, carry=jservers)
    try:
        jl = _run_trainers(fluid, jdt, model, jreal, phs, trainers, steps)
        tl = _run_trainers(pt, tdt, model, treal, phs, trainers, steps)
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        for (_, jp), (_, tp) in zip(jservers, tservers):
            assert jp.round == tp.round == steps
            for n in tp.param_names:
                np.testing.assert_allclose(tp.scope.find_var(n).numpy(),
                                           np.asarray(jp.scope.find_var(n)), atol=ATOL,
                                           err_msg=n)
    finally:
        _stop(jservers, jps.PServerClient)
        _stop(tservers, tps.PServerClient)


@pytest.mark.parametrize("model", ["adam", "noam", "sliced"])
def test_one_trainer_bit_equal_to_the_local_step(model):
    """One trainer through two pservers takes the same steps as local
    training from the same (stamped) startup: every loss and the servers'
    parameters bit-equal."""
    steps = 4
    main, startup, loss = _build(pt, model)
    tdt._stamp_init_seeds(startup)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    base = [float(exe.run(main, feed=_feed(model, s), fetch_list=[loss], scope=scope)[0])
            for s in range(steps)]
    phs = ["127.0.0.1:1", "127.0.0.1:2"]
    main2, startup2, loss2 = _build(pt, model)
    t = _transpile(tdt, main2, startup2, phs, sliced=model == "sliced")
    servers, real = _start(tps, pt.Executor, t, phs, 1, place=CPU)
    try:
        prog = _point(t.get_trainer_program(), real)
        tr, tscope = pt.Executor(CPU), pt.Scope()
        tr.run(startup2, scope=tscope)
        dist = [float(tr.run(prog, feed=_feed(model, s), fetch_list=[loss2], scope=tscope)[0])
                for s in range(steps)]
        assert dist == base
        for _, ps in servers:
            for n in ps.param_names:
                if n in t.unit_src and t.unit_src[n][2] >= 0:
                    src, r0, rows = t.unit_src[n]
                    want = scope.find_var(src)[r0:r0 + rows]
                else:
                    want = scope.find_var(n)
                assert torch.equal(ps.scope.find_var(n), want), n
    finally:
        _stop(servers, tps.PServerClient)


# ------------------------------------------------------ server arithmetic
def _sgd_server(pkg_ps, pkg, exe_kw, shape, trainers, sync_mode=True, lr=0.1):
    """A ParameterServer of ``pkg`` holding one param "p" updated by SGD:
    tests/test_transport_throughput.py's ``_make_ps``."""
    scope = pkg.Scope()
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        g = pkg.layers.data(name="p@GRADFEED", shape=list(shape), append_batch_size=False)
        p = prog.global_block.create_var(name="p", shape=shape, dtype="float32",
                                         persistable=True)
        lrv = prog.global_block.create_var(name="p@LR", shape=(1,), dtype="float32",
                                           persistable=True)
        prog.global_block.append_op("sgd", inputs={"Param": p, "Grad": g, "LearningRate": lrv},
                                    outputs={"ParamOut": p})
    start = np.random.RandomState(0).rand(*shape).astype(np.float32)
    if pkg is pt:
        params_from_numpy({"p": start, "p@LR": np.asarray([lr], np.float32)}, scope, "cpu")
    else:
        scope.set_var("p", start)
        scope.set_var("p@LR", np.asarray([lr], np.float32))
    return pkg_ps.ParameterServer(["p"], {"p": (prog, "p@GRADFEED")}, scope, trainers,
                                  sync_mode=sync_mode, **exe_kw)


@pytest.mark.parametrize("trainers", [1, 2, 3])
def test_sync_average_bit_equal_to_the_jax_server(trainers):
    """The float64 mean over the trainers, cast back, then the update: the
    same bits as the JAX server's ``np.mean(..., dtype=np.float64)``."""
    shape = (7, 33)
    jp = _sgd_server(jps, fluid, {}, shape, trainers)
    tp = _sgd_server(tps, pt, {"place": CPU}, shape, trainers)
    rs = np.random.RandomState(trainers)
    for _ in range(2):
        for tid in range(trainers):
            g = (rs.randn(*shape) * 10.0 ** rs.randint(-3, 3, shape)).astype(np.float32)
            jp.push_grad("p", tid, g.copy())
            tp.push_grad("p", tid, g.copy())
    assert jp.round == tp.round == 2
    np.testing.assert_array_equal(tp.get_param("p", 2), jp.get_param("p", 2))


def test_table_push_and_prefetch_bit_equal_to_the_jax_server():
    full = np.random.RandomState(3).rand(23, 4).astype(np.float32)
    meta = {"t": {"shard_id": 1, "num_shards": 3, "lr": 0.1}}
    js, ts = fluid.Scope(), pt.Scope()
    js.set_var("t", full.copy())
    params_from_numpy({"t": full}, ts, "cpu")
    jp = jps.ParameterServer([], {}, js, 1, tables=jps.slice_table_shards(js, meta))
    tp = tps.ParameterServer([], {}, ts, 1, tables=tps.slice_table_shards(ts, meta), place=CPU)
    assert ts.find_var("t") is None                 # the full table leaves the scope
    ids = np.array([1, 4, 10, 22], np.int64)
    rows = np.random.RandomState(4).randn(4, 4).astype(np.float32)
    for p in (jp, tp):
        p.push_sparse_rows("t", 0, ids, rows)
    np.testing.assert_array_equal(tp.prefetch_rows("t", ids), jp.prefetch_rows("t", ids))
    np.testing.assert_array_equal(tp.tables["t"]["shard"].numpy(), jp.tables["t"]["shard"])


def test_rounds_barrier_and_async_mode():
    """Sync mode: a round completes only once every trainer pushed, and
    ``get_param(min_round)`` blocks until it has; async mode applies each
    push at once."""
    shape = (3,)
    ps = _sgd_server(tps, pt, {"place": CPU}, shape, trainers=2)
    start = ps.get_param("p", 0).copy()
    ps.push_grad("p", 0, np.ones(shape, np.float32))
    assert ps.round == 0
    got = []
    waiter = threading.Thread(target=lambda: got.append(ps.get_param("p", 1)))
    waiter.start()
    time.sleep(0.2)
    assert waiter.is_alive() and not got
    ps.push_grad("p", 1, 3 * np.ones(shape, np.float32))
    waiter.join(timeout=10)
    assert ps.round == 1
    np.testing.assert_allclose(got[0], start - np.float32(0.1) * 2.0, rtol=1e-6)
    asy = _sgd_server(tps, pt, {"place": CPU}, shape, trainers=2, sync_mode=False)
    a0 = asy.get_param("p", 0).copy()
    asy.push_grad("p", 0, np.ones(shape, np.float32))
    assert asy.round == 1
    np.testing.assert_allclose(asy.get_param("p", 5), a0 - np.float32(0.1), rtol=1e-6)
    assert len(ps.stats()["round_s"]) == 1


def test_send_grads_is_one_round_trip_and_updates_like_send_grad():
    """tests/test_transport_throughput.py's batched case: one call for a
    push of 200 tensors, and the same server state as per-tensor pushes."""
    specs = {f"w{i}": (64,) for i in range(200)}
    scope, programs = pt.Scope(), {}
    for name, shape in specs.items():
        params_from_numpy({name: np.zeros(shape, np.float32),
                           f"{name}@LR": np.asarray([0.1], np.float32)}, scope, "cpu")
        prog, startup = pt.Program(), pt.Program()
        with pt.program_guard(prog, startup):
            g = pt.layers.data(name=f"{name}@GRADFEED", shape=list(shape),
                               append_batch_size=False)
            p = prog.global_block.create_var(name=name, shape=shape, dtype="float32",
                                             persistable=True)
            lr = prog.global_block.create_var(name=f"{name}@LR", shape=(1,), dtype="float32",
                                              persistable=True)
            prog.global_block.append_op("sgd", inputs={"Param": p, "Grad": g,
                                                       "LearningRate": lr},
                                        outputs={"ParamOut": p})
        programs[name] = (prog, f"{name}@GRADFEED")
    ps = tps.ParameterServer(list(specs), programs, scope, trainers=1, sync_mode=False,
                             place=CPU)
    srv, (host, port) = tps.serve_pserver(ps)
    try:
        cli = tps.PServerClient(f"{host}:{port}")
        grads = [(n, np.ones(s, np.float32)) for n, s in specs.items()]
        cli.send_grads(grads, trainer_id=0)
        assert cli.calls == 1
        for n, g in grads:
            cli.send_grad(n, 0, g)
        assert cli.calls == 201
        np.testing.assert_allclose(ps.get_param("w0", 0), -0.2, rtol=1e-6)
        np.testing.assert_array_equal(ps.get_param("w199", 0), ps.get_param("w0", 0))
        cli.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_threaded_trainers_push_concurrently():
    """tests/test_transport_throughput.py's concurrent case: 4 trainer
    threads push through their own clients, each waiting for the round
    before its next push (the BSP loop); every push completes and each
    round averages the four."""
    shape = (256, 64)
    ps = _sgd_server(tps, pt, {"place": CPU}, shape, trainers=4)
    start = ps.get_param("p", 0).copy()
    srv, (host, port) = tps.serve_pserver(ps)
    errs = []

    def trainer(tid):
        try:
            c = tps.PServerClient(f"{host}:{port}")
            for r in range(3):
                c.send_grad("p", tid, np.full(shape, tid, np.float32))
                c.get_param("p", r + 1)
            c.close()
        except Exception as e:  # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=trainer, args=(i,)) for i in range(4)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errs and ps.round == 3
        np.testing.assert_allclose(ps.get_param("p", 3), start - 3 * np.float32(0.1) * 1.5,
                                   rtol=1e-5, atol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()


def test_listen_and_serv_raises_and_run_pserver_wants_a_pserver_program():
    main, startup, _ = _build(pt, "mlp")
    t = _transpile(tdt, main, startup, ["127.0.0.1:1"])
    pp = t.get_pserver_program("127.0.0.1:1")
    with pytest.raises(RuntimeError, match="run_pserver"):
        pt.Executor(CPU).run(pp, scope=pt.Scope())
    with pytest.raises(ValueError, match="not a pserver program"):
        pt.Executor(CPU).run_pserver(main)


# ----------------------------------------------------- the executor's split
def test_host_stages_split_and_a_server_op_in_the_middle_blocks_the_graph():
    from paddle_tpu_torch.core.executor import graph_blockers, plan_host_stages
    main, startup, _ = _build(pt, "sliced")
    t = _transpile(tdt, main, startup, ["a:1", "b:1"], sliced=True)
    prog = t.get_trainer_program()
    stages = plan_host_stages(prog)
    assert [o.type for o in stages.head] == ["recv"] * 7 + ["fetch_barrier"]
    assert [o.type for o in stages.tail] == ["send"] * 7 + ["send_barrier"]
    body_types = [o.type for o in stages.body.desc.block(0).ops]
    assert body_types[0] == "concat" and not {"recv", "send"} & set(body_types)
    assert stages.tail_reads == list(dict.fromkeys(o.input("X")[0] for o in stages.tail
                                                   if o.type == "send"))
    assert plan_host_stages(main) is None
    # a send whose gradient a later op rewrites cannot wait for the tail,
    # nor go to the head: it stays in the body, which then runs op by op
    block = prog.desc.block(0)
    send_i = next(i for i, o in enumerate(block.ops) if o.type == "send")
    g = block.ops[send_i].input("X")[0]
    from paddle_tpu_torch.core.desc import OpDesc
    block.insert_op(send_i + 1, OpDesc(type="scale", inputs={"X": [g]}, outputs={"Out": [g]},
                                       attrs={"scale": 1.0}))
    stages = plan_host_stages(prog)
    assert [o.type for o in stages.tail] == ["send"] * 6 + ["send_barrier"]
    reasons = graph_blockers(stages.body, [], [])
    assert any("parameter server" in r and "send" in r for r in reasons), reasons
    with pytest.raises(NotImplementedError, match="parameter servers"):
        pt.Executor(CPU).precompile(prog, feed={"x": ((8, 6), "float32")})


# ------------------------------------------------- the subprocess cluster
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_pserver_cluster_of_runner_processes(tmp_path):
    """``pserver_runner --cpu``: one pserver (``Executor.run_pserver`` with
    its ``ready_file``) and two trainers, sync SGD; the mean of the two
    trainers' half-batch losses tracks the single-process full-batch loss
    (tests/test_dist_pserver.py's gate), the trainers received the same
    parameters each round, and the pserver's record holds its rounds."""
    ep = f"127.0.0.1:{_free_port()}"
    ready = str(tmp_path / "ready")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, RUNNER]
    ps = subprocess.Popen(run + ["pserver", ep, "2", ready, "--cpu", "--out",
                                 str(tmp_path / "ps.json")], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not os.path.exists(ready):
            assert ps.poll() is None, ps.communicate()[1][-3000:]
            assert time.time() < deadline, "pserver never became ready"
            time.sleep(0.1)
        assert open(ready).read() == ep
        trs = [subprocess.Popen(run + ["trainer", ep, "2", str(i), "--cpu", "--out",
                                       str(tmp_path / f"tr{i}.json")], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
               for i in range(2)]
        for p in trs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
        ps.terminate()
        _, err = ps.communicate(timeout=60)
        assert ps.returncode == 0, err[-3000:]
    finally:
        if ps.poll() is None:
            ps.kill()
    recs = [json.loads((tmp_path / f"tr{i}.json").read_text()) for i in range(2)]
    psrec = json.loads((tmp_path / "ps.json").read_text())
    assert recs[0]["digests"] == recs[1]["digests"]
    assert psrec["rounds"] == len(psrec["round_s"]) == 6 and psrec["bytes_in"] > 0
    sys.path.insert(0, os.path.dirname(RUNNER))
    import pserver_runner as runner
    main, startup, loss = runner.build(pt, "mlp")
    tdt._stamp_init_seeds(startup)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    base = [float(exe.run(main, feed=runner.global_feed("mlp", runner.ROWS["mlp"], runner.SEED + s),
                          fetch_list=[loss], scope=scope)[0]) for s in range(6)]
    dist = np.mean([recs[0]["losses"], recs[1]["losses"]], axis=0)
    np.testing.assert_allclose(dist, base, rtol=2e-4, atol=1e-5)
    assert dist[-1] < dist[0]


# ------------------------------------------------------ the env contract
def test_env_contract_and_the_collective_half_raising(monkeypatch, tmp_path):
    from paddle_tpu_torch import distributed as dist
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1, b:2")
    env = dist.ParallelEnv()
    assert (dist.trainer_id(), dist.num_trainers(), env.rank, env.nranks) == (3, 4, 3, 4)
    assert dist.trainer_endpoints() == ["a:1", "b:2"]
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    monkeypatch.setenv("PADDLE_TRAINERS", "2")
    assert dist.num_trainers() == 2
    # the collective half is ported (tests/test_torch_parallel.py runs it in
    # ranks); what a process outside a clique sees: a clique of two needs a
    # rendezvous, one device a rank, no backend but NCCL and gloo, barrier a
    # no-op, and what waits for item 12c raises naming it
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS")
    with pytest.raises(ValueError, match="needs a coordinator"):
        dist.init_parallel_env(place=pt.CPUPlace())
    with pytest.raises(ValueError, match="one device a rank"):
        dist.init_parallel_env(local_device_count=2, place=pt.CPUPlace())
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        dist.init_parallel_env(num_trainers=1, place=pt.CPUPlace(), backend="mpi")
    assert dist.barrier() is None
    assert callable(dist.data_mesh) and callable(dist.feed_sharding)
    with pytest.raises(NotImplementedError, match="item 12c"):
        pt.checkpoint.CheckpointManager(str(tmp_path), async_save=False).save(
            pt.Program(), pt.Scope(), step=1, mesh=object())
    assert not dist.is_initialized()


# ------------------------------------------------------------ the master
def test_master_dispatch_finish_and_eof():
    from paddle_tpu_torch.distributed import Master, NoMoreTasks
    m = Master(chunks=["a", "b", "c"], timeout_s=60)
    seen = []
    for _ in range(3):
        tid, chunk = m.get_task()
        seen.append(chunk)
        m.task_finished(tid)
    assert sorted(seen) == ["a", "b", "c"]
    with pytest.raises(NoMoreTasks):
        m.get_task()
    assert m.counts == {"todo": 0, "pending": 0, "done": 3, "failed": 0}


def test_master_timeout_redispatch():
    from paddle_tpu_torch.distributed import Master, NoMoreTasks
    m = Master(chunks=[1, 2], timeout_s=0.1)
    t1, c1 = m.get_task()
    t2, c2 = m.get_task()
    m.task_finished(t2)
    time.sleep(0.15)
    t1b, c1b = m.get_task()
    assert c1b == c1
    m.task_finished(t1b)
    with pytest.raises(NoMoreTasks):
        m.get_task()


def test_master_discards_after_max_failures():
    from paddle_tpu_torch.distributed import Master, NoMoreTasks
    m = Master(chunks=["poison"], timeout_s=60, max_failures=2)
    for _ in range(3):
        tid, _ = m.get_task()
        m.task_failed(tid)
    with pytest.raises(NoMoreTasks):
        m.get_task()
    assert m.counts["failed"] == 1


def test_master_snapshot_recover_across_the_packages(tmp_path):
    """A snapshot the port's master writes recovers in the JAX package's
    master (and the other way): one file format."""
    from paddle_tpu.distributed import Master as JMaster
    from paddle_tpu_torch.distributed import Master, NoMoreTasks
    for writer, reader in ((Master, JMaster), (JMaster, Master)):
        path = str(tmp_path / f"snap_{writer.__module__}.json")
        m = writer(chunks=[10, 20, 30], timeout_s=60, snapshot_path=path)
        tid, chunk = m.get_task()
        m.task_finished(tid)
        m.get_task()                 # left pending: the master "dies" here
        m._snapshot()
        m2 = reader(chunks=[], timeout_s=60, snapshot_path=path)
        assert m2.counts["done"] == 1 and m2.counts["todo"] == 2
        got = []
        while True:
            try:
                t, ch = m2.get_task()
            except Exception as e:  # noqa: BLE001 -- either package's NoMoreTasks
                assert type(e).__name__ == NoMoreTasks.__name__
                break
            got.append(ch)
            m2.task_finished(t)
        assert sorted(got + [chunk]) == [10, 20, 30]


def test_master_server_and_client_over_tcp():
    from paddle_tpu_torch.distributed import Master, MasterClient, MasterServer, NoMoreTasks
    server = MasterServer(Master(chunks=list(range(5)), timeout_s=60))
    try:
        cli = MasterClient(server.address)
        got = []
        while True:
            try:
                tid, chunk = cli.get_task()
            except NoMoreTasks:
                break
            got.append(chunk)
            cli.task_finished(tid)
        assert sorted(got) == list(range(5))
        cli.close()
    finally:
        server.shutdown()
