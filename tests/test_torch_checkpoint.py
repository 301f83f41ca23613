"""The port's async checkpointing (``paddle_tpu_torch/checkpoint/
manager.py``) on the CPU: the JAX package's ``tests/test_checkpoint.py``
cases that exist on one device (the commit protocol, torn-shard
detection, async retention and counters, an exact round trip with the
generator, a snapshot consistent despite later in-place steps,
``restore_fit`` from the manifest alone, the shape-drift refusal, the
Trainer's auto-save and resume, fetch-timeout save-and-exit, rollback on
divergence (also behind a starved writer), the io manifest shim,
``tools/ckpt_tool.py`` and ``tools/stats.py`` over the port's directory,
and a kill-mid-epoch resume in subprocesses), plus the cross-package
checks: a checkpoint the JAX ``CheckpointManager`` writes restores into
the port bit-equal, and one the port writes restores into the JAX
package bit-equal, each skipping the other's generator.  Restores copy
into the scope's tensors: every address, and the executor's cache, stay.
The resharded restore waits for the multi-GPU port (ROADMAP §A item
12)."""
import glob
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import checkpoint as jax_ckpt
from paddle_tpu_torch import layers, telemetry
from paddle_tpu_torch.checkpoint import (CKPT_RECORDS, CheckpointConfig, CheckpointError,
                                         CheckpointManager, list_steps, read_manifest,
                                         validate_shards)
from paddle_tpu_torch.checkpoint import manifest as manifest_mod
from paddle_tpu_torch.core.executor import RNG_STATE_VAR

from _torch_fresh import _fresh_port_programs  # noqa: F401
from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_mlp(pkg=pt, in_dim=16, hidden=8, lr=0.01):
    """Forward + loss + Adam on the default programs; returns the loss."""
    x = pkg.layers.data(name="x", shape=[in_dim], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    h = pkg.layers.fc(input=x, size=hidden, act="relu")
    pred = pkg.layers.fc(input=h, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
    pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return loss


def _feed(rs, batch=8, in_dim=16):
    return {"x": rs.rand(batch, in_dim).astype(np.float32),
            "y": rs.rand(batch, 1).astype(np.float32)}


def _persistable_values(program, scope):
    out = {}
    for name, vd in program.desc.block(0).vars.items():
        if vd.persistable:
            v = scope.find_var(name)
            if isinstance(v, torch.Tensor):
                out[name] = v.to("cpu", copy=True).numpy()
    return out


def _started(build=_build_mlp, **kw):
    loss = build(**kw)
    main = pt.default_main_program()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program(), scope=scope)
    return loss, main, scope, exe


# ------------------------------------------------------ manifest + commit

def test_save_commit_manifest_and_validate(tmp_path):
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    assert m.latest() is None
    m.save(main, scope, step=3, epoch_id=1, step_id=4)
    assert m.steps() == [3]
    d = manifest_mod.checkpoint_dir(str(tmp_path), 3)
    man = read_manifest(d)
    assert man["format"] == manifest_mod.FORMAT
    assert man["trainer"] == {"epoch_id": 1, "step_id": 4}
    names = set(man["vars"])
    assert any(n.endswith("w_0") for n in names)
    assert any("moment" in n for n in names)
    assert any("beta" in n for n in names)
    summary = validate_shards(d, man)
    assert summary["vars"] == len(names) and summary["ranks"] == 1
    assert os.path.isfile(os.path.join(d, manifest_mod.PROGRAM_NAME))
    assert man["rng"] == {"key": "@RNG_STATE@::key", "impl": "torch-cpu"}
    os.makedirs(os.path.join(str(tmp_path), "ckpt_9.tmp.123"))
    os.makedirs(os.path.join(str(tmp_path), "ckpt_7"))
    assert list_steps(str(tmp_path)) == [3]


def test_validate_shards_detects_torn_checkpoints(tmp_path):
    d = str(tmp_path)
    np.savez(os.path.join(d, "shard_r0.npz"), **{"w": np.zeros((4, 4), np.float32)})
    man = {"format": manifest_mod.FORMAT, "step": 0,
           "vars": {"w": {"shape": [8, 4], "dtype": "float32"}},
           "shards": {"0": {"file": "shard_r0.npz",
                            "chunks": {"w": [{"key": "w", "index": [[0, 4], [0, 4]]}]}},
                      "1": {"file": "shard_r1.npz",
                            "chunks": {"w": [{"key": "w", "index": [[4, 8], [0, 4]]}]}}}}
    manifest_mod.write_manifest(d, man)
    with pytest.raises(CheckpointError, match="shard_r1"):
        validate_shards(d, read_manifest(d))
    man["shards"].pop("1")
    manifest_mod.write_manifest(d, man)
    with pytest.raises(CheckpointError, match="cover"):
        validate_shards(d, read_manifest(d))


def test_async_save_retention_and_counters(tmp_path):
    telemetry.reset_scope("checkpoint")
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for step in (1, 2, 3, 4):
        m.save(main, scope, step=step)
        m.wait()
    assert m.steps() == [3, 4]
    snap = telemetry.REGISTRY.snapshot(scope="checkpoint")
    assert snap["saves"] == 4 and snap["saves_async"] == 4
    assert snap["pruned"] == 2 and snap["save_errors"] == 0
    assert snap["bytes_written"] > 0
    m.close()


def test_a_failed_async_save_raises_at_the_next_save_and_wait(tmp_path, monkeypatch):
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), async_save=True)

    def broken(arr_file, **payload):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    m.save(main, scope, step=1)
    with pytest.raises(CheckpointError, match="disk full"):
        m.wait()
    m.save(main, scope, step=2)
    deadline = time.time() + 30
    while m._error is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(CheckpointError, match="a previous async save failed"):
        m.save(main, scope, step=3)
    monkeypatch.undo()
    m.close()
    assert m.steps() == []


def test_a_save_on_a_full_queue_is_skipped_before_its_snapshot(tmp_path, monkeypatch):
    """With the writer busy and its queue full, ``save`` returns False and
    counts a skip without taking a snapshot (no copies, no pinned buffer);
    the saves it took commit once the writer moves on."""
    import threading

    from paddle_tpu_torch.checkpoint import manager as manager_mod
    telemetry.reset_scope("checkpoint")
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), keep=5, async_save=True)
    gate, snaps = threading.Event(), []
    serialize, snapshot = m._serialize, manager_mod.snapshot_program_state

    def held(job):
        gate.wait(30)
        serialize(job)

    def counted(*a, **kw):
        snaps.append(kw.get("pool"))
        return snapshot(*a, **kw)
    monkeypatch.setattr(m, "_serialize", held)
    monkeypatch.setattr(manager_mod, "snapshot_program_state", counted)
    assert m.save(main, scope, step=1)
    deadline = time.time() + 30
    while not m._q.empty() and time.time() < deadline:   # the writer holds step 1
        time.sleep(0.01)
    assert m.save(main, scope, step=2) and m.save(main, scope, step=3)
    assert not m.save(main, scope, step=4)
    assert len(snaps) == 3 and all(p is m._pool for p in snaps)
    assert telemetry.REGISTRY.snapshot(scope="checkpoint")["saves_skipped"] == 1
    gate.set()
    m.wait()
    assert m.steps() == [1, 2, 3]
    m.close()


def test_the_pinned_pool_hands_back_a_released_buffer_by_dtype_and_size():
    """``_PinnedPool``: a buffer given back is taken again for the same
    dtype and size (no allocation), and a snapshot's release empties it of
    its arrays and returns its buffers."""
    from paddle_tpu_torch.checkpoint import manager as manager_mod
    pool = manager_mod._PinnedPool()
    a, b = torch.empty(6, dtype=torch.float32), torch.empty(6, dtype=torch.int64)
    pool.give([a, b])
    assert pool.take(torch.float32, 6) is a and pool.take(torch.int64, 6) is b
    assert not any(pool._free.values())
    m = CheckpointManager(os.devnull, async_save=False)
    snap = manager_mod._Snapshot(vars={}, chunks=[("w", None, a.numpy())], rng=None)
    snap.buffers = (a,)
    m._release(snap)
    assert snap == {} and snap.buffers == () and m._pool.take(torch.float32, 6) is a


# --------------------------------------------------------- exact round trip

def test_restore_exact_roundtrip_with_rng_in_place(tmp_path):
    loss, main, scope, exe = _started()
    rs = np.random.RandomState(0)
    for _ in range(3):
        exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    before = _persistable_values(main, scope)
    gen = scope.find_var(RNG_STATE_VAR)
    gen.manual_seed(1234)
    torch.rand(5, generator=gen)
    rng_before = gen.get_state().clone()
    addrs = {n: scope.find_var(n).data_ptr() for n in before}
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(main, scope, step=3)
    for name in before:
        scope.find_var(name).zero_()
    gen.manual_seed(999)
    compiles = exe.compile_count
    m.restore(main, scope)
    after = _persistable_values(main, scope)
    for name, b in before.items():
        np.testing.assert_array_equal(after[name], b)
        assert scope.find_var(name).data_ptr() == addrs[name], name
    assert scope.find_var(RNG_STATE_VAR) is gen
    assert torch.equal(gen.get_state(), rng_before)
    out = exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    assert exe.compile_count == compiles           # the same cache entry ran


def test_snapshot_is_consistent_despite_later_in_place_steps(tmp_path):
    """The snapshot is taken when ``save`` is called; the in-place steps
    after it do not leak into the checkpoint."""
    loss, main, scope, exe = _started()
    rs = np.random.RandomState(1)
    exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    at_save = _persistable_values(main, scope)
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(main, scope, step=1)
    for _ in range(4):
        exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    m.wait()
    assert not all(np.array_equal(v, at_save[n])
                   for n, v in _persistable_values(main, scope).items())
    fresh = pt.Scope()
    exe.run(pt.default_startup_program(), scope=fresh)
    m.restore(main, fresh)
    restored = _persistable_values(main, fresh)
    for name, b in at_save.items():
        np.testing.assert_array_equal(restored[name], b)
    m.close()


def test_mesh_and_layout_wait_for_the_multi_gpu_port(tmp_path):
    """``save`` / ``restore`` with ``mesh=`` and ``layout=`` (the multi-GPU
    half, ported): on a world of one here (two ranks in
    tests/test_torch_mesh_checkpoint.py) the state lives on DTensors; the
    save records the mesh and the layout's fingerprint as the JAX package
    records them, and the restore places each value back on the mesh in
    place, or onto no mesh."""
    from paddle_tpu_torch.parallel import SpecLayout, shard_program_state
    import _torch_mesh_ranks as R
    _, main, scope, exe = _started()
    layout = SpecLayout()
    m = CheckpointManager(str(tmp_path), async_save=False)
    at_save = _persistable_values(main, scope)
    with R.world_of_one() as mesh:
        shard_program_state(main, scope, mesh, layout)
        m.save(main, scope, step=1, mesh=mesh, layout=layout)
        man = read_manifest(manifest_mod.checkpoint_dir(str(tmp_path), 1))
        assert man["mesh"] == {"axes": {"data": 1}}
        assert man["layout_fp"] == layout.fingerprint()
        validate_shards(manifest_mod.checkpoint_dir(str(tmp_path), 1), man)
        names = list(at_save)
        ptrs = {n: scope.find_var(n).to_local().data_ptr() for n in names}
        for n in names:
            scope.find_var(n).to_local().zero_()
        m.restore(main, scope, mesh=mesh, layout=layout)
        for n in names:
            v = scope.find_var(n)
            assert v.to_local().data_ptr() == ptrs[n]
            np.testing.assert_array_equal(v.full_tensor().numpy(), at_save[n])
    fresh = pt.Scope()
    exe.run(pt.default_startup_program(), scope=fresh)
    m.restore(main, fresh, layout=layout)
    for n, b in at_save.items():
        np.testing.assert_array_equal(_persistable_values(main, fresh)[n], b)


# ------------------------------------------------------------ cross-package

def _jax_started():
    loss = _build_mlp(fluid)
    main = fluid.default_main_program()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program(), scope=scope)
    return loss, main, scope, exe


def test_a_jax_checkpoint_restores_into_the_port_bit_equal(tmp_path):
    jloss, jmain, jscope, jexe = _jax_started()
    rs = np.random.RandomState(5)
    for _ in range(3):
        jexe.run(jmain, feed=_feed(rs), fetch_list=[jloss], scope=jscope)
    jax_ckpt.CheckpointManager(str(tmp_path), async_save=False).save(
        jmain, jscope, step=3, epoch_id=0, step_id=4)
    loss, main, scope, exe = _started()
    gen_state = scope.find_var(RNG_STATE_VAR).get_state().clone()
    addrs = {n: scope.find_var(n).data_ptr() for n in _persistable_values(main, scope)}
    man = CheckpointManager(str(tmp_path)).restore(main, scope)
    assert man["trainer"] == {"epoch_id": 0, "step_id": 4}
    got = _persistable_values(main, scope)
    want = {n: np.asarray(jscope.find_var(n)) for n in got}
    assert len(got) == len(man["vars"]) == 21
    for n in got:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        assert scope.find_var(n).data_ptr() == addrs[n]
    # the JAX key is skipped: the port's generator is as it was
    assert torch.equal(scope.find_var(RNG_STATE_VAR).get_state(), gen_state)
    # and both go on training to the same loss
    f = _feed(rs)
    (a,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    (b,) = jexe.run(jmain, feed=f, fetch_list=[jloss], scope=jscope)
    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_a_port_checkpoint_restores_into_the_jax_package_bit_equal(tmp_path):
    loss, main, scope, exe = _started()
    rs = np.random.RandomState(6)
    for _ in range(3):
        exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(main, scope, step=3, epoch_id=1, step_id=2)
    m.close()
    jloss, jmain, jscope, jexe = _jax_started()
    key = jscope.find_var("@RNG_STATE@")
    key_before = None if key is None else np.asarray(jax.random.key_data(key))
    man = jax_ckpt.CheckpointManager(str(tmp_path)).restore(jmain, jscope)
    assert man["trainer"] == {"epoch_id": 1, "step_id": 2}
    want = _persistable_values(main, scope)
    for n, w in want.items():
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), w, err_msg=n)
    if key_before is not None:      # the port's generator is skipped
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jscope.find_var("@RNG_STATE@"))), key_before)
    assert jax_ckpt.validate_shards(manifest_mod.checkpoint_dir(str(tmp_path), 3))["vars"] \
        == len(want)


# ------------------------------------------------------------- restore fit

def test_restore_fit_manifest_only(tmp_path):
    from paddle_tpu_torch.analysis import PredictedOOMError, plan_state_memory
    from paddle_tpu_torch.checkpoint import restore_fit_dir

    _, main, scope, _ = _started(in_dim=64, hidden=32)
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(main, scope, step=1)
    d = manifest_mod.checkpoint_dir(str(tmp_path), 1)
    man = read_manifest(d)
    fit = CheckpointManager.restore_fit(None, man, budget="1GiB")
    assert fit["peak_bytes"] > 0
    with pytest.raises(PredictedOOMError):
        CheckpointManager.restore_fit(None, man, budget=16)
    est_1 = manifest_mod.persistent_device_bytes(man, None, None)
    plan = plan_state_memory(man["vars"])
    assert plan.peak_bytes == est_1["persistent_bytes"]
    assert plan.breakdown == {"persistent": plan.peak_bytes}
    # the directory form reads the embedded program: the full plan
    full = restore_fit_dir(d, budget="1GiB")
    assert full["source"] == "plan_memory" and full["peak_bytes"] >= fit["peak_bytes"]
    with pytest.raises(PredictedOOMError):
        m.restore(main, scope, memory_budget=64)


def test_restore_refuses_shape_drift(tmp_path):
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(main, scope, step=1)
    d = manifest_mod.checkpoint_dir(str(tmp_path), 1)
    man = read_manifest(d)
    name = next(n for n in man["vars"] if n.endswith("w_0"))
    man["vars"][name]["shape"] = [3, 3]
    manifest_mod.write_manifest(d, man)
    with pytest.raises(CheckpointError, match="shape drift"):
        m.restore(main, scope)


# ----------------------------------------------------- trainer integration

def _trainer_parts(steps=8, batch=8):
    def train_func():
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        return layers.mean(layers.square_error_cost(input=pred, label=y))

    def opt_func():
        return pt.optimizer.Adam(learning_rate=0.01)

    def reader():
        rs = np.random.RandomState(7)
        for _ in range(steps):
            xs = rs.rand(batch, 16).astype(np.float32)
            ys = xs.sum(1, keepdims=True).astype(np.float32)
            yield [(x, y) for x, y in zip(xs, ys)]
    return train_func, opt_func, reader


def _trainer(train_func, opt_func, **kw):
    with pt.unique_name.guard():
        return pt.Trainer(train_func=train_func, optimizer_func=opt_func,
                          place=pt.CPUPlace(), **kw)


def test_trainer_auto_save_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    train_func, opt_func, reader = _trainer_parts()
    losses = {}

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent):
            losses[ev.step] = float(np.asarray(ev.metrics[0]))

    t = _trainer(train_func, opt_func,
                 checkpoint=CheckpointConfig(dir=ckpt, step_interval=3, epoch_interval=0))
    t.train(num_epochs=1, event_handler=handler, reader=reader, feed_order=["x", "y"])
    assert len(losses) == 8 and list_steps(ckpt)
    losses2 = {}

    def handler2(ev):
        if isinstance(ev, pt.EndStepEvent):
            losses2[ev.step] = float(np.asarray(ev.metrics[0]))

    t2 = _trainer(train_func, opt_func,
                  checkpoint=CheckpointConfig(dir=ckpt, step_interval=3, epoch_interval=0))
    assert t2._ckpt_state["step_id"] == 7            # saved after step 6
    t2.train(num_epochs=1, event_handler=handler2, reader=reader, feed_order=["x", "y"])
    assert sorted(losses2) == [7]
    assert losses2[7] == losses[7]                   # bit-identical continuation
    with pytest.raises(ValueError, match="not both"):
        _trainer(train_func, opt_func, checkpoint=CheckpointConfig(dir=ckpt),
                 checkpoint_config=pt.CheckpointConfig(checkpoint_dir=str(tmp_path / "old")))


def test_trainer_epoch_interval_saves_at_the_epoch_end(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    train_func, opt_func, reader = _trainer_parts(steps=3)
    t = _trainer(train_func, opt_func, checkpoint=CheckpointConfig(dir=ckpt, epoch_interval=1))
    t.train(num_epochs=2, event_handler=lambda ev: None, reader=reader, feed_order=["x", "y"])
    man = read_manifest(manifest_mod.checkpoint_dir(ckpt, list_steps(ckpt)[-1]))
    assert man["trainer"] == {"epoch_id": 2, "step_id": 0} and man["reason"] == "epoch"
    assert list_steps(ckpt) == [3, 6]


def test_trainer_fetch_timeout_save_and_exit(tmp_path):
    from paddle_tpu_torch.core import staging

    ckpt = str(tmp_path / "ckpt")
    train_func, opt_func, reader = _trainer_parts(steps=10)
    seen = []

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent):
            seen.append(ev.step)
            if ev.step == 3:
                staging._notify_fetch_timeout("test", 0.01)

    n0 = len(CKPT_RECORDS.records())
    t = _trainer(train_func, opt_func,
                 checkpoint=CheckpointConfig(dir=ckpt, step_interval=0, epoch_interval=0,
                                             save_on_fetch_timeout=True))
    t.train(num_epochs=1, event_handler=handler, reader=reader, feed_order=["x", "y"])
    assert seen[-1] == 3
    assert list_steps(ckpt)
    recs = [r for r in CKPT_RECORDS.records()[n0:] if r.get("kind") == "save"]
    assert recs and recs[-1]["reason"] == "fetch-timeout"
    man = read_manifest(manifest_mod.checkpoint_dir(ckpt, list_steps(ckpt)[-1]))
    assert man["trainer"]["step_id"] == 4


def _diverging_parts(steps):
    def train_func():
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        return layers.mean(layers.square_error_cost(input=pred, label=y))

    def opt_func():
        return pt.optimizer.SGD(learning_rate=0.1)

    def reader():
        rs = np.random.RandomState(3)
        for i in range(steps):
            xs = rs.rand(8, 8).astype(np.float32)
            if i == 5:
                xs[0, 0] = np.nan          # poisons the loss and the update
            ys = np.nansum(xs, 1, keepdims=True).astype(np.float32)
            yield [(x, y) for x, y in zip(xs, ys)]
    return train_func, opt_func, reader


def test_trainer_rollback_on_divergence_in_place(tmp_path):
    """A non-finite sentinel trip rolls back to the last good checkpoint:
    the parameters are finite again, copied into the same tensors, and no
    new cache entry is built."""
    telemetry.reset_scope("checkpoint")
    from paddle_tpu_torch.health import HealthConfig
    train_func, opt_func, reader = _diverging_parts(12)
    t = _trainer(train_func, opt_func, health=HealthConfig(localize=False),
                 checkpoint=CheckpointConfig(dir=str(tmp_path / "ckpt"), step_interval=2,
                                             epoch_interval=0, rollback_on_divergence=True))
    addrs = {n: t.scope.find_var(n).data_ptr()
             for n in _persistable_values(t._step_program, t.scope)}
    compiles = []
    t.train(num_epochs=1, reader=reader, feed_order=["x", "y"],
            event_handler=lambda ev: compiles.append(t.exe.compile_count)
            if isinstance(ev, pt.EndStepEvent) else None)
    snap = telemetry.REGISTRY.snapshot(scope="checkpoint")
    assert snap["rollbacks"] >= 1, snap
    for name, val in _persistable_values(t._step_program, t.scope).items():
        assert np.isfinite(val).all(), name
        assert t.scope.find_var(name).data_ptr() == addrs[name], name
    assert len(set(compiles)) == 1, compiles


def test_trainer_rollback_waits_for_starved_writer(tmp_path, monkeypatch):
    telemetry.reset_scope("checkpoint")
    from paddle_tpu_torch.checkpoint import manager as mgr_mod
    from paddle_tpu_torch.health import HealthConfig
    orig_write = mgr_mod.CheckpointManager._write

    def starved_write(self, job):
        if not (isinstance(job.meta, dict) and job.meta.get("__barrier__")):
            time.sleep(1.0)
        return orig_write(self, job)

    monkeypatch.setattr(mgr_mod.CheckpointManager, "_write", starved_write)
    train_func, opt_func, reader = _diverging_parts(8)
    t = _trainer(train_func, opt_func, health=HealthConfig(localize=False),
                 checkpoint=CheckpointConfig(dir=str(tmp_path / "ckpt"), step_interval=2,
                                             epoch_interval=0, rollback_on_divergence=True))
    t.train(num_epochs=1, event_handler=lambda ev: None, reader=reader, feed_order=["x", "y"])
    snap = telemetry.REGISTRY.snapshot(scope="checkpoint")
    assert snap["rollbacks"] >= 1, snap
    for name, val in _persistable_values(t._step_program, t.scope).items():
        assert np.isfinite(val).all(), name


# -------------------------------------------------------------- io.py shim

def test_io_persistables_manifest_shim_roundtrip(tmp_path):
    loss, main, scope, exe = _started()
    rs = np.random.RandomState(2)
    exe.run(main, feed=_feed(rs), fetch_list=[loss], scope=scope)
    d = str(tmp_path / "model")
    with pt.scope_guard(scope):
        pt.io.save_persistables(exe, d, main)
    assert os.path.isfile(os.path.join(d, "__params__.npz"))
    man = read_manifest(d)
    assert man["format"] == manifest_mod.FLAT_FORMAT
    validate_shards(d, man)
    before = _persistable_values(main, scope)
    scope2 = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope2)
    with pt.scope_guard(scope2):
        pt.io.load_persistables(exe, d, main)
    for name, b in before.items():
        np.testing.assert_array_equal(scope2.find_var(name).numpy(), b)
    os.remove(os.path.join(d, manifest_mod.MANIFEST_NAME))
    scope3 = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope3)
    with pt.scope_guard(scope3):
        pt.io.load_persistables(exe, d, main)
    for name, b in before.items():
        np.testing.assert_array_equal(scope3.find_var(name).numpy(), b)


# ------------------------------------------------------------ the tools

def test_ckpt_tool_cli_over_the_ports_directory(tmp_path):
    _, main, scope, _ = _started()
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(main, scope, step=5, epoch_id=0, step_id=6)

    def run_tool(*args):
        return subprocess.run([sys.executable, os.path.join(REPO, "tools", "ckpt_tool.py"),
                               *args], capture_output=True, text=True, timeout=120)

    p = run_tool(str(tmp_path), "--validate", "--json")
    assert p.returncode == 0, p.stdout + p.stderr
    out = json.loads(p.stdout)
    assert out["step"] == 5 and out["valid"] is True
    assert out["trainer"] == {"epoch_id": 0, "step_id": 6}
    p = run_tool(str(tmp_path), "--fit", "--budget", "1GiB", "--json")
    assert p.returncode == 0, p.stdout + p.stderr
    fit = json.loads(p.stdout)["fit"]
    assert fit["fits"] is True and fit["source"] == "plan_memory"
    p = run_tool(str(tmp_path), "--fit", "--budget", "64", "--json")
    assert p.returncode == 2, p.stdout + p.stderr
    assert json.loads(p.stdout)["fit"]["code"] == "M501"
    d = manifest_mod.checkpoint_dir(str(tmp_path), 5)
    os.remove(os.path.join(d, manifest_mod.shard_filename(0)))
    p = run_tool(d, "--validate", "--json")
    assert p.returncode == 1 and json.loads(p.stdout)["valid"] is False


def test_stats_checkpoint_section_over_the_ports_records(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "tele"))
    CKPT_RECORDS.reopen()
    try:
        _, main, scope, _ = _started()
        m = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
        m.save(main, scope, step=4)
        m.save(main, scope, step=8)
        m.wait()
        m.restore(main, scope, step=8)
        m.restore(main, scope, step=4, reason="rollback")
        m.close()
    finally:
        monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR")
        CKPT_RECORDS.reopen()
    assert glob.glob(str(tmp_path / "tele" / "checkpoint_*.jsonl"))
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "stats.py"),
                        str(tmp_path / "tele"), "--json"], capture_output=True, text=True,
                       timeout=60)
    ck = json.loads(p.stdout)["checkpoint"]
    assert ck["saves"] == 2 and ck["restores"] == 1
    assert ck["rollbacks"] == 1 and ck["last_step"] == 8
    assert ck["bytes_written"] > 0


# --------------------------------------------- kill/resume subprocess proof

def test_kill_mid_epoch_resume_bit_identical(tmp_path):
    """SIGKILL a training process mid-epoch after an async checkpoint
    committed; a fresh process resumes and its losses are bit-identical to
    an uninterrupted run's (``paddle_tpu_torch/tools/ckpt_smoke.py``, on
    the CPU)."""
    env = dict(os.environ)
    env["PADDLE_TPU_TELEMETRY_DIR"] = str(tmp_path / "tel")
    p = subprocess.run([sys.executable,
                        os.path.join(REPO, "paddle_tpu_torch", "tools", "ckpt_smoke.py"),
                        "--cpu", str(tmp_path / "work")],
                       capture_output=True, text=True, env=env, timeout=420)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["ckpt_smoke"] == "PASS" and summary["place"] == "cpu"
    assert summary["resumed_steps"] > 0 and summary["checkpoint_validated"] is True
    assert glob.glob(str(tmp_path / "tel" / "checkpoint_*.jsonl"))
