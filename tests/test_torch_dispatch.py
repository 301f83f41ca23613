"""The port's elastic data dispatch (``paddle_tpu_torch/dispatch``) and
``Trainer(dispatch=)`` on the CPU, held against the JAX package's.

- The lease state machine: one scripted sequence of calls (leases, stale
  finishes, expiry with its backoff schedule, voluntary failures up to the
  quarantine, a worker reap, epoch resets) drives a queue of each package
  under a ``FakeClock``; every reply and the final snapshot are equal.
- Snapshots written by one package load in the other (and a torn one is
  ignored by both).
- The TCP master and client end to end: two workers, lease expiry onto a
  survivor, heartbeats, an injected finish failure, a master restart
  mid-epoch, ``reap_worker``, the bounded reconnect, and a client of each
  package against a master of the other.
- RecordIO chunk tasks: ``chunk_offsets`` / ``read_chunk`` /
  ``make_recordio_tasks`` equal to the JAX package's on one file.
- ``Trainer(dispatch=DispatchConfig(...))`` on a small DeepFM
  (``vocab_sizes=[50, 30, 20]``, ``embed_dim`` 4, no dropout) fed from the
  same RecordIO tasks as the JAX ``Trainer``: the losses within
  ``LOSS_RTOL`` and the parameters within ``PARAM_ATOL``.
- The port's ``dispatch_<pid>.jsonl`` read by ``tools/stats.py`` and
  ``tools/health_report.py`` unedited, and the chaos proof
  (``paddle_tpu_torch/tools/dispatch_smoke.py --quick``) in a subprocess.

Every socket wait has a timeout and every master is closed in a ``with``
block or a ``finally``.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import dispatch as jd
from paddle_tpu import faults as jax_faults
from paddle_tpu_torch import dispatch as td
from paddle_tpu_torch import faults, telemetry

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# the small DeepFM's trainer parity: losses are float32 sums in other
# orders (XLA against torch); each Adam update differs from the jitted JAX
# one in the last bits (tests/test_torch_faults.py), carried over 4 steps
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clean_faults_and_scope():
    faults.reset()
    jax_faults.reset()
    telemetry.reset_scope(td.DISPATCH_SCOPE)
    yield
    faults.reset()
    jax_faults.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _queues(n_tasks, **kw):
    """A queue of each package over the same range tasks, each on its own
    fake clock."""
    kw = dict(dict(lease_timeout_s=10.0, max_failures=3, backoff_base_s=1.0,
                   backoff_mult=2.0), **kw)
    out = []
    for mod in (jd, td):
        clock = FakeClock()
        out.append((mod.TaskQueue(mod.make_range_tasks(n_tasks * 8, 8), clock=clock, **kw),
                    clock))
    return out


def _script_lifecycle(q, clock):
    out = [q.get_task("w0"), q.get_task("w1"), q.counts()]
    a, b = out[0], out[1]
    out.append(q.finish(a["task"]["task_id"], a["lease_id"], "w1"))       # wrong worker
    out.append(q.finish(a["task"]["task_id"], a["lease_id"] + 7, "w0"))   # wrong lease
    clock.advance(4.0)
    out.append(q.renew(b["task"]["task_id"], b["lease_id"], "w1"))
    out.append(q.finish(a["task"]["task_id"], a["lease_id"], "w0"))
    out.append(q.finish(b["task"]["task_id"], b["lease_id"], "w1"))
    out.append(q.get_task("w0"))
    out += [q.done, dict(q.counters)]
    return out


def _script_expiry_backoff(q, clock):
    """The same task expires three times: backoff 1 s, then 2 s, then it is
    quarantined; a late finish from the first holder is stale."""
    out = []
    first = q.get_task("w0")
    out.append(first)
    for _ in range(3):
        clock.advance(10.5)
        out.append(q.reap_expired())
        out.append(q.get_task("w1"))       # backing off, or the retry
        clock.advance(2.5)
        out.append(q.get_task("w1"))
    out.append(q.finish(first["task"]["task_id"], first["lease_id"], "w0"))
    out += [q.counts(), [t.task_id for t in q.dead_tasks()], dict(q.counters)]
    return out


def _script_fail_reap_epoch(q, clock):
    out = []
    a = q.get_task("w0")
    out.append(q.fail(a["task"]["task_id"], a["lease_id"], "w0", error="bad chunk"))
    out.append(q.get_task("w1"))                # task 0 backs off: task 1
    out.append(q.begin_epoch(1))                # not done: wait
    out.append(q.reap_worker("w1"))             # requeued at once, no backoff
    out.append(q.get_task("w2"))
    clock.advance(1.5)
    while True:
        t = q.get_task("w2")
        out.append(t)
        if t["task"] is None:
            break
        out.append(q.finish(t["task"]["task_id"], t["lease_id"], "w2"))
    out.append(q.begin_epoch(1))
    out.append(q.begin_epoch(1))
    out.append(q.counts())
    with pytest.raises(Exception, match="cannot begin epoch 3"):
        q.begin_epoch(3)
    out.append(q.to_snapshot())
    return out


@pytest.mark.parametrize("script", [_script_lifecycle, _script_expiry_backoff,
                                    _script_fail_reap_epoch])
def test_queue_replies_and_snapshot_equal_to_jax(script):
    (jq, jc), (tq, tc) = _queues(3)
    want, got = script(jq, jc), script(tq, tc)
    assert got == want
    assert tq.to_snapshot() == jq.to_snapshot()
    assert tq.done == jq.done


def test_backoff_schedule_and_dead_cap():
    ((_, _), (q, clock)) = _queues(1, max_failures=4, backoff_cap_s=3.0)
    assert [q._backoff(k) for k in (1, 2, 3, 4, 5)] == [1.0, 2.0, 3.0, 3.0, 3.0]
    for k in range(4):
        t = q.get_task("w0")
        assert t["task"] is not None, k
        clock.advance(10.5)
        (r,) = q.reap_expired()
        clock.advance(3.0)
    assert r["state"] == td.DEAD and q.done and q.counters["dead"] == 1
    assert q.get_task("w0") == {"task": None, "done": True, "retry_after": None}


@pytest.mark.parametrize("writer,reader", [(jd, td), (td, jd)])
def test_snapshots_load_across_packages(tmp_path, writer, reader):
    ((jq, jc), (tq, tc)) = _queues(3)
    q = jq if writer is jd else tq
    lease = q.get_task("w0")
    q.finish(lease["task"]["task_id"], lease["lease_id"], "w0")
    q.get_task("w1")
    d = str(tmp_path / "snap")
    for seq in (1, 2, 3):
        writer.save_snapshot(d, q.to_snapshot(), seq=seq, keep=2)
    snap = reader.load_snapshot(d)
    assert snap["_seq"] == 3
    assert sorted(os.listdir(d)) == ["manifest.json", "snapshot_2.json", "snapshot_3.json"]
    back = reader.TaskQueue.from_snapshot(snap, clock=FakeClock())
    assert back.to_snapshot() == q.to_snapshot()
    assert back.counts() == {"pending": 1, "leased": 1, "finished": 1, "dead": 0, "total": 3}


@pytest.mark.parametrize("tear", ["no_manifest", "garbled_manifest", "missing_target",
                                  "foreign_format"])
def test_a_torn_snapshot_is_none_in_both(tmp_path, tear):
    d = tmp_path / "snap"
    ((q, _), _) = _queues(2)
    td.save_snapshot(str(d), q.to_snapshot(), seq=1)
    if tear == "no_manifest":
        (d / "manifest.json").unlink()
    elif tear == "garbled_manifest":
        (d / "manifest.json").write_text('{"seq": 1, "fi')
    elif tear == "missing_target":
        (d / "snapshot_1.json").unlink()
    else:
        (d / "snapshot_1.json").write_text(json.dumps({"format": "other"}))
    assert td.load_snapshot(str(d)) is None and jd.load_snapshot(str(d)) is None


# --------------------------------------------------------- master + client

def _range_reader(mod):
    return mod.range_task_reader(lambda i: i)


def test_master_client_end_to_end(tmp_path):
    addr_file = str(tmp_path / "addr")
    with td.DispatchMaster(td.make_range_tasks(48, 8), addr_file=addr_file,
                           snapshot_dir=str(tmp_path / "snap"), lease_timeout_s=5.0) as m:
        seen = {}

        def run(worker):
            client = td.DispatchClient(addr_file=addr_file, worker=worker, timeout_s=5.0)
            reader = td.DispatchReader(_range_reader(td), client)
            seen[worker] = (list(reader()), reader.consumed)
            client.close()

        threads = [threading.Thread(target=run, args=(f"w{i}",)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(seen["w0"][0] + seen["w1"][0]) == list(range(48))
        assert sorted(seen["w0"][1] + seen["w1"][1]) == list(range(6))
        st = m.stats()
        assert st["done"] and st["counters"]["finished"] == 6 and st["counters"]["dead"] == 0
        snap = telemetry.REGISTRY.snapshot(scope="dispatch")
        assert snap["tasks_finished"] == snap["tasks_served"] == 6
        assert snap["task_latency_s"]["count"] == 6
    assert td.load_snapshot(str(tmp_path / "snap"))["counters"]["finished"] == 6


def test_lease_expiry_reserves_to_a_survivor():
    with td.DispatchMaster(td.make_range_tasks(8, 8), lease_timeout_s=0.3,
                           sweep_interval_s=0.05, backoff_base_s=0.0) as m:
        ca = td.DispatchClient(m.addr, worker="wA", timeout_s=5.0)
        cb = td.DispatchClient(m.addr, worker="wB", timeout_s=5.0)
        try:
            ta = ca.get_task()
            t0 = time.monotonic()
            tb = cb.get_task()            # waits out the expiry, then leases
            assert tb["task_id"] == ta["task_id"] and time.monotonic() - t0 < 10
            late = ca.task_finished(ta)
            assert late.get("stale") and not late.get("done")
            assert cb.task_finished(tb)["done"]
            c = m.stats()["counters"]
            assert (c["finished"], c["lease_expiry"], c["stale_finish"]) == (1, 1, 1)
        finally:
            ca.close()
            cb.close()


def test_heartbeat_keeps_a_slow_task_alive():
    with td.DispatchMaster(td.make_range_tasks(4, 4), lease_timeout_s=0.2,
                           sweep_interval_s=0.03) as m:
        client = td.DispatchClient(m.addr, worker="w0", timeout_s=5.0)

        def slow_reader(payload):
            for i in range(int(payload["count"])):
                time.sleep(0.12)          # ~0.5 s in all, over two lease lifetimes
                yield i
        try:
            assert list(td.DispatchReader(slow_reader, client)()) == [0, 1, 2, 3]
            c = m.stats()["counters"]
            assert c["finished"] == 1 and c["lease_expiry"] == 0
        finally:
            client.close()


def test_an_injected_finish_failure_requeues_then_retires_once():
    faults.install("fail@dispatch.finish:n=1")
    with td.DispatchMaster(td.make_range_tasks(8, 8), lease_timeout_s=0.3,
                           sweep_interval_s=0.05, backoff_base_s=0.0) as m:
        client = td.DispatchClient(m.addr, worker="w0", timeout_s=5.0)
        try:
            reader = td.DispatchReader(_range_reader(td), client)
            got = list(reader())
            assert sorted(set(got)) == list(range(8)) and len(got) == 16
            c = m.stats()["counters"]
            assert (c["finished"], c["served"], c["lease_expiry"]) == (1, 2, 1)
            assert reader.tasks_finished == 1 and reader.consumed == [0, 0]
        finally:
            client.close()


def test_master_restart_recovers_mid_epoch(tmp_path):
    addr_file, snap_dir = str(tmp_path / "addr"), str(tmp_path / "snap")
    m1 = td.DispatchMaster(td.make_range_tasks(40, 8), addr_file=addr_file,
                           snapshot_dir=snap_dir, lease_timeout_s=5.0)
    client = td.DispatchClient(addr_file=addr_file, worker="w0", retry_window_s=20.0,
                               timeout_s=5.0)
    m2 = None
    try:
        it = td.DispatchReader(_range_reader(td), client)()
        got = [next(it) for _ in range(16)]
        m1.close()
        m2 = td.DispatchMaster(snapshot_dir=snap_dir, addr_file=addr_file, lease_timeout_s=5.0)
        got += list(it)
        assert sorted(got) == list(range(40))
        st = m2.stats()
        assert st["counters"]["finished"] == 5 and st["metrics"]["recovers"] == 1
    finally:
        m1.close()
        if m2 is not None:
            m2.close()
        client.close()


def test_reap_worker_reserves_a_dead_ranks_lease_at_once():
    with td.DispatchMaster(td.make_range_tasks(16, 8), lease_timeout_s=30.0,
                           sweep_interval_s=5.0) as m:
        dead = td.DispatchClient(m.addr, worker="rank1", timeout_s=5.0)
        t = dead.get_task()
        dead.close()
        survivor = td.DispatchClient(m.addr, worker="rank0", timeout_s=5.0)
        restarted = td.DispatchClient(m.addr, worker="rank1", timeout_s=5.0)
        try:
            assert restarted.reap_worker() == [t["task_id"]]
            assert survivor.get_task()["task_id"] == t["task_id"]
            assert m.stats()["counters"]["worker_reaps"] == 1
        finally:
            survivor.close()
            restarted.close()


def test_bounded_reconnect_raises_master_unreachable():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    client = td.DispatchClient(f"127.0.0.1:{port}", worker="w0", timeout_s=0.2,
                               retry_window_s=30.0, retry_backoff_s=0.01, max_reconnect=3)
    t0 = time.monotonic()
    with pytest.raises(td.MasterUnreachable) as ei:
        client.ping()
    assert time.monotonic() - t0 < 10.0 and ei.value.attempts == 3
    assert isinstance(ei.value, td.DispatchUnavailable)
    client.close()
    cfg = td.DispatchConfig(addr=f"127.0.0.1:{port}", task_reader=lambda payload: [],
                            worker="w1", timeout_s=0.2, total_deadline_s=0.05)
    c = cfg.make_client()
    with pytest.raises(td.MasterUnreachable) as ei:
        c.ping()
    assert ei.value.elapsed_s >= 0.05
    c.close()


@pytest.mark.parametrize("master_mod,client_mod", [(jd, td), (td, jd)])
def test_a_client_of_one_package_against_the_others_master(master_mod, client_mod):
    """The line-JSON wire protocol across the packages: leases, a renew, a
    stale finish, a reap and the epoch, with equal accounting."""
    with master_mod.DispatchMaster(master_mod.make_range_tasks(24, 8), lease_timeout_s=5.0,
                                   sweep_interval_s=1.0) as m:
        a = client_mod.DispatchClient(m.addr, worker="wa", timeout_s=5.0)
        b = client_mod.DispatchClient(m.addr, worker="wb", timeout_s=5.0)
        try:
            assert a.ping()["ok"]
            held = a.get_task()
            assert a.renew(held) is True
            assert b.reap_worker("wa") == [held["task_id"]]
            assert a.task_finished(held).get("stale")
            got = list(client_mod.DispatchReader(_range_reader(client_mod), b)())
            assert sorted(got) == list(range(24))
            st = b.stats()
            assert st["done"] and st["counters"]["finished"] == 3
            assert st["counters"]["worker_reaps"] == 1
            assert b.begin_epoch(1) == 1
        finally:
            a.close()
            b.close()


def test_recordio_chunk_tasks_equal_to_jax(tmp_path):
    from paddle_tpu_torch import recordio
    paths = []
    for k in range(2):
        p = str(tmp_path / f"part-{k}.rio")
        with recordio.Writer(p, max_chunk_bytes=5 * 12) as w:
            for i in range(23):
                w.write((100 * k + i).to_bytes(8, "little"))
        paths.append(p)
    for p in paths:
        assert td.chunk_offsets(p) == jd.chunk_offsets(p)
        for ch in td.chunk_offsets(p):
            assert list(td.read_chunk(p, ch["offset"])) == list(jd.read_chunk(p, ch["offset"]))
    tasks = td.make_recordio_tasks(paths, chunks_per_task=2)
    assert tasks == jd.make_recordio_tasks(paths, chunks_per_task=2) and len(tasks) == 6
    decode = lambda rec: int.from_bytes(rec, "little")  # noqa: E731
    got = [x for t in tasks for x in td.recordio_task_reader(decode)(t)]
    assert got == [100 * k + i for k in range(2) for i in range(23)]
    with pytest.raises(ValueError):
        td.make_recordio_tasks(paths, chunks_per_task=0)


# ---------------------------------------------------- Trainer(dispatch=)

VOCABS, EMBED, HIDDEN, N_DENSE, BATCH = [50, 30, 20], 4, (8, 8), 3, 16
FM_ORDER = [f"C{i}" for i in range(len(VOCABS))] + ["dense", "label"]


def _fm_train_func(pkg, deepfm_mod):
    def train_func():
        ids = [pkg.layers.data(name=f"C{i}", shape=[1], dtype="int64") for i in range(3)]
        dense = pkg.layers.data(name="dense", shape=[N_DENSE], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="float32")
        logits = deepfm_mod.deepfm(ids, dense, VOCABS, embed_dim=EMBED, hidden=HIDDEN,
                                   is_test=True)
        return pkg.layers.mean(pkg.layers.sigmoid_cross_entropy_with_logits(x=logits,
                                                                            label=label))
    return train_func


def _fm_shards(tmp_path, n_shards=2, chunks=2):
    """RecordIO shards of the small DeepFM's samples, one chunk a batch:
    each record the C-order bytes of 3 int64 ids, 3 float32 dense features
    and one int64 label."""
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.models.deepfm import synthetic_feed
    rec_bytes = 3 * 8 + N_DENSE * 4 + 8
    paths, k = [], 0
    for s in range(n_shards):
        p = str(tmp_path / f"fm-{s}.rio")
        with recordio.Writer(p, max_chunk_bytes=BATCH * (rec_bytes + 4)) as w:
            for _ in range(chunks):
                f = synthetic_feed(100 + k, BATCH, vocab_sizes=VOCABS, num_dense=N_DENSE)
                k += 1
                ids = np.concatenate([f[f"C{i}"] for i in range(3)], axis=1)
                for r in range(BATCH):
                    w.write(ids[r].tobytes() + f["dense"][r].tobytes()
                            + f["label"][r].astype(np.int64).tobytes())
        paths.append(p)
    return paths


def _fm_decode(rec):
    ids = np.frombuffer(rec, np.int64, 3, 0)
    return (*ids.reshape(3, 1), np.frombuffer(rec, np.float32, N_DENSE, 24),
            np.frombuffer(rec, np.int64, 1, 24 + 4 * N_DENSE).astype(np.float32))


def _batch_task_reader(mod):
    def task_reader(payload):
        for ch in payload["chunks"]:
            yield [_fm_decode(r) for r in mod.read_chunk(payload["path"], ch["offset"])]
    return task_reader


def test_trainer_dispatch_against_the_jax_trainer(tmp_path):
    """Both Trainers read the same RecordIO tasks through their own master,
    from the same start (the JAX startup's state carried into the port
    trainer's tensors); a dead rank's lease is reaped on construction."""
    from paddle_tpu.models import deepfm as jax_deepfm
    from paddle_tpu_torch.models import deepfm as pt_deepfm
    paths = _fm_shards(tmp_path)
    runs = {}
    for name, mod, pkg, deepfm_mod in (("jax", jd, fluid, jax_deepfm),
                                       ("pt", td, pt, pt_deepfm)):
        with mod.DispatchMaster(mod.make_recordio_tasks(paths), lease_timeout_s=10.0) as m:
            dead = mod.DispatchClient(m.addr, worker="rank0", timeout_s=5.0)
            assert dead.get_task()["task_id"] == 0       # the dead rank's lease
            dead.close()
            cfg = mod.DispatchConfig(addr=m.addr, task_reader=_batch_task_reader(mod),
                                     worker="rank0", timeout_s=5.0)
            kw = {"place": pt.CPUPlace()} if pkg is pt else {}
            with pkg.unique_name.guard():
                trainer = pkg.Trainer(train_func=_fm_train_func(pkg, deepfm_mod),
                                      optimizer_func=lambda: pkg.optimizer.Adam(1e-2),
                                      dispatch=cfg, **kw)
            if pkg is pt:
                for n, a in runs["jax"]["start"].items():
                    trainer.scope.find_var(n).copy_(torch.from_numpy(a))
            else:
                runs["jax"] = {"start": {
                    v.name: np.array(trainer.scope.find_var(v.name))
                    for v in trainer.train_program.list_vars() if v.persistable}}
            losses = []
            trainer.train(num_epochs=1, reader=None, feed_order=FM_ORDER, event_handler=lambda ev:
                          losses.append(float(np.asarray(ev.metrics[0])))
                          if type(ev).__name__ == "EndStepEvent" else None)
            st = m.stats()
            assert st["done"] and st["counters"]["finished"] == 4, st
            assert st["counters"]["worker_reaps"] == 1 and st["counters"]["served"] == 5
            runs.setdefault(name, {}).update(losses=losses, reader=trainer.dispatch_reader,
                                             params={n: np.asarray(trainer.scope.find_var(n))
                                                     for n in runs["jax"]["start"]})
    j, t = runs["jax"], runs["pt"]
    assert len(t["losses"]) == 4 and t["reader"].tasks_finished == 4
    assert t["reader"].consumed == [0, 1, 2, 3]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
    for n, a in j["params"].items():
        np.testing.assert_allclose(t["params"][n], a, atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_train_without_a_reader_or_dispatch_raises_as_jax_does():
    with pt.unique_name.guard():
        t = pt.Trainer(train_func=_fm_train_func(pt, __import__(
            "paddle_tpu_torch.models.deepfm", fromlist=["deepfm"])),
            optimizer_func=lambda: pt.optimizer.SGD(0.1), place=pt.CPUPlace())
    with pytest.raises(ValueError, match="dispatch"):
        t.train(num_epochs=1, event_handler=lambda ev: None, reader=None, feed_order=FM_ORDER)


def test_a_dispatch_config_needs_an_address_and_a_task_reader():
    for mod in (jd, td):
        with pytest.raises(ValueError, match="addr"):
            mod.DispatchConfig(task_reader=lambda p: [])
        with pytest.raises(ValueError, match="task_reader"):
            mod.DispatchConfig(addr="127.0.0.1:1")


# -------------------------------------------------------------- the tools

def test_stats_and_health_report_read_the_ports_dispatch_traces(tmp_path, monkeypatch):
    """A port master's dispatch_<pid>.jsonl (a served, expired, requeued,
    dead and finished task) read by the JAX package's tools unedited."""
    tel = tmp_path / "tel"
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tel))
    with td.DispatchMaster(td.make_range_tasks(16, 8), lease_timeout_s=0.2,
                           sweep_interval_s=0.03, max_failures=1) as m:
        w0 = td.DispatchClient(m.addr, worker="w0", timeout_s=5.0)
        try:
            w0.get_task()                 # expires: quarantined (max_failures 1)
            deadline = time.monotonic() + 10
            while m.stats()["counters"]["dead"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            assert list(td.DispatchReader(_range_reader(td), w0)()) == list(range(8, 16))
        finally:
            w0.close()
    files = sorted(tel.glob("dispatch_*.jsonl"))
    assert files, list(tel.iterdir())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, str(REPO / "tools" / "stats.py"), str(tel), "--json"],
                       capture_output=True, text=True, env=env, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
    d = json.loads(p.stdout)["dispatch"]
    assert d["events"]["finished"] == 1 and d["events"]["served"] == 2
    assert d["dead_tasks"] == [0]
    p = subprocess.run([sys.executable, str(REPO / "tools" / "health_report.py"), str(tel),
                        "--json"], capture_output=True, text=True, env=env, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
    rep = json.loads(p.stdout)["dispatch"]
    assert rep["workers"]["w0"]["finished"] == 1 and rep["dead_tasks"] == [0]


def test_quick_chaos_subprocess(tmp_path):
    """The port's chaos proof: two worker subprocesses over RecordIO chunk
    tasks, one killed mid-lease by fault injection, the master killed and
    restarted mid-epoch: every task retired exactly once."""
    env = dict(os.environ, PYTHONPATH=str(REPO), PADDLE_TPU_TELEMETRY_DIR=str(tmp_path / "tel"))
    p = subprocess.run([sys.executable, str(REPO / "paddle_tpu_torch" / "tools" /
                                            "dispatch_smoke.py"), "--quick",
                        str(tmp_path / "work")],
                       capture_output=True, text=True, env=env, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["dispatch_smoke"] == "PASS" and out["mode"] == "quick"
    assert out["counters"]["finished"] == out["tasks"] and out["counters"]["dead"] == 0
    assert out["counters"]["lease_expiry"] >= 1 and sum(out["scanned"].values()) == 96
