"""The port's training flight recorder (``paddle_tpu_torch/health.py`` and
``Executor(sentinels=...)``) against the JAX package's, on the CPU.

The ``_faulty_train_func`` MLP of ``tests/test_health.py`` (``log(trig)``
is 0 for the normal feed and NaN for ``trig=-1``) is built by both
packages from one function (so the ops' callsites are the same lines),
the JAX startup's parameters carried into the port's scope
(``params_from_numpy``); each package runs a clean and a tripping step
with its monitor attached.  The sentinel's mask must be equal bit for bit
and the four scalars within ``SCALAR_RTOL``; the localization must name
the same op index, type (``log``) and callsite.  Then the divergence
detector on one series, sentinels off (no extra outputs) and toggled (a
new cache entry), empty groups, a donated feed still localized, the
Trainer's records (the JAX Trainer's keys; ``tools/health_report.py`` on
the port's directory) and the fetch-timeout event."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import health as jax_health
from paddle_tpu_torch import health
from paddle_tpu_torch.core import staging

from _torch_fresh import _fresh_port_programs  # noqa: F401
from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the norms: XLA sums each tensor's squares, the port squares each
# tensor's norm (torch._foreach_norm); 1e-7 apart on these steps
SCALAR_RTOL = 1e-5


def _faulty_train_func(pkg):
    def train_func():
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        trig = pkg.layers.data(name="trig", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
        probe = pkg.layers.log(trig)                    # the planted numerics fault
        return loss + 1e-9 * pkg.layers.mean(probe)
    return train_func


def _optimizer(pkg, name):
    return pkg.optimizer.SGD(learning_rate=0.1) if name == "sgd" else \
        pkg.optimizer.Adam(learning_rate=0.01)


def _build(pkg, opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = _faulty_train_func(pkg)()
        _optimizer(pkg, opt).minimize(loss)
    return main, startup, loss


def _feed(rs, t):
    return {"x": rs.rand(8, 8).astype(np.float32), "y": rs.rand(8, 1).astype(np.float32),
            "trig": np.full((8, 1), t, np.float32)}


class _Tap:
    """A health hook that keeps each step's sentinel values as numpy and
    parks them with the monitor."""

    def __init__(self, monitor):
        self.monitor, self.values = monitor, []

    def __call__(self, **kw):
        self.values.append([np.asarray(v) for v in kw["values"]])
        self.monitor.on_step(**kw)


def _two_steps(opt):
    """Both packages: the clean step then the tripping one; returns the
    sentinel values and the records of each."""
    jm, js, jl = _build(fluid, opt)
    pm, ps, pl = _build(pt, opt)
    jscope = fluid.Scope()
    fluid.Executor().run(js, scope=jscope)
    pscope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(ps, scope=pscope)
    pt.params_from_numpy({v.name: np.asarray(jscope.find_var(v.name))
                          for v in jm.list_vars() if v.persistable}, pscope, "cpu")
    out = {}
    for name, exe, mod, main, loss, scope in (
            ("jax", fluid.Executor(sentinels=True), jax_health, jm, jl, jscope),
            ("port", pt.Executor(pt.CPUPlace(), sentinels=True), health, pm, pl, pscope)):
        mon = mod.HealthMonitor()
        mon.attach(exe)
        tap = _Tap(mon)
        exe._health_hook = tap
        n0 = len(mod.HEALTH_RECORDS.records())
        rs = np.random.RandomState(2)
        for t in (1.0, -1.0):
            exe.run(main, feed=_feed(rs, t), fetch_list=[loss], scope=scope, sync=False)
        assert mon.flush() == 2
        out[name] = (tap.values, mod.HEALTH_RECORDS.records()[n0:])
    return out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sentinel_mask_and_scalars_equal_the_jax_packages(opt):
    out = _two_steps(opt)
    (jv, jrecs), (pv, precs) = out["jax"], out["port"]
    assert len(jv) == len(pv) == 2
    for step, (j, p) in enumerate(zip(jv, pv)):
        np.testing.assert_array_equal(p[0].astype(np.uint32), j[0].astype(np.uint32))
        for a, b in zip(p[1:], j[1:]):
            if np.isnan(b):
                assert np.isnan(a), (step, a, b)
            else:
                assert abs(float(a) - float(b)) <= SCALAR_RTOL * abs(float(b)), (step, a, b)
    assert [int(v[0][0]) for v in pv] == [0, 1]     # clean, then the loss bit
    keys = lambda recs: [sorted(r) for r in recs]
    assert keys(precs) == keys(jrecs)
    steps = [r for r in precs if r["kind"] == "step"]
    assert [r["ok"] for r in steps] == [True, False]
    assert steps[0]["grad_norm"] > 0 and steps[0]["update_ratio"] > 0
    assert steps[0]["rank"] == 0 and steps[0]["pid"] == os.getpid()


def test_localization_equals_the_jax_packages():
    out = _two_steps("sgd")
    (_, jrecs), (_, precs) = out["jax"], out["port"]
    jtrip = [r for r in jrecs if r.get("event") == "non-finite"]
    ptrip = [r for r in precs if r.get("event") == "non-finite"]
    assert len(jtrip) == len(ptrip) == 1
    jl, pl = jtrip[0]["localization"], ptrip[0]["localization"]
    assert pl["op_type"] == "log"
    for k in ("op_index", "op_type", "callsite", "bad_outputs", "probes", "ops_replayed"):
        assert pl[k] == jl[k], k
    assert "test_torch_health.py" in pl["callsite"]
    assert ptrip[0]["bad_vars"] == jtrip[0]["bad_vars"]


def _two_bad_ops(pkg):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    bad1 = pkg.layers.log(x)                       # log(0) = -inf (first)
    bad2 = pkg.layers.sqrt(x - 1.0)                # sqrt(-1) = nan (second)
    pkg.layers.mean(bad1 + bad2)


def test_localize_names_the_first_of_two_bad_ops_as_the_jax_package():
    _two_bad_ops(pt)
    _two_bad_ops(fluid)
    feed = {"x": np.zeros((2, 4), np.float32)}
    loc = health.localize_first_bad_op(pt.default_main_program(), feed, scope=pt.Scope(),
                                       device="cpu")
    jloc = jax_health.localize_first_bad_op(fluid.default_main_program(), feed,
                                            scope=fluid.Scope())
    assert loc["op_type"] == "log" and loc["probes"] >= 2
    assert {k: loc[k] for k in ("op_index", "op_type", "callsite", "bad_outputs")} == \
        {k: jloc[k] for k in ("op_index", "op_type", "callsite", "bad_outputs")}


def test_localize_runs_on_the_card_unless_told(monkeypatch):
    """Numpy feeds and a scope without tensors: the replay's device is
    ``CUDAPlace(0)``, which raises without a card instead of using the
    CPU."""
    _two_bad_ops(pt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        health.localize_first_bad_op(pt.default_main_program(),
                                     {"x": np.zeros((2, 4), np.float32)}, scope=pt.Scope())


def test_localize_clean_program_returns_none_and_writes_nothing():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    pred = pt.layers.fc(input=x, size=1, act="relu")
    loss = pt.layers.mean(pt.layers.square_error_cost(input=pred, label=y))
    pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(pt.default_startup_program(), scope=scope)
    params = [v.name for v in pt.default_main_program().list_vars() if v.persistable]
    before = {n: scope.find_var(n).clone() for n in params}
    assert len(before) >= 2
    feed = {"x": np.ones((2, 4), np.float32), "y": np.ones((2, 1), np.float32)}
    assert health.localize_first_bad_op(pt.default_main_program(), feed, scope=scope) is None
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), n      # the sgd ops ran on clones


def test_divergence_detector_events_equal_the_jax_packages():
    rs = np.random.RandomState(0)
    losses = list(1.0 + 0.01 * rs.randn(40))
    gnorms = list(2.0 + 0.1 * rs.rand(40))
    losses[20], losses[33] = 50.0, float("nan")
    gnorms[25], gnorms[30] = 40.0, float("inf")
    kw = dict(window=16, min_steps=4, loss_spike_z=4.0, grad_explosion_factor=5.0)
    mine, ref = health.DivergenceDetector(**kw), jax_health.DivergenceDetector(**kw)
    got = [mine.observe(loss=float(a), grad_norm=float(b)) for a, b in zip(losses, gnorms)]
    want = [ref.observe(loss=float(a), grad_norm=float(b)) for a, b in zip(losses, gnorms)]
    assert got == want
    assert sum(len(e) for e in got) == 2
    assert list(mine._losses) == list(ref._losses)


def test_sentinels_off_add_no_outputs_and_toggling_builds_a_new_entry():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    out = pt.layers.fc(input=x, size=2)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program(), scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    res = exe.run(pt.default_main_program(), feed=feed, fetch_list=[out], scope=scope)
    assert len(res) == 1
    (entry,) = [e for e in exe._cache.values() if e.fetch_names == [out.name]]
    assert entry.sentinel_extra == 0 and entry.sentinel_watch == ()
    fp_off = entry.fingerprint
    compiles = exe.compile_count
    exe.sentinels = ("fetches",)
    res = exe.run(pt.default_main_program(), feed=feed, fetch_list=[out], scope=scope)
    assert len(res) == 1                        # the sentinel never reaches the caller
    assert exe.compile_count == compiles + 1
    on = [e for e in exe._cache.values() if e.sentinel_extra]
    assert len(on) == 1 and on[0].sentinel_watch == (out.name,)
    assert on[0].fingerprint != fp_off
    exe.sentinels = ()
    exe.run(pt.default_main_program(), feed=feed, fetch_list=[out], scope=scope)
    assert exe.compile_count == compiles + 1    # back on the first entry
    with pytest.raises(ValueError, match="unknown sentinel"):
        pt.Executor(pt.CPUPlace(), sentinels=("loss",))


def test_sentinel_empty_groups_never_trip():
    """A startup program writes state it never reads: no old values, so
    the update norm is absent (NaN), which reads as healthy."""
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    pt.layers.fc(input=x, size=2)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), sentinels=True)
    monitor = health.HealthMonitor().attach(exe)
    n0 = len(health.HEALTH_RECORDS.records())
    exe.run(pt.default_startup_program(), scope=scope)
    monitor.flush()
    recs = health.HEALTH_RECORDS.records()[n0:]
    assert all(r.get("kind") != "event" for r in recs), recs
    assert all(r.get("ok") for r in recs if r.get("kind") == "step")


def test_a_donated_feed_is_kept_for_localization():
    """``run_pipelined(donate_feeds=True)`` empties each staged batch; the
    monitor (``localize=True``) still localizes the tripping step, from
    the clone the executor kept, and holds at most ``max_pending``."""
    main, startup, loss = _build(pt, "sgd")
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), sentinels=True)
    exe.run(startup, scope=scope)
    mon = health.HealthMonitor(health.HealthConfig(max_pending=2)).attach(exe)
    n0 = len(health.HEALTH_RECORDS.records())
    rs = np.random.RandomState(3)
    feeds = [_feed(rs, -1.0 if i == 3 else 1.0) for i in range(5)]
    for _ in exe.run_pipelined(main, feeds, fetch_list=[loss], scope=scope, donate_feeds=True):
        assert len(mon._pending) <= 2
    mon.flush()
    trips = [r for r in health.HEALTH_RECORDS.records()[n0:] if r.get("event") == "non-finite"]
    # the executor's run count: the startup run is run 1, feeds[3] run 5
    assert len(trips) == 1 and trips[0]["step"] == 5
    assert trips[0]["localization"]["op_type"] == "log"


def test_an_empty_monitor_polls_nothing_and_a_localize_off_monitor_keeps_no_feed():
    main, startup, loss = _build(pt, "sgd")
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), sentinels=("fetches",))
    exe.run(startup, scope=scope)
    mon = health.HealthMonitor(health.HealthConfig(localize=False)).attach(exe)
    assert mon.poll() == 0
    kept = []
    exe._health_hook = lambda **kw: (kept.append(kw["feed"]), mon.on_step(**kw))
    exe.run(main, feed=_feed(np.random.RandomState(0), 1.0), fetch_list=[loss], scope=scope)
    assert kept == [None] and mon.flush() == 1


# ------------------------------------------------------------------ Trainer

def _faulty_reader(steps=10, inject_at=6, batch=8):
    def reader():
        rs = np.random.RandomState(0)
        w = rs.randn(8, 1).astype(np.float32)
        for i in range(steps):
            xs = rs.rand(batch, 8).astype(np.float32)
            t = -1.0 if i == inject_at else 1.0
            trig = np.full((batch, 1), t, np.float32)
            yield [(xs[j], xs[j] @ w, trig[j]) for j in range(batch)]
    return reader


def test_trainer_health_records_keys_localization_and_health_report(tmp_path, monkeypatch):
    tele = tmp_path / "tele"
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tele))
    health.HEALTH_RECORDS.reopen()
    try:
        n0 = len(health.HEALTH_RECORDS.records())
        with pt.unique_name.guard():
            t = pt.Trainer(train_func=_faulty_train_func(pt),
                           optimizer_func=lambda: _optimizer(pt, "sgd"),
                           place=pt.CPUPlace(), health=True)
        assert t.exe.sentinels == health.SENTINEL_CLASSES
        t.train(num_epochs=1, event_handler=lambda ev: None,
                reader=_faulty_reader(steps=10, inject_at=6), feed_order=["x", "y", "trig"])
        recs = health.HEALTH_RECORDS.records()[n0:]
    finally:
        monkeypatch.delenv("PADDLE_TPU_TELEMETRY_DIR")
        health.HEALTH_RECORDS.reopen()
    n1 = len(jax_health.HEALTH_RECORDS.records())
    with fluid.unique_name.guard():
        jt = fluid.Trainer(train_func=_faulty_train_func(fluid),
                           optimizer_func=lambda: _optimizer(fluid, "sgd"), health=True)
    jt.train(num_epochs=1, event_handler=lambda ev: None,
             reader=_faulty_reader(steps=10, inject_at=6), feed_order=["x", "y", "trig"])
    jrecs = jax_health.HEALTH_RECORDS.records()[n1:]
    steps = [r for r in recs if r.get("kind") == "step"]
    trips = [r for r in recs if r.get("event") == "non-finite"]
    assert len(steps) == 10 and sum(1 for r in steps if not r["ok"]) == 1
    assert len(trips) == 1 and trips[0]["localization"]["op_type"] == "log"
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    assert [r["ok"] for r in steps] == [r["ok"] for r in jrecs if r.get("kind") == "step"]
    files = list(tele.glob("health_*.jsonl"))
    assert len(files) == 1
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "health_report.py"),
                          str(tele), "--json"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["health"]["0"]["steps"] == 10


def test_trainer_health_off_by_default():
    with pt.unique_name.guard():
        t = pt.Trainer(train_func=_faulty_train_func(pt),
                       optimizer_func=lambda: _optimizer(pt, "sgd"), place=pt.CPUPlace())
    assert t.health is None and t.exe.sentinels == ()


def test_fetch_timeout_in_pipelined_trainer_records_health_event():
    n0 = len(health.HEALTH_RECORDS.records())
    before = staging.COUNTERS.get("fetch_timeouts")
    saw = {"raised": False}

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent) and not saw["raised"]:
            h = ev.metrics[0]
            assert isinstance(h, staging.FetchHandle)     # the pipelined path
            orig = staging.FetchHandle.ready
            staging.FetchHandle.ready = lambda self: False
            try:
                with pytest.raises(staging.FetchTimeoutError):
                    h.result(timeout=0.05)
            finally:
                staging.FetchHandle.ready = orig
            saw["raised"] = True

    with pt.unique_name.guard():
        t = pt.Trainer(train_func=_faulty_train_func(pt),
                       optimizer_func=lambda: _optimizer(pt, "sgd"), place=pt.CPUPlace(),
                       health=True)
    assert t.pipeline
    t.train(num_epochs=1, event_handler=handler, reader=_faulty_reader(steps=4, inject_at=99),
            feed_order=["x", "y", "trig"])
    assert saw["raised"]
    events = [r for r in health.HEALTH_RECORDS.records()[n0:]
              if r.get("event") == "fetch-timeout"]
    assert len(events) == 1 and events[0]["timeout_s"] == 0.05
    assert events[0]["rank"] == 0 and events[0]["pid"] == os.getpid()
    assert staging.COUNTERS.get("fetch_timeouts") == before + 1
