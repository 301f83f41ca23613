"""The port's observability records against the JAX package's, and the
JAX package's jax-free readers over the port's records.

* Capture-log records, serving ``kind: request`` / ``kind: batch`` rows
  and ``passes_<pid>.jsonl`` records carry the JAX package's keys on the
  same run; the executor's and the stager's timeline spans have the JAX
  package's names; the kernel pass counts its decisions in the
  ``"kernels"`` scope under the JAX package's counter names.
* ``tools/trace_tool.py --strict``, ``stats.py``, ``profile_report.py``,
  ``compile_report.py`` and ``pass_report.py``, run as subprocesses,
  exit 0 over a telemetry directory the port wrote (a profiled Trainer, a
  traced serving session under one root trace, a pass pipeline, a gauge
  sample and program dumps).
* ``PADDLE_TPU_SAMPLER=1`` starts the sampler at import (in a
  subprocess); with telemetry off nothing starts and nothing is written.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import compile_log as jax_compile_log
from paddle_tpu import telemetry as jax_telemetry
from paddle_tpu.passes import base as jax_passes
from paddle_tpu.serving import engine as jax_engine
from paddle_tpu_torch import compile_log as pt_compile_log
from paddle_tpu_torch import telemetry as pt_telemetry
from paddle_tpu_torch.passes import base as pt_passes
from paddle_tpu_torch.serving import engine as pt_engine

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TRACE_IDS = {"trace_id", "span_id", "parent_id"}


def _linear(pkg):
    """x [N, 13] -> fc -> mean, SGD."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13])
        loss = pkg.layers.mean(pkg.layers.fc(input=x, size=1))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _linear_feed(seed=0, rows=8):
    return {"x": np.random.RandomState(seed).randn(rows, 13).astype(np.float32)}


def _executors():
    return fluid.Executor(), pt.Executor(pt.CPUPlace())


def test_capture_records_carry_the_jax_keys():
    """The startup's and the step's records: the same keys in both
    packages; the port's kinds say what each entry cost on the CPU."""
    out = {}
    for name, pkg, log, exe in (("jax", fluid, jax_compile_log, _executors()[0]),
                                ("port", pt, pt_compile_log, _executors()[1])):
        main, startup, loss = _linear(pkg)
        scope = pkg.Scope()
        n0 = len(log.COMPILE_LOG.records())
        exe.run(startup, scope=scope)
        exe.run(main, feed=_linear_feed(), fetch_list=[loss], scope=scope)
        exe.run(main, feed=_linear_feed(1), fetch_list=[loss], scope=scope)
        out[name] = log.COMPILE_LOG.records()[n0:]
    jrecs, trecs = out["jax"], out["port"]
    assert len(trecs) == len(jrecs) == 2
    for j, t in zip(jrecs, trecs):
        assert set(t) - TRACE_IDS == set(j) - TRACE_IDS
        assert t["reasons"][0] == j["reasons"][0] == "new-program"
        assert t["cost"] is None and t["memory"] is None and t["aot"] is False
    assert [r["kind"] for r in trecs] == ["eager", "eager"]
    assert trecs[0]["reasons"][1].startswith("eager:initializes state")
    assert trecs[1]["reasons"][1:] == ["eager:the CPU runs the block op by op"]
    assert trecs[1]["feeds"] == {"x": [[8, 13], "float32"]}


def test_a_new_feed_shape_is_attributed():
    main, startup, loss = _linear(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_linear_feed(rows=8), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_linear_feed(rows=4), fetch_list=[loss], scope=scope)
    rec = pt_compile_log.COMPILE_LOG.records()[-1]
    assert rec["reasons"][0] == "feed-shape-change:x (8,13)->(4,13)"
    info = exe.cache_info()
    assert info["scope"] == exe.telemetry_scope
    snap = pt_telemetry.REGISTRY.snapshot(scope=exe.telemetry_scope)
    assert (snap["compile_count"], snap["cache_misses"], snap["runs"]) == (3, 3, 3)
    assert (info["compile_count"], info["misses"], info["runs"], info["persistent_hits"]) == \
        (3, 3, 3, 0)


def _serving_rows(pkg_engine, telemetry, tmp_path, monkeypatch, n=6):
    """``n`` single-row requests from 3 threads through an engine whose
    runner doubles the rows, under a root trace; the engine's rows."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    eng = pkg_engine.BatchingEngine(lambda feed: [feed["x"] * 2.0], max_batch_size=4,
                                    max_wait_ms=20.0)
    root = telemetry.TraceContext.new_root()
    errors = []

    def client(t):
        try:
            with telemetry.use_trace(root):
                for i in range(t, n, 3):
                    (a,) = eng.infer({"x": np.full((1, 3), i, np.float32)}, timeout=30)
                    assert np.array_equal(a, np.full((1, 3), 2.0 * i, np.float32))
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    eng.close()
    assert not errors and not any(th.is_alive() for th in threads)
    return root, eng._records.records()


def test_serving_rows_carry_the_jax_keys_and_link_their_requests(tmp_path, monkeypatch):
    rows = {name: _serving_rows(eng, tel, tmp_path / name, monkeypatch)
            for name, eng, tel in (("jax", jax_engine, jax_telemetry),
                                   ("port", pt_engine, pt_telemetry))}
    (_, jrows), (root, trows) = rows["jax"], rows["port"]
    for kind in ("request", "batch"):
        jk = {frozenset(set(r) - {"links"}) for r in jrows if r["kind"] == kind}
        tk = {frozenset(set(r) - {"links"}) for r in trows if r["kind"] == kind}
        assert tk == jk, kind
    reqs = [r for r in trows if r["kind"] == "request"]
    batches = [r for r in trows if r["kind"] == "batch"]
    assert len(reqs) == 6 and sum(b["requests"] for b in batches) == 6
    assert all(r["trace_id"] == root.trace_id and r["parent_id"] == root.span_id for r in reqs)
    spans = {r["span_id"] for r in reqs}
    linked = [ln["span_id"] for b in batches for ln in b["links"]]
    assert sorted(linked) == sorted(spans)
    assert all(b["parent_id"] in spans for b in batches)
    for r in reqs:
        assert abs(r["queue_s"] + r["device_s"] + r["demux_s"] - r["latency_s"]) < 1e-5
    snap = pt_telemetry.REGISTRY.snapshot(scope="serving")
    assert snap["requests"] >= 6 and snap["batch_size"]["count"] >= len(batches)


def test_passes_records_carry_the_jax_keys(tmp_path):
    """One ``pallas-kernels`` pipeline over each package's 2-layer
    transformer step: the exported record's keys and each pass's keys."""
    from paddle_tpu.models import transformer as jax_transformer
    from paddle_tpu_torch.models import transformer as pt_transformer
    recs = {}
    for name, pkg, mod, passes in (("jax", fluid, jax_transformer, jax_passes),
                                   ("port", pt, pt_transformer, pt_passes)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
            trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
            lbl = pkg.layers.data(name="lbl", shape=[16, 1], dtype="int64")
            loss, _ = mod.train_network(src, trg, lbl, 100, 100, max_len=16, n_layer=1,
                                        d_model=32, n_head=2, d_inner=64, fuse_final_ce=True)
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        _, result = passes.PassPipeline(["pallas-kernels"], verify="off").run(
            main, fetch_list=[loss])
        path = passes.export_pipeline_result(result, out_dir=str(tmp_path / name))
        with open(path) as f:
            (recs[name],) = [json.loads(line) for line in f]
    assert set(recs["port"]) == set(recs["jax"])
    assert set(recs["port"]["passes"][0]) == set(recs["jax"]["passes"][0])
    assert recs["port"]["changed"] and recs["port"]["program_fp_before"] != \
        recs["port"]["program_fp_after"]


def test_kernel_pass_counts_its_decisions():
    from paddle_tpu_torch.ops.cuda.kernel_pass import PallasKernelsPass
    from paddle_tpu_torch.ops.cuda.policy import KernelPolicy
    from paddle_tpu_torch.models import transformer as pt_transformer
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pt.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pt.layers.data(name="lbl", shape=[16, 1], dtype="int64")
        loss, _ = pt_transformer.train_network(src, trg, lbl, 100, 100, max_len=16,
                                               n_layer=1, d_model=64, n_head=2, d_inner=64,
                                               fuse_final_ce=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    types = [o.type for o in main.desc.block(0).ops]
    n_flash = types.count("flash_attention") + types.count("flash_attention_grad")
    n_big = sum(1 for p in main.global_block.all_parameters() if int(np.prod(p.shape)) >= 4096)
    for policy, flash_name in ((KernelPolicy(), "flash_selected"),
                               (KernelPolicy(disable=["flash_attention"]),
                                "flash_skip:policy-disabled")):
        before = pt_telemetry.REGISTRY.snapshot(scope="kernels")
        pt_passes.PassPipeline([PallasKernelsPass(policy)], verify="off").run(
            main, fetch_list=[loss])
        after = pt_telemetry.REGISTRY.snapshot(scope="kernels")
        moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        assert moved[flash_name] == n_flash
        assert moved.get("optimizer_applied", 0) == n_big > 0
        assert moved["optimizer_skip:param-too-small"] == types.count("adam") - n_big > 0
        assert moved["embedding_applied"] == types.count("lookup_table") + \
            types.count("lookup_table_grad")


def _names(timeline):
    return sorted({e["name"] for e in timeline.events() if e["ph"] == "X"})


def test_executor_and_stager_spans_have_the_jax_names():
    """Three synchronous steps and three pipelined ones through each
    package's executor with its timeline on: the same span names (feed,
    run, fetch, compile, the device lane's ``step[n]``, the stager's
    ``stage[<seq>]`` and ``stage::convert(<name>)``), and one flow from
    each staged batch to the step that read it."""
    out = {}
    for name, pkg, tel, exe in (("jax", fluid, jax_telemetry, _executors()[0]),
                                ("port", pt, pt_telemetry, _executors()[1])):
        main, startup, loss = _linear(pkg)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        tel.TIMELINE.reset()
        tel.TIMELINE.enabled = True
        try:
            for i in range(3):
                exe.run(main, feed=_linear_feed(i), fetch_list=[loss], scope=scope)
            for handles in exe.run_pipelined(main, feeds=[_linear_feed(i) for i in range(3)],
                                             fetch_list=[loss], scope=scope):
                np.asarray(handles[0])
        finally:
            tel.TIMELINE.enabled = False
        out[name] = (_names(tel.TIMELINE), tel.TIMELINE.events())
        tel.TIMELINE.reset()      # the process's timeline goes back to empty
    assert out["port"][0] == out["jax"][0]
    assert "executor::run(block0/" in " ".join(out["port"][0])
    flows = {}
    for e in out["port"][1]:
        if e["ph"] in ("s", "f"):
            flows.setdefault(e["id"], []).append(e["ph"])
    assert len(flows) == 3 and all(sorted(v) == ["f", "s"] for v in flows.values())


# ---------------------------------------------------------------- the tools

def _tool(name, *args):
    return subprocess.run([sys.executable, str(REPO / "tools" / f"{name}.py"), *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """A telemetry dir the port wrote: a Trainer with ``profile_steps=1``
    (steps_, profile_, costmodel_, compiles_), a traced serving session
    under one root trace whose own record closes the chain (serving_), an
    executor with the kernel tier on (passes_), a gauge sample (gauges_)
    and program dumps (program_*.json)."""
    from paddle_tpu_torch import resource_sampler
    from paddle_tpu_torch.profiling import op_profiler
    d = tmp_path_factory.mktemp("port_telemetry")
    env = {"PADDLE_TPU_TELEMETRY_DIR": str(d), "PADDLE_TPU_PROGRAM_DUMP_DIR": str(d)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    streams = (pt_telemetry.STEPS, op_profiler.PROFILE_RECORDS, pt_compile_log.COMPILE_LOG)
    for s in streams:
        s.reopen()
    try:
        def train_func():
            x = pt.layers.data(name="x", shape=[13])
            return pt.layers.mean(pt.layers.fc(input=x, size=1))

        def reader():
            rs = np.random.RandomState(3)
            for _ in range(3):
                yield [(rs.randn(13).astype(np.float32),) for _ in range(8)]
        with pt.unique_name.guard():
            tr = pt.Trainer(train_func, lambda: pt.optimizer.SGD(learning_rate=0.05),
                            place=pt.CPUPlace(), profile_steps=1)
        tr.train(1, lambda ev: None, reader=reader, feed_order=["x"])

        def infer_func():
            x = pt.layers.data(name="x", shape=[13])
            return pt.layers.fc(input=x, size=4)
        sess = pt.ServingSession(infer_func, place=pt.CPUPlace(), max_batch_size=4,
                                 max_wait_ms=10.0)
        root = pt_telemetry.TraceContext.new_root()
        client = pt_telemetry.StepTelemetry(prefix="client")
        with pt_telemetry.use_trace(root):
            for i in range(5):
                sess.infer({"x": np.full((1 + i % 2, 13), i, np.float32)}, timeout=30)
        client.record(kind="client", requests=5, **root.fields())
        client.reopen()
        sess.close()

        main, startup, loss = _linear(pt)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), kernels=True)
        exe.run(startup, scope=scope)
        exe.run(main, feed=_linear_feed(), fetch_list=[loss], scope=scope)
        sampler = resource_sampler.ResourceSampler()
        sampler.write_sample(resource_sampler.sample_once())
        sampler.close()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for s in streams:
            s.reopen()
    return d


def test_the_port_writes_every_record_family(port_dir):
    names = os.listdir(port_dir)
    for prefix in ("steps_", "compiles_", "profile_", "costmodel_", "gauges_", "passes_",
                   "serving_", "program_"):
        assert any(n.startswith(prefix) for n in names), (prefix, names)


@pytest.mark.parametrize("tool,args", [
    ("trace_tool", ["--strict"]), ("stats", []), ("profile_report", []),
    ("compile_report", []), ("pass_report", [])])
def test_jax_free_tools_read_the_ports_records(port_dir, tool, args):
    p = _tool(tool, str(port_dir), *args)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    if tool == "trace_tool":
        assert "BROKEN" not in p.stdout and "request" in p.stdout and "batch:seq" in p.stdout


def test_trace_tool_strict_fails_on_a_broken_chain(port_dir, tmp_path):
    """The control: a request record whose parent span wrote nothing."""
    rows = [json.loads(line) for f in port_dir.glob("serving_*.jsonl") for line in open(f)]
    req = next(r for r in rows if r["kind"] == "request")
    (tmp_path / "serving_1.jsonl").write_text(json.dumps(req) + "\n")
    assert _tool("trace_tool", str(tmp_path), "--strict").returncode == 1


# ------------------------------------------------- the sampler, telemetry off

def _clean_env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_") and k != "GLOG_v"}
    env["PYTHONPATH"] = str(REPO)
    env.update(kw)
    return env


def test_sampler_autostarts_under_the_flag(tmp_path):
    code = ("import time, paddle_tpu_torch as pt\n"
            "s = pt.resource_sampler.resource_sampler()\n"
            "assert s is not None and s.running\n"
            "deadline = time.time() + 30\n"
            "while s.samples < 2 and time.time() < deadline:\n"
            "    time.sleep(0.02)\n"
            "s.stop()\n"
            "print(s.samples, s.sink_path)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env=_clean_env(PADDLE_TPU_SAMPLER="1", PADDLE_TPU_SAMPLER_INTERVAL="0.05",
                                      PADDLE_TPU_TELEMETRY_DIR=str(tmp_path / "t")))
    assert p.returncode == 0, p.stderr
    (path,) = (tmp_path / "t").glob("gauges_*.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) >= 2 and all("process_rss_bytes" in r for r in rows)


def test_with_telemetry_off_nothing_starts_and_nothing_is_written(tmp_path):
    """A step, a profile-free Trainer epoch and a served request with no
    telemetry variable set: no sampler thread, no timeline event, no
    sink opened, no file in the working directory."""
    code = (
        "import threading, numpy as np, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import compile_log, resource_sampler, telemetry\n"
        "def train_func():\n"
        "    x = pt.layers.data(name='x', shape=[3])\n"
        "    return pt.layers.mean(pt.layers.fc(input=x, size=1))\n"
        "tr = pt.Trainer(train_func, lambda: pt.optimizer.SGD(learning_rate=0.1),\n"
        "                place=pt.CPUPlace())\n"
        "reader = lambda: iter([[(np.ones(3, np.float32),)] * 4] * 2)\n"
        "tr.train(1, lambda ev: None, reader=reader, feed_order=['x'])\n"
        "sess = pt.ServingSession(lambda: pt.layers.scale(pt.layers.data(name='x', shape=[3]),\n"
        "                         2.0), place=pt.CPUPlace(), max_batch_size=2)\n"
        "sess.infer({'x': np.ones((1, 3), np.float32)})\n"
        "sess.close()\n"
        "assert resource_sampler.resource_sampler() is None\n"
        "assert not [t for t in threading.enumerate() if 'sampler' in t.name]\n"
        "assert telemetry.TIMELINE.events() == []\n"
        "assert telemetry.STEPS.sink_path is None and compile_log.COMPILE_LOG.sink_path is None\n"
        "assert len(telemetry.STEPS.records()) == 2\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=_clean_env())
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
    assert os.listdir(tmp_path) == []
