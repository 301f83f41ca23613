"""The static memory planner ported (``paddle_tpu_torch.analysis.memory``),
against the JAX package's on the CPU.

* ``plan_memory`` gives equal ``peak_bytes``, ``peak_op_index``,
  ``breakdown``, timeline and M50x findings on the corpus of
  tests/test_torch_analysis.py (its planted programs whose op types the
  port lowers, with ``mesh=`` and ``layout=`` where they carry them, and
  the main paths at their feed shapes, donated and not), and on the
  seeded M501-M505 programs of tests/test_memory.py;
* ``parse_memory_budget`` and ``DEVICE_PROFILES`` (the TPU names kept,
  the H100 added); ``plan_state_memory`` over a manifest var table;
* ``Executor(memory_budget=)`` raising ``PredictedOOMError`` before any
  op is lowered, memoized, with the gauge and the ``memplan_`` record;
  ``precompile``; ``Inferencer.warmup`` and ``ServingSession`` rejecting
  over-budget buckets (the survivors' answers bit-equal to an unbudgeted
  session's); the Trainer's step-0 plan equal to the JAX Trainer's;
* ``tools/memory_report.py`` and ``tools/stats.py`` read the port's
  program dumps and ``memplan_`` records.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.analysis  # noqa: F401  (registers fluid.analysis)
import paddle_tpu_torch as pt
from paddle_tpu import layers as jl
from paddle_tpu.analysis import memory as jax_memory
from paddle_tpu.core.desc import DataType as JaxDataType
from paddle_tpu.core.desc import OpDesc as JaxOpDesc
from paddle_tpu.core.desc import ProgramDesc as JaxProgramDesc
from paddle_tpu.core.desc import VarDesc as JaxVarDesc
from paddle_tpu.parallel import SpecLayout
from paddle_tpu_torch.analysis import (DEVICE_PROFILES, PredictedOOMError, memory,
                                       parse_memory_budget, plan_memory)
from paddle_tpu_torch.telemetry import REGISTRY
from test_torch_analysis import (lowered_types, main_path_programs, planted_programs, to_jax,
                                 to_port)

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 2, "fsdp": 2, "tp": 2}


def _key(mod, plan, budget=None, donate=False):
    diags = mod.memory_diagnostics(plan, budget=budget, donate_feeds=donate)
    return {"peak": plan.peak_bytes, "peak_op": (plan.peak_op_index, plan.peak_op_type),
            "breakdown": dict(plan.breakdown), "timeline": list(plan.timeline),
            "persistent": plan.persistent_bytes, "feeds": plan.feed_bytes,
            "outputs": plan.output_bytes, "pad": plan.pad_bytes,
            "devices": plan.num_devices, "unsized": [u["name"] for u in plan.unsized],
            "dynamic": sorted(plan.dynamic), "donated": plan.donated_feeds,
            "m5xx": sorted((d.code, d.severity, d.var or "", d.op_index or -1) for d in diags)}


def both_plans(jdesc, tdesc, budget=None, **kw):
    """(the JAX package's plan key, the port's) of one program."""
    donate = kw.get("donate_feeds", False)
    return (_key(jax_memory, jax_memory.plan_memory(jdesc, **kw), budget, donate),
            _key(memory, plan_memory(tdesc, **kw), budget, donate))


# ------------------------------------------------------------ the corpus

def _lowered_only(desc):
    """Every op of ``desc`` has a lowering in the port (a ``<type>_grad``
    through its forward's)."""
    lowered = set(lowered_types())
    return all(op.type in lowered or op.type[:-len("_grad")] in lowered
               for b in desc.blocks for op in b.ops)


PLANTED_FEEDS = {"x": (16, 8), "lbl": (16, 1), "seq": (16, 24, 1)}


@pytest.mark.parametrize("name", sorted(planted_programs()))
def test_planted_programs_plan_equal(name):
    """Planted programs whose op types the port lowers (the while,
    conditional_block and one_hot programs hold op types the port does not
    lower; their verifier findings are compared in
    tests/test_torch_analysis.py)."""
    jdesc, tdesc, fetch, kw = planted_programs()[name]
    if not _lowered_only(tdesc):
        assert name.startswith(("while", "cond", "S103")), name
        return
    plan_kw = {k: v for k, v in kw.items() if k in ("feed_names", "mesh", "layout",
                                                    "donate_feeds")}
    feeds = {k: v for k, v in PLANTED_FEEDS.items() if tdesc.block(0).find_var(k) is not None}
    want, got = both_plans(jdesc, tdesc, fetch_list=fetch, feed_shapes=feeds, **plan_kw)
    assert got == want and got["peak"] > 0


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("name", ["serving", "fused_step", "reference_step", "reference_eval",
                                  "resnet18", "mnist", "vgg16", "serving_int8",
                                  "fused_step_bf16", "fused_step_kernels",
                                  "reference_step_bf16", "resnet18_bf16"])
def test_main_paths_plan_equal(name, donate):
    """Each package plans its parse of the port's serialized program (the
    rewrites exist only in the port) and, for a program both built, its
    own: equal plans, no unsized var."""
    jprog, tprog, fetch, fs = main_path_programs()[name]
    kw = dict(fetch_list=fetch, feed_shapes=fs, donate_feeds=donate)
    want, got = both_plans(to_jax(tprog), tprog, **kw)
    assert got == want and got["unsized"] == [] and got["peak"] > got["persistent"] > 0
    if not isinstance(jprog, JaxProgramDesc):
        assert _key(jax_memory, jax_memory.plan_memory(jprog, **kw), None, donate) == got


def test_donated_feeds_end_at_their_last_use():
    _, tprog, fetch, fs = main_path_programs()["fused_step"]
    held = plan_memory(tprog, fetch_list=fetch, feed_shapes=fs)
    donated = plan_memory(tprog, fetch_list=fetch, feed_shapes=fs, donate_feeds=True)
    assert donated.tensors["lbl"].end == donated.tensors["lbl"].last_use \
        < held.tensors["lbl"].end
    assert donated.peak_bytes <= held.peak_bytes


# ------------------------------------------------------ seeded M5xx programs

def _m503_program(pkg):
    """tests/test_memory.py's 4 MiB feed dead after the first projection."""
    x = pkg.layers.data(name="x", shape=[16384], dtype="float32")
    s = pkg.layers.fc(input=x, size=8, act="relu")
    h = pkg.layers.fc(input=s, size=2048, act="relu")
    return [pkg.layers.fc(input=h, size=2048)]


def _m502_program(pkg):
    """An early 2 MiB fetch held to the end through a later peak."""
    x = pkg.layers.data(name="x", shape=[64], dtype="float32")
    early = pkg.layers.fc(input=x, size=8192, act="relu")
    small = pkg.layers.fc(input=early, size=4, act="relu")
    h = pkg.layers.fc(input=small, size=2048, act="relu")
    return [early, pkg.layers.fc(input=h, size=8192)]


def _dead_chain_program(pkg):
    """tests/test_passes.py's corpus: a dead 2 MiB chain at the peak (M502)
    and the M503 feed."""
    x = pkg.layers.data(name="x", shape=[16384], dtype="float32")
    s = pkg.layers.fc(input=x, size=8, act="relu")
    pkg.layers.fc(input=s, size=8192)          # never fetched: dead
    h = pkg.layers.fc(input=s, size=2048, act="relu")
    return [pkg.layers.fc(input=h, size=2048)]


def _mlp_adam(pkg):
    """tests/test_memory.py's MLP with Adam."""
    x = pkg.layers.data(name="x", shape=[64], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="int64")
    h = pkg.layers.fc(input=x, size=32, act="relu")
    pred = pkg.layers.fc(input=h, size=10, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=y))
    pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss]


def build(pkg, fn):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = fn(pkg)
    return main, startup, [v.name for v in outs]


@pytest.mark.parametrize("fn,feeds,code", [
    (_m503_program, {"x": (64, 16384)}, "M503"),
    (_m502_program, {"x": (64, 64)}, "M502"),
    (_dead_chain_program, {"x": (64, 16384)}, "M502"),
    (_mlp_adam, {"x": (16, 64), "y": (16, 1)}, None)])
def test_seeded_m5xx_programs_plan_equal(fn, feeds, code):
    (jm, _, fetch), (tm, _, _) = build(fluid, fn), build(pt, fn)
    for donate in (False, True):
        want, got = both_plans(jm, tm, fetch_list=fetch, feed_shapes=feeds,
                               donate_feeds=donate)
        assert got == want
        if code and not donate:
            assert code in {c[0] for c in got["m5xx"]}
    # the budget: M501 at one byte under the peak, none at the peak
    peak = plan_memory(tm, fetch_list=fetch, feed_shapes=feeds).peak_bytes
    for budget, fires in ((peak - 1, True), (peak, False)):
        want, got = both_plans(jm, tm, budget=budget, fetch_list=fetch, feed_shapes=feeds)
        assert got == want and (("M501", "error") in {c[:2] for c in got["m5xx"]}) == fires


def test_seeded_unsized_var_m504_and_the_hint():
    def desc(mod_desc, hint=None):
        d = mod_desc["ProgramDesc"]()
        block = d.block(0)
        block.add_var(mod_desc["VarDesc"](name="inp", shape=(4, 8)))
        block.add_var(mod_desc["VarDesc"](name="mystery_out", shape=(-1, -1),
                                          dtype=mod_desc["FP32"]))
        if hint:
            block.vars["mystery_out"].attrs["mem_bytes_hint"] = hint
        block.ops.append(mod_desc["OpDesc"](type="mystery_op", inputs={"X": ["inp"]},
                                            outputs={"Out": ["mystery_out"]},
                                            attrs={"callsite": "model.py:7"}))
        return d
    from paddle_tpu_torch.core import desc as tdesc
    jmods = {"ProgramDesc": JaxProgramDesc, "VarDesc": JaxVarDesc, "OpDesc": JaxOpDesc,
             "FP32": JaxDataType.FP32}
    tmods = {"ProgramDesc": tdesc.ProgramDesc, "VarDesc": tdesc.VarDesc,
             "OpDesc": tdesc.OpDesc, "FP32": tdesc.DataType.FP32}
    for hint in (None, 4096):
        kw = dict(fetch_list=["mystery_out"], feed_shapes={"inp": (4, 8)})
        want, got = both_plans(desc(jmods, hint), desc(tmods, hint), **kw)
        assert got == want
        assert got["unsized"] == ([] if hint else ["mystery_out"])
    fp = desc(tmods).fingerprint()
    assert desc(tmods, 4096).fingerprint() == fp     # the hint moves no cache key


def test_layout_padding_m505_and_sharded_state():
    """A 4-way sharded (6, 10) weight pads to 2 rows a device (M505), and
    under a 2x2x2 layout the parameters and their Adam slots divide; the
    JAX package's ``SpecLayout`` drives both planners (the port has no
    mesh yet: only its ``{axis: size}`` dict and ``spec_for`` are read)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = jl.data(name="x", shape=[6], dtype="float32")
        out = jl.fc(input=x, size=10)
        out.set_sharding([["fsdp", "tp"], None])
        main.global_block.var("fc_0.w_0").set_sharding([["fsdp", "tp"], None])
    kw = dict(fetch_list=[out.name], feed_shapes={"x": (8, 6)}, mesh=MESH)
    want, got = both_plans(to_jax(main), to_port(main), **kw)
    assert got == want and got["pad"] > 0
    (jm, _, fetch), (tm, _, _) = build(fluid, _mlp_adam), build(pt, _mlp_adam)
    kw = dict(fetch_list=fetch, feed_shapes={"x": (16, 64), "y": (16, 1)}, mesh=MESH,
              layout=SpecLayout())
    want, got = both_plans(jm, tm, **kw)
    assert got == want and got["devices"] == 8
    assert plan_memory(tm, **kw).persistent_bytes < plan_memory(
        tm, fetch_list=fetch, feed_shapes={"x": (16, 64), "y": (16, 1)}).persistent_bytes


def test_plan_state_memory_equal():
    table = {"w": {"shape": [64, 32], "dtype": "float32"},
             "w_moment1_0": {"shape": [64, 32], "dtype": "float32", "slot_of": "w"},
             "ids": {"shape": [7], "dtype": "int64"}}
    for kw in ({}, {"mesh": MESH, "layout": SpecLayout()}):
        a = jax_memory.plan_state_memory(table, **kw)
        b = memory.plan_state_memory(table, **kw)
        assert (b.peak_bytes, b.breakdown, b.top) == (a.peak_bytes, a.breakdown, a.top)


# ----------------------------------------------------------- the budget knob

def test_parse_memory_budget_and_profiles():
    for v in (1024, "2KiB", "1.5kb", "16GiB", "512MB", "tpu-v4", "v3", "tpu-v5p"):
        assert parse_memory_budget(v) == jax_memory.parse_memory_budget(v), v
    assert {k: v for k, v in DEVICE_PROFILES.items() if k.startswith("tpu-")} == \
        jax_memory.DEVICE_PROFILES
    assert parse_memory_budget("h100-80gb-hbm3") == memory.H100_TOTAL_MEMORY \
        == parse_memory_budget("H100-80GB-HBM3")
    with pytest.raises(ValueError):
        parse_memory_budget("lots")


def _startup(main, startup):
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace(), validate="off").run(startup, scope=scope)
    return scope


def _mlp_feed(rows=16):
    rs = np.random.RandomState(0)
    return {"x": rs.rand(rows, 64).astype(np.float32),
            "y": rs.randint(0, 10, (rows, 1)).astype(np.int64)}


def test_executor_budget_raises_before_any_lowering(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    main, startup, fetch = build(pt, _mlp_adam)
    scope = _startup(main, startup)
    lowered = []
    from paddle_tpu_torch.core import executor as ex
    real = ex.lower_block
    monkeypatch.setattr(ex, "lower_block", lambda *a, **k: (lowered.append(1), real(*a, **k)))
    exe = pt.Executor(pt.CPUPlace(), memory_budget=8192)
    with pytest.raises(PredictedOOMError) as ei:
        exe.run(main, feed=_mlp_feed(), fetch_list=fetch, scope=scope)
    assert lowered == [] and exe.cache_info()["executables"] == 0 and exe.run_count == 0
    e = ei.value
    assert e.diagnostic.code == "M501" and e.budget == 8192
    assert e.diagnostic.callsite and os.path.basename(__file__) in e.diagnostic.callsite
    assert "top live tensors" in str(e) and len(e.plan.top) >= 3
    jm, _, _ = build(fluid, _mlp_adam)
    assert e.plan.peak_bytes == jax_memory.plan_memory(
        jm, fetch_list=fetch, feed_shapes={k: v.shape for k, v in _mlp_feed().items()}).peak_bytes
    assert REGISTRY.gauge("predicted_peak_bytes", scope=exe.telemetry_scope).value == \
        e.plan.peak_bytes
    (rec,) = [json.loads(line) for f in tmp_path.glob("memplan_*.jsonl") for line in open(f)]
    assert rec["peak_bytes"] == e.plan.peak_bytes and rec["budget"] == 8192
    with pytest.raises(PredictedOOMError):      # the memo raises again, no second plan
        exe.run(main, feed=_mlp_feed(), fetch_list=fetch, scope=scope)
    assert len(list(open(next(tmp_path.glob("memplan_*.jsonl"))))) == 1
    with pytest.raises(PredictedOOMError):
        exe.precompile(main, feed={"x": ((64, 64), "float32"), "y": ((64, 1), "int64")},
                       fetch_list=fetch, scope=scope)
    assert exe.compile_count == 0 and lowered == []


def test_executor_budget_under_the_plan_runs():
    main, startup, fetch = build(pt, _mlp_adam)
    scope = _startup(main, startup)
    for budget in ("h100-80gb-hbm3", "1MiB"):
        exe = pt.Executor(pt.CPUPlace(), memory_budget=budget)
        (loss,) = exe.run(main, feed=_mlp_feed(), fetch_list=fetch, scope=scope)
        assert np.isfinite(loss).all() and exe.compile_count == 1


def _serving_net(pkg):
    x = pkg.layers.data(name="x", shape=[64], dtype="float32")
    h = pkg.layers.fc(input=x, size=256, act="relu")
    return pkg.layers.fc(input=h, size=10, act="softmax")


def _bucket_plans(buckets):
    inf = pt.Inferencer(lambda: _serving_net(pt), place=pt.CPUPlace(), validate="off")
    return {b: plan_memory(inf.inference_program, fetch_list=[v.name for v in inf.predict_vars],
                           feed_shapes={"x": (b, 64)}).peak_bytes for b in buckets}


def test_inferencer_warmup_rejects_over_budget_batch_sizes():
    plans = _bucket_plans((1, 2, 4, 8))
    budget = (plans[2] + plans[4]) // 2
    inf = pt.Inferencer(lambda: _serving_net(pt), place=pt.CPUPlace(), memory_budget=budget)
    report = {r["batch_size"]: r for r in inf.warmup((1, 2, 4, 8))}
    assert [bs for bs, r in report.items() if r.get("rejected")] == [4, 8]
    r = report[8]
    assert r["code"] == "M501" and "M501" in r["error"] and r["budget_bytes"] == budget
    assert r["predicted_peak_bytes"] == plans[8]
    assert report[1]["kind"] == "eager" and "rejected" not in report[1]


def test_serving_session_drops_rejected_buckets_and_answers_bit_equal():
    plans = _bucket_plans((1, 2, 4, 8))
    budget = (plans[2] + plans[4]) // 2
    plain = pt.ServingSession(lambda: _serving_net(pt), place=pt.CPUPlace(), max_batch_size=8,
                              max_wait_ms=1.0)
    budgeted = pt.ServingSession(inferencer=pt.Inferencer(lambda: _serving_net(pt),
                                                          place=pt.CPUPlace()),
                                 max_batch_size=8, max_wait_ms=1.0, memory_budget=budget)
    try:
        assert budgeted.inferencer.exe.memory_budget == budget
        assert budgeted.buckets == (1, 2) and budgeted.engine.buckets == (1, 2)
        assert plain.buckets == (1, 2, 4, 8)
        # the same weights in both sessions: carry the plain one's parameters
        for n in plain.inferencer.scope._vars:
            v = plain.inferencer.scope.find_var(n)
            if hasattr(v, "copy_") and budgeted.inferencer.scope.find_var(n) is not None:
                budgeted.inferencer.scope.find_var(n).copy_(v)
        rs = np.random.RandomState(7)
        for rows in (1, 2):
            x = {"x": rs.rand(rows, 64).astype(np.float32)}
            (a,), (b,) = plain.infer(x), budgeted.infer(x)
            np.testing.assert_array_equal(a, b)
        with pytest.raises(Exception):
            budgeted.infer({"x": rs.rand(4, 64).astype(np.float32)})
    finally:
        plain.close()
        budgeted.close()


def test_serving_session_all_buckets_rejected_raises():
    plans = _bucket_plans((1,))
    with pytest.raises(ValueError, match="memory budget"):
        pt.ServingSession(lambda: _serving_net(pt), place=pt.CPUPlace(), max_batch_size=4,
                          memory_budget=plans[1] - 1)


# ---------------------------------------------------------------- Trainer

def _trainer_reader():
    rng = np.random.RandomState(0)
    for _ in range(2):
        yield [(rng.rand(64).astype(np.float32), rng.randint(0, 10, (1,)).astype(np.int64))
               for _ in range(8)]


def _train_func(pkg):
    def train_func():
        x = pkg.layers.data(name="x", shape=[64], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        pred = pkg.layers.fc(input=h, size=10, act="softmax")
        return pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=y))
    return train_func


def test_trainer_step0_plan_record(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "port"))
    with pt.unique_name.guard():
        t = pt.Trainer(train_func=_train_func(pt), place=pt.CPUPlace(),
                       optimizer_func=lambda: pt.optimizer.SGD(learning_rate=0.1))
    t.train(num_epochs=1, event_handler=lambda ev: None, reader=_trainer_reader,
            feed_order=["x", "y"])
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "jax"))
    with fluid.unique_name.guard():
        jt = fluid.Trainer(train_func=_train_func(fluid),
                           optimizer_func=lambda: fluid.optimizer.SGDOptimizer(learning_rate=0.1))
    jt.train(num_epochs=1, event_handler=lambda ev: None, reader=_trainer_reader,
             feed_order=["x", "y"])
    assert t.memory_plan is not None and t.memory_plan.unsized == []
    assert (t.memory_plan.peak_bytes, t.memory_plan.breakdown) == \
        (jt.memory_plan.peak_bytes, jt.memory_plan.breakdown)
    (rec,) = [json.loads(line) for f in (tmp_path / "port").glob("memplan_*.jsonl")
              for line in open(f)]
    (jrec,) = [json.loads(line) for f in (tmp_path / "jax").glob("memplan_*.jsonl")
               for line in open(f)]
    assert rec["source"] == "trainer" and rec["peak_bytes"] == t.memory_plan.peak_bytes
    assert rec.keys() == jrec.keys()


# ------------------------------------------------------------------ tools

def test_memory_report_and_stats_read_the_ports_records(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROGRAM_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    main, startup, fetch = build(pt, _mlp_adam)
    scope = _startup(main, startup)
    exe = pt.Executor(pt.CPUPlace(), memory_budget="1GiB")
    exe.run(main, feed=_mlp_feed(), fetch_list=fetch, scope=scope)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "memory_report.py"),
                        str(tmp_path), "--json"], capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    out = json.loads(p.stdout)
    assert out["jax_free"] and out["memplans"] >= 1
    peaks = [row["plan"]["peak_bytes"] for rows in out["files"].values() for row in rows]
    assert plan_memory(main, fetch_list=fetch,
                       feed_shapes={k: v.shape for k, v in _mlp_feed().items()}).peak_bytes \
        in peaks
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "stats.py"), str(tmp_path),
                        "--json"], capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout)["memory"]["peak_bytes"] > 0
