"""The port's sampled per-op profiler against the JAX package's.

A 2+2-layer ``train_network(fuse_final_ce=True)`` + ``Adam`` (vocab 1000,
d_model 64, 4 heads, d_inner 256, max_len 32, batch 4, ragged lengths) is
built by both packages under ``unique_name.guard()``, with the JAX
startup's state carried into the port's scope (``params_from_numpy``).
Both profile the float32 step on the CPU (``profile_program``, and each
package's ``Executor.profile_ops``): the same ``(op_index, op_type)`` rows,
the same static FLOPs and bytes per op (exact), and records and cost
models with the same keys.  The port's replay writes nothing (the scope's
tensors, their addresses, every generator and the executor's cache are
left as they were), ``Trainer(profile_steps=2)`` trains bit-equal to a
Trainer without profiles, and ``diff_signatures`` and
``summarize_compile_records`` give the JAX package's output on the same
inputs.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import compile_log as jax_compile_log
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.profiling import op_profiler as jax_op_profiler
from paddle_tpu_torch import compile_log as pt_compile_log
from paddle_tpu_torch.core.executor import RNG_STATE_VAR
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.profiling import op_profiler as pt_op_profiler

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1000, 64, 4, 256, 32, 2, 4


def _build(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                    n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                    d_inner=D_INNER, fuse_final_ce=True)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _feed():
    """ids as int32 (what both executors run them in, so a raw feed and a
    coerced one move the same bytes)."""
    rs = np.random.RandomState(0)
    return {"src": rs.randint(1, VOCAB, (BATCH, T, 1)).astype(np.int32),
            "trg": rs.randint(1, VOCAB, (BATCH, T, 1)).astype(np.int32),
            "lbl": rs.randint(1, VOCAB, (BATCH, T, 1)).astype(np.int32),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}


@pytest.fixture(scope="module")
def both():
    """Both packages' programs, scopes and executors from the same state,
    after one step each (so the JAX executor's cache holds the step)."""
    jm, js, jl = _build(fluid, jax_transformer)
    tm, ts, tl = _build(pt, pt_transformer)
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    persist = [v.name for v in jm.list_vars() if v.persistable]
    pt.params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in persist}, tscope, "cpu")
    feed = _feed()
    jexe.run(jm, feed=feed, fetch_list=[jl.name], scope=jscope)
    texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)
    return dict(jax=(jm, jscope, jexe, jl), port=(tm, tscope, texe, tl), feed=feed)


def _profiles(both, how):
    jm, jscope, jexe, _ = both["jax"]
    tm, tscope, texe, _ = both["port"]
    feed = both["feed"]
    if how == "profile_program":
        kw = dict(samples=1, record=False, export=False)
        return (jax_op_profiler.profile_program(jm, feed, scope=jscope, **kw),
                pt_op_profiler.profile_program(tm, feed, scope=tscope, **kw))
    return (jexe.profile_ops(jm, feed=feed, scope=jscope, samples=1),
            texe.profile_ops(tm, feed=feed, scope=tscope, samples=1))


@pytest.mark.parametrize("how", ["profile_program", "Executor.profile_ops"])
def test_profile_rows_flops_and_bytes_equal_the_jax_packages(both, how):
    """Every op of the step (fetch_list=None keeps the backward and the
    updates live), the same rows in program order, and each op's static
    cost exactly: bytes as they are, FLOPs through the JAX profile's own
    scale (its executor joins XLA's counted FLOPs; the port's scale is 1)."""
    jprof, tprof = _profiles(both, how)
    jrows = sorted((o.op_index, o.op_type) for o in jprof.ops)
    trows = sorted((o.op_index, o.op_type) for o in tprof.ops)
    assert trows == jrows
    assert tprof.ops_replayed == jprof.ops_replayed == len(both["port"][0].desc.block(0).ops)
    types = {t for _, t in trows}
    assert "adam" in types and "flash_attention_grad" in types
    assert tprof.flops_scale == 1.0 and tprof.xla_cost is None
    jby, tby = ({o.op_index: o for o in p.ops} for p in (jprof, tprof))
    for i, t in tby.items():
        j = jby[i]
        assert t.bytes == j.bytes, (i, t.op_type, t.bytes, j.bytes)
        assert t.flops * jprof.flops_scale == j.flops, (i, t.op_type)
        assert t.callsite == j.callsite
    assert 0.0 < tprof.coverage <= 1.0 + 1e-9
    assert tprof.peak_flops == jprof.peak_flops == 0.05e12   # the CPU's nominal figure


def test_profile_records_and_costmodel_have_the_jax_keys(both, tmp_path, monkeypatch):
    """``kind: op`` and ``kind: summary`` rows and ``costmodel_<pid>.json``
    with the JAX package's keys.  The JAX rows are read from its ring (its
    stream's file may have been opened in another directory earlier in the
    process); the port's from the file."""
    jm, jscope, _, _ = both["jax"]
    tm, tscope, _, _ = both["port"]
    feed = both["feed"]
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "jax"))
    n0 = len(jax_op_profiler.PROFILE_RECORDS.records())
    jprof = jax_op_profiler.profile_program(jm, feed, scope=jscope, samples=1, export=False)
    jrecs = jax_op_profiler.PROFILE_RECORDS.records()[n0:]
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "port"))
    pt_op_profiler.PROFILE_RECORDS.reopen()
    tprof = pt_op_profiler.profile_program(tm, feed, scope=tscope, samples=1, export=False)
    pt_op_profiler.PROFILE_RECORDS.reopen()
    with open(tmp_path / "port" / f"profile_{os.getpid()}.jsonl") as f:
        trecs = [json.loads(line) for line in f]
    for kind in ("op", "summary"):
        jk = {frozenset(r) for r in jrecs if r["kind"] == kind}
        tk = {frozenset(r) for r in trecs if r["kind"] == kind}
        assert len(jk) == len(tk) == 1 and tk == jk, kind
    assert sum(r["kind"] == "op" for r in trecs) == len(tprof.ops)
    jpath = jax_op_profiler.export_costmodel(jprof, out_dir=str(tmp_path / "jax_cm"))
    tpath = pt_op_profiler.export_costmodel(tprof, out_dir=str(tmp_path / "port_cm"))
    jdoc, tdoc = (json.loads(open(p).read()) for p in (jpath, tpath))
    assert set(tdoc) == set(jdoc)
    assert set(tdoc["types"]) == set(jdoc["types"])
    for name, row in tdoc["types"].items():
        assert set(row) == set(jdoc["types"][name]), name


def _snapshot(scope, names):
    return {n: (scope.find_var(n).clone(), scope.find_var(n).data_ptr()) for n in names}


def test_profile_ops_writes_nothing(both):
    """After two profiles (one with a warm-up pass and two samples) every
    persistable is bit-equal and at its address, the scope's generator and
    the default generator are where they were, and the executor built no
    cache entry."""
    tm, tscope, texe, tl = both["port"]
    persist = [v.name for v in tm.list_vars() if v.persistable]
    before = _snapshot(tscope, persist)
    gen = tscope.find_var(RNG_STATE_VAR).get_state()
    default = torch.get_rng_state()
    info = texe.cache_info()
    texe.profile_ops(tm, feed=both["feed"], scope=tscope, samples=2)
    pt.profiler.profile_ops(tm, both["feed"], scope=tscope, executor=texe)
    for n, (t, ptr) in before.items():
        now = tscope.find_var(n)
        assert now.data_ptr() == ptr and torch.equal(now, t), n
    assert torch.equal(tscope.find_var(RNG_STATE_VAR).get_state(), gen)
    assert torch.equal(torch.get_rng_state(), default)
    after = texe.cache_info()
    assert (after["executables"], after["compile_count"], after["runs"]) == \
        (info["executables"], info["compile_count"], info["runs"])


def test_profile_of_a_fetch_prunes_to_its_live_slice(both):
    """A loss fetch keeps the forward only: no grad or update row."""
    tm, tscope, texe, tl = both["port"]
    prof = texe.profile_ops(tm, feed=both["feed"], fetch_list=[tl], scope=tscope, samples=1)
    types = {o.op_type for o in prof.ops}
    assert not any(t.endswith("_grad") or t == "adam" for t in types)
    assert "fused_fc_softmax_ce" in types


def test_profiler_profile_ops_spans_by_op_type(both):
    """``profiler.profile_ops``: one ``op::<type>`` span an op, summed by
    type, the timeline left as it was (disabled)."""
    tm, tscope, texe, _ = both["port"]
    assert not pt.telemetry.TIMELINE.enabled
    timings = pt.profiler.profile_ops(tm, both["feed"], scope=tscope, executor=texe, repeat=2)
    types = [o.type for o in tm.desc.block(0).ops]
    assert set(timings) == set(types)
    assert timings["adam"]["calls"] == 2 * types.count("adam")
    assert all(r["total"] >= r["max"] >= r["min"] >= 0 for r in timings.values())
    assert not pt.telemetry.TIMELINE.enabled


def _trainer(profile_steps=None):
    def train_func():
        src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pt.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pt.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = pt_transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                               n_layer=N_LAYER, d_model=D_MODEL,
                                               n_head=N_HEAD, d_inner=D_INNER,
                                               fuse_final_ce=True)
        return loss
    with pt.unique_name.guard():
        return pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=1e-3),
                          place=pt.CPUPlace(), profile_steps=profile_steps)


def _samples(n, seed=0):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield (rs.randint(1, VOCAB, (rs.randint(17, T + 1), 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64))
    return reader


@pytest.mark.parametrize("pipeline", [True, False])
def test_trainer_profile_steps_trains_bit_equal_to_no_profiles(tmp_path, monkeypatch, pipeline):
    """Four steps with ``profile_steps=2`` against four without, from the
    same state: losses and every persistable bit-equal; two profiles of
    the training step (grad and update rows) in ``profile_<pid>.jsonl``,
    each carrying the step's measured run time."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    pt_op_profiler.PROFILE_RECORDS.reopen()
    prof, plain = _trainer(profile_steps=2), _trainer()
    plain.pipeline = prof.pipeline = pipeline
    persist = [v.name for v in prof.train_program.list_vars() if v.persistable]
    for n in persist:
        plain.scope.find_var(n).copy_(prof.scope.find_var(n))
    runs = {}
    for name, tr in (("profiled", prof), ("plain", plain)):
        losses = []

        def handler(ev):
            if isinstance(ev, pt.EndStepEvent):
                losses.append(np.asarray(ev.metrics[0]).copy())
        tr.train(1, handler, reader=pt.batch(_samples(4 * BATCH), BATCH),
                 feed_order=["src", "trg", "lbl"])
        runs[name] = losses
    pt_op_profiler.PROFILE_RECORDS.reopen()
    assert len(runs["profiled"]) == 4
    for a, b in zip(runs["profiled"], runs["plain"]):
        assert np.array_equal(a, b)
    for n in persist:
        assert torch.equal(prof.scope.find_var(n), plain.scope.find_var(n)), n
    with open(tmp_path / f"profile_{os.getpid()}.jsonl") as f:
        recs = [json.loads(line) for line in f]
    summaries = [r for r in recs if r["kind"] == "summary"]
    assert len(summaries) == 2
    assert all(r.get("compiled_step_s") is not None and r["coverage"] > 0.5 for r in summaries)
    types = {r["op_type"] for r in recs if r["kind"] == "op"}
    assert "adam" in types and any(t.endswith("_grad") for t in types)
    assert os.path.exists(tmp_path / f"costmodel_{os.getpid()}.json")


def test_trainer_profile_failure_is_logged_not_raised(monkeypatch, capsys):
    """A profile that raises costs the run nothing but a VLOG(1) line."""
    from paddle_tpu_torch import log
    tr = _trainer(profile_steps=1)
    tr.pipeline = False

    def broken(*a, **kw):
        raise RuntimeError("profile broke")
    monkeypatch.setattr(tr.exe, "profile_ops", broken)
    log.set_verbosity(1, "trainer")
    try:
        losses = []
        tr.train(1, lambda ev: losses.append(1) if isinstance(ev, pt.EndStepEvent) else None,
                 reader=pt.batch(_samples(2 * BATCH), BATCH), feed_order=["src", "trg", "lbl"])
    finally:
        log.set_verbosity(0, "trainer")
    assert len(losses) == 2
    assert capsys.readouterr().err.count("profile_ops failed: RuntimeError: profile broke") == 2


def _sig(**kw):
    base = {"program_fp": "fp0", "scope": "executor:1",
            "feed_sig": [["x", [4, 8], "float32"], ["ids", [4], "int32"]],
            "state_sig": [["w", [8, 8], "float32"], ["b", None, None]],
            "fetch_names": ["loss"], "donated": ["w"], "mesh": None, "amp": False,
            "layout": None, "passes": None, "kernels": None}
    base.update(kw)
    return base


SIG_PAIRS = [
    (None, _sig()),
    (_sig(), _sig()),
    (_sig(), _sig(program_fp="fp1")),
    (_sig(), _sig(feed_sig=[["x", [4, 16], "float32"], ["ids", [4], "int32"]])),
    (_sig(), _sig(feed_sig=[["x", [4, 8], "bfloat16"], ["ids", [4], "int32"]])),
    (_sig(), _sig(feed_sig=[["x", [4, 8], "float32"]])),
    (_sig(), _sig(state_sig=[["w", [8, 8], "float32"], ["b", [8], "float32"],
                             ["m", [8], "float32"]])),
    (_sig(), _sig(fetch_names=["loss", "acc"], scope="executor:2")),
    (_sig(), _sig(donated=[], amp="ab12", passes="cd34", kernels="ef56")),
    (_sig(), _sig(mesh={"axes": {"data": 2}}, layout="0123")),
]


@pytest.mark.parametrize("pair", range(len(SIG_PAIRS)))
def test_diff_signatures_equal_to_the_jax_packages(pair):
    prev, cur = SIG_PAIRS[pair]
    assert pt_compile_log.diff_signatures(prev, cur) == \
        jax_compile_log.diff_signatures(prev, cur)


def test_summarize_compile_records_equal_to_the_jax_packages():
    recs = [{"kind": k, "compile_s": s, "program_uid": u, "scope": "executor:1",
             "fingerprint": "abcdef0123456789", "program_fp": "0123456789ab",
             "reasons": r, "amp": a, "kernels": kf}
            for k, s, u, r, a, kf in (
                ("capture", 1.5, 1, ["new-program"], False, None),
                ("eager", 0.1, 2, ["new-program", "eager:initializes state (2 vars: a, b)"],
                 False, None),
                ("capture", 2.0, 1, ["feed-shape-change:x (4,8)->(4,16)"], "ab12", "cd34"),
                ("capture", 2.5, 1, ["feed-shape-change:x (4,16)->(4,32)"], "ab12", "cd34"))]
    assert pt_compile_log.summarize_compile_records(recs) == \
        jax_compile_log.summarize_compile_records(recs)


def test_peak_flops_table():
    """The card's spec-sheet dense bf16 peak by name; the CPU's nominal
    figure; an unknown card's 100 TFLOP/s."""
    assert pt_op_profiler.peak_flops_of("NVIDIA H100 80GB HBM3") == 989e12
    assert pt_op_profiler.peak_flops_of("NVIDIA H100 PCIe") == 756e12
    assert pt_op_profiler.peak_flops_of(torch.device("cpu")) == 0.05e12
    assert pt_op_profiler.peak_flops_of("some other card") == 100e12
    assert (pt_op_profiler.OVERHEAD_WALL_S, pt_op_profiler.RIDGE_FLOPS_PER_BYTE) == \
        (jax_op_profiler.OVERHEAD_WALL_S, jax_op_profiler.RIDGE_FLOPS_PER_BYTE)
