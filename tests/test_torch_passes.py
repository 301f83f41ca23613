"""The seed passes and the verifier-checked pipeline ported
(``paddle_tpu_torch.passes``), against the JAX package's on the CPU.

* Each seed pass (``fuse-fc-softmax-ce``, ``dead-op-elim``,
  ``donation-insert``; ``bn-fold`` in tests/test_torch_cnn_ops.py) and the
  default pipeline rewrite a program built by both packages into equal
  ProgramDescs (callsite scrubbed), with equal ``PipelineResult``\\ s
  (ops removed and added, vars, ``donate_vars``, verify counts before and
  after); the M502/M503 corpus of tests/test_passes.py re-plans with no
  M502/M503 at a lower peak.
* The reference path's eval clone (1+1 layers) through ``passes=True``:
  one head fused; the fused eval's loss within rtol 1e-5 / atol 1e-6 of
  the unfused eval's and of the JAX package's fused eval from the same
  parameters; fusion skips training programs.
* The pipeline's invariants: a hostile pass raises
  ``PassVerificationError`` naming it (``"warn"`` warns), a version bump
  is supplied, an identity pipeline returns the input program;
  ``make_pipeline`` spellings and ``compose_passes`` ordering equal to
  the JAX package's.
* ``Executor(passes=True)`` on the corpus bit-equal to the plain run; a
  ``donate`` stamp (run as ``donate_feeds=True``) is a cache entry of its
  own, empties a donatable staged batch and leaves the fetches
  bit-equal; ``Inferencer(passes=True)``; ``InferenceTranspiler``;
  ``tools/pass_report.py`` on the port's dumps.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.passes  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu.amp import compose_passes as jax_compose_passes
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.ops.pallas.policy import KernelPolicy as JaxKernelPolicy
from paddle_tpu_torch.amp import compose_passes
from paddle_tpu_torch.analysis import memory, plan_memory
from paddle_tpu_torch.core.desc import PASS_PROVENANCE_ATTR
from paddle_tpu_torch.core.staging import StagedBatch
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.passes import (PassPipeline, PassResult, PassVerificationError,
                                     ProgramPass, default_pipeline, make_pipeline)
from test_torch_analysis import reference_net, transformer_feed
from test_torch_memory import _dead_chain_program, build

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEED_SHAPES = {"x": (64, 16384)}
# the fused head sums the loss in another order than softmax + CE
FUSE_RTOL, FUSE_ATOL = 1e-5, 1e-6


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def descs_equal(a, b):
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert [o["type"] for o in da["blocks"][0]["ops"]] == \
        [o["type"] for o in db["blocks"][0]["ops"]]
    assert da == db and a.desc.fingerprint() == b.desc.fingerprint()


def result_key(res):
    """A PipelineResult without its wall times, fingerprints and callsites."""
    d = res.to_dict()
    d.pop("wall_s")
    for r in d["passes"]:
        r.pop("wall_s")
        for op in r["ops_added"] + r["ops_removed"]:
            op.pop("callsite")
    return d


def _mcounts(plan):
    codes = [d.code for d in memory.memory_diagnostics(plan)]
    return {c: codes.count(c) for c in ("M502", "M503")}


# ------------------------------------------------------- seed-pass parity

@pytest.mark.parametrize("passes", [["dead-op-elim"], ["donation-insert"],
                                    ["dead-op-elim", "donation-insert"], "default"])
def test_seed_passes_rewrite_the_corpus_as_the_jax_package(passes):
    (jm, _, fetch), (tm, _, _) = build(fluid, _dead_chain_program), \
        build(pt, _dead_chain_program)
    jpipe = fluid.passes.default_pipeline() if passes == "default" \
        else fluid.passes.PassPipeline(passes)
    tpipe = default_pipeline() if passes == "default" else PassPipeline(passes)
    assert tpipe.fingerprint() == jpipe.fingerprint()
    a, jres = jpipe.run(jm, fetch_list=fetch, feed_shapes=FEED_SHAPES)
    b, res = tpipe.run(tm, fetch_list=fetch, feed_shapes=FEED_SHAPES)
    descs_equal(a, b)
    assert result_key(res) == result_key(jres) and res.changed
    assert res.verify_counts_pre and res.verify_counts_post["error"] == 0
    before = plan_memory(tm, fetch_list=fetch, feed_shapes=FEED_SHAPES)
    after = plan_memory(b, fetch_list=fetch, feed_shapes=FEED_SHAPES)
    assert after.peak_bytes < before.peak_bytes
    if "donation-insert" in passes or passes == "default":
        assert res.donate_vars == ["x"]
        assert b.desc.block(0).find_var("x").attrs.get(memory.DONATE_ATTR) is True
    if passes == "default" or passes[-1] == "donation-insert" and len(passes) == 2:
        assert _mcounts(after) == {"M502": 0, "M503": 0}


def _ref_eval(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = reference_net(pkg, mod)
    return main.clone(for_test=True), startup, loss.name


@pytest.fixture(scope="module")
def ref_evals():
    """The reference path's eval clone built by both packages, the JAX
    startup's parameters carried into the port's scope."""
    jtest, js, jloss = _ref_eval(fluid, jax_transformer)
    ttest, ts, tloss = _ref_eval(pt, pt_transformer)
    assert jloss == tloss
    descs_equal(jtest, ttest)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {n: np.array(jscope.find_var(n)) for n, v in jtest.desc.block(0).vars.items()
             if v.persistable and jscope.find_var(n) is not None}
    tscope = pt.Scope()
    pt.Executor(pt.CPUPlace(), validate="off").run(ts, scope=tscope)
    pt.params_from_numpy(state, tscope, "cpu")
    return (jtest, jexe, jscope), (ttest, tscope), tloss


def test_fuse_pass_rewrites_the_reference_eval_as_the_jax_package(ref_evals):
    (jtest, _, _), (ttest, _), loss = ref_evals
    fs = {k: v.shape for k, v in transformer_feed(weights=True).items()}
    a, jres = fluid.passes.default_pipeline().run(jtest, fetch_list=[loss], feed_shapes=fs)
    b, res = default_pipeline().run(ttest, fetch_list=[loss], feed_shapes=fs)
    descs_equal(a, b)
    assert result_key(res) == result_key(jres)
    fuse = res.passes[0]
    assert fuse.name == "fuse-fc-softmax-ce" and fuse.ops_replaced == 1
    assert "1 softmax+cross_entropy head(s) fused" in fuse.notes[0]
    types = [o.type for o in b.desc.block(0).ops]
    assert types.count("fused_fc_softmax_ce") == 1 and "softmax_with_cross_entropy" not in types
    blk = b.desc.block(0)
    (op,) = [o for o in blk.ops if o.type == "fused_fc_softmax_ce"]
    (ce,) = [o for o in ttest.desc.block(0).ops if o.type == "softmax_with_cross_entropy"]
    # the loss keeps its name and the unfused loss's shape; @LSE is added
    assert op.output("Loss") == ce.output("Loss")
    assert blk.find_var(op.output("Loss")[0]).shape == \
        ttest.desc.block(0).find_var(ce.output("Loss")[0]).shape == (-1, -1, 1)
    assert op.output("LogSumExp") == [op.output("Loss")[0] + "@LSE"]
    assert tuple(blk.find_var(op.output("LogSumExp")[0]).shape) == (-1,)
    # the fused program plans without the [rows, vocab] logits and softmax
    unfused = plan_memory(ttest, fetch_list=[loss], feed_shapes=fs).peak_bytes
    fused = plan_memory(b, fetch_list=[loss], feed_shapes=fs).peak_bytes
    assert fused < unfused - 2 * 4 * 32 * 1000 * 4 // 2


def test_fused_eval_matches_the_unfused_eval_and_the_jax_fused_eval(ref_evals):
    (jtest, jexe, jscope), (ttest, tscope), loss = ref_evals
    feed = transformer_feed(weights=True, seed=3)
    plain = pt.Executor(pt.CPUPlace(), validate="error")
    fusing = pt.Executor(pt.CPUPlace(), validate="error", passes=True)
    (want,) = plain.run(ttest, feed=feed, fetch_list=[loss], scope=tscope)
    (got,) = fusing.run(ttest, feed=feed, fetch_list=[loss], scope=tscope)
    ran = fusing._apply_passes(ttest, list(feed), [loss], tscope)
    assert "fused_fc_softmax_ce" in [o.type for o in ran.desc.block(0).ops]
    np.testing.assert_allclose(got, want, rtol=FUSE_RTOL, atol=FUSE_ATOL)
    jfused, _ = fluid.passes.default_pipeline().run(jtest, fetch_list=[loss])
    (jgot,) = jexe.run(jfused, feed=feed, fetch_list=[loss], scope=jscope)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=FUSE_RTOL, atol=FUSE_ATOL)


def test_fusion_skips_training_programs():
    def fn(pkg):
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        logits = pkg.layers.fc(input=x, size=8)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]
    (jm, _, fetch), (tm, _, _) = build(fluid, fn), build(pt, fn)
    prog, res = PassPipeline(["fuse-fc-softmax-ce"]).run(tm, fetch_list=fetch)
    _, jres = fluid.passes.PassPipeline(["fuse-fc-softmax-ce"]).run(jm, fetch_list=fetch)
    assert prog is tm and not res.changed and "training" in res.passes[0].skipped
    assert result_key(res) == result_key(jres)


# ------------------------------------------------ pipeline invariants

class _HostilePass(ProgramPass):
    """Removes the fetch target's producer and leaves the version where it
    was, as a faulty desc-level rewrite would."""

    name = "hostile"

    def apply(self, ctx, result: PassResult) -> None:
        block = ctx.desc.block(0)
        target = ctx.fetch_names[0]
        block.ops = [op for op in block.ops if target not in op.output_names()]
        result.changed = True


def test_a_pass_introducing_a_finding_raises_naming_the_pass():
    tm, _, fetch = build(pt, _dead_chain_program)
    with pytest.raises(PassVerificationError) as ei:
        PassPipeline([_HostilePass()]).run(tm, fetch_list=fetch)
    assert ei.value.pass_name == "hostile" and "hostile" in str(ei.value)
    assert any(d.code == "D203" for d in ei.value.introduced)
    with pytest.warns(UserWarning, match="hostile"):
        PassPipeline([_HostilePass()], verify="warn").run(tm, fetch_list=fetch)
    v0, uid0 = tm.desc.version, tm.desc.uid
    rewritten, res = PassPipeline([_HostilePass()], verify="off").run(tm, fetch_list=fetch)
    assert rewritten.desc.uid == uid0 and rewritten.desc.version > v0
    assert any("version bump supplied" in n for n in res.passes[0].notes)
    _, res2 = PassPipeline([_HostilePass(), "dead-op-elim"], verify="off").run(
        tm, fetch_list=fetch)
    assert res2.version_after != res.version_after


def test_an_identity_pipeline_returns_the_input_program():
    tm, _, fetch = build(pt, _dead_chain_program)
    prog, res = PassPipeline(["bn-fold"]).run(tm, fetch_list=fetch, scope=pt.Scope())
    assert prog is tm and not res.changed


def test_make_pipeline_spellings_and_compose_order():
    assert make_pipeline(None) is None and make_pipeline(False) is None
    p = make_pipeline(True)
    assert [q.name for q in p.passes] == ["fuse-fc-softmax-ce", "bn-fold", "dead-op-elim",
                                          "donation-insert"]
    assert make_pipeline(p) is p and p.verify == "error"
    named = make_pipeline(["dead-op-elim"])
    assert [q.name for q in named.passes] == ["dead-op-elim"] and named.verify == "error"
    with pytest.raises(KeyError):
        make_pipeline(["no-such-pass"])
    assert make_pipeline(["dead-op-elim", "donation-insert"]).fingerprint() == \
        fluid.passes.make_pipeline(["dead-op-elim", "donation-insert"]).fingerprint()
    assert make_pipeline(["dead-op-elim", "donation-insert"]).fingerprint() != \
        make_pipeline(["donation-insert", "dead-op-elim"]).fingerprint()
    # the amp and kernel passes slot in before the liveness passes
    from paddle_tpu_torch.passes import KernelPolicy
    knobs = ("flash_block_q", "flash_block_k", "flash_min_block_q", "flash_lane",
             "flash_vmem_budget", "gather_min_rows", "int8_min_k", "int8_min_n",
             "adam_min_params", "sgd_min_params")
    ref = JaxKernelPolicy()
    policy = KernelPolicy(**{k: getattr(ref, k) for k in knobs if hasattr(ref, k)})
    for amp in (None, pt.amp.AmpConfig(), pt.amp.AmpConfig(bf16=False, quant=True)):
        jamp = None if amp is None else fluid.amp.AmpConfig(bf16=amp.bf16, quant=amp.quant)
        ours = compose_passes(True, amp, kernels=policy)
        theirs = jax_compose_passes(True, jamp, kernels=ref)
        assert [q.name for q in ours.passes] == [q.name for q in theirs.passes]
        assert ours.verify == theirs.verify == "error"


# ------------------------------------------ executor / serving plumbing

def _run_corpus(exe_kw, feed, scope=None):
    tm, ts, fetch = build(pt, _dead_chain_program)
    if scope is None:
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace(), validate="off").run(ts, scope=scope)
    exe = pt.Executor(pt.CPUPlace(), **exe_kw)
    return exe.run(tm, feed=dict(feed), fetch_list=fetch, scope=scope), exe, tm, fetch, scope


def test_executor_passes_true_on_the_corpus_is_bit_equal():
    feed = {"x": np.random.RandomState(4).rand(64, 16384).astype(np.float32)}
    (want,), _, _, _, scope = _run_corpus({}, feed)
    (got,), exe, tm, fetch, _ = _run_corpus({"passes": True, "validate": "error"}, feed, scope)
    np.testing.assert_array_equal(got, want)
    ran = exe._apply_passes(tm, ["x"], fetch, scope)
    plan = plan_memory(ran, fetch_list=fetch, feed_shapes=FEED_SHAPES)
    assert _mcounts(plan) == {"M502": 0, "M503": 0}
    assert plan.peak_bytes < plan_memory(tm, fetch_list=fetch, feed_shapes=FEED_SHAPES).peak_bytes
    assert ran.desc.block(0).find_var("x").attrs.get(memory.DONATE_ATTR) is True


def test_a_donate_stamp_donates_a_staged_batch_and_changes_no_fetch():
    """The stamped program runs as ``run(donate_feeds=True)``: a
    ``donatable`` staged batch is emptied (the step holds its tensors),
    the entry is one of its own (the stamp moves the fingerprint, and the
    flag is in the key) and the fetches are bit-equal to the unstamped
    program's."""
    tm, ts, fetch = build(pt, _dead_chain_program)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace(), validate="off").run(ts, scope=scope)
    stamped, _ = PassPipeline(["donation-insert"]).run(tm, fetch_list=fetch,
                                                       feed_shapes=FEED_SHAPES)
    assert stamped.desc.fingerprint() != tm.desc.fingerprint()
    x = np.random.RandomState(5).rand(64, 16384).astype(np.float32)
    exe = pt.Executor(pt.CPUPlace())
    (want,) = exe.run(tm, feed={"x": x}, fetch_list=fetch, scope=scope)
    batch = StagedBatch({"x": pt.core.executor.torch.from_numpy(x.copy())})
    batch.donatable = True
    (got,) = exe.run(stamped, feed=batch, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(got, want)
    assert len(batch) == 0
    entries = exe.cache_info()["entries"]
    assert len(entries) == 2 and entries[0]["fingerprint"] != entries[1]["fingerprint"]
    kept = StagedBatch({"x": pt.core.executor.torch.from_numpy(x.copy())})
    (again,) = exe.run(stamped, feed=kept, fetch_list=fetch, scope=scope)
    np.testing.assert_array_equal(again, want)
    assert len(kept) == 1                  # not donatable: the caller keeps it


def test_inferencer_passes_true_fuses_and_folds():
    def infer_func():
        img = pt.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        c = pt.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        bn = pt.layers.batch_norm(c, act="relu", is_test=True)
        return pt.layers.fc(input=bn, size=3, act="softmax")
    x = np.random.RandomState(5).rand(2, 3, 8, 8).astype(np.float32)
    plain = pt.Inferencer(infer_func, place=pt.CPUPlace())
    (want,) = plain.infer({"img": x})
    folded = pt.Inferencer(infer_func, place=pt.CPUPlace(), passes=True, validate="error")
    for n in plain.scope._vars:
        v = plain.scope.find_var(n)
        if hasattr(v, "copy_") and folded.scope.find_var(n) is not None:
            folded.scope.find_var(n).copy_(v)
    (got,) = folded.infer({"img": x})
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    ran = folded.exe._apply_passes(folded.inference_program, ["img"],
                                   [v.name for v in folded.predict_vars], folded.scope)
    assert "batch_norm" not in [o.type for o in ran.desc.block(0).ops]


def test_inference_transpiler_wraps_the_bn_fold_pass():
    def fn(pkg):
        img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1, bias_attr=False)
        bn = pkg.layers.batch_norm(c)
        return [pkg.layers.fc(input=bn, size=2)]
    tm, ts, fetch = build(pt, fn)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace(), validate="off").run(ts, scope=scope)
    legacy = tm.clone(for_test=True)
    pt.InferenceTranspiler().transpile(legacy, scope=scope)
    via_pass, _ = PassPipeline(["bn-fold"]).run(tm.clone(for_test=True), fetch_list=fetch,
                                                scope=scope)
    assert legacy.desc.fingerprint() == via_pass.desc.fingerprint()
    inserted = [o for o in via_pass.desc.block(0).ops if o.attrs.get(PASS_PROVENANCE_ATTR)]
    assert inserted and inserted[0].attrs[PASS_PROVENANCE_ATTR] == "bn-fold"
    with pytest.raises(ValueError, match="test-mode"):
        pt.InferenceTranspiler().transpile(tm, scope=scope)
    pt.transpiler.memory_optimize(tm)
    pt.transpiler.release_memory(tm)


# ----------------------------------------------------------------- tools

def test_pass_report_reads_the_ports_dumps_and_passes_records(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROGRAM_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    feed = {"x": np.zeros((64, 16384), np.float32)}
    _run_corpus({"passes": True}, feed)
    recs = [json.loads(line) for f in tmp_path.glob("passes_*.jsonl") for line in open(f)]
    assert recs and all(r["verify_pre"] and r["verify_post"] for r in recs)
    seed = [r for r in recs if [p["name"] for p in r["passes"]][:1] == ["fuse-fc-softmax-ce"]]
    assert seed and seed[0]["donate_vars"] == ["x"]
    # the executor dumps the program it runs (the rewrite); the input
    # program goes beside it, as the JAX package's test writes one
    tm, _, fetch = build(pt, _dead_chain_program)
    (tmp_path / "program_0_0_v0.json").write_text(json.dumps(
        {"program": tm.desc.to_dict(), "fetch_names": fetch, "feed_names": ["x"],
         "feed_shapes": {"x": [64, 16384]}, "mesh": None}))
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "pass_report.py"),
                        str(tmp_path), "--json"], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    rep = json.loads(p.stdout)
    assert rep["jax_free"] is True
    (row,) = [r for r in rep["files"] if r["m503_before"]]
    assert row["m502_before"] >= 1 and row["m502_after"] == row["m503_after"] == 0
    assert row["peak_bytes_after"] < row["peak_bytes_before"]
    assert {r["name"]: r["skipped"] for r in row["passes"]}["bn-fold"]   # no scope in a dump
