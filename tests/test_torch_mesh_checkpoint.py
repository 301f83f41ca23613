"""Sharded state on a mesh: multi-rank checkpoints with a resharded
restore, ``Trainer(checkpoint=, health=)`` under a mesh, the sentinel's
global norms, ``FLAGS_check_nan_inf``'s global mode and
``tools/health_report.py`` over the ranks' streams, against one process
and the JAX package.

The module computes the JAX package's references first (the 1+1
transformer's and the MLP's initial state, its table trained and saved on
a 2 x 2 mesh of its virtual CPU devices), then spawns two gloo ranks on
the CPU once (``_torch_mesh_ranks.spawn``, suite ``mesh_checkpoint``),
each writing its telemetry into one directory.  The parent then holds the
ranks' checkpoint against the JAX package's ``CheckpointManager.restore``
and the port's own restore onto no mesh.

Tolerances: every restore is bit-equal.  The next step after a restore
onto the source's layout gives the source's loss bit for bit; onto
``{"data": 2}`` within 1e-5 relative (its gradients are all-reduced, the
source's reduce-scattered; equal in development runs).  The sentinel's
norms on the mesh within 1e-5 relative of one process's: the ranks' sums
of squares add in another order (equal in development runs on the CPU).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.parallel import SpecLayout as JaxSpecLayout
from paddle_tpu.parallel import make_mesh as jax_make_mesh

import _torch_mesh_ranks as R
from _torch_validate import _no_port_validate_findings  # noqa: F401

WORLD = 2
NEXT_LOSS_RTOL = 1e-5
SENTINEL_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _persist(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name)) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _jax_refs(wd):
    refs = {}
    for name, build in (("tf_init", R.build_transformer), ("mlp_init", R.build_mlp)):
        main, startup, _ = build(fluid)
        scope = fluid.Scope()
        fluid.Executor().run(startup, scope=scope)
        np.savez(os.path.join(wd, f"{name}.npz"), **_persist(main, scope))
    # the JAX package's table, trained and saved on its 2 x 2 mesh
    from paddle_tpu.checkpoint import CheckpointManager as JaxManager
    main, startup, loss = R.build_table(fluid, True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    mesh = jax_make_mesh({"fsdp": 2, "tp": 2}, devices=jax.devices()[:4])
    layout = JaxSpecLayout()
    exe = fluid.Executor(mesh=mesh, layout=layout)
    for f in R.table_feeds():
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    JaxManager(os.path.join(wd, "ckpt_jax"), async_save=False).save(main, scope, step=3, mesh=mesh,
                                                                   layout=layout)
    refs["jax_table"] = np.asarray(scope.find_var("user_table"))
    np.savez(os.path.join(wd, "jax_table.npz"), user_table=refs["jax_table"])
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mesh_checkpoint"))
    refs = _jax_refs(wd)
    tel = os.path.join(wd, "telemetry")
    os.makedirs(tel)
    return R.spawn("mesh_checkpoint", WORLD, wd, env={"PADDLE_TPU_TELEMETRY_DIR": tel}), refs, wd


def _value(ranks, case):
    recs, _, _ = ranks
    out = []
    for rec in recs:
        assert rec[case]["ok"], rec[case].get("error")
        out.append(rec[case]["value"])
    return out


# -------------------------------------------------------------- the save
@pytest.mark.parametrize("step", ["2", "3"])
def test_two_ranks_write_a_shard_file_each_and_one_manifest_naming_both(ranks, step):
    """Step 2 saved synchronously, step 3 through the async writer."""
    for v in _value(ranks, "ckpt_save"):
        rec = v[step]
        assert rec["shards"] == {"0": "shard_r0.npz", "1": "shard_r1.npz"}
        assert rec["files"] == ["manifest.json", "program.json", "shard_r0.npz", "shard_r1.npz"]
        assert rec["validate"]["ranks"] == WORLD
        assert v["steps"] == [2, 3] and v["async"] is True


@pytest.mark.parametrize("step", ["2", "3"])
def test_each_chunk_is_written_once_by_the_lowest_rank_that_holds_it(ranks, step):
    """A var the layout shards has one chunk a rank; a replicated one a
    single chunk (rank 0's), which ``validate_shards`` would refuse twice."""
    for v in _value(ranks, "ckpt_save"):
        rec = v[step]
        assert rec["sharded"], "fsdp shards nothing"
        for n, c in rec["chunks"].items():
            assert c == (WORLD if n in rec["sharded"] else 1), n
        assert rec["validate"]["chunks"] == sum(rec["chunks"].values())


def test_the_manifest_records_the_mesh_and_the_layout(ranks):
    for v in _value(ranks, "ckpt_save"):
        assert v["2"]["mesh"] == {"axes": {"fsdp": WORLD}}
        assert v["2"]["layout_fp"] is True


def test_validate_shards_passes_on_the_parent_side(ranks):
    from paddle_tpu.checkpoint import manifest as jax_manifest
    from paddle_tpu_torch.checkpoint import checkpoint_dir, read_manifest, validate_shards
    _, _, wd = ranks
    for step in (2, 3):
        d = checkpoint_dir(os.path.join(wd, "ckpt_tf"), step)
        got = validate_shards(d, read_manifest(d))
        assert got == jax_manifest.validate_shards(d, jax_manifest.read_manifest(d))
        assert got["ranks"] == WORLD


# ----------------------------------------------------------- the restore
LAYOUTS = ["data2", "fsdp2"]


@pytest.mark.parametrize("key", LAYOUTS)
def test_restore_onto_a_layout_is_bit_equal(ranks, key):
    for v in _value(ranks, "ckpt_restore"):
        rec = v[key]
        assert rec["diffs"] == {}
        assert rec["source_mesh"] == {"axes": {"fsdp": WORLD}}
        want = ["Replicate()"] if key == "data2" else ["Shard(dim=0)"]
        assert rec["placements"]["src_emb"] == want


@pytest.mark.parametrize("key", LAYOUTS)
def test_a_second_restore_copies_into_the_same_tensors(ranks, key):
    for v in _value(ranks, "ckpt_restore"):
        assert v[key]["in_place"]


@pytest.mark.parametrize("key", LAYOUTS)
def test_the_step_after_a_restore_gives_the_sources_loss(ranks, key):
    src = _value(ranks, "ckpt_save")
    for s, v in zip(src, _value(ranks, "ckpt_restore")):
        if key == "fsdp2":
            assert v[key]["loss3"] == s["loss3"]
        else:
            np.testing.assert_allclose(v[key]["loss3"], s["loss3"], rtol=NEXT_LOSS_RTOL)


@pytest.mark.parametrize("key", LAYOUTS)
def test_an_impossible_budget_raises_m501_before_any_placement(ranks, key):
    for v in _value(ranks, "ckpt_restore"):
        assert v[key]["m501"] == "M501" and v[key]["untouched"]


@pytest.mark.parametrize("key", LAYOUTS)
def test_the_restore_record_carries_source_and_target_mesh(ranks, key):
    for v in _value(ranks, "ckpt_restore"):
        assert v[key]["record"] == {"source_mesh": {"fsdp": WORLD},
                                    "target_mesh": {key[:-1]: WORLD}}


def _port_program_scope(build):
    main, startup, _ = build(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    return main, scope


def test_the_ranks_checkpoint_restores_onto_no_mesh(ranks):
    from paddle_tpu_torch.checkpoint import CheckpointManager
    _, _, wd = ranks
    want = R._load(wd, "ck_state2.npz")
    main, scope = _port_program_scope(R.build_transformer)
    CheckpointManager(os.path.join(wd, "ckpt_tf")).restore(main, scope, step=2)
    for n, a in want.items():
        got = scope.find_var(n)
        assert not hasattr(got, "placements")
        np.testing.assert_array_equal(got.numpy().reshape(a.shape), a, err_msg=n)


def test_the_jax_package_restores_the_ranks_checkpoint_bit_equal(ranks):
    from paddle_tpu.checkpoint import CheckpointManager as JaxManager
    _, _, wd = ranks
    want = R._load(wd, "ck_state2.npz")
    main, startup, _ = R.build_transformer(fluid)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    JaxManager(os.path.join(wd, "ckpt_tf"), async_save=False).restore(main, scope, step=2)
    for n, a in want.items():
        np.testing.assert_array_equal(np.asarray(scope.find_var(n)).reshape(a.shape), a,
                                      err_msg=n)


def test_the_port_restores_the_jax_checkpoint_onto_no_mesh(ranks):
    from paddle_tpu_torch.checkpoint import CheckpointManager, read_manifest
    _, refs, wd = ranks
    root = os.path.join(wd, "ckpt_jax")
    man = read_manifest(os.path.join(root, "ckpt_3"))
    assert list(man["shards"]) == ["0"] and len(man["shards"]["0"]["chunks"]["user_table"]) == 4
    main, scope = _port_program_scope(lambda pkg: R.build_table(pkg, True))
    CheckpointManager(root).restore(main, scope)
    np.testing.assert_array_equal(scope.find_var("user_table").numpy(), refs["jax_table"])


def test_the_port_restores_the_jax_checkpoint_onto_the_ranks_mesh(ranks):
    for v in _value(ranks, "ckpt_restore"):
        assert v["jax_table"] == {"equal": True, "placements": ["Shard(dim=0)"],
                                  "local": [R.TBL["rows"] // WORLD, R.TBL["dim"]]}


def test_an_impossible_budget_raises_m501_in_both_packages(ranks):
    from paddle_tpu.analysis import PredictedOOMError as JaxOOM
    from paddle_tpu.checkpoint import CheckpointManager as JaxManager
    from paddle_tpu_torch.analysis import PredictedOOMError
    from paddle_tpu_torch.checkpoint import CheckpointManager
    _, _, wd = ranks
    root = os.path.join(wd, "ckpt_tf")
    main, scope = _port_program_scope(R.build_transformer)
    with pytest.raises(PredictedOOMError) as got:
        CheckpointManager(root).restore(main, scope, step=2, memory_budget=256)
    jm, js, _ = R.build_transformer(fluid)
    jscope = fluid.Scope()
    fluid.Executor().run(js, scope=jscope)
    with pytest.raises(JaxOOM) as want:
        JaxManager(root, async_save=False).restore(jm, jscope, step=2, memory_budget=256)
    assert got.value.diagnostic.code == want.value.diagnostic.code == "M501"


def test_a_same_step_resave_through_the_async_writer_commits_the_second(ranks):
    """Two async saves at one step on two ranks: each in its own tmp
    directory, the second renamed over the first; nothing else is left."""
    for v in _value(ranks, "resave"):
        assert v["saved"] == [True, True]
        assert v["entries"] and v["validate"]["ranks"] == WORLD
        assert v["second"]


@pytest.mark.parametrize("call", ["save", "wait"])
def test_a_writer_error_on_one_rank_raises_on_every_rank(ranks, call):
    for v in _value(ranks, "resave"):
        assert "failed on rank 1" in v[call + "_raised"]
        assert "injected writer failure" in v[call + "_raised"]
        assert v["steps"] == [5]


def test_the_serial_dir_of_a_sharded_table_is_gathered_on_rank_0s_host(ranks):
    """``Trainer(checkpoint_config=)``'s serial dir under a mesh: no value
    made whole on a device, the rank keeps its shard, rank 0 writes the
    whole table."""
    recs = _value(ranks, "legacy_dir")
    for v in recs:
        assert v["local"] == [R.TBL["rows"] // WORLD, R.TBL["dim"]]
    assert recs[0]["dirs"] == ["checkpoint_0", "checkpoint_1"] and recs[0]["equal"]


# ------------------------------------------------------ Trainer and health
def test_trainer_checkpoint_under_a_mesh_saves_and_resumes(ranks):
    for v in _value(ranks, "trainer_ckpt"):
        assert len(v["losses"]) == 2 and v["steps"] == [2]
        # fsdp splits the weights' rows (16 and 32 divide by 2); biases replicate
        for name, (shape, placements) in v["placements"].items():
            assert placements == (["Shard(dim=0)"] if len(shape) == 2 else ["Replicate()"]), name
        assert v["resume_equal"] and v["resume_step"] == 2


def test_a_nan_in_one_ranks_feed_trips_every_rank_and_rolls_back(ranks):
    for rank, v in enumerate(_value(ranks, "trainer_ckpt")):
        assert len(v["trips"]) == 1, v["trips"]
        trip = v["trips"][0]
        assert trip["rank"] == rank
        assert "grads" in trip["bad_vars"] and "params" in trip["bad_vars"]
        assert not np.isfinite(v["nan_losses"][0])
        assert v["rolled_back"] and v["finite"]


def test_a_trips_localization_is_skipped_on_a_mesh_that_spans_processes(ranks):
    for v in _value(ranks, "trainer_ckpt"):
        loc = v["trips"][0]["localization"]
        assert list(loc) == ["skipped"] and loc["skipped"].startswith("multi-process mesh")


@pytest.mark.parametrize("key", ["loss", "grad_norm", "param_norm", "update_norm"])
def test_the_sentinels_global_norms_match_one_process(ranks, key):
    for v in _value(ranks, "sentinel"):
        np.testing.assert_allclose(v["mesh"][key], v["single"][key], rtol=SENTINEL_RTOL)
        assert np.isfinite(v["mesh"][key])


def test_the_sentinels_mask_is_clean_and_the_step_spans_processes(ranks):
    for v in _value(ranks, "sentinel"):
        assert v["mesh"]["mask"] == v["single"]["mask"] == [0]
        assert v["mesh"]["multiproc"] is True and v["single"]["multiproc"] is False


def test_check_nan_inf_takes_the_global_mode_on_a_mesh(ranks):
    for v in _value(ranks, "nan_global"):
        assert np.isfinite(v["clean"])
        assert v["error"] is not None and "multi-trainer global check" in v["error"]
        assert "fc_0.w_0" in v["error"]


def _health_report(wd, *flags):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", "health_report.py"),
                           os.path.join(wd, "telemetry"), *flags],
                          capture_output=True, text=True, timeout=60)


def test_health_report_merges_the_ranks_streams(ranks):
    """The reference's tool, unedited: two ranks, their compiles in
    lockstep, the trip on each."""
    _, _, wd = ranks
    run = _health_report(wd, "--json")
    assert run.returncode == 0, run.stderr
    report = json.loads(run.stdout)
    assert sorted(report["step_skew"]["ranks"]) == ["0", "1"]
    assert report["fingerprint_lockstep"]["lockstep"] is True
    assert sorted(report["health"]) == ["0", "1"]
    for h in report["health"].values():
        assert h["events"].get("non-finite") == 1


def test_health_report_strict_exits_1_on_the_trip(ranks):
    _, _, wd = ranks
    assert _health_report(wd, "--strict").returncode == 1


def test_the_ranks_programs_raise_no_verifier_findings(ranks):
    for rec in ranks[0]:
        assert rec["findings"] == 0
