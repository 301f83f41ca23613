"""The collective half of the port (ROADMAP §A item 12b) against the JAX
package: meshes, ``SpecLayout`` on DTensor, ``init_parallel_env``,
``ParallelExecutor``, ``Executor(mesh=, layout=)``, ``Trainer(parallel=,
layout=)``, ``DeviceLoader(sharding=)`` and the analysis given the real
mesh and layout.

Without ranks: ``make_mesh``'s checks and messages equal the JAX
package's; ``SpecLayout.spec_for`` gives the JAX class's spec for every
var of transformer-base under ``{data:2, fsdp:2, tp:2}``, ``{fsdp:4}``
and ``{tp:4}``; specs map to DTensor placements.

With ranks: the module spawns two gloo ranks on the CPU once
(``_torch_mesh_ranks.spawn``) and every multi-rank case runs inside that
spawn; the JAX package's references (its 8 virtual CPU devices, as its
own tests run it, and its one-device Executor) are computed here first
and carried to the ranks as files.  A data-parallel rank feeds its rows
of the global batch.  Tolerances: the JAX tests' own (5 losses, rtol
1e-4, atol 1e-5); the 1+1 transformer's parameters within the training
tests' Adam bound (atol 5e-5, rtol 1e-4).
"""
import types

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.parallel import layout as jax_layout
from paddle_tpu.parallel import BuildStrategy as JaxBuildStrategy
from paddle_tpu.parallel import ParallelExecutor as JaxParallelExecutor
from paddle_tpu_torch.parallel import layout as pt_layout

import _torch_mesh_ranks as R
from _torch_validate import _no_port_validate_findings  # noqa: F401

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4
WORLD = 2


# ------------------------------------------------------------ without ranks
@pytest.mark.parametrize("axes", [{"data": 3}, {"data": -1, "fsdp": -1}, {"data": 0},
                                  {"data": -1, "fsdp": 3}, {"fsdp": 2, "tp": 2}])
def test_make_mesh_checks_and_messages_equal_the_jax_package(axes):
    import jax
    from paddle_tpu.parallel import make_mesh as jax_make_mesh
    from paddle_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError) as want:
        jax_make_mesh(dict(axes), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        make_mesh(dict(axes), devices=list(range(8)))
    assert str(got.value) == str(want.value)


def _transformer_base_program(pkg):
    from importlib import import_module
    transformer = import_module(pkg.__name__ + ".models.transformer")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[256, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 32000, 32000, max_len=256,
                                            n_layer=6, d_model=512, n_head=8, d_inner=2048,
                                            fuse_final_ce=True)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main


@pytest.mark.parametrize("axes", [{"data": 2, "fsdp": 2, "tp": 2}, {"fsdp": 4}, {"tp": 4}])
def test_spec_for_equals_the_jax_layout_for_every_var_of_transformer_base(axes):
    mesh = types.SimpleNamespace(shape=dict(axes))
    pm, jm = _transformer_base_program(pt), _transformer_base_program(fluid)
    pb, jb = pm.desc.block(0), jm.desc.block(0)
    mine, theirs = pt_layout.SpecLayout(mesh_axes=axes), jax_layout.SpecLayout(mesh_axes=axes)
    names = [n for n, vd in pb.vars.items() if vd.persistable]
    assert len(names) > 500
    got = {n: mine.spec_for(n, pb.vars[n].shape, mesh, slot_of=pb.vars[n].attrs.get("slot_of"),
                            param_lookup=pb.find_var) for n in names}
    want = {n: theirs.spec_for(n, jb.vars[n].shape, mesh,
                               slot_of=jb.vars[n].attrs.get("slot_of"),
                               param_lookup=jb.find_var) for n in names}
    assert got == want
    assert sum(1 for s in got.values() if s) > 100
    assert mine.fingerprint() == theirs.fingerprint()
    assert mine.batch_axes(mesh) == theirs.batch_axes(mesh)
    assert mine.batch_spec(mesh, 2) == theirs.batch_spec(mesh, 2)


class _Mesh:
    """The mesh attributes ``as_placements`` reads."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def dim(self, axis):
        return self.axis_names.index(axis)


def test_specs_become_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh({"data": 2, "fsdp": 2, "tp": 2})
    R_, S = Replicate(), Shard
    assert pt_layout.as_placements(None, mesh) == (R_, R_, R_)
    assert pt_layout.as_placements(["fsdp", "tp"], mesh) == (R_, S(0), S(1))
    assert pt_layout.as_placements([("data", "fsdp"), None], mesh) == (S(0), S(0), R_)
    assert pt_layout.as_placements([None, ["fsdp", "tp"]], mesh) == (R_, S(1), S(1))
    # an axis the mesh lacks is a no-op, as a sharding over a size-1 axis
    assert pt_layout.as_placements(["seq", "tp"], mesh) == (R_, R_, S(1))
    assert pt_layout.spec_tuple([None, ["a", "b"], None]) == (None, ("a", "b"))


def test_layouts_place_parameters_as_the_jax_package_specs_say():
    """The placements shard_program_state gives each var are its JAX spec's."""
    mesh = _Mesh({"data": 2, "fsdp": 2, "tp": 2})
    pm = _transformer_base_program(pt)
    lay = pt_layout.SpecLayout()
    b = pm.desc.block(0)
    for n in ("src_emb", "src_pos_emb", "fc_0.w_0", "fc_4.w_0"):
        spec = pt_layout.state_spec(b, n, mesh, lay)
        assert spec == jax_layout.SpecLayout().spec_for(n, b.vars[n].shape, mesh)


def test_init_parallel_env_refusals_without_a_group():
    from paddle_tpu_torch import distributed as dist
    with pytest.raises(ValueError, match="one device a rank"):
        dist.init_parallel_env(local_device_count=2, place=pt.CPUPlace())
    with pytest.raises(ValueError, match="needs a coordinator"):
        dist.init_parallel_env(num_trainers=2, place=pt.CPUPlace())
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        dist.init_parallel_env(place=pt.CPUPlace(), backend="mpi")
    assert not dist.is_initialized()
    dist.barrier()                      # a no-op outside a clique


# ---------------------------------------------------------------- with ranks
def _jax_run(main, startup, feeds, loss, init=None, pe=None):
    """The JAX package's losses over ``feeds`` from ``init`` (or its
    startup), in a scope of their own; returns (losses, scope)."""
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if init is not None:
        import jax.numpy as jnp
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    if pe is None:
        losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
                  for f in feeds]
    else:
        par = pe(main, scope, loss)
        losses = [float(par.run(feed=f, fetch_list=[loss])[0]) for f in feeds]
    return losses, scope


def _persist(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name)) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX references, then one spawn of two gloo ranks running every
    case of the suite; (rank records, references, workdir)."""
    wd = tmp_path_factory.mktemp("mesh_parallel")
    refs = {}
    # DP: one device and the JAX ParallelExecutor on its 8 devices
    jm, js, jl = R.build_mlp(fluid)
    feeds = [R.mlp_data(s) for s in range(5)]
    single, sc = _jax_run(jm, js, [], jl)
    init = _persist(jm, sc)
    np.savez(wd / "dp_init.npz", **init)
    refs["dp_single"], _ = _jax_run(jm, js, feeds, jl, init)
    refs["dp_pe"], _ = _jax_run(jm, js, feeds, jl, init, pe=lambda m, s, loss: JaxParallelExecutor(
        loss_name=loss.name, main_program=m, scope=s))
    # Reduce
    jm, js, jl = R.build_mlp(fluid, width=256, reduce_net=True)
    _, sc = _jax_run(jm, js, [], jl)
    init = _persist(jm, sc)
    np.savez(wd / "reduce_init.npz", **init)

    def reduce_pe(m, s, loss):
        bs = JaxBuildStrategy()
        bs.reduce_strategy = JaxBuildStrategy.ReduceStrategy.Reduce
        return JaxParallelExecutor(loss_name=loss.name, main_program=m, scope=s,
                                   build_strategy=bs)
    refs["reduce_pe"], _ = _jax_run(jm, js, R.reduce_data(), jl, init, pe=reduce_pe)
    # the 1+1 transformer on one device
    jm, js, jl = R.build_transformer(fluid)
    _, sc = _jax_run(jm, js, [], jl)
    init = _persist(jm, sc)
    np.savez(wd / "tf_init.npz", **init)
    refs["tf_losses"], sc = _jax_run(jm, js, R.transformer_feeds(), jl, init)
    refs["tf_final"] = _persist(jm, sc)
    # the analysis of the annotated net against {data: 2}
    from paddle_tpu import analysis as jax_analysis
    jm, _, jl = R.build_analysis_net(fluid)
    res = jax_analysis.verify(jm, fetch_list=[jl], mesh={"data": WORLD},
                              layout=jax_layout.SpecLayout())
    refs["analysis_codes"] = sorted(d.code for d in res.diagnostics)
    plan = jax_analysis.plan_memory(jm, fetch_list=[jl], feed_shapes={"x": (8, 6)},
                                    mesh={"data": WORLD}, layout=jax_layout.SpecLayout())
    refs["analysis_plan"] = {"num_devices": plan.num_devices, "mesh": plan.mesh,
                             "layout": plan.layout_fp}
    refs["analysis_m5"] = sorted(d.code for d in jax_analysis.memory.memory_diagnostics(plan))
    return R.spawn("parallel", WORLD, str(wd)), refs, wd


def _value(ranks, case):
    recs = ranks[0]
    for r, rec in enumerate(recs):
        assert rec[case]["ok"], f"rank {r}: {rec[case]['error']}"
    return [rec[case]["value"] for rec in recs]


def test_env_is_one_clique_with_cached_meshes_and_feed_shardings(ranks):
    for r, v in enumerate(_value(ranks, "env")):
        assert (v["nranks"], v["rank"], v["global_devices"]) == (WORLD, r, WORLD)
        assert v["is_initialized"] and v["data_mesh_cached"]
        assert "conflicting re-init" in v["conflict"]
        assert v["data_mesh_shape"] == {"data": WORLD} and v["coordinate"] == r
        assert v["feed_sharding"] == [["data"], ["Shard(dim=0)"]]
        assert v["feed_sharding_spec"] == [[None, "data"], ["Shard(dim=1)"]]


def test_parallel_executor_matches_one_device_and_the_jax_parallel_executor(ranks):
    _, refs, _ = ranks
    vals = _value(ranks, "dp")
    for v in vals:
        assert v["device_count"] == WORLD
        np.testing.assert_allclose(v["losses"], refs["dp_pe"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(v["losses"], refs["dp_single"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
    assert vals[0]["losses"] == vals[1]["losses"]


def test_reduce_strategy_shards_dim_0_over_data_and_matches_the_jax_package(ranks):
    _, refs, _ = ranks
    for v in _value(ranks, "reduce"):
        np.testing.assert_allclose(v["losses"], refs["reduce_pe"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        assert v["losses"][-1] < v["losses"][0]
        (w,) = [n for n, s in v["local_shapes"].items() if s == [32, 256]]
        assert v["sharded"][w] == ["Shard(dim=0)"]


@pytest.mark.parametrize("axes", R.LAYOUTS, ids=R.layout_key)
def test_layout_transformer_matches_the_jax_executor(ranks, axes):
    _, refs, wd = ranks
    key = R.layout_key(axes)
    vals = _value(ranks, "layout")
    for v in vals:
        np.testing.assert_allclose(v[key]["losses"], refs["tf_losses"], rtol=LOSS_RTOL)
        # the layout shards parameters over fsdp and tp, never over data
        assert (v[key]["sharded"] > 0) == (key != "data2")
        assert any("gloo" in r for r in v[key]["entry"])
    got = np.load(wd / f"tf_{key}.npz")
    for n, want in refs["tf_final"].items():
        np.testing.assert_allclose(got[n], want, atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=n)


def test_fsdp_and_tp_hold_less_state_a_rank_than_data(ranks):
    for v in _value(ranks, "layout"):
        data, fsdp, tp = (v[R.layout_key(a)]["state_bytes"] for a in R.LAYOUTS)
        assert fsdp < 0.6 * data and tp < 0.8 * data


def test_trainer_parallel_and_layout_match_one_process(ranks):
    for v in _value(ranks, "trainer"):
        assert len(v["single"]) == 2
        np.testing.assert_allclose(v["parallel"], v["single"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(v["fsdp"], v["single"], rtol=LOSS_RTOL)
        assert v["parallel_mesh"] == {"data": WORLD}
        assert v["fsdp_mesh"] == {"fsdp": WORLD}
        # a gloo mesh runs op by op: nothing captured
        assert v["parallel_captures"] == 0 and v["fsdp_captures"] == 0


def test_trainer_options_that_wait_for_item_12c_raise_naming_it(ranks):
    """Ported (item 12c): under Trainer(parallel=True) the checkpoint and
    health options train the epoch as the plain run does, the checkpoint
    saving at the second step, the sentinel's steps clean."""
    for v in _value(ranks, "trainer"):
        for option in ("checkpoint", "health"):
            np.testing.assert_allclose(v[option]["losses"], v["single"], rtol=LOSS_RTOL)
        assert v["checkpoint"]["steps"] == [2]
        assert v["health"]["ok"] == [True, True]


def test_device_loader_hands_out_the_ranks_shard_and_feeds_the_mesh(ranks):
    for v in _value(ranks, "device_loader"):
        assert v["losses"] == v["numpy_losses"]
        for kind, placements, global_shape, local_shape in v["kinds"]:
            assert kind == "DTensor" and placements == ["Shard(dim=0)"]
            assert global_shape == [32, 16] and local_shape == [16, 16]


def test_analysis_takes_the_real_mesh_and_layout_as_the_jax_package_does(ranks):
    _, refs, _ = ranks
    for v in _value(ranks, "analysis"):
        assert v["codes"] == refs["analysis_codes"]
        assert {"R402", "R404"} <= set(v["codes"])
        assert v["plan"] == refs["analysis_plan"]
        assert v["m5"] == refs["analysis_m5"]


def test_refusals_under_a_mesh(ranks):
    for v in _value(ranks, "errors"):
        assert v["layout_without_mesh"].startswith("ValueError: Executor(layout=...) needs mesh=")
        assert v["sentinels_under_mesh"] == ["fetches", "grads", "params"]
        assert v["checkpoint_save"] is True
        assert "mesh sizes" in v["bad_axes"]
        assert "at most one axis" in v["two_inferred"]


def test_the_ranks_programs_raise_no_verifier_findings(ranks):
    for rec in ranks[0]:
        assert rec["findings"] == 0
