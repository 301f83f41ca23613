"""Row-sharded embedding tables on a mesh against one process and the JAX
package: ``sharded_table`` through K2 / K3 on each rank's shard and the
lazy sparse update of a row-sharded table, ``embedding.plan_table(mesh=,
layout=)`` and ``deepfm(shard_tables=True)``.

The module spawns two gloo ranks on the CPU once
(``_torch_mesh_ranks.spawn``, suite ``sharded_tables``); the JAX
package's references (its virtual CPU devices, as its own tests run it,
and its one-device Executor) are computed here first and carried to the
ranks as files.  Each rank feeds its rows of each global batch.

Tolerances: the tables are bit-equal (a mean over a power-of-two batch
and a power-of-two rate keep every SGD update exact, and a gather's rows
are copies), to one process and to the JAX package; Adam's lazy and
dense updates bit-equal to one process of the port (the same arithmetic
on the same rows); so are the sparse SGD under a global-norm clip (each
rank holds the whole batch's merged gradient, so its norm is the one
process's) and under an L2 decay (a touched row's decay read on the rank
that holds it).  DeepFM on ``{"data": 2}``: sharded bit-equal to
unsharded on the same mesh; against one process within 1e-6 (its MLP's
gradients are all-reduced, so they add in another order).
"""
import types

import jax
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.parallel import SpecLayout as JaxSpecLayout
from paddle_tpu.parallel import make_mesh as jax_make_mesh
from paddle_tpu_torch.parallel import layout as pt_layout

import _torch_mesh_ranks as R
from _torch_validate import _no_port_validate_findings  # noqa: F401

WORLD = 2
FM_SINGLE_ATOL = 1e-6
SGD_ARMS = ("dense", "sparse", "dense_kernel_tier", "sparse_kernel_tier")
ARMS = [a[0] for a in R.TABLE_ARMS]


def _jax_table(start, is_sparse, axes=None):
    """The JAX package's 3 SGD steps of the table net from ``start``
    (on a mesh of its virtual devices when ``axes`` is given)."""
    main, startup, loss = R.build_table(fluid, is_sparse)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    if start is not None:
        scope.update_var("user_table", np.asarray(start))
    if axes is None:
        exe = fluid.Executor()
    else:
        n = int(np.prod(list(axes.values())))
        exe = fluid.Executor(mesh=jax_make_mesh(dict(axes), devices=jax.devices()[:n]),
                             layout=JaxSpecLayout())
    for f in R.table_feeds():
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    return np.asarray(scope.find_var("user_table")), scope


def _jax_refs(wd):
    main, startup, _ = R.build_table(fluid, True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    start = np.asarray(scope.find_var("user_table"))
    np.savez(f"{wd}/tbl_start.npz", user_table=start)
    refs = {"start": start, "dense": _jax_table(start, False)[0]}
    refs["sparse_mesh"], jscope = _jax_table(start, True, {"fsdp": WORLD})
    refs["sparse_mesh_spec"] = pt_layout.spec_tuple(jscope.find_var("user_table").sharding.spec)
    mesh = jax_make_mesh({"fsdp": WORLD}, devices=jax.devices()[:WORLD])
    refs["plan"] = {str(kw): fluid.embedding.plan_table("t", 1024, 16, mesh=mesh,
                                                        layout=JaxSpecLayout(), **kw)
                    for kw in R.PLAN_CASES}
    main, startup, _ = R.build_deepfm(fluid, False)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    np.savez(f"{wd}/fm_init.npz", **{v.name: np.asarray(scope.find_var(v.name))
                                     for v in main.list_vars() if v.persistable
                                     and scope.find_var(v.name) is not None
                                     and np.asarray(scope.find_var(v.name)).ndim == 2})
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sharded_tables"))
    refs = _jax_refs(wd)
    return R.spawn("sharded_tables", WORLD, wd), refs, wd


def _value(ranks, case):
    recs, _, _ = ranks
    out = []
    for rec in recs:
        assert rec[case]["ok"], rec[case].get("error")
        out.append(rec[case]["value"])
    return out


# ------------------------------------------------------------ without ranks
class _FakeMesh:
    """A DeviceMesh stand-in: sizes and this rank's index a mesh dim."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, i):
        return self.coords[i]


@pytest.mark.parametrize("coords,want", [((0, 0), (0, 16)), ((0, 1), (16, 16)),
                                         ((1, 0), (32, 16)), ((1, 1), (48, 16))])
def test_shard_range_gives_the_rows_dtensor_places_on_a_rank(coords, want):
    """A [64, D] table on ``("fsdp", "tp")`` over a 2 x 2 mesh: split by
    fsdp first, then tp, as DTensor and the JAX package nest the axes; the
    result is the same slice ``torch.chunk`` gives that rank."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh((2, 2), coords)
    got = pt_layout.shard_range((Shard(0), Shard(0)), mesh, 64, 0)
    assert got == want
    rows = torch.arange(64)
    chunk = rows.chunk(2)[coords[0]].chunk(2)[coords[1]]
    assert (int(chunk[0]), len(chunk)) == want
    assert pt_layout.shard_range((Replicate(), Shard(0)), mesh, 64, 0) == (coords[1] * 32, 32)
    assert pt_layout.shard_range((Shard(1), Replicate()), mesh, 64, 0) == (0, 64)
    assert pt_layout.first_replica((Shard(0), Replicate()), mesh) == (coords[1] == 0)


def test_a_sharding_that_does_not_divide_raises_as_jax_device_put_does():
    """An explicit spec over an axis that does not divide the rows raises
    (``jax.device_put`` refuses it with the same words), while a rule's
    spec degrades to replicated (``_fit_axes``), in both packages."""
    from jax.sharding import NamedSharding, PartitionSpec
    mesh = types.SimpleNamespace(shape={"data": 2})
    with pytest.raises(ValueError, match="should be divisible by 2") as got:
        pt_layout.check_divisible("fm_emb_0", (5, 2), ["data", None], mesh)
    assert "equal to 5 (full shape: (5, 2))" in str(got.value)
    jmesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="should be divisible by 2"):
        jax.device_put(np.zeros((5, 2), np.float32),
                       NamedSharding(jmesh, PartitionSpec("data", None)))
    pt_layout.check_divisible("t", (6, 2), ["data", None], mesh)
    for layout in (pt_layout.SpecLayout(), JaxSpecLayout()):
        assert layout.spec_for("t", (5, 2), types.SimpleNamespace(shape={"fsdp": 2}),
                               role="embedding") is None


def test_plan_table_mesh_divides_rows():
    """tests/test_embedding.py's case: a table whose footprint exceeds one
    device's budget fits once dim 0 is split over fsdp x tp; equal to the
    JAX plan (its mesh of 4 virtual devices, the port's ``{axis: size}``)."""
    budget = 1024 * 16 * 4
    jmesh = jax_make_mesh({"fsdp": 2, "tp": 2}, devices=jax.devices()[:4])
    want = fluid.embedding.plan_table("t", 1024, 16, slots=1, mesh=jmesh, layout=JaxSpecLayout(),
                                      budget=budget)
    plan = pt.embedding.plan_table("t", 1024, 16, slots=1, mesh={"fsdp": 2, "tp": 2},
                                   layout=pt_layout.SpecLayout(), budget=budget)
    assert plan == want
    assert plan["num_devices"] == 4 and plan["fits"] is True
    assert plan["per_device_bytes"] == plan["total_bytes"] // 4
    assert pt.embedding.plan_table("t", 1024, 16, slots=1, budget=budget)["fits"] is False


def _scrubbed(desc):
    d = desc.to_dict()
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return d


@pytest.mark.parametrize("shard", [True, False])
def test_deepfm_program_equals_the_jax_one_sharding_attr_included(shard):
    jm, js, _ = R.build_deepfm(fluid, shard)
    pm, ps, _ = R.build_deepfm(pt, shard)
    assert _scrubbed(pm.desc) == _scrubbed(jm.desc)
    assert _scrubbed(ps.desc) == _scrubbed(js.desc)
    block = pm.desc.block(0)
    for i in range(len(R.FM["vocab"])):
        assert block.vars[f"fm_emb_{i}"].attrs.get("sharding") == (["data", None] if shard
                                                                  else None)
        assert block.vars[f"fm_w1_{i}"].attrs.get("sharding") is None


@pytest.mark.allow_validate_findings
def test_jax_package_refuses_an_odd_vocabulary_on_a_data_axis():
    """Its verifier warns R404 first (the planted odd vocabulary), then the
    placement raises."""
    main, startup, loss = R.build_deepfm(fluid, True, R.FM["odd_vocab"])
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    exe = fluid.Executor(mesh=jax_make_mesh({"data": 2}, devices=jax.devices()[:2]),
                         layout=JaxSpecLayout())
    with pytest.raises(ValueError, match="should be divisible by 2"):
        exe.run(main, feed=R.deepfm_feeds(R.FM["odd_vocab"])[0], fetch_list=[loss], scope=scope)


# --------------------------------------------------------------- with ranks
def test_jax_reference_sparse_on_its_mesh_equals_dense(ranks):
    _, refs, _ = ranks
    np.testing.assert_array_equal(refs["sparse_mesh"], refs["dense"])
    assert refs["sparse_mesh_spec"] == ("fsdp",)


@pytest.mark.parametrize("arm", ARMS)
def test_each_arm_on_two_ranks_is_bit_equal_to_one_process(ranks, arm):
    for v in _value(ranks, "tables"):
        assert v[arm]["equal_single"], arm
    _, _, wd = ranks
    z = R._load(wd, f"tbl_{arm}.npz")
    np.testing.assert_array_equal(z["mesh"], z["single"])


@pytest.mark.parametrize("arm", SGD_ARMS)
def test_sgd_arms_are_bit_equal_to_the_jax_package(ranks, arm):
    _, refs, wd = ranks
    z = R._load(wd, f"tbl_{arm}.npz")
    np.testing.assert_array_equal(z["mesh"], refs["dense"])
    np.testing.assert_array_equal(z["mesh"], refs["sparse_mesh"])
    assert not np.array_equal(z["mesh"], refs["start"])


@pytest.mark.parametrize("arm", ARMS)
def test_the_table_lives_row_sharded_on_each_rank(ranks, arm):
    for v in _value(ranks, "tables"):
        assert v[arm]["placements"] == ["Shard(dim=0)"]
        assert v[arm]["local"] == [R.TBL["rows"] // WORLD, R.TBL["dim"]]


@pytest.mark.parametrize("arm", ARMS)
def test_k2_and_k3_receive_the_ranks_shard_never_the_whole_table(ranks, arm):
    """From the shapes the wrappers were handed: K2 (the gather) on every
    arm, K3 (the scatter-add) on the dense arms, each at the rank's
    [32, 8] shard; the one-process run hands them the whole [64, 8]."""
    shard, whole = [R.TBL["rows"] // WORLD, R.TBL["dim"]], [R.TBL["rows"], R.TBL["dim"]]
    want = {"gather_rows"} | ({"scatter_add_rows"} if arm.startswith("dense") else set())
    for v in _value(ranks, "tables"):
        seen = v[arm]["kernel_tables"]
        assert {n for n, _ in seen} == want, seen
        assert all(s == shard for _, s in seen), seen
        assert all(s == whole for _, s in v[arm]["kernel_tables_single"])


@pytest.mark.parametrize("case", [str(kw) for kw in R.PLAN_CASES])
def test_plan_table_on_the_real_mesh_equals_the_jax_plan(ranks, case):
    _, refs, _ = ranks
    for v in _value(ranks, "plan"):
        assert v[case] == refs["plan"][case]
        assert v[case]["num_devices"] == WORLD


def test_deepfm_sharded_trains_bit_equal_to_unsharded(ranks):
    for v in _value(ranks, "deepfm"):
        assert v["sharded_equal_unsharded"]
        assert v["sharded"]["losses"] == v["unsharded"]["losses"]
        assert v["sharded"]["placements"] == {"fm_emb_0": ["Shard(dim=0)"],
                                              "fm_w1_0": ["Replicate()"]}


def test_deepfm_sharded_against_one_process(ranks):
    for v in _value(ranks, "deepfm"):
        np.testing.assert_allclose(v["sharded"]["losses"], v["single"]["losses"], rtol=1e-6)
        assert v["sharded_vs_single_max_abs"] <= FM_SINGLE_ATOL


def test_deepfm_odd_vocabulary_raises_at_placement_as_the_jax_package_does(ranks):
    for v in _value(ranks, "deepfm"):
        assert v["odd"] is not None and "should be divisible by 2" in v["odd"]
        assert "fm_emb_0" in v["odd"] and "equal to 5" in v["odd"]


def test_the_ranks_programs_raise_no_verifier_findings(ranks):
    """None but the R404 of the planted odd vocabulary."""
    for rec in ranks[0]:
        assert rec["deepfm"]["value"]["odd_findings"] == 1
        assert rec["findings"] == 1
