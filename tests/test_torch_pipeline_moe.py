"""The port's pipeline, ring attention, switch-MoE and the collectives
under them (``parallel/{_collectives,pipeline,ring_attention}.py``,
``ops/{pipeline_ops,moe_ops}.py``, ``layers/pipeline.py``,
``layers.switch_moe``) against the JAX package.

Without ranks: ``switch_moe_forward`` against the JAX function (float32
within 2e-6 of the largest output, the aux loss within 1e-6 relative),
ties taking the first expert, overflow tokens zero, float32 position
bookkeeping under bf16; the pipeline and MoE ProgramDescs equal to the
JAX package's op for op; the sequential pipeline (no ``pipe`` axis)
against the JAX lowering from the same parameters; the layer's
guards (nesting, closures, random ops, per-stage fans).

With ranks (two gloo ranks on the CPU, spawned once for the module):
``ppermute`` and ``psum`` values and gradients (also through host
memory), the pipeline on ``{"pipe": 2}`` against the JAX package's
one-device run (4 SGD losses, rtol 1e-4, atol 1e-6: its own test's
tolerance), ring attention on ``{"seq": 2}`` against the JAX lowering
(output rtol 2e-4, atol 1e-5 as its test; every parameter gradient the
same), and experts sharded on ``{"expert": 2}`` against the JAX
package's unsharded run (rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt

import _torch_mesh_ranks as R
from _torch_validate import _no_port_validate_findings  # noqa: F401

WORLD = 2


# ------------------------------------------------------------------- MoE
def _moe_inputs(rs, t, d, e, h):
    return (rs.randn(t, d).astype(np.float32), rs.randn(d, e).astype(np.float32) * 0.5,
            rs.randn(e, d, h).astype(np.float32) * 0.1, rs.randn(e, h).astype(np.float32) * 0.1,
            rs.randn(e, h, d).astype(np.float32) * 0.1, rs.randn(e, d).astype(np.float32) * 0.1)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_switch_moe_forward_matches_the_jax_function(cf):
    from paddle_tpu.ops.moe_ops import switch_moe_forward as jax_moe
    from paddle_tpu_torch.ops.moe_ops import switch_moe_forward
    args = _moe_inputs(np.random.RandomState(0), 64, 8, 4, 16)
    want_out, want_aux = jax_moe(*args, capacity_factor=cf)
    got_out, got_aux = switch_moe_forward(*(torch.from_numpy(a) for a in args),
                                          capacity_factor=cf)
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=0,
                               atol=2e-6 * np.abs(want_out).max())
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-6)


def test_switch_moe_ties_take_the_first_expert_and_overflow_is_zero():
    from paddle_tpu_torch.ops.moe_ops import switch_moe_forward
    x, _, w1, b1, w2, b2 = _moe_inputs(np.random.RandomState(1), 24, 8, 4, 16)
    gate = np.zeros((8, 4), np.float32)             # every gate equal: all ties
    out, aux = switch_moe_forward(*(torch.from_numpy(a) for a in (x, gate, w1, b1, w2, b2)),
                                  capacity_factor=1.0)
    cap = int(1.0 * 24 / 4)
    rows = (out.abs().sum(1) > 0).numpy()
    assert rows[:cap].all() and not rows[cap:].any()   # expert 0 takes the first cap tokens
    assert float(aux) == pytest.approx(4 * 1.0 * 0.25)


def test_switch_moe_positions_stay_exact_in_bf16():
    """Queue positions past bf16's exact integers (256) stay distinct: the
    bookkeeping runs in float32, so each expert keeps exactly its capacity."""
    from paddle_tpu_torch.ops.moe_ops import switch_moe_forward
    x, _, w1, b1, w2, b2 = _moe_inputs(np.random.RandomState(2), 600, 8, 2, 16)
    gate = np.zeros((8, 2), np.float32)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, gate, w1, b1, w2, b2)]
    out, _ = switch_moe_forward(*args, capacity_factor=1.0)
    assert int((out.float().abs().sum(1) > 0).sum()) == 300


def _scrub(d):
    for b in d["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return d


@pytest.mark.parametrize("which", ["moe", "pipeline"])
def test_program_descs_equal_the_jax_packages(which):
    build = {"moe": lambda pkg: R.build_moe(pkg)[:2],
             "pipeline": lambda pkg: R.build_pipelined(pkg)[:2]}[which]
    for a, b in zip(build(pt), build(fluid)):
        assert _scrub(a.desc.to_dict()) == _scrub(b.desc.to_dict())


def test_switch_moe_layer_trains_and_stamps_the_expert_axis():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        y = pt.layers.data(name="y", shape=[8], dtype="float32")
        out, aux = pt.layers.switch_moe(x, num_experts=4, d_hidden=16, expert_axis="expert")
        loss = pt.layers.elementwise_add(
            pt.layers.mean(pt.layers.square_error_cost(input=out, label=y)),
            pt.layers.scale(aux, scale=0.01))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    stamps = {v.name: v.sharding for v in main.list_vars() if v.persistable and v.sharding}
    assert sorted(len(s) for s in stamps.values()) == [2, 2, 3, 3]
    assert all(s[0] == "expert" for s in stamps.values())
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    xv = rs.randn(32, 8).astype(np.float32)
    feed = {"x": xv, "y": np.tanh(xv)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(40)]
    assert losses[-1] < 0.5 * losses[0]


# -------------------------------------------------------------- pipeline
def _jax_scope(main, startup, init=None):
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if init:
        import jax.numpy as jnp
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    return scope, exe


def _persist(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name)) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def test_sequential_pipeline_matches_the_jax_lowering_and_the_composition():
    jm, js, _, jpipe = R.build_pipelined(fluid, n_stages=3, sgd=False)
    jscope, jexe = _jax_scope(jm, js)
    init = _persist(jm, jscope)
    xv = np.random.default_rng(0).standard_normal((8, R.D)).astype(np.float32)
    feed = {"x": xv, "y": xv.sum(1, keepdims=True)}
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jpipe.output], scope=jscope)
    main, startup, _, pipe = R.build_pipelined(pt, n_stages=3, sgd=False)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    pt.params_from_numpy(init, scope, "cpu")
    (got,) = exe.run(main, feed=feed, fetch_list=[pipe.output], scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    op = [o for o in main.global_block.ops if o.type == "pipeline"][0]
    stored = sorted(op.desc.attr("stage_params"))
    w = [init[n] for n in stored if init[n].ndim == 3][0]
    b = [init[n] for n in stored if init[n].ndim == 2][0]
    h = xv
    for i in range(3):
        h = np.maximum(h @ w[i] + b[i], 0.0)
    np.testing.assert_allclose(got, h, rtol=1e-5, atol=1e-6)


def test_pipeline_block_guards_match_the_jax_layer():
    from paddle_tpu_torch import layers
    with pt.program_guard(pt.Program(), pt.Program()):
        x = layers.data(name="x", shape=[R.D], dtype="float32")
        prog = pt.default_main_program()
        pipe = layers.PipelinedStages(input=x, n_stages=2, n_micro=2)
        with pytest.raises(RuntimeError, match="boom"):
            with pipe.block():
                raise RuntimeError("boom")
        assert prog.current_block() is prog.block(0)
        outer = layers.fc(input=x, size=R.D)
        pipe = layers.PipelinedStages(input=x, n_stages=2, n_micro=2)
        with pytest.raises(ValueError, match="outside the block"):
            with pipe.block() as s:
                pipe.complete(layers.elementwise_add(s, outer))
        pipe = layers.PipelinedStages(input=x, n_stages=2, n_micro=2)
        with pytest.raises(ValueError, match="deterministic"):
            with pipe.block() as s:
                pipe.complete(layers.dropout(s, dropout_prob=0.3))
        pipe = layers.PipelinedStages(input=x, n_stages=2, n_micro=2)
        with pytest.raises(RuntimeError, match="does not nest"):
            with pipe.block() as s:
                with layers.PipelinedStages(input=s, n_stages=2, n_micro=2).block():
                    pass


def test_stacked_stage_params_init_with_per_stage_fans():
    main, startup, _, pipe = R.build_pipelined(pt, n_stages=4, sgd=False)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    op = [o for o in main.global_block.ops if o.type == "pipeline"][0]
    (wname,) = [n for n in op.desc.attr("stage_params") if scope.find_var(n).ndim == 3]
    w = scope.find_var(wname).numpy()
    assert w.shape == (4, R.D, R.D)
    limit = np.sqrt(6.0 / (2 * R.D))
    assert np.abs(w).max() <= limit * 1.0001 and np.abs(w).max() > 0.5 * limit


# --------------------------------------------------------------- with ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mesh_pipeline_moe")
    refs = {}
    jm, js, jl, jpipe = R.build_pipelined(fluid, n_stages=WORLD)
    init = _persist(jm, _jax_scope(jm, js)[0])
    np.savez(wd / "pipe_init.npz", **init)
    jscope, jexe = _jax_scope(jm, js, init)
    runs = [jexe.run(jm, feed=f, fetch_list=[jl, jpipe.output], scope=jscope)
            for f in R.pipeline_feeds()]
    refs["pipe_losses"], refs["pipe_out0"] = [float(r[0]) for r in runs], runs[0][1]
    for causal in (True, False):
        jm, js, jattn, params = R.build_ring(fluid, causal)
        jscope, jexe = _jax_scope(jm, js)
        np.savez(wd / f"ring_init_{causal}.npz", **_persist(jm, jscope))
        outs = jexe.run(jm, feed=R.ring_feed(), fetch_list=[jattn] + [p + "@GRAD" for p in params],
                        scope=jscope)
        refs[f"ring_{causal}"] = dict(zip(["out"] + params, (np.asarray(o) for o in outs)))
    jm, js, jout, jaux = R.build_moe(fluid, expert_axis=None)
    jscope, jexe = _jax_scope(jm, js)
    np.savez(wd / "moe_init.npz", **_persist(jm, jscope))
    refs["moe"] = [np.asarray(v) for v in jexe.run(jm, feed=R.moe_feed(),
                                                   fetch_list=[jout, jaux], scope=jscope)]
    return R.spawn("pipeline_moe", WORLD, str(wd)), refs, wd


def _value(ranks, case):
    recs = ranks[0]
    for r, rec in enumerate(recs):
        assert rec[case]["ok"], f"rank {r}: {rec[case]['error']}"
    return [rec[case]["value"] for rec in recs]


@pytest.mark.parametrize("staged", [False, True])
def test_ppermute_and_psum_values_and_gradients(ranks, staged):
    for r, v in enumerate(_value(ranks, "collectives")):
        v = v[f"staged={staged}"]
        base = np.arange(4.0)
        other = base + 10 * (1 - r)
        assert v["index"] == r
        np.testing.assert_array_equal(v["ring"], other)
        np.testing.assert_array_equal(v["shift"], base if r == 1 else np.zeros(4))
        # d/dv: the ring sends v on and the cotangent comes back from the
        # receiver (w = its rank + 1); the shift only from rank 0 to 1
        want = np.full(4, (1 - r) + 1.0) + (2 * 2.0 if r == 0 else 0.0)
        np.testing.assert_array_equal(v["grad"], want)
        np.testing.assert_array_equal(v["psum"], base * 1 + (base + 10) * 2)
        np.testing.assert_array_equal(v["psum_grad"], np.full(4, r + 1.0))


def test_pipeline_on_a_pipe_mesh_matches_the_jax_package(ranks):
    _, refs, _ = ranks
    for v in _value(ranks, "pipeline"):
        np.testing.assert_allclose(v["out0"], refs["pipe_out0"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v["losses"], refs["pipe_losses"], rtol=1e-4, atol=1e-6)
        # the stacked parameters are state every rank holds whole, as in the
        # JAX package; each stage computes on its slice
        assert v["placements"] and all(p == ["Replicate()"] for p in v["placements"].values())


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_on_a_seq_mesh_matches_the_jax_lowering(ranks, causal):
    _, refs, wd = ranks
    _value(ranks, "ring")
    got = np.load(wd / f"ring_got_{causal}.npz")
    want = refs[f"ring_{causal}"]
    np.testing.assert_allclose(got["out"], want["out"], rtol=2e-4, atol=1e-5)
    for n in want:
        if n != "out":
            np.testing.assert_allclose(got[n], want[n], rtol=2e-4, atol=1e-5, err_msg=n)


def test_ring_attention_refuses_ragged_keys(ranks):
    for v in _value(ranks, "ring"):
        assert "ragged keys" in v["ragged"]


def test_switch_moe_with_sharded_experts_matches_the_jax_package(ranks):
    _, refs, _ = ranks
    for v in _value(ranks, "moe"):
        np.testing.assert_allclose(v["out"], refs["moe"][0], rtol=1e-4, atol=1e-5)
        assert v["aux"] == pytest.approx(float(refs["moe"][1]), rel=1e-4)
        assert v["w1_placements"] == ["Shard(dim=0)"]
        assert v["w1_local"][0] == R.MOE["e"] // WORLD


def test_the_ranks_programs_raise_no_verifier_findings(ranks):
    for rec in ranks[0]:
        assert rec["findings"] == 0
