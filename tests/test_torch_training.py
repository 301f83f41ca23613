"""The PyTorch/CUDA port's training slice against the JAX package.

A 2+2-layer ``train_network(fuse_final_ce=True)`` (vocab 1000, d_model 64,
4 heads, d_inner 256, max_len 32, batch 4, ragged lengths) with
``Adam(1e-3).minimize`` is built by both packages under
``unique_name.guard()``: the main and startup ProgramDescs must be equal
op for op.  With the JAX startup's parameters carried across, the port's
``Executor(CPUPlace())`` must give every parameter's step-1 gradient and
the 3-step losses of the JAX ``Executor``, and parameters after 3 steps
within the bound Adam allows.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.core.desc import grad_var_name
from paddle_tpu_torch.core.registry import OPS, register_lowering
from paddle_tpu_torch.models import transformer as pt_transformer

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1000, 64, 4, 256, 32, 2, 4
LR, STEPS = 1e-3, 3
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4     # float32, XLA vs torch summation orders
LOSS_RTOL = 1e-4
# Adam moves a parameter by about lr * m1 / sqrt(m2): where a gradient is
# ~0 that ratio is ~sign(g), so two correct implementations may differ by
# up to 2 * lr a step there; elsewhere the parameters agree closely.
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4
ZERO_GRAD = 1e-7


def _build(pkg, mod, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                    n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                    d_inner=D_INNER, fuse_final_ce=True, **kw)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _feed():
    rs = np.random.RandomState(0)
    return {"src": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "trg": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "lbl": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}


@pytest.fixture(scope="module")
def runs():
    """Both packages' programs, step-1 gradients, per-step losses and
    final parameters, from the same initial parameters and feed."""
    jm, js, jl = _build(fluid, jax_transformer)
    tm, ts, tl = _build(pt, pt_transformer)
    params = [p.name for p in tm.global_block.all_parameters()]
    fetch = [tl.name] + [grad_var_name(p) for p in params]
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    persist = [v.name for v in jm.list_vars() if v.persistable]
    pt.params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in persist}, tscope, "cpu")
    feed = _feed()
    jout = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)]
    tout = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    losses = [(float(jout[0]), float(tout[0]))]
    for _ in range(STEPS - 1):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl.name], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)
        losses.append((float(np.asarray(a)), float(b)))
    final = {n: (np.asarray(jscope.find_var(n)), tscope.find_var(n).numpy()) for n in params}
    return dict(progs=((jm, js), (tm, ts)), params=params,
                grads=dict(zip(params, zip(jout[1:], tout[1:]))), losses=losses, final=final)


def test_training_program_descs_equal_op_for_op(runs):
    (jm, js), (tm, ts) = runs["progs"]
    for a, b in ((jm, tm), (js, ts)):
        da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
        assert [o["type"] for o in da["blocks"][0]["ops"]] == \
            [o["type"] for o in db["blocks"][0]["ops"]]
        assert da == db
        assert a.desc.fingerprint() == b.desc.fingerprint()
    types = [o.type for o in tm.desc.block(0).ops]
    n_params = len(runs["params"])
    assert types.count("adam") == n_params
    assert types.count("fused_fc_softmax_ce") == types.count("fused_fc_softmax_ce_grad") == 1
    assert types.count("lookup_table_grad") == 4 and types.count("sum") > 0
    assert types.count("flash_attention_grad") == 3 * N_LAYER
    slots = [v for v in tm.global_block.vars.values() if "slot_of" in v.desc.attrs]
    assert len(slots) == 4 * n_params


def test_every_parameter_gets_the_jax_gradient(runs):
    assert len(runs["grads"]) == len(runs["params"]) == 66
    for name, (ref, got) in runs["grads"].items():
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_three_step_losses_match_and_fall(runs):
    ref, got = zip(*runs["losses"])
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert got[0] > got[1] > got[2]


def test_parameters_after_three_steps_within_the_adam_bound(runs):
    for name, (ref, got) in runs["final"].items():
        g1 = runs["grads"][name][0]
        tol = np.where(np.abs(g1) < ZERO_GRAD, 2 * LR * STEPS,
                       PARAM_ATOL + PARAM_RTOL * np.abs(ref))
        assert (np.abs(got - ref) <= tol).all(), name


def test_gradient_flags_match_the_jax_registrations(runs):
    """``no_gradient``, ``non_diff_inputs`` and whether a grad maker is
    registered, for every forward op type of both training programs."""
    (jm, js), _ = runs["progs"]
    types = {o.type for p in (jm, js) for o in p.desc.block(0).ops
             if not o.type.endswith("_grad")}
    assert {"lookup_table", "adam", "fill_constant", "uniform_random"} <= types
    for t in sorted(types):
        ours, ref = OPS.get(t), JAX_OPS.get(t)
        assert ours.no_gradient == ref.no_gradient, t
        assert tuple(ours.non_diff_inputs) == tuple(ref.non_diff_inputs), t
        assert (ours.grad_maker is None) == (ref.grad_maker is None), t


def test_the_cpu_step_runs_in_float64_from_float64_parameters(runs):
    """The plain kernel versions compute in float64 when given float64, so
    the port on the CPU is a double-precision witness of a float32 step."""
    tm, ts = runs["progs"][1]
    params = runs["params"]
    fetch = [n for o in tm.desc.block(0).ops if o.type == "fused_fc_softmax_ce"
             for n in o.output("Loss")] + [grad_var_name(p) for p in params]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(ts, scope=scope)
    init = {v.name: scope.find_var(v.name).numpy() for v in tm.list_vars() if v.persistable}
    out = {}
    for dt in (np.float32, np.float64):
        s = pt.Scope()
        pt.params_from_numpy({n: a.astype(dt) if a.dtype == np.float32 else a
                              for n, a in init.items()}, s, "cpu")
        out[dt] = exe.run(tm, feed=_feed(), fetch_list=fetch, scope=s)
    assert all(a.dtype == np.float64 for a in out[np.float64])
    for name, a, b in zip(fetch, out[np.float32], out[np.float64]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="softmax_with_cross_entropy"):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
            pt_transformer.train_network(src, src, src, 10, 10, fuse_final_ce=False)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        loss = pt.layers.mean(pt.layers.fc(input=x, size=2))
        with pytest.raises(NotImplementedError, match="regularization"):
            pt.optimizer.SGD(0.1, regularization=object()).minimize(loss)


def test_sgd_trains_a_linear_regression():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3])
        y = pt.layers.data(name="y", shape=[2])
        pred = pt.layers.fc(input=x, size=2)
        loss = pt.layers.mean(pt.layers.elementwise_add(pred, pt.layers.scale(y, scale=-1.0)))
        _, pairs = pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    (w, _), (b, _) = pairs
    assert w.shape == (3, 2) and b.shape == (2,)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    b0 = scope.find_var(b.name).clone()
    feed = {"x": np.ones((4, 3), np.float32), "y": np.zeros((4, 2), np.float32)}
    (l0,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    # d mean / d b = 1/2 per bias element, so one step moves b by -0.25
    torch.testing.assert_close(scope.find_var(b.name), b0 - 0.25)
    (l1,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert l1 < l0


def test_dropout_gradient_uses_the_forward_mask():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[64])
        x.stop_gradient = False
        out = pt.layers.dropout(x, dropout_prob=0.5)
        loss = pt.layers.mean(out)
        pt.append_backward(loss)
    assert [o.type for o in main.desc.block(0).ops][-1] == "dropout_grad"
    mask_name = main.desc.block(0).ops[0].output("Mask")[0]
    exe = pt.Executor(pt.CPUPlace())
    mask, dx = exe.run(main, feed={"x": np.ones((2, 64), np.float32)},
                       fetch_list=[mask_name, grad_var_name("x")], scope=pt.Scope())
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(dx, mask / mask.size)


def test_generic_grad_refuses_a_lowering_without_autograd_history():
    """A kernel output with no autograd history would silently drop the
    gradient; the generic grad raises instead."""
    name = "test_torch_training_detached_op"

    @register_lowering(name)
    def _detached(ctx, op):
        ctx.write_slot(op, "Out", ctx.read_slot(op, "X").detach() * 2.0)

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        h = pt.layers.fc(input=x, size=4)
        out = main.global_block.create_var(name="out", shape=h.shape)
        main.global_block.append_op(name, inputs={"X": h}, outputs={"Out": out})
        loss = pt.layers.mean(out)
        pt.optimizer.SGD(0.1).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="no autograd history"):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)}, scope=scope)
