"""The port's optimizer slice against the JAX package, on the CPU.

* every op the slice adds (elementwise, reductions, unary, comparisons,
  clip and norms, softmax and the cross-entropy losses, shape motion,
  matmul): the same tiny program built by both packages (equal
  ProgramDescs), run on the same numpy feeds; outputs within ``ATOL``
  (exactly for integer, boolean and copy ops) and, for differentiable
  ops, the input gradient from ``calc_gradient`` within ``ATOL``;
* every optimizer class: equal main and startup ProgramDescs for a small
  two-layer network, and 3 steps from the JAX startup's parameters within
  ``STEP_ATOL`` of the JAX ``Executor`` (a fused multiply-add under XLA
  against two roundings here);
* the five schedules' learning rates over 8 runs against the JAX
  package's and the closed forms; ``piecewise_decay``'s program equal to
  the JAX package's, and its error on values that do not fit;
* clip, then L2 regularization, then SGD with a staircase-decayed rate,
  against hand math;
* ``clone(for_test=True)`` leaving the step counter alone, and the
  counter's dtype equal to the JAX scope's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt

from _torch_validate import _no_port_validate_findings  # noqa: F401

ATOL = 1e-5          # float32, XLA against torch
STEP_ATOL = 2e-5     # parameters after 3 steps, float32


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _descs_equal(a, b):
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert [o["type"] for o in da["blocks"][0]["ops"]] == \
        [o["type"] for o in db["blocks"][0]["ops"]]
    assert da == db


def _op(pkg, op_type, inputs, attrs=None, outs=("Out",), dtype="float32"):
    """Append ``op_type`` through a LayerHelper; returns its outputs' vars."""
    helper = pkg.layer_helper.LayerHelper(op_type)
    out = {s: helper.create_variable_for_type_inference(dtype) for s in outs}
    helper.append_op(op_type, inputs=inputs, outputs=out, attrs=attrs or {})
    return [out[s] for s in outs]


def _run_both(build, feed, grad=True):
    """``build(pkg, xs)`` appends ops over the data vars ``xs`` (one per
    feed, gradient-carrying where float) and returns the vars to fetch.
    With ``grad``, the gradient of sum(first fetch * 1.5) w.r.t. every
    float input is fetched too (``calc_gradient``)."""
    results = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            xs = [pkg.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                                  append_batch_size=False,
                                  stop_gradient=a.dtype.kind != "f")
                  for n, a in feed.items()]
            fetch = build(pkg, xs)
            if grad:
                target = pkg.layers.reduce_sum(pkg.layers.scale(fetch[0], scale=1.5))
                fetch += [g for g in pkg.calc_gradient(target, [x for x in xs
                                                                if not x.stop_gradient])]
        results.append((main, startup, fetch))
    (jm, js, jf), (tm, ts, tf) = results
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    assert [v is None for v in jf] == [v is None for v in tf]
    jf, tf = [v for v in jf if v is not None], [v for v in tf if v is not None]
    jscope = fluid.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    ref = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)]
    tscope = pt.Scope()
    texe = pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    got = [np.asarray(a) for a in texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)
    return got


def _f(seed, *shape, lo=None):
    rs = np.random.RandomState(seed)
    a = rs.randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def _unary(op_type, **attrs):
    return lambda pkg, xs: _op(pkg, op_type, {"X": xs[0]}, attrs)


def _binary(layer, axis=-1):
    return lambda pkg, xs: [getattr(pkg.layers.nn, layer)(xs[0], xs[1], axis=axis)]


def _reduce(layer, **kw):
    return lambda pkg, xs: [getattr(pkg.layers.nn, layer)(xs[0], **kw)]


def _compare(op_type):
    return lambda pkg, xs: _op(pkg, op_type, {"X": xs[0], "Y": xs[1]}, dtype="bool")


X46, Y46, Y6 = _f(0, 4, 6), _f(1, 4, 6), _f(2, 6)
POS = _f(3, 4, 6, lo=0.1)
INT = np.array([[3, 0], [1, 2]], np.int32)
OPS = {
    # (build, feed, take the gradient)
    "elementwise_sub": (_binary("elementwise_sub"), {"x": X46, "y": Y46}, True),
    "elementwise_div": (_binary("elementwise_div"), {"x": X46, "y": POS}, True),
    "elementwise_min": (_binary("elementwise_min"), {"x": X46, "y": Y46}, True),
    "elementwise_max_bcast": (_binary("elementwise_max"), {"x": X46, "y": Y6}, True),
    "elementwise_pow": (_binary("elementwise_pow"), {"x": POS, "y": Y46}, True),
    "elementwise_mul_axis0": (_binary("elementwise_mul", axis=0),
                              {"x": X46, "y": _f(4, 4)}, True),
    "reduce_sum_all": (_reduce("reduce_sum"), {"x": X46}, True),
    "reduce_sum_dim1_keep": (_reduce("reduce_sum", dim=1, keep_dim=True), {"x": X46}, True),
    "reduce_mean_dim0": (_reduce("reduce_mean", dim=0), {"x": X46}, True),
    "reduce_max_dims": (_reduce("reduce_max", dim=[0, -1]), {"x": _f(5, 3, 4, 5)}, True),
    "reduce_min_neg_dim": (_reduce("reduce_min", dim=-1), {"x": X46}, True),
    "reduce_prod": (_reduce("reduce_prod", dim=[1]), {"x": POS}, True),
    "square": (_unary("square"), {"x": X46}, True),
    "sqrt": (_unary("sqrt"), {"x": POS}, True),
    "rsqrt": (_unary("rsqrt"), {"x": POS}, True),
    "abs": (_unary("abs"), {"x": X46}, True),
    "exp": (_unary("exp"), {"x": X46}, True),
    "log": (_unary("log"), {"x": POS}, True),
    "floor": (_unary("floor"), {"x": X46 * 3}, True),
    "ceil": (_unary("ceil"), {"x": X46 * 3}, True),
    "round": (_unary("round"), {"x": X46 * 3}, True),
    "sign": (_unary("sign"), {"x": X46}, True),
    "reciprocal": (_unary("reciprocal"), {"x": POS}, True),
    "sin": (_unary("sin"), {"x": X46}, True),
    "cos": (_unary("cos"), {"x": X46}, True),
    "pow": (_unary("pow", factor=-0.5), {"x": POS}, True),
    "clip": (_unary("clip", min=-0.5, max=0.7), {"x": X46}, True),
    "clip_by_norm_clips": (_unary("clip_by_norm", max_norm=1.0), {"x": X46}, True),
    "clip_by_norm_keeps": (_unary("clip_by_norm", max_norm=100.0), {"x": X46}, True),
    "squared_l2_norm": (_unary("squared_l2_norm"), {"x": X46}, True),
    "increment_float": (_unary("increment", step=2.5), {"x": X46}, False),
    "increment_int": (_unary("increment", step=1.0, ), {"x": INT}, False),
    "maximum": (lambda pkg, xs: _op(pkg, "maximum", {"X": xs[0], "Y": xs[1]}),
                {"x": X46, "y": Y46}, True),
    "less_than": (_compare("less_than"), {"x": X46, "y": Y46}, False),
    "less_equal": (_compare("less_equal"), {"x": X46, "y": X46}, False),
    "greater_than": (_compare("greater_than"), {"x": X46, "y": Y46}, False),
    "greater_equal": (_compare("greater_equal"), {"x": X46, "y": Y46}, False),
    "equal": (_compare("equal"), {"x": INT, "y": INT.T.copy()}, False),
    "not_equal": (_compare("not_equal"), {"x": INT, "y": INT.T.copy()}, False),
    "softmax": (lambda pkg, xs: [pkg.layers.softmax(xs[0])], {"x": _f(6, 3, 4, 7)}, True),
    "log_softmax": (_unary("log_softmax"), {"x": _f(6, 3, 4, 7)}, True),
    "cross_entropy_hard": (
        lambda pkg, xs: [pkg.layers.cross_entropy(pkg.layers.softmax(xs[0]), xs[1])],
        {"x": _f(7, 5, 9), "lbl": np.array([[1], [8], [0], [4], [4]], np.int64)}, True),
    "cross_entropy_soft": (
        lambda pkg, xs: [pkg.layers.cross_entropy(pkg.layers.softmax(xs[0]),
                                                  pkg.layers.softmax(xs[1]), soft_label=True)],
        {"x": _f(7, 5, 9), "y": _f(8, 5, 9)}, True),
    "softmax_with_cross_entropy_hard": (
        lambda pkg, xs: [pkg.layers.softmax_with_cross_entropy(xs[0], xs[1])],
        {"x": _f(9, 2, 3, 11) * 3, "lbl": np.random.RandomState(9).randint(0, 11, (2, 3, 1))},
        True),
    "softmax_with_cross_entropy_soft": (
        lambda pkg, xs: [pkg.layers.softmax_with_cross_entropy(
            xs[0], pkg.layers.softmax(xs[1]), soft_label=True)],
        {"x": _f(10, 4, 11), "y": _f(11, 4, 11)}, True),
    "transpose": (lambda pkg, xs: [pkg.layers.transpose(xs[0], [2, 0, 1])],
                  {"x": _f(12, 2, 3, 4)}, True),
    "concat": (lambda pkg, xs: [pkg.layers.concat([xs[0], xs[1]], axis=1)],
               {"x": X46, "y": _f(13, 4, 2)}, True),
    "split_num": (lambda pkg, xs: pkg.layers.split(xs[0], 3, dim=1), {"x": X46}, True),
    "split_sections": (lambda pkg, xs: pkg.layers.split(xs[0], [1, 3], dim=0),
                       {"x": X46}, True),
    "assign": (lambda pkg, xs: [pkg.layers.assign(xs[0])], {"x": X46}, True),
    "fill_constant_batch_size_like": (
        lambda pkg, xs: [pkg.layers.fill_constant_batch_size_like(xs[0], [-1, 3], "float32",
                                                                  2.5)],
        {"x": X46}, False),
    "fill_zeros_like": (lambda pkg, xs: [pkg.layers.zeros_like(xs[0])], {"x": X46}, False),
    "matmul": (lambda pkg, xs: [pkg.layers.matmul(xs[0], xs[1])],
               {"x": _f(14, 5, 6), "y": _f(15, 6, 3)}, True),
    "matmul_transposed_alpha": (
        lambda pkg, xs: [pkg.layers.matmul(xs[0], xs[1], transpose_x=True, transpose_y=True,
                                           alpha=0.5)],
        {"x": _f(14, 6, 5), "y": _f(15, 3, 6)}, True),
    "matmul_batched_bcast": (lambda pkg, xs: [pkg.layers.matmul(xs[0], xs[1])],
                             {"x": _f(16, 2, 4, 5, 6), "y": _f(17, 4, 6, 3)}, True),
    "matmul_vector": (lambda pkg, xs: [pkg.layers.matmul(xs[0], xs[1])],
                      {"x": _f(18, 4, 6), "y": _f(19, 6)}, True),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_lowering_and_gradient_equal_the_jax_lowering(case):
    build, feed, grad = OPS[case]
    got = _run_both(build, feed, grad=grad)
    assert all(np.isfinite(g).all() for g in got if g.dtype.kind == "f")


# ------------------------------------------------------------ optimizers

OPTIMIZERS = {
    "SGD": lambda o: o.SGD(learning_rate=0.1),
    "Momentum": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    "Momentum_nesterov": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9,
                                              use_nesterov=True),
    "LarsMomentum": lambda o: o.LarsMomentum(learning_rate=50.0, momentum=0.9),
    "Adam": lambda o: o.Adam(learning_rate=0.05),
    "Adamax": lambda o: o.Adamax(learning_rate=0.05),
    "Adagrad": lambda o: o.Adagrad(learning_rate=0.2),
    "DecayedAdagrad": lambda o: o.DecayedAdagrad(learning_rate=0.02),
    "Adadelta": lambda o: o.Adadelta(learning_rate=1.0),
    "RMSProp": lambda o: o.RMSProp(learning_rate=0.05, momentum=0.5),
    "Ftrl": lambda o: o.Ftrl(learning_rate=0.3, l1=0.01, l2=0.1),
    "Ftrl_lr_power": lambda o: o.Ftrl(learning_rate=0.3, lr_power=-0.3),
}


def _net(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[6])
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        logits = pkg.layers.fc(input=h, size=5)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, y))
        make_opt(pkg.optimizer).minimize(loss)
    return main, startup, loss


def _steps(main, startup, loss, jax_main, jax_startup, steps=3):
    """3 steps in both packages from the JAX startup's state; returns the
    losses and every persistable's final values (JAX, port)."""
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(12, 6).astype(np.float32), "y": rs.randint(0, 5, (12, 1))}
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jax_startup, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(startup, scope=tscope)
    persist = [v.name for v in jax_main.list_vars() if v.persistable]
    pt.params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in persist}, tscope, "cpu")
    losses = []
    for _ in range(steps):
        (a,) = jexe.run(jax_main, feed=feed, fetch_list=[loss.name], scope=jscope)
        (b,) = texe.run(main, feed=feed, fetch_list=[loss.name], scope=tscope)
        losses.append((float(np.asarray(a)), float(b)))
    final = {n: (np.asarray(jscope.find_var(n)), tscope.find_var(n).numpy()) for n in persist}
    return losses, final


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_program_and_three_steps_equal_the_jax_executor(name):
    jm, js, jl = _net(fluid, OPTIMIZERS[name])
    tm, ts, tl = _net(pt, OPTIMIZERS[name])
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    losses, final = _steps(tm, ts, tl, jm, js)
    ref, got = zip(*losses)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0], losses
    for n, (a, b) in final.items():
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_allclose(b, a, atol=STEP_ATOL, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_each_family_lowers_as_one_group_bit_equal_to_op_by_op(name, monkeypatch):
    """The group lowering over all updates of a step equals lowering each
    update op alone (a group of one), bit for bit."""
    from paddle_tpu_torch.core import executor as executor_module
    from paddle_tpu_torch.core import lower
    make = OPTIMIZERS[name]
    if True:
        tm, ts, tl = _net(pt, make)
        results = []
        for grouped in (True, False):
            scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
            exe.run(ts, scope=scope)
            # parameters random, accumulators in (0.05, 0.35) (moments stay
            # positive, beta powers below 1), as after some steps
            torch.manual_seed(0)
            params = {p.name for p in tm.global_block.all_parameters()}
            for v in tm.list_vars():
                if v.persistable and scope.find_var(v.name).is_floating_point():
                    t = scope.find_var(v.name)
                    t.copy_(torch.randn(t.shape) * 0.3 if v.name in params
                            else torch.rand(t.shape) * 0.3 + 0.05)
            rs = np.random.RandomState(1)
            feed = {"x": rs.randn(12, 6).astype(np.float32), "y": rs.randint(0, 5, (12, 1))}
            with monkeypatch.context() as m:
                if not grouped:
                    m.setattr(executor_module, "lower_block",
                              lambda ctx, block: [lower.lower_op(ctx, op, i)
                                                  for i, op in enumerate(block.ops)])
                exe.run(tm, feed=feed, fetch_list=[tl], scope=scope)
            results.append({v.name: scope.find_var(v.name).clone()
                            for v in tm.list_vars() if v.persistable})
        for n in results[0]:
            assert torch.equal(results[0][n], results[1][n]), (name, n)


# -------------------------------------------------------------- schedules

SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(1.0, 2, 0.5),
                    lambda t: 0.5 ** (t / 2)),
    "exponential_staircase": (lambda L: L.exponential_decay(1.0, 2, 0.5, staircase=True),
                              lambda t: 0.5 ** (t // 2)),
    "natural_exp": (lambda L: L.natural_exp_decay(1.0, 2, 0.5), lambda t: np.exp(-0.5 * t / 2)),
    "natural_exp_staircase": (lambda L: L.natural_exp_decay(1.0, 2, 0.5, staircase=True),
                              lambda t: np.exp(-0.5 * (t // 2))),
    "inverse_time": (lambda L: L.inverse_time_decay(1.0, 2, 0.5),
                     lambda t: 1.0 / (1 + 0.5 * t / 2)),
    "polynomial": (lambda L: L.polynomial_decay(1.0, 4, end_learning_rate=0.1),
                   lambda t: 0.9 * (1 - min(t, 4) / 4) + 0.1),
    "polynomial_power2": (lambda L: L.polynomial_decay(1.0, 4, end_learning_rate=0.1, power=2.0),
                          lambda t: 0.9 * (1 - min(t, 4) / 4) ** 2 + 0.1),
    "noam": (lambda L: L.noam_decay(64, 4),
             lambda t: 64 ** -0.5 * min((t + 1) ** -0.5, (t + 1) * 4 ** -1.5)),
}


def _trace(pkg, exe, build, steps=8):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        lr = build(pkg.layers)
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    vals = [float(np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0]).reshape(()))
            for _ in range(steps)]
    return main, startup, lr, vals


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_learning_rates_equal_the_jax_package_and_the_formula(name):
    build, formula = SCHEDULES[name]
    jm, js, jlr, ref = _trace(fluid, fluid.Executor(fluid.CPUPlace()), build)
    tm, ts, tlr, got = _trace(pt, pt.Executor(pt.CPUPlace()), build)
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    assert tlr.shape == (1,) and all(o.attrs.get("op_role") == "lr_sched"
                                     for o in tm.desc.block(0).ops)
    # XLA and torch may round a power differently in the last bit
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)
    np.testing.assert_allclose(got, [formula(t) for t in range(8)], rtol=1e-5)


def test_piecewise_decay_raises_naming_its_roadmap_item():
    """It raised NotImplementedError naming ROADMAP item 9 while the port
    had no Switch.  Now it builds the JAX package's program (a Switch of
    conditional blocks: every block equal, tests/test_torch_control_flow.py
    runs it) and raises only where the JAX package does: on values that do
    not fit the boundaries."""
    built = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            pkg.layers.piecewise_decay(boundaries=[2, 5], values=[1.0, 0.5, 0.1])
            with pytest.raises(ValueError, match="len\\(values\\)"):
                pkg.layers.piecewise_decay(boundaries=[2, 5], values=[1.0, 0.5])
        built.append((main, startup))
    assert built[1][0].desc.num_blocks() == 4
    _descs_equal(built[0][0], built[1][0])
    _descs_equal(built[0][1], built[1][1])


def test_the_step_counter_is_int32_in_both_scopes_and_the_eval_clone_leaves_it():
    out = []
    for pkg, exe in ((fluid, fluid.Executor(fluid.CPUPlace())), (pt, pt.Executor(pt.CPUPlace()))):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[3])
            loss = pkg.layers.mean(pkg.layers.fc(input=x, size=2))
            lr = pkg.layers.noam_decay(16, 10)
            pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
        test_prog = main.clone(for_test=True)
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((2, 3), np.float32)}
        name = "@LR_DECAY_COUNTER@_0"
        counts = []
        for prog in (main, test_prog, test_prog, main):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            counts.append(np.asarray(scope.find_var(name)).copy())
        assert not any(o.attrs.get("op_role") == "lr_sched" for o in test_prog.desc.block(0).ops)
        out.append(counts)
    (ref, got) = out
    assert [c.dtype for c in got] == [c.dtype for c in ref] == [np.dtype("int32")] * 4
    assert [int(c[0]) for c in got] == [int(c[0]) for c in ref] == [1, 1, 1, 2]


def test_clip_then_regularize_then_decayed_sgd_against_hand_math():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        y = pt.layers.data(name="y", shape=[1])
        pred = pt.layers.fc(input=x, size=1, param_attr=pt.ParamAttr(name="w"), bias_attr=False)
        loss = pt.layers.mean(pt.layers.square_error_cost(input=pred, label=y))
        lr = pt.layers.exponential_decay(learning_rate=0.1, decay_steps=2, decay_rate=0.5,
                                         staircase=True)
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(clip_norm=0.05))
        pt.optimizer.SGD(learning_rate=lr,
                         regularization=pt.regularizer.L2Decay(0.1)).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    w_ref = scope.find_var("w").numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((5, 3, 4)).astype(np.float32)
    Y = X.sum(axis=2, keepdims=True).astype(np.float32)
    for step in range(5):
        xb, yb = X[step], Y[step]
        exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss], scope=scope)
        g = (2.0 / xb.shape[0]) * xb.T @ (xb @ w_ref - yb)
        gn = np.sqrt((g ** 2).sum())
        if gn > 0.05:
            g = g * (0.05 / gn)          # clip first
        g = g + 0.1 * w_ref              # then L2Decay
        w_ref = w_ref - 0.1 * 0.5 ** (step // 2) * g
    np.testing.assert_allclose(scope.find_var("w").numpy(), w_ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
@pytest.mark.parametrize("reg", ["L1", "L2"])
def test_clips_and_regularizers_build_and_step_as_the_jax_package(clip, reg):
    def make(o, pkg):
        return o.Momentum(learning_rate=0.05, momentum=0.9,
                          regularization=getattr(pkg.regularizer, reg + "Decay")(0.01))
    out = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[6])
            y = pkg.layers.data(name="y", shape=[1], dtype="int64")
            logits = pkg.layers.fc(input=pkg.layers.fc(input=x, size=16, act="relu"), size=5)
            loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, y))
            c = {"value": lambda: pkg.clip.GradientClipByValue(0.02),
                 "norm": lambda: pkg.clip.GradientClipByNorm(0.05),
                 "global_norm": lambda: pkg.clip.GradientClipByGlobalNorm(0.05)}[clip]()
            pkg.clip.set_gradient_clip(c)
            make(pkg.optimizer, pkg).minimize(loss)
        out.append((main, startup, loss))
    (jm, js, jl), (tm, ts, tl) = out
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    losses, final = _steps(tm, ts, tl, jm, js)
    ref, got = zip(*losses)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for n, (a, b) in final.items():
        np.testing.assert_allclose(b, a, atol=STEP_ATOL, rtol=1e-5, err_msg=n)
