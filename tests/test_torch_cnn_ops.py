"""The CNN slice's ops against the JAX package, on the CPU.

* the repairs: ``split`` at the JAX lowering's offsets (C1), hard labels
  outside [0, C) in both cross-entropy losses (C2), ``reduce_mean`` of an
  integer tensor (C3);
* the random initializer ops, held by their distribution (JAX threefry and
  torch's generators never agree bit for bit) and the initializers'
  startup ops equal to the JAX package's;
* ``conv2d``, ``depthwise_conv2d``, ``pool2d`` (max, avg, global,
  ``exclusive``, windows of ties, ``ceil_mode``), ``batch_norm`` and
  ``batch_norm_grad`` (4-D and 2-D, training and test mode, a bf16 input),
  ``top_k``, ``accuracy``, the 22 activations, ``prelu`` and ``maxout``:
  the same program built by both packages (equal ProgramDescs), run on the
  same numpy feeds and parameters; outputs and, for differentiable ops,
  the gradients from ``calc_gradient`` within the gate written beside each;
* the ``bn-fold`` pass: the rewrite equal to the JAX package's, its logits
  within the JAX package's fold tolerance, the input program and its scope
  values untouched.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.initializer  # noqa: F401  (registers the attribute)
import paddle_tpu.passes  # noqa: F401
import paddle_tpu_torch as pt

from _torch_validate import _no_port_validate_findings  # noqa: F401

ATOL = 1e-5          # float32, XLA against torch, single ops
CONV_RTOL = 1e-5     # conv outputs and gradients, relative to the largest value


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def descs_equal(a, b):
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert [o["type"] for o in da["blocks"][0]["ops"]] == \
        [o["type"] for o in db["blocks"][0]["ops"]]
    assert da == db


def build_both(build):
    """``build(pkg)`` under ``unique_name.guard()`` in fresh programs of
    both packages; returns ((main, startup, out) of the JAX package, the
    same of the port), the ProgramDescs held equal."""
    results = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            out = build(pkg)
        results.append((main, startup, out))
    descs_equal(results[0][0], results[1][0])
    descs_equal(results[0][1], results[1][1])
    return results


def persistables(main):
    return [n for n, v in main.desc.block(0).vars.items() if v.persistable]


def start_both(jax_side, port_side):
    """Run both startups; the JAX scope's persistables carried into the
    port's scope.  Returns (JAX executor, JAX scope, port executor, port
    scope, the carried state)."""
    (jm, js, _), (tm, ts, _) = jax_side, port_side
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {n: np.array(jscope.find_var(n)) for n in persistables(jm)
             if jscope.find_var(n) is not None}
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    pt.params_from_numpy(state, tscope, "cpu")
    return jexe, jscope, texe, tscope, state


def fetch_names(fetch):
    return [getattr(v, "name", v) for v in fetch]


def run_both(build, feed, grad=True):
    """``build(pkg, xs)`` appends ops over the data vars ``xs`` (one per
    feed; float feeds carry a gradient) and returns the vars to fetch.
    With ``grad`` the gradients of sum(first fetch * 1.5) with respect to
    every float input are fetched too.  Returns (JAX fetches, port
    fetches) as numpy arrays, dtypes and shapes held equal."""
    def program(pkg):
        xs = [pkg.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                              append_batch_size=False, stop_gradient=a.dtype.kind != "f")
              for n, a in feed.items()]
        fetch = build(pkg, xs)
        if grad:
            target = pkg.layers.reduce_sum(pkg.layers.scale(fetch[0], scale=1.5))
            fetch += pkg.calc_gradient(target, [x for x in xs if not x.stop_gradient])
        return fetch
    jax_side, port_side = build_both(program)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    names = fetch_names(jax_side[2])
    assert names == fetch_names(port_side[2])
    ref = [np.asarray(a) for a in jexe.run(jax_side[0], feed=feed, fetch_list=names,
                                           scope=jscope)]
    got = [np.asarray(a) for a in texe.run(port_side[0], feed=feed, fetch_list=names,
                                           scope=tscope)]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return ref, got


def assert_close(got, ref, rtol):
    """Each array within ``rtol`` of the reference's largest magnitude (NaN
    where the reference has NaN)."""
    for a, b in zip(got, ref):
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            scale = max(float(np.nanmax(np.abs(b), initial=0.0)), 1.0)
            np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)
        else:
            np.testing.assert_array_equal(a, b)


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _op(pkg, op_type, inputs, attrs=None, outs=("Out",), dtype="float32"):
    helper = pkg.layer_helper.LayerHelper(op_type)
    out = {s: helper.create_variable_for_type_inference(dtype) for s in outs}
    helper.append_op(op_type, inputs=inputs, outputs=out, attrs=attrs or {})
    return [out[s] for s in outs]


# ------------------------------------------------------------------ C1 split
@pytest.mark.parametrize("shape,arg,dim", [
    ((10,), 3, 0),                # sections [3, 3, 3]: the last part takes 4
    ((4, 11), [2, 4, 5], 1),
    ((4, 11), [2, 4, 3], -1),     # sections short of the dim: the rest goes last
    ((6, 4), 3, 0),               # num, divisible
    ((6, 4), [6], 0),
])
def test_split_cuts_at_the_jax_lowerings_offsets(shape, arg, dim):
    feed = {"x": _f(0, *shape)}
    ref, got = run_both(lambda pkg, xs: list(pkg.layers.split(xs[0], arg, dim=dim)), feed,
                        grad=False)
    assert [a.shape for a in got] == [a.shape for a in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_split_into_unequal_parts_raises_as_jnp_split_does():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[10], append_batch_size=False)
        helper = pt.layer_helper.LayerHelper("split")
        outs = [helper.create_variable_for_type_inference("float32") for _ in range(3)]
        helper.append_op("split", inputs={"X": x}, outputs={"Out": outs},
                         attrs={"axis": 0, "sections": [], "num": 3})
    with pytest.raises(ValueError, match="equal parts"):
        pt.Executor(pt.CPUPlace()).run(main, feed={"x": _f(0, 10)}, fetch_list=outs,
                                       scope=pt.Scope())


# ------------------------------------------------------ C2 labels outside [0, C)
LABEL_CASES = {"minus_one": -1, "zero": 0, "last": 4, "C": 5}


@pytest.mark.parametrize("loss", ["cross_entropy", "softmax_with_cross_entropy"])
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_hard_label_outside_the_classes_matches_the_jax_lowering(loss, case):
    """Label -1 picks the last class, label C gives NaN (the JAX lowerings'
    ``take_along_axis``); a label in [0, C) has a finite gradient."""
    label = np.array([[LABEL_CASES[case]], [1], [2]], np.int64)
    feed = {"x": _f(1, 3, 5), "label": label}

    def build(pkg, xs):
        if loss == "cross_entropy":
            return [pkg.layers.cross_entropy(pkg.layers.softmax(xs[0]), xs[1])]
        return [pkg.layers.softmax_with_cross_entropy(xs[0], xs[1])]
    ref, got = run_both(build, feed, grad=LABEL_CASES[case] in range(5))
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(ref[0]))
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=1e-5)
    assert np.isnan(got[0][0, 0]) == (LABEL_CASES[case] == 5)
    if len(got) > 1:
        assert np.isfinite(got[1]).all()
        np.testing.assert_allclose(got[1], ref[1], atol=ATOL, rtol=1e-5)


# -------------------------------------------------------- C3 integer reduce_mean
@pytest.mark.parametrize("dim", [None, 1])
def test_reduce_mean_of_integers_is_float32(dim):
    feed = {"x": np.arange(12, dtype=np.int32).reshape(3, 4) * 7}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.reduce_mean(xs[0], dim=dim)], feed,
                        grad=False)
    assert got[0].dtype == np.float32 == ref[0].dtype
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)


# ------------------------------------------------ random ops and initializers
def _draw(op_type, attrs, n=200_000):
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        (out,) = _op(pt, op_type, {}, dict(attrs, shape=[n], dtype="float32"))
    return pt.Executor(pt.CPUPlace()).run(main, fetch_list=[out], scope=pt.Scope())[0]


def test_gaussian_random_has_its_mean_and_std():
    x = _draw("gaussian_random", {"mean": 0.5, "std": 2.0, "seed": 0})
    # the sample mean's std is 2 / sqrt(2e5) = 0.0045: 5 of them
    assert abs(x.mean() - 0.5) < 0.023 and abs(x.std() - 2.0) < 0.02
    assert x.dtype == np.float32


def test_truncated_gaussian_random_stays_inside_two_stds():
    x = _draw("truncated_gaussian_random", {"mean": -1.0, "std": 0.5, "seed": 0})
    assert x.min() > -2.0 and x.max() < 0.0     # mean +- 2 std, open
    # a standard normal truncated to (-2, 2) has std 0.8796
    assert abs(x.std() - 0.5 * 0.8796) < 0.005 and abs(x.mean() + 1.0) < 0.005
    assert (np.abs(x + 1.0) > 0.9).mean() > 0.01   # the tails reach the bound


def test_a_nonzero_seed_draws_the_same_numbers_twice():
    a = _draw("gaussian_random", {"mean": 0.0, "std": 1.0, "seed": 7}, n=64)
    b = _draw("gaussian_random", {"mean": 0.0, "std": 1.0, "seed": 7}, n=64)
    np.testing.assert_array_equal(a, b)


INITIALIZERS = {
    "normal": lambda m: m.NormalInitializer(0.1, 0.02),
    "truncated_normal": lambda m: m.TruncatedNormalInitializer(0.0, 0.05),
    "xavier_normal": lambda m: m.XavierInitializer(uniform=False),
    "xavier_uniform": lambda m: m.XavierInitializer(),
    "msra_normal": lambda m: m.MSRAInitializer(uniform=False),
    "msra_uniform": lambda m: m.MSRAInitializer(fan_in=50),
}


@pytest.mark.parametrize("name", sorted(INITIALIZERS))
def test_initializer_writes_the_jax_packages_startup_op(name):
    def build(pkg):
        init = INITIALIZERS[name](pkg.initializer)
        return pkg.layers.fc(pkg.layers.data(name="x", shape=[400]), size=300,
                             param_attr=pkg.ParamAttr(initializer=init))
    (_, _, _), (tm, ts, _) = build_both(build)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(ts, scope=scope)
    op = ts.desc.block(0).ops[0]
    w = scope.find_var(op.output("Out")[0]).numpy()
    if op.type in ("gaussian_random", "truncated_gaussian_random"):
        assert abs(w.std() - op.attr("std") * (0.8796 if "truncated" in op.type else 1)) \
            < 0.02 * op.attr("std")
        assert abs(w.mean() - op.attr("mean")) < 0.05 * op.attr("std")
    else:
        assert w.min() >= op.attr("min") and w.max() <= op.attr("max")
        assert w.max() > 0.99 * op.attr("max")


# ------------------------------------------------------------------- conv2d
CONVS = {
    # (x shape, filter (O, I, kh, kw), attrs)
    "3x3_pad1": ((2, 3, 9, 9), (4, 3, 3, 3), {"strides": [1, 1], "paddings": [1, 1]}),
    "7x7_stride2_pad3": ((2, 3, 15, 15), (8, 3, 7, 7), {"strides": [2, 2], "paddings": [3, 3]}),
    "1x1_stride2": ((2, 8, 8, 8), (4, 8, 1, 1), {"strides": [2, 2], "paddings": [0, 0]}),
    "dilation2": ((1, 2, 11, 10), (3, 2, 3, 3), {"dilations": [2, 2], "paddings": [2, 1]}),
    "groups2": ((2, 4, 6, 6), (6, 2, 3, 3), {"groups": 2, "paddings": [1, 1]}),
    "rect_stride": ((1, 3, 10, 7), (2, 3, 3, 2), {"strides": [2, 1], "paddings": [0, 1]}),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d_matches_the_jax_lowering(name):
    xs, ws, attrs = CONVS[name]
    feed = {"x": _f(2, *xs), "w": _f(3, *ws) * 0.3}
    ref, got = run_both(lambda pkg, v: _op(pkg, "conv2d", {"Input": v[0], "Filter": v[1]},
                                           attrs, outs=("Output",)), feed)
    assert_close(got, ref, CONV_RTOL)


def test_depthwise_conv2d_matches_the_jax_lowering():
    feed = {"x": _f(4, 2, 4, 8, 8), "w": _f(5, 8, 1, 3, 3)}
    ref, got = run_both(lambda pkg, v: _op(pkg, "depthwise_conv2d",
                                           {"Input": v[0], "Filter": v[1]},
                                           {"strides": [2, 2], "paddings": [1, 1]},
                                           outs=("Output",)), feed)
    assert_close(got, ref, CONV_RTOL)


def test_conv2d_layer_with_bias_and_act_matches_the_jax_package():
    feed = {"x": _f(6, 2, 3, 8, 8)}
    ref, got = run_both(lambda pkg, v: [pkg.layers.conv2d(v[0], num_filters=5, filter_size=3,
                                                          padding=1, act="relu")], feed)
    assert_close(got, ref, CONV_RTOL)


# ------------------------------------------------------------------- pool2d
POOLS = {
    # (x shape, layer kwargs)
    "max_3x3_s2_p1": ((2, 3, 9, 9), dict(pool_size=3, pool_stride=2, pool_padding=1)),
    "max_2x2_s2": ((2, 3, 8, 8), dict(pool_size=2, pool_stride=2)),
    "max_pad_over_half_window": ((1, 2, 7, 7), dict(pool_size=2, pool_stride=1,
                                                    pool_padding=2)),
    "avg_2x2_s2": ((2, 3, 8, 8), dict(pool_size=2, pool_stride=2, pool_type="avg")),
    "avg_exclusive_pad": ((2, 3, 7, 7), dict(pool_size=3, pool_stride=2, pool_padding=1,
                                             pool_type="avg")),
    "avg_inclusive_pad": ((2, 3, 7, 7), dict(pool_size=3, pool_stride=2, pool_padding=1,
                                             pool_type="avg", exclusive=False)),
    "avg_exclusive_pad_over_half_window": ((1, 2, 6, 6), dict(pool_size=2, pool_stride=2,
                                                              pool_padding=2,
                                                              pool_type="avg")),
    "global_max": ((2, 4, 5, 6), dict(global_pooling=True)),
    "global_avg": ((2, 4, 7, 7), dict(global_pooling=True, pool_type="avg")),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool2d_matches_the_jax_lowering(name):
    xs, kw = POOLS[name]
    ref, got = run_both(lambda pkg, v: [pkg.layers.pool2d(v[0], **kw)], {"x": _f(7, *xs)})
    assert_close(got, ref, ATOL)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pool2d_over_a_window_of_ties_routes_the_gradient_as_jax_does(pool_type):
    """Equal values in every window (a 3 x 3, stride 2, pad 1 window): max
    pooling sends each window's gradient to its first maximum, in both."""
    feed = {"x": np.ones((2, 3, 7, 7), np.float32)}
    ref, got = run_both(lambda pkg, v: [pkg.layers.pool2d(
        v[0], pool_size=3, pool_stride=2, pool_padding=1, pool_type=pool_type)], feed)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_pool2d_ceil_mode_declares_a_shape_its_runtime_does_not_give():
    """A fault of the reference that the port copies in the ProgramDesc and
    not in a value: the infer-shape rule honours ``ceil_mode`` (4 x 4 here)
    while the lowering's ``reduce_window`` floors (3 x 3); the port's
    runtime floors as the JAX lowering does."""
    feed = {"x": _f(8, 1, 2, 8, 8)}
    results = build_both(lambda pkg: pkg.layers.pool2d(
        pkg.layers.data(name="x", shape=[1, 2, 8, 8], append_batch_size=False), pool_size=3,
        pool_stride=2, ceil_mode=True))
    declared = [tuple(m.desc.block(0).find_var(out.name).shape) for m, _, out in results]
    assert declared == [(1, 2, 4, 4)] * 2
    ref, got = run_both(lambda pkg, v: [pkg.layers.pool2d(v[0], pool_size=3, pool_stride=2,
                                                          ceil_mode=True)], feed)
    assert ref[0].shape == got[0].shape == (1, 2, 3, 3)
    assert_close(got, ref, ATOL)


# --------------------------------------------------------------- batch_norm
def bn_program(pkg, x_shape, is_test, dtype="float32", momentum=0.9):
    """A batch_norm over data var ``x`` (gradient-carrying), its output
    times the fed ``ramp`` summed, and the gradients of that sum with
    respect to x, Scale and Bias.  Returns (fetch vars, the op's
    Mean/Variance/SavedMean/SavedVariance names)."""
    x = pkg.layers.data(name="x", shape=list(x_shape), dtype=dtype,
                        append_batch_size=False, stop_gradient=False)
    ramp = pkg.layers.data(name="ramp", shape=list(x_shape), dtype=dtype,
                           append_batch_size=False)
    y = pkg.layers.batch_norm(x, is_test=is_test, momentum=momentum)
    op = pkg.default_main_program().global_block.desc.ops[-1]
    target = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(y, ramp))
    scale, bias = op.input("Scale")[0], op.input("Bias")[0]
    blk = pkg.default_main_program().global_block
    grads = pkg.calc_gradient(target, [x, blk.var(scale), blk.var(bias)])
    names = {s: op.output(s)[0] for s in ("MeanOut", "VarianceOut", "SavedMean",
                                          "SavedVariance")}
    return [y] + grads, names


BN_CASES = {
    # (x shape, is_test)
    "nchw_train": ((4, 3, 5, 6), False),
    "nc_train": ((16, 7), False),
    "nchw_test": ((4, 3, 5, 6), True),
    "one_row_spatial_train": ((8, 5, 1, 1), False),
}
BN_RTOL = 2e-5       # outputs and gradients, relative to the largest value


def _run_bn(x_shape, is_test, x, dtype="float32", perturb_state=True):
    results = build_both(lambda pkg: bn_program(pkg, x_shape, is_test, dtype))
    jax_side, port_side = results
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    names = jax_side[2][1]
    if perturb_state:
        # running statistics away from (0, 1), so test mode reads them
        rs = np.random.RandomState(11)
        for slot in ("MeanOut", "VarianceOut"):
            n = names[slot]
            v = (rs.rand(*state[n].shape) + 0.5).astype(state[n].dtype)
            jscope.update_var(n, v)
            tscope.find_var(n).copy_(torch.from_numpy(v.astype(np.float32)))
    fetch = fetch_names(jax_side[2][0]) + ([] if is_test else [names["SavedMean"],
                                                               names["SavedVariance"]])
    feed = {"x": x, "ramp": np.linspace(-1, 2, x.size).reshape(x.shape).astype(np.float32)}
    # a bf16 value compared as float32 (the port fetches bf16 widened)
    ref = [np.asarray(a, np.float32) for a in jexe.run(jax_side[0], feed=feed,
                                                       fetch_list=fetch, scope=jscope)]
    got = [np.asarray(a, np.float32) for a in texe.run(port_side[0], feed=feed,
                                                       fetch_list=fetch, scope=tscope)]
    stats = [(np.asarray(jscope.find_var(names[s]), np.float32),
              tscope.find_var(names[s]).float().numpy()) for s in ("MeanOut", "VarianceOut")]
    return ref, got, stats


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_and_its_grad_match_the_jax_lowerings(case):
    """Y, the gradients of X, Scale and Bias (``batch_norm_grad``), the
    saved batch mean and 1/sqrt(var + eps), and the running statistics
    written in place."""
    x_shape, is_test = BN_CASES[case]
    x = (_f(9, *x_shape) * 3 + 1).astype(np.float32)
    ref, got, stats = _run_bn(x_shape, is_test, x)
    assert_close(got, ref, BN_RTOL)
    for j, t in stats:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_batch_norm_statistics_are_biased_with_the_reference_momentum():
    """The running variance takes the biased batch variance, weighted as
    0.9 * running + 0.1 * batch, and SavedVariance is 1/sqrt(var + eps):
    checked against numpy, so an unbiased variance (a factor n/(n-1) = 4/3
    here), torch's momentum convention or the variance saved as itself
    each fails."""
    x_shape = (4, 3)
    x = _f(10, *x_shape)
    ref, got, stats = _run_bn(x_shape, False, x, perturb_state=False)
    var = x.var(0)
    np.testing.assert_allclose(stats[1][1], 0.9 * 1.0 + 0.1 * var, rtol=1e-6)
    np.testing.assert_allclose(stats[0][1], 0.1 * x.mean(0), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[-1], 1 / np.sqrt(var + 1e-5), rtol=1e-5)
    np.testing.assert_allclose(got[-2], x.mean(0), rtol=1e-5, atol=1e-7)


def test_batch_norm_over_a_bf16_input_matches_the_jax_lowering():
    """The bf16 branch: float32-accumulated E[x^2] - E[x]^2, Y written in
    bf16 (one bf16 rounding apart at most), the statistics float32."""
    x_shape = (4, 3, 5, 5)
    x = (_f(12, *x_shape) * 2 + 0.5).astype(np.float32)
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    ref, got, stats = _run_bn(x_shape, False, x_bf16, dtype="bfloat16")
    # Y: within one bf16 ulp of |Y|'s largest values; the statistics
    # (float32) within float32 rounding
    np.testing.assert_allclose(got[0], ref[0], atol=2 ** -7 * float(np.abs(ref[0]).max()))
    for a, b in zip(got[-2:], ref[-2:]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for j, t in stats:
        np.testing.assert_allclose(t, j, rtol=1e-5)


# ----------------------------------------------------------- top_k, accuracy
def test_top_k_values_and_indices_match_the_jax_lowering():
    feed = {"x": _f(13, 6, 9)}
    ref, got = run_both(lambda pkg, v: list(pkg.layers.topk(v[0], k=3)), feed, grad=False)
    assert got[1].dtype == np.int32          # declared int64, 64-bit mode off
    assert_close(got, ref, 0.0)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_matches_the_jax_lowering(k):
    rs = np.random.RandomState(14)
    feed = {"x": _f(14, 16, 10), "label": rs.randint(0, 10, (16, 1)).astype(np.int64)}
    ref, got = run_both(lambda pkg, v: [pkg.layers.accuracy(v[0], v[1], k=k)], feed,
                        grad=False)
    assert got[0].dtype == np.float32 and got[0].shape == ()
    np.testing.assert_array_equal(got[0], ref[0])


def test_accuracy_writes_int32_counts():
    rs = np.random.RandomState(15)
    feed = {"x": _f(15, 12, 5), "label": rs.randint(0, 5, (12, 1)).astype(np.int64)}

    def build(pkg, v):
        helper = pkg.layer_helper.LayerHelper("acc")
        correct = helper.create_variable_for_type_inference("int32", True)
        total = helper.create_variable_for_type_inference("int32", True)
        acc = pkg.layers.accuracy(v[0], v[1], k=2, correct=correct, total=total)
        return [acc, correct, total]
    ref, got = run_both(build, feed, grad=False)
    assert [a.dtype for a in got] == [np.float32, np.int32, np.int32]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[2] == 12


# -------------------------------------------------------------- activations
ACTIVATIONS = {
    # op type -> (attrs, input); inputs stay off the kinks of each function
    "sigmoid": ({}, None), "logsigmoid": ({}, None), "relu": ({}, None), "tanh": ({}, None),
    "tanh_shrink": ({}, None), "softshrink": ({"lambda": 0.3}, None),
    "hard_shrink": ({"threshold": 0.4}, None), "softsign": ({}, None),
    "softplus": ({}, "wide"), "elu": ({"alpha": 0.7}, None), "relu6": ({}, "wide"),
    "leaky_relu": ({"alpha": 0.1}, None), "soft_relu": ({"threshold": 3.0}, "wide"),
    "brelu": ({"t_min": -0.5, "t_max": 1.0}, None),
    "stanh": ({"scale_a": 0.5, "scale_b": 2.0}, None),
    "hard_sigmoid": ({"slope": 0.3, "offset": 0.4}, None),
    "thresholded_relu": ({"threshold": 0.2}, None), "swish": ({"beta": 1.5}, None),
    "gelu": ({}, None), "mish": ({}, "wide"), "silu": ({}, None), "exp_act": ({}, None),
}
ACT_DEFAULTS = ["softshrink", "hard_shrink", "elu", "leaky_relu", "soft_relu", "brelu",
                "stanh", "hard_sigmoid", "thresholded_relu", "swish"]


def _act_input(kind):
    x = _f(16, 4, 25) * (8.0 if kind == "wide" else 1.5)
    # keep away from the kinks (0, +-0.2 ... +-6) by at least 1e-3
    for kink in (0.0, 0.2, -0.2, 0.3, -0.3, 0.4, -0.4, -0.5, 1.0, 3.0, -3.0, 6.0):
        near = np.abs(x - kink) < 1e-3
        x[near] += 3e-3
    return x


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_and_its_gradient_match_the_jax_lowering(name):
    attrs, kind = ACTIVATIONS[name]
    ref, got = run_both(lambda pkg, v: [getattr(pkg.layers.nn, name)(v[0], **attrs)]
                        if hasattr(fluid.layers.nn, name)
                        else _op(pkg, name, {"X": v[0]}, attrs), {"x": _act_input(kind)})
    assert_close(got, ref, 2e-6)


@pytest.mark.parametrize("name", ACT_DEFAULTS)
def test_activation_defaults_match_the_jax_lowering(name):
    """Each op with its attrs left out: the defaults are the reference's."""
    ref, got = run_both(lambda pkg, v: _op(pkg, name, {"X": v[0]}), {"x": _act_input("wide")})
    assert_close(got, ref, 2e-6)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_approximate_attr_matches_the_jax_lowering(approximate):
    ref, got = run_both(lambda pkg, v: _op(pkg, "gelu", {"X": v[0]},
                                           {"approximate": approximate}),
                        {"x": _act_input(None)})
    assert_close(got, ref, 2e-6)


def test_act_on_a_layer_appends_each_activation():
    """``act=`` on a layer appends the activation op by name."""
    ref, got = run_both(lambda pkg, v: [pkg.layers.fc(v[0], size=6, act="mish")],
                        {"x": _f(17, 3, 4)})
    assert_close(got, ref, 2e-6)


@pytest.mark.parametrize("mode,shape", [("all", (3, 4, 5, 5)), ("channel", (3, 4, 5, 5)),
                                        ("element", (3, 4, 6))])
def test_prelu_matches_the_jax_lowering(mode, shape):
    """The learned alpha (0.25 at start) and its gradient, in each mode."""
    def build(pkg, v):
        out = pkg.layers.prelu(v[0], mode=mode)
        alpha = [n for n, d in pkg.default_main_program().global_block.desc.vars.items()
                 if d.persistable][0]
        blk = pkg.default_main_program().global_block
        (ga,) = pkg.calc_gradient(pkg.layers.reduce_sum(out), [blk.var(alpha)])
        return [out, ga]
    ref, got = run_both(build, {"x": _f(18, *shape)})
    assert_close(got, ref, 2e-6)


def test_maxout_matches_the_jax_lowering():
    ref, got = run_both(lambda pkg, v: _op(pkg, "maxout", {"X": v[0]}, {"groups": 3}),
                        {"x": _f(19, 2, 6, 4, 5)})
    assert ref[0].shape == (2, 2, 4, 5)
    assert_close(got, ref, 0.0)
    layer = pt.Program()
    with pt.program_guard(layer, pt.Program()):
        out = pt.layers.maxout(pt.layers.data(name="x", shape=[6, 4, 5]), groups=2)
    assert tuple(layer.desc.block(0).find_var(out.name).shape) == (-1, 3, 4, 5)


# ------------------------------------------------------------------ bn-fold
BN_FOLD_RTOL, BN_FOLD_ATOL = 2e-4, 2e-5      # the JAX package's fold tolerance


def _fold_net(pkg, conv_bias):
    img = pkg.layers.data(name="img", shape=[3, 12, 12], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    c = pkg.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                          bias_attr=None if conv_bias else False)
    bn = pkg.layers.batch_norm(c, act="relu")
    pool = pkg.layers.pool2d(bn, pool_size=2, pool_stride=2)
    pred = pkg.layers.fc(input=pool, size=4, act="softmax")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=label))
    pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss, pred


@pytest.mark.parametrize("conv_bias", [True, False])
def test_bn_fold_matches_the_jax_pass_and_leaves_its_input_alone(conv_bias):
    results = build_both(lambda pkg: _fold_net(pkg, conv_bias))
    jexe, jscope, texe, tscope, _ = start_both(*results)
    (jm, _, (jloss, jpred)), (tm, _, (tloss, tpred)) = results
    rs = np.random.RandomState(20)
    for _ in range(3):       # training steps, so the running statistics move
        feed = {"img": rs.rand(8, 3, 12, 12).astype(np.float32),
                "label": rs.randint(0, 4, (8, 1)).astype(np.int64)}
        jexe.run(jm, feed=feed, fetch_list=[jloss.name], scope=jscope)
        texe.run(tm, feed=feed, fetch_list=[tloss.name], scope=tscope)
    jtest = jm.clone(for_test=True)._prune([jpred.name])
    ttest = tm.clone(for_test=True)._prune([tpred.name])
    descs_equal(jtest, ttest)
    jfold, _ = fluid.passes.PassPipeline(["bn-fold"], verify="off").run(
        jtest, fetch_list=[jpred.name], scope=jscope)
    before = {n: tscope.find_var(n).clone() for n in persistables(tm)}
    tfold, res = pt.passes.PassPipeline(["bn-fold"], verify="off").run(
        ttest, fetch_list=[tpred.name], scope=tscope)
    descs_equal(jfold, tfold)
    assert res.passes[0].ops_replaced == 1
    assert "batch_norm" in [o.type for o in ttest.desc.block(0).ops]
    assert "batch_norm" not in [o.type for o in tfold.desc.block(0).ops]
    for n, v in before.items():
        assert torch.equal(tscope.find_var(n), v), n
    x = {"img": rs.rand(4, 3, 12, 12).astype(np.float32)}
    want = texe.run(ttest, feed=x, fetch_list=[tpred.name], scope=tscope)[0]
    got = texe.run(tfold, feed=x, fetch_list=[tpred.name], scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=BN_FOLD_RTOL, atol=BN_FOLD_ATOL)
    jgot = np.asarray(jexe.run(jfold, feed=x, fetch_list=[jpred.name], scope=jscope)[0])
    np.testing.assert_allclose(got, jgot, rtol=BN_FOLD_RTOL, atol=BN_FOLD_ATOL)
    still = texe.run(ttest, feed=x, fetch_list=[tpred.name], scope=tscope)[0]
    np.testing.assert_array_equal(still, want)


def test_bn_fold_through_the_executor_and_without_a_scope():
    """``Executor(passes=["bn-fold"])`` folds with the scope it runs in; a
    pipeline run without a scope skips the pass; a training-mode
    batch_norm is left alone.  Its last check read "``default_pipeline``
    still raises (three seed passes to go)" before the seed passes were
    ported; now ``make_pipeline(True)`` folds this program too, within the
    fold tolerance, with the verifier on (``verify="error"``)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, pred = _fold_net(pt, True)
    scope = pt.Scope()
    plain, folding = pt.Executor(pt.CPUPlace()), pt.Executor(pt.CPUPlace(), passes=["bn-fold"])
    plain.run(startup, scope=scope)
    test = main.clone(for_test=True)._prune([pred.name])
    x = {"img": np.random.RandomState(21).rand(2, 3, 12, 12).astype(np.float32)}
    want = plain.run(test, feed=x, fetch_list=[pred.name], scope=scope)[0]
    got = folding.run(test, feed=x, fetch_list=[pred.name], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=BN_FOLD_RTOL, atol=BN_FOLD_ATOL)
    ran = folding._apply_passes(test, ["img"], [pred.name], scope)
    assert "batch_norm" not in [o.type for o in ran.desc.block(0).ops]
    _, res = pt.passes.PassPipeline(["bn-fold"], verify="off").run(test, fetch_list=[pred.name])
    assert res.passes[0].skipped and not res.changed
    _, res = pt.passes.PassPipeline(["bn-fold"], verify="off").run(
        main, fetch_list=[loss.name], scope=scope)
    assert not res.changed and "training-mode" in res.passes[0].notes[0]
    seed = pt.passes.make_pipeline(True)
    assert seed.verify == "error" and "bn-fold" in [p.name for p in seed.passes]
    folded, res = seed.run(test, fetch_list=[pred.name], scope=scope)
    assert "batch_norm" not in [o.type for o in folded.desc.block(0).ops]
    assert res.verify_counts_post["error"] == res.verify_counts_post["warning"] == 0
    got = plain.run(folded, feed=x, fetch_list=[pred.name], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=BN_FOLD_RTOL, atol=BN_FOLD_ATOL)


def test_inferencer_with_bn_fold_serves_the_folded_program():
    """``Inferencer(passes=["bn-fold"])`` on a test-mode conv + batch_norm
    net folds every batch_norm with its own scope, within the fold
    tolerance of the same Inferencer without the pass."""
    def infer_func():
        img = pt.layers.data(name="img", shape=[3, 12, 12], dtype="float32")
        c = pt.layers.conv2d(img, num_filters=6, filter_size=3, padding=1, bias_attr=False)
        bn = pt.layers.batch_norm(c, act="relu", is_test=True)
        return pt.layers.fc(input=bn, size=4)
    plain = pt.Inferencer(infer_func, place=pt.CPUPlace())
    folding = pt.Inferencer(infer_func, place=pt.CPUPlace(), passes=["bn-fold"])
    rs = np.random.RandomState(22)
    for v in plain.inference_program.list_vars():
        if v.persistable:     # statistics away from (0, 1); the same in both
            t = plain.scope.find_var(v.name)
            t.copy_(torch.from_numpy(rs.rand(*t.shape).astype(np.float32) + 0.5))
            folding.scope.find_var(v.name).copy_(t)
    x = {"img": rs.rand(2, 3, 12, 12).astype(np.float32)}
    want, got = plain.infer(x)[0], folding.infer(x)[0]
    ran = folding.exe._apply_passes(folding.inference_program, ["img"],
                                    [v.name for v in folding.predict_vars], folding.scope)
    assert "batch_norm" not in [o.type for o in ran.desc.block(0).ops]
    np.testing.assert_allclose(got, want, rtol=BN_FOLD_RTOL, atol=BN_FOLD_ATOL)
