"""The shape, math, normalization, quantization and update ops of the
book models' slice against the JAX package's lowerings, on the CPU.

Each op is appended by both packages to the same program (equal
ProgramDescs), run on the same seeded numpy inputs and parameters, and
compared output by output and, for differentiable ops, gradient by
gradient (``calc_gradient`` of sum(1.5 * the first output)):

* bit-equal where the maths is exact: copies, gathers, tiles, pads, the
  one-hot rows, the arg reductions, integer mod and floor division, the
  booleans, the range quantizer's window and counter, the straight-through
  gradients and ``average_accumulates``' sums and counters;
* within ``ATOL`` of the largest magnitude elsewhere (float32, XLA against
  torch), ``CONV_RTOL`` for ``conv2d_transpose``, half a bf16 ulp (+
  ``LRN_F32_RTOL``) for ``lrn`` on a bf16 input and ``PROX_RTOL`` for the
  proximal rules, whose zeros (the L1 shrink) are exact.

The edge cases the two libraries disagree on by default are held to the
JAX lowering's answer: ``one_hot`` of an id outside [0, depth) (a zero
row), ``squeeze`` of an axis whose size is not 1 (an error), ``expand``
as a tile, ``slice`` bounds clamped, ties in ``arg_max`` / ``arg_min``
(the first index), Python's modulus and floored division, ``gather`` at
an index outside the rows (a NaN row), ``lrn`` without a ``k`` attr (2.0)
and ``conv2d_transpose`` ignoring ``groups``.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu_torch.core.registry import OPS
from test_torch_cnn_ops import (CONV_RTOL, _f, _op, assert_close, build_both, fetch_names,
                                run_both, start_both)

from _torch_validate import _no_port_validate_findings  # noqa: F401

ATOL = 1e-5          # float32, XLA against torch, relative to the largest value
# lrn on a bf16 input: both compute op by op in bf16 (each op's float32
# result rounded, the scalars bf16).  XLA drops the last op's bf16 round
# trip before the fetch's cast to float32 (excess precision), so each JAX
# value is the last op's float32 result: the port's within half a bf16 ulp
# of it, plus LRN_F32_RTOL for the two libraries' float32 pow
LRN_F32_RTOL = 1e-6
# the proximal rules, relative to the largest value: XLA on the CPU
# contracts p - lr * g into one fused multiply-add (one rounding), the port
# rounds the product first, so an element may move by an ulp of the larger
# term before the shrink and the division (readings: 1 ulp, 1.2e-7)
PROX_RTOL = 5e-7


def _exact(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the registry

SLICE_OPS = ("assign_value", "flatten", "stack", "squeeze", "unsqueeze", "gather", "slice",
             "expand", "pad", "one_hot", "arg_max", "arg_min", "lrn", "conv2d_transpose",
             "elementwise_mod", "elementwise_floordiv", "isfinite", "cos_sim",
             "squared_l2_distance", "fake_quantize_abs_max", "fake_quantize_range_abs_max",
             "fake_quantize_ste_grad", "proximal_gd", "proximal_adagrad",
             "average_accumulates")


@pytest.mark.parametrize("op_type", SLICE_OPS + ("shape", "top_k", "is_empty"))
def test_gradient_flags_and_shape_rules_match_the_jax_registrations(op_type):
    """``no_gradient`` (``mark_no_gradient`` marks shape, one_hot, arg_max,
    arg_min, top_k and is_empty, lowered or not), ``non_diff_inputs``,
    whether a grad maker is registered and whether an infer-shape rule is."""
    ours, ref = OPS.get(op_type), JAX_OPS.get(op_type)
    assert ours.no_gradient == ref.no_gradient
    assert tuple(ours.non_diff_inputs) == tuple(ref.non_diff_inputs)
    assert (ours.grad_maker is None) == (ref.grad_maker is None)
    assert (OPS.infer_shape_fn(op_type) is None) == (JAX_OPS.infer_shape_fn(op_type) is None)
    if op_type != "is_empty" and op_type != "shape":
        assert ours.lower is not None


# ----------------------------------------------------------------- shape ops

@pytest.mark.parametrize("values,shape,dtype", [
    ([1.5, -2.0, 3.25, 0.0, 7.0, -1.0], [2, 3], "float32"),
    ([3, -4, 2 ** 31 - 1, 0], [4], "int64"),          # made int32, as JAX with x64 off
    ([1, 0, 1], [3, 1], "int32"),
])
def test_assign_value(values, shape, dtype):
    def build(pkg):
        return [pkg.layers.assign_value(values, shape, dtype)]
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    names = fetch_names(jax_side[2])
    ref = [np.asarray(a) for a in jexe.run(jax_side[0], fetch_list=names, scope=jscope)]
    got = [np.asarray(a) for a in texe.run(port_side[0], fetch_list=names, scope=tscope)]
    assert got[0].dtype == ref[0].dtype and got[0].shape == tuple(shape)
    _exact(got, ref)


def test_assign_value_hands_each_run_a_fresh_tensor():
    """The constant is made once a device and cloned each run (a CUDA
    graph can capture the clone): a run's value written in place leaves
    the next run's alone."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        out = pt.layers.assign_value([1.0, 2.0, 3.0], [3])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    first = exe.run(main, fetch_list=[out], scope=scope, return_numpy=False)[0]
    first.add_(10.0)
    (second,) = exe.run(main, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(second, [1.0, 2.0, 3.0])


@pytest.mark.parametrize("axis", [0, 1, 2, 4])
def test_flatten(axis):
    feed = {"x": _f(0, 2, 3, 4, 5)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.flatten(xs[0], axis=axis)], feed)
    _exact(got, ref)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack(axis):
    feed = {"a": _f(1, 3, 4), "b": _f(2, 3, 4), "c": _f(3, 3, 4)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.stack(xs, axis=axis)], feed)
    _exact(got, ref)


@pytest.mark.parametrize("shape,axes", [((3, 1, 4, 1), [1]), ((3, 1, 4, 1), [-1]),
                                        ((3, 1, 4, 1), [1, 3]), ((1, 3, 1, 4, 1), [])])
def test_squeeze(shape, axes):
    feed = {"x": _f(4, *shape)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.squeeze(xs[0], axes=axes)], feed)
    _exact(got, ref)


def test_squeeze_of_an_axis_not_of_size_one_raises_in_both():
    """``jnp.squeeze`` raises where ``torch.squeeze(dim)`` would keep the
    dim: the port raises too."""
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[3, 4], dtype="float32", append_batch_size=False)
        return [pkg.layers.squeeze(x, axes=[1])]
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    names = fetch_names(jax_side[2])
    feed = {"x": _f(5, 3, 4)}
    with pytest.raises(Exception):
        jexe.run(jax_side[0], feed=feed, fetch_list=names, scope=jscope)
    with pytest.raises(ValueError, match="not of size 1"):
        texe.run(port_side[0], feed=feed, fetch_list=names, scope=tscope)


@pytest.mark.parametrize("axes", [[0], [0, 2], [-1], [1, 3]])
def test_unsqueeze(axes):
    feed = {"x": _f(6, 3, 4)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.unsqueeze(xs[0], axes=axes)], feed)
    _exact(got, ref)


@pytest.mark.parametrize("index", [
    np.array([4, 0, 2, 2], np.int32),
    np.array([-1, -5, 3], np.int32),                 # from the end
    np.array([[1, 0, 3], [2, 2, 4]], np.int64),      # 2-D: Out is [2, 3, 6]
    np.array([7, 1, -6], np.int32),                  # outside [-5, 5): NaN rows
])
def test_gather(index):
    """X's rows at Index; Index takes no gradient, X's gradient sums the
    rows' (0 for an index outside the rows)."""
    feed = {"x": _f(7, 5, 6), "index": index}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.gather(xs[0], xs[1])], feed)
    _exact(got, ref)


@pytest.mark.parametrize("axes,starts,ends", [
    ([0, 2], [1, -3], [10, -1]),       # an end past the dim, negative bounds
    ([1], [2], [2]),                   # empty
    ([0, 1, 2], [0, 1, 0], [-1, 100, 3]),
    ([-1], [1], [4]),
])
def test_slice(axes, starts, ends):
    feed = {"x": _f(8, 4, 6, 5)}
    ref, got = run_both(lambda pkg, xs: _op(pkg, "slice", {"Input": xs[0]},
                                            {"axes": axes, "starts": starts, "ends": ends}),
                        feed, grad=bool(np.prod([len(range(*slice(s, e).indices(d)))
                                                 for s, e, d in zip(starts, ends, (4, 6, 5))])))
    _exact(got, ref)


@pytest.mark.parametrize("times", [[2, 3], [1, 1], [3, 1]])
def test_expand_tiles(times):
    feed = {"x": _f(9, 2, 3)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.expand(xs[0], times)], feed)
    _exact(got, ref)


def test_expand_with_more_times_than_dims_tiles_as_jnp_tile():
    """``jnp.tile`` prepends dims for the extra reps (the JAX lowering's
    answer; ``Tensor.expand`` would broadcast instead of copy)."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.lower import LowerCtx
    x = _f(10, 2, 3)
    op = OpDesc(type="expand", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                attrs={"expand_times": [2, 1, 3]})
    ctx = LowerCtx(None, {"x": torch.from_numpy(x)}, torch.Generator(), torch.device("cpu"))
    OPS.get("expand").lower(ctx, op)
    np.testing.assert_array_equal(ctx.env["y"].numpy(), np.asarray(jnp.tile(x, (2, 1, 3))))


@pytest.mark.parametrize("paddings,value", [([1, 0, 2, 3], 0.5), ([0, 0, 0, 4], 0.0)])
def test_pad(paddings, value):
    feed = {"x": _f(11, 2, 3)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.pad(xs[0], paddings, pad_value=value)], feed)
    _exact(got, ref)


@pytest.mark.parametrize("ids", [
    np.array([[0], [3], [2], [4]], np.int64),          # a trailing 1 squeezed
    np.array([[-1], [5], [8], [1]], np.int32),         # outside [0, 5): zero rows
    np.array([1, 4, -3, 0], np.int32),
    np.array([[1, 2], [9, 0]], np.int64),
])
def test_one_hot(ids):
    feed = {"ids": ids}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.one_hot(xs[0], depth=5)], feed, grad=False)
    assert got[0].dtype == np.float32
    _exact(got, ref)


@pytest.mark.parametrize("layer", ["argmax", "argmin"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_arg_reductions_take_the_first_of_ties(layer, axis):
    x = np.round(_f(12, 5, 6) * 0.6).astype(np.float32)   # many ties
    x[2, :] = 1.0
    x[:, 3] = x[:, 1]
    feed = {"x": x}
    ref, got = run_both(lambda pkg, xs: [getattr(pkg.layers, layer)(xs[0], axis=axis)], feed,
                        grad=False)
    assert got[0].dtype == np.int32                  # declared int64, x64 off
    _exact(got, ref)


# ------------------------------------------------------- lrn, conv2d_transpose

@pytest.mark.parametrize("n,alpha,beta", [(5, 1e-4, 0.75), (3, 0.5, 0.9), (4, 0.2, 0.5)])
def test_lrn(n, alpha, beta):
    """``layers.lrn`` (k = 1.0 written), MidOut with it; large alpha so the
    normalization shows."""
    feed = {"x": _f(13, 2, 7, 4, 3) * 3}

    def build(pkg, xs):
        out = pkg.layers.lrn(xs[0], n=n, alpha=alpha, beta=beta)
        mid = [o for o in pkg.default_main_program().desc.block(0).ops if o.type == "lrn"]
        return [out, mid[0].output("MidOut")[0]]
    ref, got = run_both(build, feed)
    assert_close(got, ref, ATOL)


def test_lrn_without_k_reads_the_lowerings_default():
    """An ``lrn`` op without a ``k`` attr normalizes with k = 2.0."""
    feed = {"x": _f(14, 2, 6, 3, 3) * 2}
    ref, got = run_both(lambda pkg, xs: _op(pkg, "lrn", {"X": xs[0]}, {"n": 3, "alpha": 0.3},
                                            outs=("Out", "MidOut")), feed)
    assert_close(got, ref, ATOL)
    x = feed["x"].astype(np.float64)
    sq = np.pad(x * x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    mid = 2.0 + 0.3 * sum(sq[:, i:i + 6] for i in range(3))
    np.testing.assert_allclose(got[1], mid, rtol=1e-6)


def test_lrn_on_bf16():
    """Under amp-bf16, ``lrn`` follows its bf16 input (it is in none of the
    policy's lists): op by op in bf16 in both packages, within half a bf16
    ulp of the JAX package's values, whose last rounding XLA drops."""
    feed = {"x": _f(15, 2, 8, 5, 5) * 4}

    def build(pkg, xs):
        xb = pkg.layers.cast(xs[0], "bfloat16")
        out = _op(pkg, "lrn", {"X": xb}, {"n": 5, "k": 1.0, "alpha": 0.05, "beta": 0.75},
                  outs=("Out", "MidOut"), dtype="bfloat16")
        return [pkg.layers.cast(o, "float32") for o in out]
    ref, got = run_both(build, feed, grad=False)
    for a, b in zip(got, ref):
        b = b.astype(np.float64)
        half_ulp = np.exp2(np.floor(np.log2(np.abs(b) + 1e-30)) - 8)
        assert (np.abs(a - b) <= half_ulp + LRN_F32_RTOL * np.abs(b)).all()
        assert (a.view(np.uint32) & 0xFFFF == 0).all()      # bf16 values


@pytest.mark.parametrize("stride,padding,dilation,size", [
    (1, 0, 1, 3), (2, 1, 1, 3), (2, 0, 2, 3), (3, 2, 1, 4)])
def test_conv2d_transpose_layer(stride, padding, dilation, size):
    feed = {"x": _f(16, 2, 3, 5, 6)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.conv2d_transpose(
        xs[0], num_filters=4, filter_size=size, stride=stride, padding=padding,
        dilation=dilation, bias_attr=False)], feed)
    assert_close(got, ref, CONV_RTOL)


def test_conv2d_transpose_ignores_groups():
    """The JAX lowering reads no ``groups``: an op carrying groups=2
    computes the ungrouped transpose, in both packages."""
    feed = {"x": _f(17, 2, 4, 5, 5), "w": _f(18, 4, 6, 3, 3)}
    outs = []
    for groups in (1, 2):
        outs.append(run_both(lambda pkg, xs: _op(
            pkg, "conv2d_transpose", {"Input": xs[0], "Filter": xs[1]},
            {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": groups},
            outs=("Output",)), feed))
    for ref, got in outs:
        assert_close(got, ref, CONV_RTOL)
    np.testing.assert_array_equal(outs[0][1][0], outs[1][1][0])


# ---------------------------------------------------------------- math ops

@pytest.mark.parametrize("op_type", ["elementwise_mod", "elementwise_floordiv"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_mod_and_floordiv_take_the_divisors_sign(op_type, dtype):
    """Python's modulus (``jnp.mod``, not ``torch.fmod``) and floored
    division over every sign pair; float gradients too (floordiv's is 0)."""
    rs = np.random.RandomState(19)
    if dtype == "float32":
        x = (rs.randn(4, 6) * 7).astype(np.float32)
        y = (rs.rand(4, 6) * 3 + 0.5).astype(np.float32) * np.where(rs.rand(4, 6) < 0.5, -1, 1)
        x[0, :3] = [6.0, -6.0, 0.0]
        y[0, :3] = [3.0, 3.0, -2.0]
    else:
        x = rs.randint(-20, 20, (4, 6)).astype(np.int32)
        y = rs.randint(1, 6, (4, 6)).astype(np.int32) * np.where(rs.rand(4, 6) < 0.5, -1, 1)
    feed = {"x": x, "y": y.astype(dtype)}
    ref, got = run_both(lambda pkg, xs: _op(pkg, op_type, {"X": xs[0], "Y": xs[1]},
                                            {"axis": -1}, dtype=dtype), feed)
    _exact(got, ref)


def test_mod_broadcasts_y_from_axis():
    feed = {"x": _f(20, 2, 3, 4) * 5, "y": np.array([1.5, -2.0, 3.0], np.float32)}
    ref, got = run_both(lambda pkg, xs: _op(pkg, "elementwise_mod", {"X": xs[0], "Y": xs[1]},
                                            {"axis": 1}), feed)
    _exact(got, ref)


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_isfinite_reduces_to_one_boolean(poison):
    x = _f(21, 3, 4)
    if poison is not None:
        x[1, 2] = poison
    ref, got = run_both(lambda pkg, xs: _op(pkg, "isfinite", {"X": xs[0]}, dtype="bool"),
                        {"x": x}, grad=False)
    assert got[0].shape == () and got[0].dtype == np.bool_
    assert bool(got[0]) == (poison is None)
    _exact(got, ref)


@pytest.mark.parametrize("yrows", [4, 1])
def test_cos_sim(yrows):
    """Out, XNorm and YNorm (Y broadcast from one row), and the gradients
    of both inputs; a zero row of X meets the 1e-12."""
    x = _f(22, 4, 5)
    x[2] = 0.0
    feed = {"x": x, "y": _f(23, yrows, 5)}

    def build(pkg, xs):
        out = pkg.layers.cos_sim(xs[0], xs[1])
        op = [o for o in pkg.default_main_program().desc.block(0).ops if o.type == "cos_sim"][0]
        return [out, op.output("XNorm")[0], op.output("YNorm")[0]]
    ref, got = run_both(build, feed)
    assert got[0].shape == (4, 1) and got[2].shape == (yrows, 1)
    assert_close(got, ref, ATOL)


def test_squared_l2_distance():
    feed = {"x": _f(24, 5, 7), "y": _f(25, 5, 7)}
    ref, got = run_both(lambda pkg, xs: _op(pkg, "squared_l2_distance",
                                            {"X": xs[0], "Y": xs[1]},
                                            outs=("Out", "sub_result")), feed)
    assert got[0].shape == (5, 1)
    assert_close(got, ref, ATOL)


# -------------------------------------------------------------- quantizers

def _range_quant_steps(pkg, maxes, window, bits=8, is_test_after=None):
    """Per step of a ``fake_quantize_range_abs_max`` program: (Out, the
    scale, the window buffer, Iter)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        out, scale = pkg.layers.fake_quantize_range_abs_max(x, bit_length=bits,
                                                            window_size=window)
    op = [o for o in main.desc.block(0).ops if o.type == "fake_quantize_range_abs_max"][0]
    buf, it = op.input("InScales")[0], op.input("Iter")[0]
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(26)
    rows = []
    for m in maxes:
        xv = (rs.rand(2, 4).astype(np.float32) * 2 - 1) * np.float32(m)
        xv[0, 0] = m
        o, s = exe.run(main, feed={"x": xv}, fetch_list=[out, scale], scope=scope)
        rows.append([np.asarray(o), np.asarray(s), np.array(scope.find_var(buf)),
                     np.array(scope.find_var(it))])
    if is_test_after is not None:
        test = main.clone(for_test=True)
        (o,) = exe.run(test, feed={"x": np.full((1, 4), is_test_after, np.float32)},
                       fetch_list=[out], scope=scope)
        rows.append([np.asarray(o)])
    return main, rows


@pytest.mark.parametrize("window,bits", [(4, 8), (3, 4), (16, 8)])
def test_range_quantizer_window_and_counter_match_step_by_step(window, bits):
    """The window written at Iter % window_size, the scale its largest
    entry over the filled slots, Iter counting: bit-equal over nine steps
    (evictions included); then the eval clone (``is_test``) quantizes with
    the trained scale."""
    maxes = [1.0, 3.0, 2.0, 0.5, 0.25, 0.125, 4.0, 0.1, 0.2]
    jm, jrows = _range_quant_steps(fluid, maxes, window, bits, is_test_after=8.0)
    tm, trows = _range_quant_steps(pt, maxes, window, bits, is_test_after=8.0)
    from test_torch_cnn_ops import descs_equal
    descs_equal(jm, tm)
    for step, (a, b) in enumerate(zip(trows, jrows)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, step
            np.testing.assert_array_equal(x, y, err_msg=f"step {step}")
    assert int(trows[len(maxes) - 1][3]) == len(maxes)
    np.testing.assert_array_equal(trows[-1][0], np.full((1, 4), float((1 << (bits - 1)) - 1)))


def test_range_quantizer_without_its_state_raises_in_train_mode():
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        helper = pkg.layer_helper.LayerHelper("fake_quantize_range_abs_max")
        s = pkg.layers.fill_constant([1], "float32", 1.0)
        out = helper.create_variable_for_type_inference("float32")
        sc = helper.create_variable_for_type_inference("float32")
        helper.append_op("fake_quantize_range_abs_max", inputs={"X": x, "InScale": s},
                         outputs={"Out": out, "OutScale": sc}, attrs={"window_size": 4})
        return [out]
    jax_side, port_side = build_both(build)
    _, _, texe, tscope, _ = start_both(jax_side, port_side)
    with pytest.raises(ValueError, match="requires InScales and Iter"):
        texe.run(port_side[0], feed={"x": _f(27, 2, 4)},
                 fetch_list=fetch_names(port_side[2]), scope=tscope)


@pytest.mark.parametrize("quantizer", ["abs_max", "range_abs_max"])
def test_ste_gradient_through_a_quantize_dequantize_pair(quantizer):
    """``fake_quantize_ste_grad``: dX = dOut * bin_cnt / s inside the clip
    range, so the pair's gradient is the identity's (1/N under a mean);
    the range quantizer's clip at its scale zeroes the rest.  Equal
    ProgramDescs (the grad maker's op) and bit-equal gradients."""
    x = np.array([[0.3, -0.7, 0.1, 0.9], [2.5, -0.2, 0.05, -3.0]], np.float32)

    def build(pkg, xs):
        if quantizer == "abs_max":
            q, scale = pkg.layers.fake_quantize_abs_max(xs[0], bit_length=8)
        else:
            q, scale = pkg.layers.fake_quantize_range_abs_max(xs[0], bit_length=8,
                                                              window_size=4)
        deq = pkg.layers.fake_dequantize_max_abs(q, scale, max_range=127.0)
        loss = pkg.layers.mean(deq)
        return [loss] + pkg.calc_gradient(loss, [xs[0]])
    ref, got = run_both(build, {"x": x}, grad=False)
    assert got[1].shape == x.shape
    assert_close(got[:1], ref[:1], ATOL)           # the mean: a reduction's order
    _exact(got[1:], ref[1:])
    if quantizer == "abs_max":
        np.testing.assert_allclose(got[1], np.full(x.shape, 1 / 8), rtol=1e-6)


# ------------------------------------------------------------ update rules

def _update_rule(pkg, op_type, feed, attrs, state=()):
    """One ``op_type`` update over data vars (its outputs named apart from
    its inputs: the port updates a clone)."""
    xs = {n: pkg.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                             append_batch_size=False) for n, a in feed.items()}
    helper = pkg.layer_helper.LayerHelper(op_type)
    ins = {"Param": xs["param"], "Grad": xs["grad"], "LearningRate": xs["lr"]}
    outs = {"ParamOut": helper.create_variable_for_type_inference("float32")}
    for s in state:
        ins[s] = xs[s.lower()]
        outs[s + "Out"] = helper.create_variable_for_type_inference("float32")
    helper.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    return list(outs.values())


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.3, 0.0), (0.1, 0.5), (2.0, 0.2)])
@pytest.mark.parametrize("op_type,state", [("proximal_gd", ()),
                                           ("proximal_adagrad", ("Moment",))])
def test_proximal_rules(op_type, state, l1, l2):
    """The shrink to zero (|p - lr g| under lr * l1) and the L2 division,
    bit-equal to the JAX lowerings."""
    feed = {"param": _f(28, 6, 5), "grad": _f(29, 6, 5),
            "lr": np.array([0.4], np.float32)}
    if state:
        feed["moment"] = np.abs(_f(30, 6, 5))
    ref, got = run_both(lambda pkg, xs: _update_rule(pkg, op_type, feed,
                                                     {"l1": l1, "l2": l2}, state),
                        feed, grad=False)
    assert (got[0] == 0).any() == (l1 > 0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a == 0, b == 0)
    assert_close(got, ref, PROX_RTOL)


_AVG_SLOTS = ("sum_1", "sum_2", "sum_3", "num_accumulates", "old_num_accumulates",
              "num_updates")


def _avg_acc(pkg, feed, attrs):
    xs = {n: pkg.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                             append_batch_size=False) for n, a in feed.items()}
    helper = pkg.layer_helper.LayerHelper("average_accumulates")
    outs = {f"out_{s}": helper.create_variable_for_type_inference(str(feed[s].dtype))
            for s in _AVG_SLOTS}
    helper.append_op("average_accumulates",
                     inputs={"param": xs["param"], **{f"in_{s}": xs[s] for s in _AVG_SLOTS}},
                     outputs=outs, attrs=attrs)
    return list(outs.values())


@pytest.mark.parametrize("counts,attrs,case", [
    ((3, 2, 10), {"average_window": 0.5, "min_average_window": 10,
                  "max_average_window": 100}, "accumulate"),
    ((9, 5, 16383), {"average_window": 0.0, "min_average_window": 100,
                     "max_average_window": 100}, "spill into sum_2"),
    ((5, 4, 20), {"average_window": 0.25, "min_average_window": 2,
                  "max_average_window": 100}, "shift into sum_3"),
    ((7, 0, 30), {"average_window": 1.0, "min_average_window": 0,
                  "max_average_window": 6}, "shift at max_average_window"),
])
def test_average_accumulates(counts, attrs, case):
    """One step from given sums and counters: each of the three branches
    (accumulate, spill every 16384 updates, shift once the window is
    long enough), the sums and int32 counters bit-equal."""
    na, oa, nu = counts
    feed = {"param": _f(31, 3, 4), "sum_1": _f(32, 3, 4) * 5, "sum_2": _f(33, 3, 4) * 50,
            "sum_3": _f(34, 3, 4) * 9, "num_accumulates": np.array([na], np.int32),
            "old_num_accumulates": np.array([oa], np.int32),
            "num_updates": np.array([nu], np.int32)}
    ref, got = run_both(lambda pkg, xs: _avg_acc(pkg, feed, attrs), feed, grad=False)
    _exact(got, ref)
    s1, s2, s3, n_acc, old, n_upd = got
    assert n_upd[0] == nu + 1
    if case.startswith("shift"):
        assert n_acc[0] == 0 and old[0] == na + 1 and not s1.any() and not s2.any()
    elif case.startswith("spill"):
        assert not s1.any() and n_acc[0] == na + 1
    else:
        assert n_acc[0] == na + 1 and old[0] == oa
