"""``ModelAverage`` and quantization-aware training against the JAX
package, on the CPU.

* ``ModelAverage`` after ``minimize`` (SGD and Adam): equal ProgramDescs
  (one ``average_accumulates`` a parameter, its six accumulators in the
  startup program); both packages run the same steps from the same
  parameters, and every accumulator (three sums, three int32 counters)
  and the averages ``apply()`` puts in place are held against the JAX
  package's: the counters bit-equal, the sums and averages within
  ``SUM_RTOL`` (the parameters they sum are the optimizer's, within its
  bound);
* the JAX package's own cases on the port: with rate 1 and no minimum
  window the average is the mean of the parameters after each step;
  ``apply()`` copies into the scope's tensors (no tensor rebound) and the
  exit copies the live values back bit-equal; an evaluation inside it
  sees the averaged weights;
* a QAT step (``fake_quantize_range_abs_max`` on an ``fc`` output,
  dequantized, SGD, gradients through the straight-through estimator)
  against the JAX package step by step: ``Iter`` bit-equal, the loss and
  the scale window bit-equal at the first step and within ``QAT_RTOL``
  after it, the parameters' changes within ``QAT_CHANGE_NREL``;
  and the JAX package's QAT convergence case on the port.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from test_torch_cnn_ops import build_both, start_both

from _torch_validate import _no_port_validate_findings  # noqa: F401

# float32 sums of float32 parameters: the parameters after each SGD step
# agree bit for bit or to an ulp (XLA fuses p - lr * g into one rounding),
# and Adam's to its bound; the sums carry that
SUM_RTOL = 1e-6
ADAM_SUM_RTOL = 1e-5
STEPS = 8
# the QAT program's parameters, each one's change since the start
# norm-relative to the JAX package's (reading: 4.3e-6 at most, a bias of
# size 1 one ulp off after a step)
QAT_CHANGE_NREL = 1e-4
# after the first step the parameters may be an ulp apart, and so the loss
# and the abs-max the window records (the first step's are bit-equal)
QAT_RTOL = 1e-6


def _regression(pkg, make_opt, window=(1.0, 0, 10000)):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    h = pkg.layers.fc(input=x, size=3, act="relu")
    pred = pkg.layers.fc(input=h, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
    make_opt(pkg).minimize(loss)
    ma = pkg.optimizer.ModelAverage(window[0], min_average_window=window[1],
                                    max_average_window=window[2])
    return loss, pred, ma


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xs = rs.rand(8, 4).astype(np.float32)
        out.append({"x": xs, "y": xs.sum(1, keepdims=True).astype(np.float32)})
    return out


def _sgd(pkg):
    return pkg.optimizer.SGD(learning_rate=0.1)


def _adam(pkg):
    return pkg.optimizer.Adam(learning_rate=0.05)


def _acc_names(ma):
    return {k: [v.name for v in d.values()] for k, d in ma._accumulators.items()}


def _run_both_averaged(make_opt, window):
    """Both packages' STEPS steps, then ``apply()``: per package, the
    accumulators after the steps, the parameters inside ``apply()`` and
    after it, and the parameters before it."""
    jax_side, port_side = build_both(lambda pkg: _regression(pkg, make_opt, window))
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    out = {}
    for pkg, (main, _, (loss, _, ma)), exe, scope in (
            (fluid, jax_side, jexe, jscope), (pt, port_side, texe, tscope)):
        with pkg.scope_guard(scope):
            for feed in _feeds(STEPS):
                exe.run(main, feed=feed, fetch_list=[loss])
            accs = {n: np.array(scope.find_var(n)) for ns in _acc_names(ma).values() for n in ns}
            live = {p.name: np.array(scope.find_var(p.name)) for p in ma.params}
            with ma.apply(exe):
                applied = {p.name: np.array(scope.find_var(p.name)) for p in ma.params}
            after = {p.name: np.array(scope.find_var(p.name)) for p in ma.params}
        out[pkg.__name__] = dict(accs=accs, live=live, applied=applied, after=after,
                                 counters=_acc_names(ma))
    return out["paddle_tpu"], out["paddle_tpu_torch"], port_side


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got.astype(np.float64) - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("opt,window,rtol", [
    (_sgd, (1.0, 0, 10000), SUM_RTOL),     # the window shifts every step
    (_sgd, (0.5, 2, 3), SUM_RTOL),         # shifts at 2, then whenever 3 are summed
    (_sgd, (0.25, 10, 100), SUM_RTOL),     # never shifts within the steps
    (_adam, (0.5, 2, 4), ADAM_SUM_RTOL),
])
def test_accumulators_and_averages_match_the_jax_package(opt, window, rtol):
    ref, got, port_side = _run_both_averaged(opt, window)
    ops = [o.type for o in port_side[0].desc.block(0).ops]
    assert ops.count("average_accumulates") == 4 and ops[-4:] == ["average_accumulates"] * 4
    for kind, names in got["counters"].items():
        for n in names:
            a, b = got["accs"][n], ref["accs"][n]
            assert a.dtype == b.dtype, (n, a.dtype, b.dtype)
            if kind.startswith("sum_"):
                _close(a, b, rtol)
            else:
                np.testing.assert_array_equal(a, b, err_msg=n)
    for n in got["applied"]:
        _close(got["applied"][n], ref["applied"][n], rtol)
        np.testing.assert_array_equal(got["after"][n], got["live"][n])


def test_apply_puts_the_mean_of_the_parameters_after_each_step():
    """The JAX package's case: rate 1, no minimum window: the window shifts
    every step, so the average is the mean of the parameter after each
    update; ``apply()`` writes into the scope's own tensor and the exit
    copies the live value back bit-equal."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        pred = pt.layers.fc(input=x, size=1, bias_attr=False)
        loss = pt.layers.mean(pt.layers.square_error_cost(input=pred, label=y))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ma = pt.optimizer.ModelAverage(average_window_rate=1.0, min_average_window=0,
                                       max_average_window=10000)
    (param,) = ma.params
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        snapshots = []
        for feed in _feeds(6, seed=0):
            exe.run(main, feed=feed, fetch_list=[loss])
            snapshots.append(scope.find_var(param.name).numpy().copy())
        t = scope.find_var(param.name)
        ptr, live = t.data_ptr(), t.numpy().copy()
        with ma.apply(exe):
            applied = scope.find_var(param.name).numpy().copy()
            assert scope.find_var(param.name) is t and t.data_ptr() == ptr
        ma.restore(exe)
    np.testing.assert_allclose(applied, np.mean(np.asarray(snapshots, np.float64), axis=0),
                               rtol=1e-6)
    assert not np.allclose(applied, live)
    np.testing.assert_array_equal(t.numpy(), live)


def test_an_evaluation_inside_apply_sees_the_averaged_weights():
    """The JAX package's case: inference inside ``apply()`` computes with
    the averaged weights; after it, with the live ones again."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3], dtype="float32")
        pred = pt.layers.fc(input=x, size=1, bias_attr=False)
        loss = pt.layers.mean(pred)
        pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
        ma = pt.optimizer.ModelAverage(1.0, min_average_window=0)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 3), np.float32)}
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(4):
            exe.run(main, feed=feed, fetch_list=[loss])
        test_prog = main.clone(for_test=True)._prune([pred.name])
        (live_out,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
        with ma.apply(exe):
            (avg_out,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
        (back,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
    assert not np.allclose(avg_out, live_out)
    np.testing.assert_array_equal(back, live_out)


def test_apply_without_restore_keeps_the_average():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, _, ma = _regression(pt, _sgd)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        for feed in _feeds(3):
            exe.run(main, feed=feed, fetch_list=[loss])
        with ma.apply(exe, need_restore=False):
            inside = {p.name: scope.find_var(p.name).numpy().copy() for p in ma.params}
        for p in ma.params:
            np.testing.assert_array_equal(scope.find_var(p.name).numpy(), inside[p.name])


# ------------------------------------------------------------------- QAT

def _qat(pkg, window=3):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    h = pkg.layers.fc(input=x, size=4)
    q, s = pkg.layers.fake_quantize_range_abs_max(h, bit_length=8, window_size=window)
    deq = pkg.layers.fake_dequantize_max_abs(q, s, max_range=127.0)
    pred = pkg.layers.fc(input=deq, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def test_a_qat_step_advances_the_scale_window_and_iter_as_the_jax_package():
    """Six steps of the QAT program from the same parameters: ``Iter``
    bit-equal step by step, the loss, the window buffer and the scale
    bit-equal at the first step and within QAT_RTOL after it; the fc
    parameters' changes within QAT_CHANGE_NREL (the SGD update rounds as in
    the JAX package or an ulp off)."""
    jax_side, port_side = build_both(_qat)
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    (op,) = [o for o in port_side[0].desc.block(0).ops
             if o.type == "fake_quantize_range_abs_max"]
    watch = [op.input("InScale")[0], op.input("InScales")[0], op.input("Iter")[0]]
    assert [o.type for o in port_side[0].desc.block(0).ops].count(
        "fake_quantize_ste_grad") == 1
    params = [p.name for p in port_side[0].global_block.all_parameters() if p.trainable]
    rs = np.random.RandomState(3)
    w_true = rs.randn(8, 1).astype(np.float32)
    for step in range(6):
        xs = rs.randn(16, 8).astype(np.float32) * (1 + step % 3)
        feed = {"x": xs, "y": xs @ w_true}
        (jl,) = jexe.run(jax_side[0], feed=feed, fetch_list=[jax_side[2].name], scope=jscope)
        (tl,) = texe.run(port_side[0], feed=feed, fetch_list=[port_side[2]], scope=tscope)
        rtol = 0.0 if step == 0 else QAT_RTOL
        np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=rtol, atol=0)
        for n in watch:
            np.testing.assert_allclose(tscope.find_var(n).numpy(), np.array(jscope.find_var(n)),
                                       rtol=rtol, atol=0, err_msg=f"{n} {step}")
        for n in params:
            want = np.array(jscope.find_var(n)).astype(np.float64) - state[n]
            got = tscope.find_var(n).numpy().astype(np.float64) - state[n]
            assert np.linalg.norm(got - want) <= QAT_CHANGE_NREL * np.linalg.norm(want), \
                (n, step, np.linalg.norm(got - want) / np.linalg.norm(want))
    assert int(tscope.find_var(watch[2]).numpy()) == 6


def test_qat_training_converges_on_the_port():
    """The JAX package's QAT case (fake_quantize_abs_max on an fc output,
    80 SGD steps) on the port, and the same with the range quantizer."""
    for quantizer in ("abs_max", "range_abs_max"):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[8], dtype="float32")
            y = pt.layers.data(name="y", shape=[1], dtype="float32")
            h = pt.layers.fc(input=x, size=1)
            if quantizer == "abs_max":
                q, s = pt.layers.fake_quantize_abs_max(h, bit_length=8)
            else:
                q, s = pt.layers.fake_quantize_range_abs_max(h, bit_length=8, window_size=16)
            pred = pt.layers.fake_dequantize_max_abs(q, s, max_range=127.0)
            loss = pt.layers.mean(pt.layers.square_error_cost(input=pred, label=y))
            pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        rs = np.random.RandomState(0)
        w_true = rs.randn(8, 1).astype(np.float32)
        losses = []
        for _ in range(80):
            xs = rs.randn(64, 8).astype(np.float32)
            losses.append(float(np.asarray(exe.run(main, feed={"x": xs, "y": xs @ w_true},
                                                   fetch_list=[loss], scope=scope)[0])))
        assert losses[-1] < 0.05 * losses[0], (quantizer, losses[0], losses[-1])
