"""fit_a_line (the book's linear regression) and the synthetic
``uci_housing`` reader against the JAX package, on the CPU.

* ``uci_housing``: the port's synthetic arrays and readers equal the JAX
  package's ``_synthetic`` (the JAX readers are not called: they try the
  network first);
* the fit_a_line program (``fc`` of 13 features to 1, ``square_error_cost``,
  ``mean``, ``SGD(0.05)``): equal ProgramDescs; 30 steps over the reader's
  batches of 32 from the JAX startup's parameters: each step's loss within
  ``LOSS_RTOL`` of the JAX package's and the parameters after the run
  within ``PARAM_RTOL``; the loss falls from ~25 to under 0.1;
* the JAX package's own cases (tests/test_fit_a_line.py) on the port.
"""
import numpy as np

import paddle_tpu.dataset.uci_housing as jax_uci
import paddle_tpu_torch as pt
from paddle_tpu_torch.dataset import uci_housing
from test_torch_cnn_ops import build_both, start_both

from _torch_validate import _no_port_validate_findings  # noqa: F401

# The update rounds as XLA's fused p - lr * g (the port's plain K5); the
# mean and the gradient's sums reduce in another order, so the loss moves by
# ulps.  Readings on the CPU (x86-64): the loss 6.4e-7 relative at worst,
# the weights 7.8e-8 of the largest, the bias bit-equal
LOSS_RTOL = 2e-6
PARAM_RTOL = 1e-6
BATCH, STEPS, LR = 32, 30, 0.05


def test_uci_housing_synthetic_arrays_and_readers_equal_the_jax_packages():
    for n, seed, reader in ((404, 0, uci_housing.train()), (102, 1, uci_housing.test())):
        x, y = uci_housing._synthetic(n, seed)
        jx, jy = jax_uci._synthetic(n, seed)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == y.dtype == np.float32 and y.shape == (n, 1)
        rows = list(reader())
        assert len(rows) == n
        np.testing.assert_array_equal(np.stack([r[0] for r in rows]), jx)
        np.testing.assert_array_equal(np.stack([r[1] for r in rows]), jy)
    assert uci_housing.FEATURE_NUM == jax_uci.FEATURE_NUM == 13


def fit_a_line(pkg):
    """The book's program (tests/test_fit_a_line.py)."""
    x = pkg.layers.data(name="x", shape=[13], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    y_predict = pkg.layers.fc(input=x, size=1)
    avg_cost = pkg.layers.mean(pkg.layers.square_error_cost(input=y_predict, label=y))
    pkg.optimizer.SGD(learning_rate=LR).minimize(avg_cost)
    return avg_cost, y_predict


def batches(n_steps, batch=BATCH):
    """Batches of the synthetic train reader, cycled."""
    reader = pt.reader.batch(uci_housing.train(), batch, drop_last=True)
    out = []
    while len(out) < n_steps:
        for rows in reader():
            out.append({"x": np.stack([r[0] for r in rows]),
                        "y": np.stack([r[1] for r in rows])})
            if len(out) == n_steps:
                break
    return out


def test_fit_a_line_matches_the_jax_package_step_by_step():
    jax_side, port_side = build_both(fit_a_line)
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    jloss, tloss = jax_side[2][0], port_side[2][0]
    assert [o.type for o in port_side[0].desc.block(0).ops] == [
        "mul", "elementwise_add", "square_error_cost", "mean", "fill_constant", "mean_grad",
        "square_error_cost_grad", "elementwise_add_grad", "mul_grad", "sgd", "sgd"]
    losses = []
    for feed in batches(STEPS):
        (jl,) = jexe.run(jax_side[0], feed=feed, fetch_list=[jloss.name], scope=jscope)
        (tl,) = texe.run(port_side[0], feed=feed, fetch_list=[tloss], scope=tscope)
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), (len(losses), tl, jl)
        losses.append(float(tl))
    for n in state:
        want = np.array(jscope.find_var(n))
        np.testing.assert_allclose(tscope.find_var(n).numpy(), want, rtol=0,
                                   atol=PARAM_RTOL * float(np.abs(want).max()), err_msg=n)
    assert 15.0 < losses[0] < 40.0 and losses[-1] < 0.1, (losses[0], losses[-1])


def test_fit_a_line_trains_on_the_port():
    """The JAX package's case: 60 steps of fresh synthetic data, the loss
    falls under 1.0."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        avg_cost, _ = fit_a_line(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    true_w = rs.randn(13, 1).astype(np.float32)
    losses = []
    for _ in range(60):
        xs = rs.randn(32, 13).astype(np.float32)
        ys = xs @ true_w + 0.5 + 0.01 * rs.randn(32, 1).astype(np.float32)
        losses.append(float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                               fetch_list=[avg_cost], scope=scope)[0])))
    assert losses[0] > losses[-1] and losses[-1] < 1.0, (losses[:3], losses[-3:])


def test_fetch_prediction_shape():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y_predict = pt.layers.fc(input=x, size=1)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    (pred,) = exe.run(main, feed={"x": np.zeros((4, 13), np.float32)}, fetch_list=[y_predict],
                      scope=scope)
    assert pred.shape == (4, 1)


def test_the_jax_package_reads_the_same_program():
    """The port's fit_a_line desc, serialized, parses in the JAX package to
    the program the JAX package builds."""
    from paddle_tpu.core.desc import ProgramDesc as JaxProgramDesc
    (jm, _, _), (tm, _, _) = build_both(fit_a_line)
    parsed = JaxProgramDesc.from_dict(tm.desc.to_dict())
    assert [o.type for o in parsed.block(0).ops] == [o.type for o in jm.desc.block(0).ops]
