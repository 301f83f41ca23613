"""Control flow of the port (``ops/control_flow_ops.py``,
``layers/control_flow.py``) against the JAX package on the CPU.

Each case builds the same program in both packages under
``unique_name.guard()`` (every block's ProgramDesc equal), carries the JAX
startup's state into the port (``params_from_numpy``), runs both on the
same seeded feeds and compares the fetches: integers, booleans, copies and
selections bit-equal; float values and gradients within 1e-5 of the
reference's largest magnitude (``test_torch_sequence.assert_close``;
float32, XLA and torch sum in other orders).  The cases follow ``tests/test_control_flow.py`` and
``tests/test_control_flow_grad.py``:

* ``while`` without ``max_iters`` (read on the host each trip), with a
  bound above the trip count, and with one below it (truncated: 4 trips of
  10); a carry only written; the condition never written; the grad against
  the closed form and a finite difference; a parameter feeding a carry's
  value before the loop; a closure var reassigned after the loop; dropout
  in the body (the grad re-runs the forward's masks); a
  ``conditional_block`` nested in the body; the no-``max_iters`` error;
* a dead trip whose body computes inf: both packages' gradients finite and
  equal, and without the port's guard the port's are NaN;
* ``conditional_block`` on both branches, with a parameter inside;
* ``recurrent`` (StaticRNN), its outputs and every gradient, and a
  closure read that the op does not declare kept alive until it runs;
* ``Switch`` through ``piecewise_decay``: the rate over 6 runs, and SGD
  driven by it;
* the tensor arrays under both names of each op type, ``is_empty`` and
  ``where``; an array fetched (the port stacks it);
* which programs may be one CUDA graph (``graph_blockers``) and the state
  analysis through sub-blocks.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
from paddle_tpu_torch.core.lower import plan_frees
from paddle_tpu_torch.ops import control_flow_ops

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_cnn_ops import build_both, fetch_names, start_both
from test_torch_sequence import assert_close  # RTOL 1e-5, float32, of the largest value


def run_programs(build, feeds=({},), state=None):
    """``build(pkg)`` returns the vars (or names) to fetch; each feed of
    ``feeds`` is one run of both programs, in order.  ``state``: scope
    values set in both after the startup.  Returns (JAX fetches, port
    fetches, port program) for every run, shapes held equal (a bf16
    fetch comes back float32 from the port)."""
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    for n, v in (state or {}).items():
        jscope.set_var(n, v)
        pt.params_from_numpy({n: v}, tscope, "cpu")
    names = fetch_names(jax_side[2])
    assert names == fetch_names(port_side[2])
    ref, got = [], []
    for feed in feeds:
        ref.append([np.asarray(a) for a in jexe.run(jax_side[0], feed=feed, fetch_list=names,
                                                    scope=jscope)])
        got.append([np.asarray(a) for a in texe.run(port_side[0], feed=feed, fetch_list=names,
                                                    scope=tscope)])
        assert [a.shape for a in got[-1]] == [b.shape for b in ref[-1]]
        assert all(a.dtype == b.dtype or b.dtype.name == "bfloat16"
                   for a, b in zip(got[-1], ref[-1]))
    return ref, got, port_side[0]


def _counter_loop(pkg, max_iters, limit=10):
    layers = pkg.layers
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    lim = layers.fill_constant(shape=[1], dtype="int32", value=limit)
    total = layers.fill_constant(shape=[1], dtype="int32", value=0)
    last = layers.fill_constant(shape=[1], dtype="int32", value=-1)
    cond = layers.less_than(i, lim)
    w = layers.While(cond, max_iters=max_iters)
    with w.block():
        layers.assign(layers.elementwise_add(total, i), output=total)
        layers.increment(i, value=1, in_place=True)
        layers.assign(i, output=last)          # written, never read in the body
        layers.less_than(i, lim, cond=cond)
    return [total, last, i, cond]


@pytest.mark.parametrize("max_iters,want", [(None, (45, 10)), (16, (45, 10)), (4, (6, 4))])
def test_while_counter_matches_jax(max_iters, want):
    """Unbounded, bounded above the trip count, and truncated at 4 trips
    (the JAX package's masked scan cuts it the same way)."""
    ref, got, prog = run_programs(lambda pkg: _counter_loop(pkg, max_iters))
    assert_close(got[0], ref[0])
    assert (int(got[0][0][0]), int(got[0][1][0])) == want
    assert prog.desc.num_blocks() == 2


def test_while_requires_condition_update():
    def build(pkg):
        layers = pkg.layers
        i = layers.fill_constant(shape=[1], dtype="int32", value=0)
        cond = layers.less_than(i, layers.fill_constant(shape=[1], dtype="int32", value=10))
        with layers.While(cond).block():
            layers.increment(i, value=1, in_place=True)
        return [i]
    jax_side, port_side = build_both(build)
    for pkg, (main, startup, fetch) in ((fluid, jax_side), (pt, port_side)):
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(Exception, match="Condition"):
            exe.run(main, fetch_list=fetch, scope=scope)


def _quadratic(pkg, max_iters):
    """s = four trips of s + (w x)^2; returns loss, w."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[1], append_batch_size=False, stop_gradient=False)
    w = layers.create_parameter(shape=[1], dtype="float32")
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    limit = layers.fill_constant(shape=[1], dtype="int32", value=4)
    s = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    s.stop_gradient = False
    cond = layers.less_than(i, limit)
    with layers.While(cond, max_iters=max_iters).block():
        wx = layers.elementwise_mul(w, x)
        layers.assign(layers.elementwise_add(s, layers.elementwise_mul(wx, wx)), output=s)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, limit, cond=cond)
    return layers.mean(s), w


def _quadratic_grads(pkg, max_iters=8):
    loss, w = _quadratic(pkg, max_iters)
    pairs = pkg.backward.append_backward(loss)
    assert [p.name for p, _ in pairs] == [w.name]
    return [loss, w, w.name + "@GRAD", "x@GRAD"]


def test_while_grad_matches_jax_and_the_closed_form():
    """loss = 4 (w x)^2: dL/dw = 8 w x^2, dL/dx = 8 w^2 x."""
    xv = np.array([1.7], np.float32)
    ref, got, prog = run_programs(_quadratic_grads, [{"x": xv}])
    assert_close(got[0], ref[0])
    lv, wv, gw, gx = got[0]
    np.testing.assert_allclose(lv, 4 * (wv * xv) ** 2, rtol=1e-5)
    np.testing.assert_allclose(gw, 8 * wv * xv * xv, rtol=1e-5)
    np.testing.assert_allclose(gx, 8 * wv * wv * xv, rtol=1e-5)
    assert [o.type for o in prog.desc.block(0).ops].count("while_grad") == 1


def test_while_grad_finite_difference():
    eps = 1e-2
    feeds = [{"x": np.array([v], np.float32)} for v in (0.9, 0.9 + eps, 0.9 - eps)]
    ref, got, _ = run_programs(_quadratic_grads, feeds)
    for r, g in zip(ref, got):
        assert_close(g, r)
    num = (float(got[1][0]) - float(got[2][0])) / (2 * eps)
    np.testing.assert_allclose(float(got[0][3][0]), num, rtol=1e-3)


def test_while_without_max_iters_raises():
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            loss, _ = _quadratic(pkg, None)
            with pytest.raises(ValueError, match="max_iters"):
                pkg.backward.append_backward(loss)


def test_append_backward_raises_on_a_parameter_behind_the_arrays():
    """A parameter whose only path to the loss runs through the array ops
    (no gradient) raises instead of never training."""
    for pkg in (fluid, pt):
        layers = pkg.layers
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            w = layers.create_parameter(shape=[2], dtype="float32")
            zero = layers.fill_constant(shape=[1], dtype="int32", value=0)
            loss = layers.mean(layers.array_read(layers.array_write(w, zero), zero))
            with pytest.raises(ValueError, match="no gradient"):
                pkg.backward.append_backward(loss)


def test_stop_gradient_accumulator_raises():
    for pkg in (fluid, pt):
        layers = pkg.layers
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = layers.data(name="x", shape=[1], append_batch_size=False, stop_gradient=False)
            w = layers.create_parameter(shape=[1], dtype="float32")
            i = layers.fill_constant(shape=[1], dtype="int32", value=0)
            limit = layers.fill_constant(shape=[1], dtype="int32", value=4)
            s = layers.fill_constant(shape=[1], dtype="float32", value=0.0)  # stop_gradient
            cond = layers.less_than(i, limit)
            with layers.While(cond, max_iters=8).block():
                layers.assign(layers.elementwise_add(s, layers.elementwise_mul(w, x)), output=s)
                layers.increment(i, value=1, in_place=True)
                layers.less_than(i, limit, cond=cond)
            with pytest.raises(ValueError, match="stop_gradient"):
                pkg.backward.append_backward(layers.mean(s))


def _carry_loop(pkg, body, limit=3, max_iters=4, x_grad=False, s_shape=(1,)):
    """A bounded loop of ``limit`` trips whose body is ``body(pkg, s, i)``
    (writing the float carry ``s``); returns the loss mean(s), w and x."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[1], append_batch_size=False, stop_gradient=not x_grad)
    w = layers.create_parameter(shape=[1], dtype="float32")
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    lim = layers.fill_constant(shape=[1], dtype="int32", value=limit)
    s = layers.fill_constant(shape=list(s_shape), dtype="float32", value=0.0)
    s.stop_gradient = False
    cond = layers.less_than(i, lim)
    pre = body(pkg, None, None, w, x)
    with layers.While(cond, max_iters=max_iters).block():
        body(pkg, s, i, w, x, pre)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, lim, cond=cond)
    return layers.mean(s), w, x


def test_grad_flows_to_the_producer_of_a_carry_before_the_loop():
    """h = w x feeds every trip: loss = 3 w x, dL/dw = 3 x."""
    def body(pkg, s, i, w, x, pre=None):
        if s is None:
            return pkg.layers.elementwise_mul(w, x)
        pkg.layers.assign(pkg.layers.elementwise_add(s, pre), output=s)

    def build(pkg):
        loss, w, _ = _carry_loop(pkg, body)
        pairs = pkg.backward.append_backward(loss)
        assert [p.name for p, _ in pairs] == [w.name]
        return [loss, w.name + "@GRAD"]
    xv = np.array([2.0], np.float32)
    ref, got, _ = run_programs(build, [{"x": xv}])
    assert_close(got[0], ref[0])
    np.testing.assert_allclose(got[0][1], 3 * xv, rtol=1e-6)


def test_grad_through_a_conditional_block_nested_in_the_loop():
    """The branch is taken on every trip: loss = 3 w x, dL/dw = 3 x."""
    def body(pkg, s, i, w, x, pre=None):
        layers = pkg.layers
        if s is None:
            return None
        always = layers.less_than(i, layers.fill_constant(shape=[1], dtype="int32", value=10))
        with layers.ConditionalBlock([always]).block():
            layers.assign(layers.elementwise_add(s, layers.elementwise_mul(w, x)), output=s)

    def build(pkg):
        loss, w, _ = _carry_loop(pkg, body)
        pkg.backward.append_backward(loss)
        return [loss, w.name + "@GRAD", w]
    xv = np.array([2.5], np.float32)
    ref, got, prog = run_programs(build, [{"x": xv}])
    assert_close(got[0], ref[0])
    lv, gw, wv = got[0]
    np.testing.assert_allclose(lv, 3 * wv * xv, rtol=1e-5)
    np.testing.assert_allclose(gw, 3 * xv, rtol=1e-6)
    assert prog.desc.num_blocks() == 3


@pytest.mark.allow_validate_findings  # the parameter written mid-program is the case (D206)
def test_grad_after_a_closure_var_is_reassigned():
    """w written after the loop: the grad re-runs the loop at the value it
    read (loss = 3 w0^2 x = 12, dL/dw = 6 w0 x = 12)."""
    def body(pkg, s, i, w, x, pre=None):
        layers = pkg.layers
        if s is None:
            return None
        ww = layers.elementwise_mul(w, w)
        layers.assign(layers.elementwise_add(s, layers.elementwise_mul(ww, x)), output=s)

    def build(pkg):
        loss, w, _ = _carry_loop(pkg, body)
        pkg.layers.assign(pkg.layers.scale(w, scale=10.0), output=w)
        pkg.backward.append_backward(loss)
        return [loss, w.name + "@GRAD"]
    jax_side, _ = build_both(build)
    wname = jax_side[0].global_block.all_parameters()[0].name
    ref, got, _ = run_programs(build, [{"x": np.array([1.0], np.float32)}],
                           state={wname: np.array([2.0], np.float32)})
    assert_close(got[0], ref[0])
    np.testing.assert_allclose([float(got[0][0]), float(got[0][1][0])], [12.0, 12.0], rtol=1e-6)


def test_while_grad_reruns_the_forwards_dropout_masks():
    """s = (sum of 3 trips' masks) w x, so dL/dw w = mean(s) / 4 over the
    rows only when the grad's re-run drew the forward's masks.  The two
    packages' generators differ, so this holds each by the property (the
    JAX package's own test) and the masks by their distribution."""
    rows = 64

    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[rows, 4], append_batch_size=False)
        w = layers.create_parameter(shape=[4], dtype="float32")
        i = layers.fill_constant(shape=[1], dtype="int32", value=0)
        lim = layers.fill_constant(shape=[1], dtype="int32", value=3)
        s = layers.fill_constant(shape=[rows, 4], dtype="float32", value=0.0)
        s.stop_gradient = False
        cond = layers.less_than(i, lim)
        with layers.While(cond, max_iters=4).block():
            dropped = layers.dropout(layers.elementwise_mul(x, w, axis=1), dropout_prob=0.5)
            layers.assign(layers.elementwise_add(s, dropped), output=s)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(i, lim, cond=cond)
        loss = layers.mean(s)
        pkg.backward.append_backward(loss)
        return [loss, w.name + "@GRAD", s, w]
    xv = np.random.RandomState(0).rand(rows, 4).astype(np.float32) + 1.0
    ref, got, prog = run_programs(build, [{"x": xv}])
    for lv, gw, sv, wv in (ref[0], got[0]):
        assert np.isfinite(lv).all() and np.isfinite(gw).all() and np.any(gw != 0)
        np.testing.assert_allclose(gw * wv, sv.mean(axis=0) / 4, rtol=1e-5, atol=1e-6)
    # each element kept 0-3 times of 3 trips at p = 0.5: mean 1.5 kept
    kept = got[0][2] / (xv * got[0][3])
    np.testing.assert_allclose(kept, np.round(kept), atol=1e-4)
    assert abs(kept.mean() - 1.5) < 0.15 and set(np.unique(np.round(kept))) <= {0, 1, 2, 3}
    st_in, st_out = analyze_state(prog.desc.block(0), ["x"])
    assert graph_blockers(prog, st_in, st_out) == \
        ["forks the generator in a generic grad (while_grad)"]


def _dead_trip(pkg):
    """Two live trips of s += w log(y), y -= 1 from y = x = 2: the two dead
    trips of max_iters=4 compute log(0) = -inf, whose local derivative is
    inf."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[1], append_batch_size=False, stop_gradient=False)
    w = layers.create_parameter(shape=[1], dtype="float32")
    i = layers.fill_constant(shape=[1], dtype="int32", value=0)
    lim = layers.fill_constant(shape=[1], dtype="int32", value=2)
    s = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    s.stop_gradient = False
    y = layers.assign(x)
    cond = layers.less_than(i, lim)
    with layers.While(cond, max_iters=4).block():
        layers.assign(layers.elementwise_add(s, layers.elementwise_mul(w, layers.log(y))),
                      output=s)
        layers.assign(layers.scale(y, bias=-1.0), output=y)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, lim, cond=cond)
    loss = layers.mean(s)
    pkg.backward.append_backward(loss)
    return [loss, w.name + "@GRAD", "x@GRAD", w]


def test_a_dead_trip_computing_inf_leaves_the_gradient_finite(monkeypatch):
    """loss = w (log 2 + log 1): dL/dw = log 2, dL/dx = w (1/2 + 1).  The
    JAX package's lax.cond never runs the dead trips; the port runs them
    masked, and its guard keeps their backward out.  Without the guard the
    port's gradients are NaN (the control)."""
    feed = {"x": np.array([2.0], np.float32)}
    ref, got, _ = run_programs(_dead_trip, [feed])
    assert_close(got[0], ref[0])
    lv, gw, gx, wv = got[0]
    np.testing.assert_allclose(gw, [np.log(2.0)], rtol=1e-6)
    np.testing.assert_allclose(gx, wv * 1.5, rtol=1e-6)
    monkeypatch.setattr(control_flow_ops, "_guard", lambda pred, v: v)
    _, unguarded, _ = run_programs(_dead_trip, [feed])
    assert np.isnan(unguarded[0][1]).all() and np.isnan(unguarded[0][2]).all()


def _cond_program(pkg, param):
    layers = pkg.layers
    x = layers.data(name="x", shape=[1], append_batch_size=False, stop_gradient=param)
    flag = layers.data(name="flag", shape=[1], dtype="int32", append_batch_size=False)
    cond = layers.greater_than(flag, layers.fill_constant(shape=[1], dtype="int32", value=0))
    out = layers.assign(x)
    out.stop_gradient = False
    w = layers.create_parameter(shape=[1], dtype="float32") if param else None
    with layers.ConditionalBlock([cond]).block():
        taken = layers.elementwise_mul(w, x) if param else layers.scale(x, scale=3.0)
        layers.assign(taken, output=out)
    loss = layers.mean(out)
    pkg.backward.append_backward(loss)
    return [loss, (w.name if param else "x") + "@GRAD"]


@pytest.mark.parametrize("param", [False, True])
@pytest.mark.parametrize("taken", [True, False])
def test_conditional_block_grads_on_both_branches(taken, param):
    """Taken: out = 3 x (dx = 3), or w x (dw = x).  Not taken: out = x
    passes through (dx = 1; dw = 0)."""
    xv = np.array([2.5], np.float32)
    feed = {"x": xv, "flag": np.array([int(taken)], np.int32)}
    ref, got, prog = run_programs(lambda pkg: _cond_program(pkg, param), [feed])
    assert_close(got[0], ref[0])
    want = (xv if taken else [0.0]) if param else ([3.0] if taken else [1.0])
    np.testing.assert_allclose(got[0][1], want, rtol=1e-6)
    assert "conditional_block_grad" in [o.type for o in prog.desc.block(0).ops]


def _static_rnn(pkg, closure):
    """A tanh cell over [T, B, D] with an fc of the step and the memory;
    with ``closure`` the body also adds a var of the enclosing block that
    the op does not declare (StaticRNN declares only parameters)."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[5, 2, 3], append_batch_size=False, stop_gradient=False)
    h0 = layers.data(name="h0", shape=[2, 4], append_batch_size=False, stop_gradient=False)
    shift = layers.scale(layers.data(name="c", shape=[2, 4], append_batch_size=False),
                         scale=0.5)
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        prev = rnn.memory(init=h0)
        h = layers.fc(input=layers.concat([xt, prev], axis=1), size=4, act="tanh")
        if closure:
            h = layers.elementwise_add(h, shift)
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    outs = rnn()
    target = layers.reduce_sum(layers.square(outs))
    params = pkg.default_main_program().global_block.all_parameters()
    grads = pkg.calc_gradient(target, [x, h0] + params)
    return [outs] + grads


@pytest.mark.parametrize("closure", [False, True])
def test_static_rnn_matches_jax(closure):
    """Outputs and the gradients of sum(outs^2) with respect to the
    inputs, the initial memory and both fc parameters.  The closure read
    is planned live until the recurrent op (``plan_frees`` folds the
    sub-block's reads into it)."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(5, 2, 3).astype(np.float32),
            "h0": rng.randn(2, 4).astype(np.float32), "c": rng.randn(2, 4).astype(np.float32)}
    ref, got, prog = run_programs(lambda pkg: _static_rnn(pkg, closure), [feed])
    assert_close(got[0], ref[0])
    assert len(got[0]) == 5 and all(np.isfinite(a).all() for a in got[0])
    block = prog.desc.block(0)
    frees = plan_frees(block, set())
    rec = [i for i, o in enumerate(block.ops) if o.type == "recurrent"][0]
    shift = block.ops[rec - 1].output("Out")[0] if closure else None
    freed_at = {n: i for i, names in enumerate(frees) for n in names}
    if closure:
        assert shift not in block.ops[rec].input_names()
        assert freed_at[shift] >= rec


def test_static_rnn_cumsum():
    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[4, 3], dtype="float32", append_batch_size=False)
        h0 = layers.fill_constant(shape=[3], dtype="float32", value=0.0)
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(init=h0)
            h = layers.elementwise_add(xt, prev)
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        return [rnn()]
    xv = np.arange(12).reshape(4, 3).astype(np.float32)
    ref, got, _ = run_programs(build, [{"x": xv}])
    np.testing.assert_array_equal(got[0][0], ref[0][0])
    np.testing.assert_array_equal(got[0][0], np.cumsum(xv, axis=0))


def test_piecewise_decay_trajectory():
    """Boundaries [2, 4]: 1.0 on steps 0-1, 0.5 on 2-3, 0.1 after,
    bit-equal to the JAX package's over 6 runs."""
    ref, got, prog = run_programs(
        lambda pkg: [pkg.layers.piecewise_decay(boundaries=[2, 4], values=[1.0, 0.5, 0.1])],
        [{}] * 6)
    seen = [float(g[0][0]) for g in got]
    assert seen == [float(r[0][0]) for r in ref]
    np.testing.assert_array_equal(np.float32(seen), np.float32([1.0, 1.0, 0.5, 0.5, 0.1, 0.1]))
    assert prog.desc.num_blocks() == 4
    st_in, st_out = analyze_state(prog.desc.block(0), [])
    assert graph_blockers(prog, st_in, st_out) == []
    lr = prog.desc.block(0).ops[-1].output("Out")[0]
    assert lr in st_in and lr in st_out


def test_piecewise_decay_drives_sgd():
    """The rate falls to 0 after 3 steps: the loss moves, then freezes."""
    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        loss = layers.mean(layers.square_error_cost(input=layers.fc(input=x, size=1), label=y))
        lr = layers.piecewise_decay(boundaries=[3], values=[0.1, 0.0])
        pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
        return [loss, lr]
    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(8, 4).astype(np.float32), "y": rs.rand(8, 1).astype(np.float32)}
    ref, got, _ = run_programs(build, [feed] * 6)
    for r, g in zip(ref, got):
        assert_close(g, r)
    losses = [float(g[0]) for g in got]
    assert losses[2] < losses[0] and losses[3] == losses[4] == losses[5]


@pytest.mark.parametrize("names", [("array_write", "array_read", "array_length"),
                                   ("write_to_array", "read_from_array", "lod_array_length")])
def test_tensor_arrays_match_jax(names):
    """Three writes, reads at a tensor index (negative: from the end; out
    of range: clamped, as the JAX gather), the length, ``is_empty``, and a
    fetched array (its elements stacked)."""
    write, read, length = names

    def op(pkg, op_type, inputs, outs, dtype="float32"):
        helper = pkg.layer_helper.LayerHelper(op_type)
        out = outs or helper.create_variable_for_type_inference(dtype)
        helper.append_op(op_type, inputs=inputs, outputs={"Out": out})
        return out

    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[3, 2], append_batch_size=False)
        arr = layers.create_array("float32")
        for k in range(3):
            idx = layers.fill_constant(shape=[1], dtype="int32", value=k)
            op(pkg, write, {"X": layers.scale(x, scale=float(k + 1)), "I": idx}, arr)
        reads = [op(pkg, read, {"X": arr, "I": layers.fill_constant(shape=[1], dtype="int32",
                                                                     value=k)}, None)
                 for k in (1, -1, 7)]
        return reads + [op(pkg, length, {"X": arr}, None, "int32"),
                        op(pkg, "is_empty", {"X": x}, None, "bool")]
    xv = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    ref, got, prog = run_programs(build, [{"x": xv}])
    assert_close(got[0], ref[0], rtol=0)
    np.testing.assert_array_equal(got[0][0], 2 * xv)
    np.testing.assert_array_equal(got[0][1], 3 * xv)
    np.testing.assert_array_equal(got[0][2], 3 * xv)
    assert int(got[0][3]) == 3 and not bool(got[0][4])
    # the JAX executor cannot return an array; the port fetches it stacked
    arr = [n for n, v in prog.desc.block(0).vars.items() if v.type == "tensor_array"]
    (stacked,) = pt.Executor(pt.CPUPlace()).run(prog, feed={"x": xv}, fetch_list=arr,
                                                scope=pt.Scope())
    np.testing.assert_array_equal(stacked, np.stack([xv, 2 * xv, 3 * xv]))


@pytest.mark.parametrize("cond_shape", [(4, 1), (4, 3)])
def test_where_matches_jax(cond_shape):
    """Rows selected by a [N, 1] condition (rank-1 and rank-2 values) and
    elements by a [N, 3] one; the gradient reaches both values."""
    rng = np.random.RandomState(2)
    feed = {"c": rng.rand(*cond_shape) > 0.5, "x": rng.randn(4, 3).astype(np.float32),
            "y": rng.randn(4, 3).astype(np.float32)}

    def build(pkg):
        layers = pkg.layers
        c = layers.data(name="c", shape=list(cond_shape), dtype="bool", append_batch_size=False)
        x, y = (layers.data(name=n, shape=[4, 3], append_batch_size=False, stop_gradient=False)
                for n in ("x", "y"))
        outs = []
        for a, b in ((x, y), (layers.reduce_sum(x, dim=[1]), layers.reduce_sum(y, dim=[1]))):
            if cond_shape[1] != 1 and len(a.shape) == 1:
                continue
            out = pkg.layer_helper.LayerHelper("where").create_variable_for_type_inference(
                "float32")
            pkg.layer_helper.LayerHelper("where").append_op(
                "where", inputs={"Condition": c, "X": a, "Y": b}, outputs={"Out": out})
            outs.append(out)
        target = layers.reduce_sum(layers.square(outs[0]))
        return outs + pkg.calc_gradient(target, [x, y])
    ref, got, _ = run_programs(build, [feed])
    assert_close(got[0], ref[0])


def test_state_analysis_and_graph_eligibility_through_sub_blocks():
    """A carry the body writes is read and written state; a bounded loop
    may be one graph; an unbounded one may not, and says why."""
    blockers = {}
    for max_iters in (None, 16):
        main = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
            total = pt.layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                                persistable=True, name="acc")
            fetch = _counter_loop(pt, max_iters)
            with pt.layers.While(fetch[3], max_iters=max_iters).block():
                pt.layers.assign(pt.layers.scale(total, scale=2.0), output=total)
                pt.layers.less_than(fetch[2], fetch[2], cond=fetch[3])
        st_in, st_out = analyze_state(main.desc.block(0), [])
        assert "acc" in st_in and "acc" in st_out
        blockers[max_iters] = graph_blockers(main, st_in, st_out)
    assert blockers[16] == []
    assert blockers[None] == ["runs 2 unbounded while loop(s) (no max_iters), which read their "
                              "condition on the host each trip"]


def test_the_masked_while_keeps_its_decisions_on_the_device(monkeypatch):
    """A bounded loop's lowering never reads a tensor on the host (which a
    CUDA graph cannot record): ``Tensor.item`` and ``__bool__`` are not
    called; the unbounded one calls ``item`` once a trip and once more."""
    calls = []
    item, as_bool = torch.Tensor.item, torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "item", lambda t: calls.append("item") or item(t))
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: calls.append("bool") or as_bool(t))
    for max_iters, want in ((16, []), (None, ["item"] * 11)):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            fetch = _counter_loop(pt, max_iters)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        calls.clear()
        exe.run(main, fetch_list=fetch, scope=scope, return_numpy=False)
        assert calls == want, (max_iters, calls)


@pytest.mark.parametrize("grads", [False, True])
def test_the_stash_is_kept_only_where_a_grad_op_follows(monkeypatch, grads):
    """A ``while`` or ``conditional_block`` keeps the values its grad re-runs
    from only where that grad op follows in the block: a forward program
    (a bounded loop, a Switch's conditional_blocks) names no stash key, so
    none of its values outlives its last reader."""
    keys = []
    stash_key = control_flow_ops._stash_key
    monkeypatch.setattr(control_flow_ops, "_stash_key",
                        lambda n, uid: keys.append(n) or stash_key(n, uid))
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        if grads:
            fetch = _quadratic_grads(pt)[:1]
        else:
            fetch = [_quadratic(pt, 8)[0],
                     pt.layers.piecewise_decay(boundaries=[2], values=[1.0, 0.5])]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.array([0.5], np.float32)}, fetch_list=fetch, scope=scope)
    assert ("@CARRIED" in keys) == grads and bool(keys) == grads, keys
