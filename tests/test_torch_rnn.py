"""The five recurrent op types of the port (``ops/rnn_ops.py``):
``dynamic_lstm``, ``dynamic_gru``, ``lstmp``, ``gru_unit`` and
``lstm_unit``, against the JAX package's lowerings on the CPU, in float32.

Each case builds the same layer in both packages (equal ProgramDescs),
carries the JAX startup's parameters into the port (the biases drawn from
a normal so the peepholes are not zero), feeds seeded numpy inputs whose
lengths are below T in all rows but one (one of them 0), and compares the
outputs and the gradients of sum(square(first output)) with respect to
the input, the initial states and every parameter, within ``RTOL`` of the
reference's largest magnitude.  The recurrences run forward and reversed
(a reversed row crosses its padded tail first, its state held), with and
without peepholes, ``h_0`` and ``c_0``, and with other activations.
"""
import numpy as np
import pytest

import paddle_tpu_torch as pt

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_sequence import _f, _op, assert_close, run_seq

RTOL = 1e-5             # float32, relative to the reference's largest value
N, T, H, P = 4, 6, 5, 3
LENS = np.array([4, 0, 6, 2], np.int32)


def _bias(pkg):
    return pkg.ParamAttr(initializer=pkg.initializer.Normal(0.0, 0.5))


def _feed(width, init=(), seed=0):
    feed = {"x": _f(seed, N, T, width), "x@SEQ_LEN": LENS}
    for i, name in enumerate(init):
        feed[name] = _f(seed + 1 + i, N, H)
    return feed


def _held(got, ref):
    assert_close(got, ref, RTOL)
    assert all(np.isfinite(a).all() for a in got)


@pytest.mark.parametrize("init", [(), ("h0", "c0")])
@pytest.mark.parametrize("peepholes", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_lstm_matches_jax(reverse, peepholes, init):
    feed = _feed(4 * H, init)

    def build(pkg, xs):
        kw = dict(zip(("h_0", "c_0"), xs[1:]))
        hidden, cell = pkg.layers.dynamic_lstm(
            xs[0], size=4 * H, use_peepholes=peepholes, is_reverse=reverse,
            bias_attr=_bias(pkg), **kw)
        return [pkg.layers.elementwise_add(hidden, cell), hidden, cell]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)
    np.testing.assert_array_equal(got[1][1], np.zeros((T, H), np.float32))   # the empty row
    np.testing.assert_array_equal(got[1][3, 2:], np.zeros((T - 2, H), np.float32))


def test_dynamic_lstm_other_activations_match_jax():
    feed = _feed(4 * H, ("h0",), seed=3)

    def build(pkg, xs):
        hidden, _ = pkg.layers.dynamic_lstm(
            xs[0], size=4 * H, h_0=xs[1], is_reverse=True, bias_attr=_bias(pkg),
            gate_activation="sigmoid", cell_activation="relu",
            candidate_activation="identity")
        return [hidden]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_gru_matches_jax(reverse, init):
    feed = _feed(3 * H, ("h0",) if init else (), seed=5)

    def build(pkg, xs):
        return [pkg.layers.dynamic_gru(xs[0], size=H, h_0=xs[1] if init else None,
                                       is_reverse=reverse, bias_attr=_bias(pkg))]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)
    np.testing.assert_array_equal(got[0][1], np.zeros((T, H), np.float32))


def test_dynamic_gru_relu_candidate_matches_jax():
    feed = _feed(3 * H, seed=7)
    ref, got = run_seq(lambda pkg, xs: [pkg.layers.dynamic_gru(
        xs[0], size=H, candidate_activation="relu", bias_attr=_bias(pkg))], feed, params=True)
    _held(got, ref)


@pytest.mark.parametrize("proj_activation", ["tanh", "identity", "relu"])
@pytest.mark.parametrize("peepholes", [True, False])
def test_lstmp_matches_jax(peepholes, proj_activation):
    """``proj_activation`` relu applies the cell activation (tanh), the
    reference's quirk the JAX lowering keeps."""
    feed = _feed(4 * H, ("h0", "c0"), seed=9)

    def build(pkg, xs):
        proj, cell = pkg.layers.dynamic_lstmp(
            xs[0], size=4 * H, proj_size=P, h_0=xs[1], c_0=xs[2],
            use_peepholes=peepholes, proj_activation=proj_activation,
            bias_attr=_bias(pkg))
        return [proj, cell]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)
    assert got[0].shape == (N, T, P) and got[1].shape == (N, T, H)


def test_lstmp_without_initial_state_matches_jax():
    feed = _feed(4 * H, seed=11)
    ref, got = run_seq(lambda pkg, xs: list(pkg.layers.dynamic_lstmp(
        xs[0], size=4 * H, proj_size=P, bias_attr=_bias(pkg))), feed, params=True)
    _held(got, ref)


def test_gru_unit_matches_jax():
    feed = {"x": _f(13, N, 3 * H), "h": _f(14, N, H)}

    def build(pkg, xs):
        hidden, reset, gate = pkg.layers.gru_unit(xs[0], xs[1], size=3 * H,
                                                  bias_attr=_bias(pkg))
        return [hidden, reset, gate]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_jax(forget_bias):
    """The op on pre-activations X [N, 4H] (i, f, o, g).  (The JAX
    package's ``lstm_unit`` layer raises: it looks ``concat`` up in its
    ``layers.tensor``; the op is built directly.)"""
    feed = {"x": _f(15, N, 4 * H), "c": _f(16, N, H)}

    def build(pkg, xs):
        cell, hidden = _op(pkg, "lstm_unit", {"X": xs[0], "C_prev": xs[1]},
                           {"forget_bias": forget_bias}, outs=("C", "H"))
        return [pkg.layers.elementwise_add(hidden, cell), hidden, cell]
    ref, got = run_seq(build, feed)
    _held(got, ref)


def test_lstm_unit_layer_builds_concat_fc_and_the_cell():
    """The port's ``lstm_unit`` layer: concat([x, h]) -> fc to 4H -> the
    op, the program the JAX package builds from those layers, and the
    same numbers."""
    feed = {"x": _f(17, N, 7), "h": _f(18, N, H), "c": _f(19, N, H)}

    def build(pkg, xs):
        if pkg is pt:
            hidden, cell = pkg.layers.lstm_unit(xs[0], xs[1], xs[2], forget_bias=0.5,
                                                bias_attr=_bias(pkg))
        else:
            helper = pkg.layer_helper.LayerHelper("lstm_unit")
            gates = pkg.layers.fc(pkg.layers.concat([xs[0], xs[1]], axis=-1), size=4 * H,
                                  bias_attr=_bias(pkg))
            cell, hidden = (helper.create_variable_for_type_inference("float32")
                            for _ in range(2))
            helper.append_op("lstm_unit", inputs={"X": gates, "C_prev": xs[2]},
                             outputs={"C": cell, "H": hidden}, attrs={"forget_bias": 0.5})
        return [pkg.layers.elementwise_add(hidden, cell), hidden, cell]
    ref, got = run_seq(build, feed, params=True)
    _held(got, ref)


def test_reversed_lstm_holds_its_state_through_the_padded_tail():
    """A reversed row shorter than T starts from its initial state at step
    len - 1, as if the padded tail were not there: the port's row 3
    (length 2) equals the same row run alone at T = 2."""
    feed = _feed(4 * H, ("h0", "c0"), seed=19)

    def build(pkg, xs):
        hidden, _ = pkg.layers.dynamic_lstm(xs[0], size=4 * H, h_0=xs[1], c_0=xs[2],
                                            is_reverse=True, bias_attr=_bias(pkg))
        return [hidden]
    _, got = run_seq(build, feed, grad=False)
    short = {"x": feed["x"][3:4, :2].copy(), "x@SEQ_LEN": np.array([2], np.int32),
             "h0": feed["h0"][3:4].copy(), "c0": feed["c0"][3:4].copy()}
    _, alone = run_seq(build, short, grad=False)
    np.testing.assert_allclose(got[0][3, :2], alone[0][0], rtol=0, atol=1e-6)
