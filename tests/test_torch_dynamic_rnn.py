"""DynamicRNN, IfElse and the book's RNN encoder-decoder on the port,
against the JAX package on the CPU (``tests/test_dynamic_rnn.py`` is the
parity target).

Both packages build each program under ``unique_name.guard()`` (every
block's ProgramDesc equal); the JAX startup's state is carried into the
port.  Float values and gradients agree within 1e-5 of the reference's
largest magnitude (float32; ``test_torch_sequence.assert_close``),
selections and masks bit-equal:

* IfElse's row-wise merge (rank-2 and rank-1 outputs) and a branch with
  parameters over 3 SGD steps;
* DynamicRNN's masked semantics against the JAX package and numpy (each
  row's memory frozen past its length, padded outputs exactly zero, a
  zero-length row), and ``static_input`` taking a gradient to its
  producer; mismatched padded lengths raise in both;
* the encoder-decoder (``test_rnn_encoder_decoder_book``'s graph: an
  embedding, fc and ``dynamic_lstm`` encoder pooled at its last step; a
  DynamicRNN decoder with the encoder's state as memory and static input;
  a masked cross-entropy; Adam whose rate is ``piecewise_decay``) at a
  small width for 3 steps: the losses, the rates across a boundary and
  every parameter's gradient each step; its program is block 0, the
  recurrent body and the Switch's three branches, and may be one CUDA
  graph.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
from paddle_tpu_torch.models import rnn_encoder_decoder

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_control_flow import assert_close, run_programs
from test_torch_cnn_ops import build_both, descs_equal

# the encoder-decoder at a small width: vocabulary, word width, hidden
# width, batch, padded length; piecewise_decay's boundaries fall inside
# the 3 steps
V, E, H, B, TT = 24, 12, 16, 4, 6
BOUNDARIES, RATES = [1, 2], [5e-3, 2e-3, 1e-3]


def encoder_decoder(pkg):
    """The port's builder at the small width, in ``pkg``."""
    return rnn_encoder_decoder.train_network(B, TT, BOUNDARIES, RATES, dict_size=V,
                                             word_dim=E, hidden_dim=H, pkg=pkg)


def encoder_decoder_feed(seed):
    return rnn_encoder_decoder.synthetic_feed(seed, B, TT, dict_size=V)


def _ifelse(pkg, branch, rank1=False):
    layers = pkg.layers
    x = layers.data(name="x", shape=[3], dtype="float32")
    flag = layers.data(name="flag", shape=[1], dtype="bool")
    ie = layers.IfElse(flag)
    for block, scale in ((ie.true_block, 2.0), (ie.false_block, -1.0)):
        with block():
            out = branch(pkg, ie.input(x), scale)
            ie.output(layers.reduce_sum(out, dim=[1]) if rank1 else out)
    return ie()


@pytest.mark.parametrize("rank1", [False, True])
def test_ifelse_merges_rows_as_jax(rank1):
    xs = np.array([[1.0, -2.0, 3.0], [-1.0, 0.5, -0.25], [4.0, 5.0, 6.0]], np.float32)
    flags = np.array([[True], [False], [True]])
    ref, got, _ = run_programs(
        lambda pkg: _ifelse(pkg, lambda pkg, d, s: pkg.layers.scale(d, scale=s), rank1),
        [{"x": xs, "flag": flags}])
    assert_close(got[0], ref[0], rtol=0)
    want = np.where(flags, 2 * xs, -xs)
    np.testing.assert_array_equal(got[0][0], want.sum(1) if rank1 else want)


def test_ifelse_branches_with_parameters_train_as_jax():
    def build(pkg):
        layers = pkg.layers
        (pred,) = _ifelse(pkg, lambda pkg, d, s: pkg.layers.fc(input=d, size=1))
        y = layers.data(name="y", shape=[1], dtype="float32")
        loss = layers.mean(layers.square_error_cost(input=pred, label=y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, pred]
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 3).astype(np.float32)
    flags = xs[:, :1] > 0
    feed = {"x": xs, "flag": flags, "y": np.where(flags, 2 * xs[:, :1], -xs[:, :1])}
    ref, got, _ = run_programs(build, [feed] * 3)
    for r, g in zip(ref, got):
        assert_close(g, r)
    assert float(got[2][0]) < float(got[0][0])


N, T, D, HID = 4, 5, 3, 6
LENS = np.array([5, 2, 0, 3], np.int32)


def _np_tanh_rnn(x, lens, w, b, h):
    """h_t = tanh([x_t, h_{t-1}] w + b), frozen past each row's length;
    outputs zero there."""
    outs = np.zeros((x.shape[0], x.shape[1], h.shape[1]), np.float32)
    for t in range(x.shape[1]):
        new = np.tanh(np.concatenate([x[:, t], h], axis=1) @ w + b)
        valid = (t < lens)[:, None]
        h = np.where(valid, new, h)
        outs[:, t] = np.where(valid, new, 0.0)
    return outs, h


def test_dynamic_rnn_masked_semantics_match_jax_and_numpy():
    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[D], dtype="float32", lod_level=1, stop_gradient=False)
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[HID], value=0.0)
            hid = layers.fc(input=layers.concat([word, prev], axis=1), size=HID, act="tanh",
                            param_attr=pkg.ParamAttr(name="rnn_w"),
                            bias_attr=pkg.ParamAttr(name="rnn_b",
                                                    initializer=pkg.initializer.Normal(0, 1)))
            drnn.update_memory(prev, hid)
            drnn.output(hid)
        out = drnn()
        target = layers.reduce_sum(layers.square(out))
        params = pkg.default_main_program().global_block.all_parameters()
        return [out, layers.sequence_length(out), "rnn_w", "rnn_b"] + \
            pkg.calc_gradient(target, [x] + params)
    xs = np.random.RandomState(1).randn(N, T, D).astype(np.float32)
    ref, got, prog = run_programs(build, [{"x": xs, "x@SEQ_LEN": LENS}])
    assert_close(got[0], ref[0])
    want, _ = _np_tanh_rnn(xs, LENS, got[0][2], got[0][3], np.zeros((N, HID), np.float32))
    np.testing.assert_allclose(got[0][0], want, atol=1e-6)
    np.testing.assert_array_equal(got[0][1], LENS)
    assert (got[0][0][1, 2:] == 0).all() and (got[0][0][2] == 0).all()
    assert prog.desc.num_blocks() == 2


def test_static_input_takes_a_gradient_to_its_producer():
    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[D], dtype="float32", lod_level=1)
        c = layers.data(name="c", shape=[D], dtype="float32")
        proj = layers.fc(input=c, size=HID, param_attr=pkg.ParamAttr(name="enc_w"),
                         bias_attr=False)
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            context = drnn.static_input(proj)
            prev = drnn.memory(shape=[HID], value=0.0)
            h = layers.fc(input=layers.concat([word, context, prev], axis=1), size=HID,
                          act="tanh", param_attr=pkg.ParamAttr(name="rnn_w"))
            drnn.update_memory(prev, h)
            drnn.output(h)
        loss = layers.mean(drnn())
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return [loss, "enc_w@GRAD", "enc_w"]
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(N, T, D).astype(np.float32), "x@SEQ_LEN": LENS,
            "c": rng.randn(N, D).astype(np.float32)}
    ref, got, _ = run_programs(build, [feed])
    assert_close(got[0], ref[0])
    assert np.abs(got[0][1]).max() > 0


def test_step_inputs_of_two_padded_lengths_raise():
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            a = pkg.layers.data(name="a", shape=[4, 3], dtype="float32")
            b = pkg.layers.data(name="b", shape=[5, 3], dtype="float32")
            drnn = pkg.layers.DynamicRNN()
            with pytest.raises(ValueError, match="ragged layout"):
                with drnn.block():
                    drnn.step_input(a)
                    drnn.step_input(b)


def test_encoder_decoder_three_steps_match_jax():
    """3 Adam steps from the same state: the losses, the rate (5e-3, 2e-3,
    1e-3: both boundaries crossed) and every parameter's gradient each
    step, within 1e-5 of the largest value."""
    def build(pkg):
        loss, lr = encoder_decoder(pkg)
        params = pkg.default_main_program().global_block.all_parameters()
        return [loss, lr] + [p.name + "@GRAD" for p in params]
    feed = encoder_decoder_feed(3)
    ref, got, prog = run_programs(build, [feed] * 3)
    for r, g in zip(ref, got):
        assert_close(g, r)
    assert [float(g[1][0]) for g in got] == [float(np.float32(v)) for v in RATES]
    losses = [float(g[0]) for g in got]
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    assert len(got[0]) == 2 + 10 and all(np.abs(a).max() > 0 for a in got[0][2:])
    # block 0, the decoder's body and the Switch's three branches
    assert prog.desc.num_blocks() == 5
    types = [o.type for o in prog.desc.block(0).ops]
    assert [types.count(t) for t in ("recurrent", "recurrent_grad", "conditional_block",
                                     "lookup_table", "lookup_table_grad", "adam")] == \
        [1, 1, 3, 2, 2, 10]
    st_in, st_out = analyze_state(prog.desc.block(0), list(feed))
    assert graph_blockers(prog, st_in, st_out) == []


def test_encoder_decoder_programs_are_equal_at_full_width():
    """The chip's configuration (vocabulary 30,000, word and hidden 32,
    batch 64, padded length 32) builds the same program in both
    packages, and the port's builder builds it in the port by default."""
    jax_side, port_side = build_both(lambda pkg: rnn_encoder_decoder.train_network(
        64, 32, BOUNDARIES, RATES, pkg=pkg))
    assert port_side[0].desc.num_blocks() == 5
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        rnn_encoder_decoder.train_network(64, 32, BOUNDARIES, RATES)
    descs_equal(jax_side[0], main)
    descs_equal(jax_side[1], startup)


# the encoder-decoder under program.amp: the amp-bf16 pass skips a program
# of several blocks, so both packages run it with the lowering-time casts
# (bf16 reads for the matmul class, float32 for the sensitive class; a
# recurrent op's steps uncast).  XLA keeps fused bf16 chains in float32
# where torch rounds each op, so the gates are bf16 ones: measured on this
# net, losses within 6e-5 relative and gradients within 0.015
# norm-relative of the JAX package's
AMP_LOSS_RTOL = 1e-3
AMP_GRAD_NREL = 0.05


def _grads_and_loss(amp):
    def build(pkg):
        loss, lr = encoder_decoder(pkg)
        if amp:
            pkg.amp.enable_amp(pkg.default_main_program())
        params = pkg.default_main_program().global_block.all_parameters()
        return [loss, lr] + [p.name + "@GRAD" for p in params]
    return build


def test_encoder_decoder_under_amp_matches_jax_lowering_time_casts():
    """3 steps: the losses and every gradient within the bf16 gates.  The
    gradients the JAX package computes in bf16 (the encoder's fc and LSTM
    weights') are bf16 values in the port too (fetched as float32), which
    the float32 run's are not: the control that the casts happened."""
    feed = encoder_decoder_feed(3)
    ref, got, prog = run_programs(_grads_and_loss(amp=True), [feed] * 3)
    for r, g in zip(ref, got):
        assert abs(float(g[0]) - float(r[0])) <= AMP_LOSS_RTOL * abs(float(r[0]))
        for a, b in zip(g[2:], r[2:]):
            assert np.isfinite(a).all()
            if b.dtype != np.float32:
                assert np.array_equal(a.astype(b.dtype).astype(np.float32), a)
            b = b.astype(np.float32)
            assert np.linalg.norm(a - b) <= AMP_GRAD_NREL * np.linalg.norm(b)
    bf16 = [i for i, b in enumerate(ref[0]) if b.dtype != np.float32]
    assert len(bf16) == 3 and prog.amp and prog.desc.num_blocks() == 5
    _, f32, _ = run_programs(_grads_and_loss(amp=False), [feed])
    for i in bf16:
        a = f32[0][i]
        assert not np.array_equal(a.astype(ref[0][i].dtype).astype(np.float32), a)
