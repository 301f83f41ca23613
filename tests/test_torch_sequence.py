"""The 17 sequence op types of the port (``ops/sequence_ops.py``) against
the JAX package's lowerings, on the CPU.

Each case builds the same program in both packages (equal ProgramDescs),
feeds the same seeded numpy inputs, ragged lengths with a zero-length row
among them, and compares every output, the lengths each output carries
(fetched through ``sequence_length``), and the gradient of
``sum(square(out))`` with respect to every float input (``calc_gradient``).
Float outputs and gradients agree within ``RTOL`` of the reference's
largest magnitude; integer outputs, masks, lengths, copies and gathers are
bit-equal.  As in ``tests/test_sequence.py`` and
``tests/test_empty_sequences.py``: all six pool types, a zero-length row
pooled to exact zeros, and finite gradients.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_cnn_ops import build_both, start_both

RTOL = 1e-5             # float32, XLA against torch, relative to the largest value
N, T, D = 4, 6, 5
LENS = np.array([6, 0, 3, 5], np.int32)      # one row empty, one full


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _data_vars(pkg, feed):
    """One data var per feed entry that is not a lengths channel, with the
    LoD level its ``@SEQ_LEN`` channels give it; float inputs carry a
    gradient."""
    levels = {}
    for k in feed:
        if "@SEQ_LEN" in k:
            base = k.split("@")[0]
            levels[base] = max(levels.get(base, 0), k.count("@SEQ_LEN@") + 1)
    return [pkg.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                            append_batch_size=False, lod_level=levels.get(n, 0),
                            stop_gradient=a.dtype.kind != "f")
            for n, a in feed.items() if "@" not in n]


def run_seq(build, feed, grad=True, params=False):
    """``build(pkg, xs)`` appends ops over the data vars ``xs`` and returns
    the vars to fetch.  With ``grad`` the gradients of sum(square(first
    fetch)) with respect to every float input (and, with ``params``, every
    parameter) are fetched too.  The JAX startup's state is carried into
    the port's scope.  Returns (JAX fetches, port fetches), dtypes and
    shapes held equal."""
    def program(pkg):
        xs = _data_vars(pkg, feed)
        fetch = list(build(pkg, xs))
        if grad:
            target = pkg.layers.reduce_sum(pkg.layers.square(fetch[0]))
            wrt = [x for x in xs if not x.stop_gradient]
            if params:
                wrt += pkg.default_main_program().global_block.all_parameters()
            fetch += pkg.calc_gradient(target, wrt)
        return fetch
    jax_side, port_side = build_both(program)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    names = [v.name for v in jax_side[2]]
    assert names == [v.name for v in port_side[2]]
    ref = [np.asarray(a) for a in jexe.run(jax_side[0], feed=feed, fetch_list=names,
                                           scope=jscope)]
    got = [np.asarray(a) for a in texe.run(port_side[0], feed=feed, fetch_list=names,
                                           scope=tscope)]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return ref, got


def assert_close(got, ref, rtol=RTOL):
    """Float arrays within ``rtol`` of the reference's largest magnitude,
    every value finite where the reference's is; others bit-equal."""
    for a, b in zip(got, ref):
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            scale = max(float(np.abs(b).max(initial=0.0)), 1.0)
            np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0)
        else:
            np.testing.assert_array_equal(a, b)


def _op(pkg, op_type, inputs, attrs=None, outs=("Out",), dtype="float32"):
    helper = pkg.layer_helper.LayerHelper(op_type)
    out = {s: helper.create_variable_for_type_inference(dtype) for s in outs}
    helper.append_op(op_type, inputs=inputs, outputs=out, attrs=attrs or {})
    return [out[s] for s in outs]


def _with_lens(pkg, outs, shape=None):
    """``outs`` and the lengths each carries.  ``shape``: the outputs'
    shape, declared where the op type has no infer-shape rule (in either
    package), so that ``sequence_length``'s rule can read it."""
    for o in outs:
        if shape is not None:
            o.desc.shape = tuple(shape)
    return list(outs) + [pkg.layers.sequence_length(o) for o in outs]


def _seq(name="x", lens=LENS, *shape, seed=0):
    shape = shape or (N, T, D)
    feed = {name: _f(seed, *shape)}
    if lens is not None:
        feed[name + "@SEQ_LEN"] = np.asarray(lens, np.int32)
    return feed


# ----------------------------------------------------------------- pooling

POOLS = ["sum", "average", "sqrt", "max", "last", "first"]


@pytest.mark.parametrize("lens", ["ragged", "none"])
@pytest.mark.parametrize("ptype", POOLS)
def test_sequence_pool_matches_jax(ptype, lens):
    """Each pool type: the empty row pools to exact zeros (and in MAX the
    dtype's lowest value leaks nowhere), the gradient is finite and
    matches, ties included (a step repeated in row 0 under MAX: the
    gradient splits evenly as the JAX max's does)."""
    feed = _seq(lens=LENS if lens == "ragged" else None)
    feed["x"][0, 3] = feed["x"][0, 1]
    ref, got = run_seq(lambda pkg, xs: [pkg.layers.sequence_pool(xs[0], ptype)], feed)
    assert_close(got, ref)
    assert all(np.isfinite(a).all() for a in got)
    if lens == "ragged":
        np.testing.assert_array_equal(got[0][1], np.zeros(D, np.float32))
        if ptype in ("max", "last", "first"):
            np.testing.assert_array_equal(got[1][1], np.zeros((T, D), np.float32))


@pytest.mark.parametrize("layer", ["sequence_last_step", "sequence_first_step"])
def test_first_and_last_step_match_jax(layer):
    ref, got = run_seq(lambda pkg, xs: [getattr(pkg.layers, layer)(xs[0])], _seq())
    assert_close(got, ref, rtol=0)
    np.testing.assert_array_equal(got[0][1], np.zeros(D, np.float32))


def test_sequence_pool_max_splits_a_tie_evenly():
    """Two equal maxima in one row: each gets half the gradient (amax, as
    the JAX max; max(dim) would route it all to one)."""
    feed = {"x": np.array([[[1.0], [3.0], [3.0], [0.0]]], np.float32),
            "x@SEQ_LEN": np.array([4], np.int32)}
    ref, got = run_seq(lambda pkg, xs: [pkg.layers.sequence_pool(xs[0], "max")], feed)
    assert_close(got, ref, rtol=0)
    np.testing.assert_array_equal(got[1][0, :, 0], [0.0, 3.0, 3.0, 0.0])


# ------------------------------------------------------ softmax and expansion

def test_sequence_softmax_matches_jax():
    feed = {"x": _f(1, N, T), "x@SEQ_LEN": LENS}
    ref, got = run_seq(lambda pkg, xs: _with_lens(pkg, [pkg.layers.sequence_softmax(xs[0])]),
                       feed)
    assert_close(got, ref)
    np.testing.assert_allclose(got[0].sum(1), [1, 0, 1, 1], rtol=1e-6)


@pytest.mark.parametrize("case", ["rows", "same_rank", "as"])
def test_sequence_expand_one_level_matches_jax(case):
    """X [N, D] tiled over Y's steps (``sequence_expand`` and
    ``sequence_expand_as``), or X already [N, T, D] and masked by Y's
    lengths."""
    feed = {"x": _f(2, N, T, D) if case == "same_rank" else _f(2, N, D),
            "y": _f(3, N, T, 2), "y@SEQ_LEN": LENS}

    def build(pkg, xs):
        if case == "as":
            out = pkg.layers.sequence_expand_as(xs[0], xs[1])
        else:
            out = pkg.layers.sequence_expand(xs[0], xs[1])
        return _with_lens(pkg, [out], shape=(N, T, D))
    ref, got = run_seq(build, feed)
    assert_close(got, ref, rtol=0)


@pytest.mark.parametrize("ref_level", [0, -1, 1])
def test_sequence_expand_two_levels_matches_jax(ref_level):
    """A 2-level Y ([N, S, T, ...] with ``@SEQ_LEN`` and ``@SEQ_LEN@1``):
    ``ref_level=0`` gives one copy of X per sub-sequence, -1 and 1 one per
    token."""
    s, t = 3, 4
    feed = {"x": _f(4, N, D), "y": _f(5, N, s, t),
            "y@SEQ_LEN": np.array([3, 0, 2, 1], np.int32),
            "y@SEQ_LEN@1": np.array([[4, 1, 2], [0, 0, 0], [3, 4, 0], [2, 0, 0]], np.int32)}
    ref, got = run_seq(lambda pkg, xs: [pkg.layers.sequence_expand(xs[0], xs[1],
                                                                   ref_level=ref_level)], feed)
    assert_close(got[:1], ref[:1], rtol=0)      # a masked copy
    assert_close(got, ref)                      # the gradient sums the copies
    assert got[0].shape == ((N, s, D) if ref_level == 0 else (N, s, t, D))


@pytest.mark.parametrize("which", ["both", "first", "second"])
def test_sequence_concat_packs_rows_as_jax(which):
    """Concatenation along time with each row's valid steps packed to the
    front; inputs without lengths count as full."""
    feed = {"a": _f(6, N, T, D), "b": _f(7, N, 3, D)}
    if which in ("both", "first"):
        feed["a@SEQ_LEN"] = LENS
    if which in ("both", "second"):
        feed["b@SEQ_LEN"] = np.array([1, 3, 0, 2], np.int32)

    def build(pkg, xs):
        (out,) = _op(pkg, "sequence_concat", {"X": list(xs)})
        return _with_lens(pkg, [out], shape=(N, T + 3, D))
    ref, got = run_seq(build, feed)
    assert_close(got, ref, rtol=0)


# ---------------------------------------------------- convolution, reshape

@pytest.mark.parametrize("filter_size", [3, 4])
def test_sequence_conv_matches_jax(filter_size):
    """The context window (start -(len-1)//2) over masked steps, its
    filter and bias gradients included."""
    feed = _seq(seed=8)

    def build(pkg, xs):
        out = pkg.layers.sequence_conv(
            xs[0], num_filters=3, filter_size=filter_size, act="tanh",
            bias_attr=pkg.ParamAttr(initializer=pkg.initializer.Normal(0.0, 0.5)))
        return _with_lens(pkg, [out])
    ref, got = run_seq(build, feed, params=True)
    assert_close(got, ref)


@pytest.mark.parametrize("new_dim", [4, 1])
def test_sequence_reshape_rescales_lengths_as_jax(new_dim):
    feed = {"x": _f(9, N, T, 2), "x@SEQ_LEN": LENS}
    ref, got = run_seq(lambda pkg, xs: _with_lens(
        pkg, [pkg.layers.sequence_reshape(xs[0], new_dim)]), feed)
    assert_close(got, ref, rtol=0)


# ------------------------------------------------------ masks and lengths

@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
@pytest.mark.parametrize("how", ["maxlen", "like"])
def test_sequence_mask_matches_jax(how, dtype):
    feed = {"lens": np.array([3, 0, 7, 5], np.int32), "y": _f(10, N, 7, 2)}

    def build(pkg, xs):
        if how == "maxlen":
            return [pkg.layers.sequence_mask(xs[0], maxlen=8, dtype=dtype)]
        return [pkg.layers.sequence_mask(xs[0], dtype=dtype, maxlen_like=xs[1])]
    ref, got = run_seq(build, feed, grad=False)
    assert_close(got, ref, rtol=0)


@pytest.mark.parametrize("lens", ["ragged", "none"])
def test_sequence_length_matches_jax(lens):
    feed = _seq(lens=LENS if lens == "ragged" else None)
    ref, got = run_seq(lambda pkg, xs: [pkg.layers.sequence_length(xs[0])], feed, grad=False)
    assert_close(got, ref, rtol=0)
    assert got[0].dtype == np.int32


# ---------------------------------------------- padding, slicing, erasing

@pytest.mark.parametrize("maxlen", [None, 4, 9])
def test_sequence_pad_matches_jax(maxlen):
    """Re-padded with PadValue (its gradient too) to T, below it or above
    it; Length capped at the padded length."""
    feed = dict(_seq(seed=11), pad=np.array([0.5], np.float32))
    ref, got = run_seq(lambda pkg, xs: list(pkg.layers.sequence_pad(xs[0], xs[1], maxlen=maxlen)),
                       feed)
    assert_close(got, ref, rtol=0)
    assert got[1].dtype == np.int32


def test_sequence_unpad_matches_jax():
    feed = {"x": _f(12, N, T, D), "len": np.array([2, 6, 0, 4], np.int64)}

    def build(pkg, xs):
        (out,) = _op(pkg, "sequence_unpad", {"X": xs[0], "Length": xs[1]})
        return _with_lens(pkg, [out]) + [pkg.layers.sequence_pool(out, "sum")]
    ref, got = run_seq(build, feed)
    assert_close(got, ref)


def test_sequence_slice_matches_jax():
    feed = {"x": _f(13, N, T, D), "x@SEQ_LEN": LENS,
            "off": np.array([[1], [0], [2], [0]], np.int64),
            "len": np.array([[3], [0], [1], [5]], np.int64)}

    def build(pkg, xs):
        (out,) = _op(pkg, "sequence_slice", {"X": xs[0], "Offset": xs[1], "Length": xs[2]})
        return _with_lens(pkg, [out])
    ref, got = run_seq(build, feed)
    assert_close(got, ref, rtol=0)


def test_sequence_erase_matches_jax():
    """Tokens 2 and 5 removed, the rest packed, lengths counted."""
    ids = np.random.RandomState(14).randint(0, 7, (N, T, 1)).astype(np.int64)
    feed = {"ids": ids, "ids@SEQ_LEN": LENS}

    def build(pkg, xs):
        (out,) = _op(pkg, "sequence_erase", {"X": xs[0]}, {"tokens": [2, 5]}, dtype="int64")
        return _with_lens(pkg, [out])
    ref, got = run_seq(build, feed, grad=False)
    assert_close(got, ref, rtol=0)


@pytest.mark.parametrize("source", ["y", "target_lod"])
def test_lod_reset_matches_jax(source):
    """New lengths from Y or from the offsets attr, read back through
    ``sequence_length`` and a pooled sum over them."""
    feed = _seq(lens=None, seed=15)
    if source == "y":
        feed["newlen"] = np.array([2, 6, 0, 3], np.int32)

    def build(pkg, xs):
        if source == "y":
            out = pkg.layers.lod_reset(xs[0], y=xs[1])
        else:
            out = pkg.layers.lod_reset(xs[0], target_lod=[0, 1, 4, 4, 6])
        return [pkg.layers.sequence_pool(out, "sum"), pkg.layers.sequence_length(out)]
    ref, got = run_seq(build, feed)
    assert_close(got, ref)


def test_row_conv_matches_jax():
    feed = _seq(seed=16)

    def build(pkg, xs):
        return _with_lens(pkg, [pkg.layers.row_conv(
            xs[0], future_context_size=2,
            param_attr=pkg.ParamAttr(initializer=pkg.initializer.Normal(0.0, 1.0)))])
    ref, got = run_seq(build, feed, params=True)
    assert_close(got, ref)


def test_every_sequence_op_type_is_lowered_and_length_aware():
    """The 17 op types lower in the port, each in the port's SEQ_LEN_AWARE
    set exactly where it is in the JAX package's."""
    from paddle_tpu.core.lower import SEQ_LEN_AWARE as JAX_AWARE
    from paddle_tpu_torch.core.lower import SEQ_LEN_AWARE
    from paddle_tpu_torch.core.registry import OPS
    types = ["sequence_pool", "sequence_softmax", "sequence_expand", "sequence_concat",
             "sequence_conv", "sequence_reshape", "sequence_expand_as", "sequence_mask",
             "sequence_length", "sequence_last_step", "sequence_first_step", "sequence_pad",
             "sequence_unpad", "sequence_slice", "sequence_erase", "lod_reset", "row_conv"]
    for t in types:
        assert OPS.get(t).lower is not None, t
        assert (t in SEQ_LEN_AWARE) == (t in JAX_AWARE), t
    assert SEQ_LEN_AWARE == {t for t in JAX_AWARE if OPS.has(t) and OPS.get(t).lower}
    assert fluid is not None and pt is not None
