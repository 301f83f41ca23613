"""Each op lowering of the port's serving slice against the JAX package's.

For every op type, the same tiny program is built by both packages under
``unique_name.guard()``; the JAX startup program initializes the
parameters, which are carried into the port's scope, and both executors
(the port's on ``CPUPlace()``) run the same numpy feeds.  Fetches must
agree within ``ATOL`` (float32, different summation orders) -- exactly
for integer and copy ops.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt

ATOL = 1e-5


def _run_both(build, feed, n_fetch=1):
    """``build(pkg)`` declares data vars and appends ops to the default
    programs of ``pkg``; returns the fetch Variables."""
    results = []
    jax_scope = fluid.Scope()
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetches = build(pkg)
        if pkg is fluid:
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=jax_scope)
            params = {v.name: np.asarray(jax_scope.find_var(v.name))
                      for v in main.list_vars() if v.persistable}
            out = exe.run(main, feed=feed, fetch_list=fetches, scope=jax_scope)
        else:
            scope = pt.Scope()
            pt.params_from_numpy(params, scope, "cpu")
            out = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=fetches,
                                                 scope=scope)
        results.append([np.asarray(o) for o in out])
    (ref, got) = results
    assert len(got) == n_fetch
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    return got


def _x(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_mul_and_elementwise_add_through_fc():
    rs = np.random.RandomState(0)

    def build(pkg):
        x = pkg.layers.data(name="x", shape=[5, 12])
        return [pkg.layers.fc(input=x, size=7, num_flatten_dims=2)]
    _run_both(build, {"x": _x(rs, 3, 5, 12)})


@pytest.mark.parametrize("bias_after_scale", [True, False])
def test_scale(bias_after_scale):
    rs = np.random.RandomState(1)

    def build(pkg):
        x = pkg.layers.data(name="x", shape=[6])
        return [pkg.layers.scale(x, scale=2.5, bias=-0.75,
                                 bias_after_scale=bias_after_scale)]
    _run_both(build, {"x": _x(rs, 4, 6)})


def test_relu_through_fc_act():
    rs = np.random.RandomState(2)

    def build(pkg):
        x = pkg.layers.data(name="x", shape=[8])
        return [pkg.layers.fc(input=x, size=8, act="relu")]
    (out,) = _run_both(build, {"x": _x(rs, 5, 8)})
    assert (out == 0).any() and (out >= 0).all()


def test_layer_norm_with_mean_and_variance():
    rs = np.random.RandomState(3)

    def build(pkg):
        x = pkg.layers.data(name="x", shape=[4, 10])
        y = pkg.layers.layer_norm(x, begin_norm_axis=2)
        op = pkg.default_main_program().global_block.desc.ops[-1]
        block = pkg.default_main_program().global_block
        return [y, block.var(op.outputs["Mean"][0]), block.var(op.outputs["Variance"][0])]
    _run_both(build, {"x": 3.0 * _x(rs, 2, 4, 10) + 1.0}, n_fetch=3)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_in_range_ids(padding_idx):
    rs = np.random.RandomState(4)

    def build(pkg):
        ids = pkg.layers.data(name="ids", shape=[6, 1], dtype="int64")
        return [pkg.layers.embedding(ids, size=[20, 16], padding_idx=padding_idx)]
    ids = rs.randint(0, 20, (3, 6, 1)).astype(np.int64)
    ids[0, :2, 0] = 3
    (out,) = _run_both(build, {"ids": ids})
    if padding_idx is not None:
        assert not out[0, :2].any()


def test_reshape_with_copied_and_inferred_dims():
    rs = np.random.RandomState(5)

    def build(pkg):
        x = pkg.layers.data(name="x", shape=[4, 6])
        return [pkg.layers.reshape(x, shape=[0, -1, 3])]
    (out,) = _run_both(build, {"x": _x(rs, 2, 4, 6)})
    assert out.shape == (2, 8, 3)


def test_position_ids_and_max_len_check():
    def build(pkg):
        ids = pkg.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        helper = pkg.layer_helper.LayerHelper("position_ids")
        out = helper.create_tmp_variable("int32")
        helper.append_op("position_ids", inputs={"X": ids}, outputs={"Out": out},
                         attrs={"max_len": 9})
        return [out]
    (out,) = _run_both(build, {"ids": np.zeros((2, 7, 1), np.int64)})
    np.testing.assert_array_equal(out, np.tile(np.arange(7, dtype=np.int32), (2, 1)))
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        build(pt)
    with pytest.raises(ValueError, match="max_len"):
        pt.Executor(pt.CPUPlace()).run(main, feed={"ids": np.zeros((1, 10, 1), np.int64)},
                                       scope=pt.Scope())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_op_masks_by_key_lengths(causal):
    """Cross-attention shapes (Tq != Tk): keys masked by K's @SEQ_LEN,
    the output carries Q's @SEQ_LEN."""
    rs = np.random.RandomState(6)

    def build(pkg):
        q = pkg.layers.data(name="q", shape=[8], lod_level=1)
        k = pkg.layers.data(name="k", shape=[8], lod_level=1)
        return [pkg.layers.flash_attention(q, k, k, num_heads=2, causal=causal)]
    feed = {"q": _x(rs, 3, 5, 8), "k": _x(rs, 3, 7, 8),
            "k@SEQ_LEN": np.array([7, 0, 3], np.int32),
            "q@SEQ_LEN": np.array([5, 2, 1], np.int32)}
    (out,) = _run_both(build, feed)
    assert not out[1].any()                    # no valid key: exact zeros


def test_startup_ops_fill_constant_and_uniform_random():
    """Startup programs: constants equal, uniform draws in the op's range
    (torch's generator and JAX's threefry give different bits)."""
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[6])
        return pkg.layers.layer_norm(pkg.layers.fc(input=x, size=30), begin_norm_axis=1)

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        build(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    for op in startup.desc.block(0).ops:
        val = scope.find_var(op.outputs["Out"][0]).numpy()
        assert list(val.shape) == op.attrs["shape"]
        if op.type == "fill_constant":
            assert (val == op.attrs["value"]).all()
        else:
            assert op.type == "uniform_random"
            assert op.attrs["min"] <= val.min() < val.max() <= op.attrs["max"]
            assert abs(val.mean()) < 0.25 * op.attrs["max"]


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_test_mode_is_identity_and_train_mode_drops(impl):
    rs = np.random.RandomState(7)
    feed = {"x": np.abs(_x(rs, 64, 64)) + 1.0}

    def build(pkg, is_test):
        x = pkg.layers.data(name="x", shape=[64])
        return [pkg.layers.dropout(x, dropout_prob=0.25, is_test=is_test,
                                   dropout_implementation=impl)]
    _run_both(lambda pkg: build(pkg, True), feed)
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        (y,) = build(pt, False)
    (out,) = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[y],
                                            scope=pt.Scope())
    kept = out != 0
    assert 0.2 < 1.0 - kept.mean() < 0.3
    scale = 1.0 / 0.75 if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[kept], feed["x"][kept] * scale, rtol=1e-6)
