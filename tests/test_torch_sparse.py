"""The port's sparse-gradient slice against the JAX package, on the CPU.

* ``SelectedRows.merged()`` against the JAX package's on the same ids
  and rows: the ids bit-equal (duplicates, ``padding_idx``, an id at
  ``height - 1``, a batch of one id), the rows within ``ATOL``;
* each of the op types the slice adds (the sparse ``lookup_table_grad``,
  ``get_tensor_from_selected_rows``, ``extract_rows``,
  ``merge_selected_rows``, ``sparse_weight_decay``, ``sparse_scale_rows``,
  ``row_prefetch``, ``gather_rows``, ``split_ids``, ``merge_ids``,
  ``split_selected_rows``) and ``sigmoid_cross_entropy_with_logits`` with
  its gradient: the same program built by both packages (equal
  ProgramDescs), run on the same feeds, outputs within ``ATOL`` (integer
  outputs bit-equal);
* sparse SGD, Adam and Adagrad: against the dense update of the port
  (SGD everywhere, Adam and Adagrad on the touched rows, lazy Adam leaving
  the others bit-equal) and against the JAX package's sparse update
  within ``STEP_ATOL``; a batch holding ``height - 1`` (the padded slots
  point at slot 0's row); ``sum`` of two sparse gradients of one table;
  the global-norm clip and L1 / L2 decay on a sparse gradient;
  ``unsupported_sparse``;
* the step's group: a SelectedRows update stays out of the K6 / K5 call,
  the step's graph blockers are empty and the verifier finds nothing;
* DeepFM at ``vocab_sizes=[50, 30, 20]``, ``embed_dim`` 4, built with
  ``is_test=True`` (no dropout; the same backward): equal ProgramDescs,
  every step-1 gradient (sparse ones densified) within ``ATOL``, and 3
  Adam steps' losses and parameters within ``STEP_ATOL``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.selected_rows import SelectedRows

from _torch_validate import _no_port_validate_findings  # noqa: F401

ATOL = 1e-5          # float32 values and gradients, XLA against torch
STEP_ATOL = 2e-5     # parameters after 3 steps, float32
VOCAB, DIM = 12, 4


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _descs_equal(a, b):
    assert _scrub(a.desc.to_dict()) == _scrub(b.desc.to_dict())


def _both(build):
    """``build(pkg)`` under each package's guards -> (jax result, port result),
    each ``(main, startup, build's return)``."""
    out = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            out.append((main, startup, build(pkg)))
    return out


def _carry(jscope, tscope, main):
    """The JAX scope's persistables copied into the port's scope."""
    names = [v.name for v in main.list_vars() if v.persistable
             and jscope.find_var(v.name) is not None]
    params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in names}, tscope, "cpu")
    return names


def _run_pair(build, feed, steps=1, carry=True):
    """Build with both packages, check equal ProgramDescs, run ``steps``
    runs of each from the same state (the JAX startup's, carried), and
    return (jax fetches, port fetches, jax scope, port scope, names)."""
    (jm, js, jf), (tm, ts, tf) = _both(build)
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    names = _carry(jscope, tscope, jm) if carry else []
    for _ in range(steps):
        ja = jexe.run(jm, feed=feed, fetch_list=list(jf), scope=jscope)
        ta = texe.run(tm, feed=feed, fetch_list=list(tf), scope=tscope)
    return ja, ta, jscope, tscope, names


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


def _table(pkg, ids, is_sparse=True, padding_idx=None, name="table", vocab=VOCAB, init=None):
    init = init or pkg.initializer.Uniform(-1.0, 1.0, seed=7)
    return pkg.layers.embedding(ids, size=[vocab, DIM], is_sparse=is_sparse,
                                padding_idx=padding_idx,
                                param_attr=pkg.ParamAttr(name=name, initializer=init))


def _ids(pkg, n, name="ids"):
    return pkg.layers.data(name=name, shape=[n, 1], dtype="int64", append_batch_size=False)


# ------------------------------------------------------------- merged()

MERGE_CASES = {
    "duplicates": [5, 2, 2, 9, 5, 2, 0, 7],
    "height_minus_one": [11, 3, 11, 0, 3, 11],
    "all_equal": [4, 4, 4, 4],
    "one_id": [6],
    "all_unique": [0, 11, 5, 3],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merged_against_jax(case):
    """Unique ids ascending, padded to K with the height, bit-equal to the
    JAX package's; the segment sums within ATOL (an exact sum here: the
    rows are small integers)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JaxSelectedRows
    import jax.numpy as jnp
    ids = np.array(MERGE_CASES[case], np.int32)
    rows = np.random.RandomState(len(ids)).randint(-4, 5, (len(ids), 3)).astype(np.float32)
    want = JaxSelectedRows(jnp.asarray(ids), jnp.asarray(rows), VOCAB).merged()
    got = SelectedRows(torch.from_numpy(ids), torch.from_numpy(rows), VOCAB).merged()
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))
    assert got.ids.dtype == torch.int32 and got.height == VOCAB


def test_merged_hot_id_against_float64_and_jax():
    """A Zipf(1.3) batch of 2,048 ids (the hottest id over 500 of them):
    each slot's sum within 1e-6 relative of the float64 sum
    (merged() adds in float64 and rounds once), the ids bit-equal to the
    JAX package's and the rows within ATOL."""
    from paddle_tpu.core.selected_rows import SelectedRows as JaxSelectedRows
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    ids = np.minimum(rng.zipf(1.3, 2048) - 1, 999).astype(np.int32)
    rows = rng.standard_normal((2048, 16)).astype(np.float32)
    got = SelectedRows(torch.from_numpy(ids), torch.from_numpy(rows), 1000).merged()
    want = JaxSelectedRows(jnp.asarray(ids), jnp.asarray(rows), 1000).merged()
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows), atol=ATOL, rtol=1e-5)
    exact = np.zeros((1000, 16))
    np.add.at(exact, ids, rows.astype(np.float64))
    n = len(np.unique(ids))
    assert np.bincount(ids).max() > 500
    np.testing.assert_allclose(got.rows.numpy()[:n], exact[np.unique(ids)], rtol=1e-6,
                               atol=1e-6)
    assert not got.rows.numpy()[n:].any()


def test_merged_wide_dynamic_range_against_float64():
    """One column holding a hot id's rows near 1e4 and, after it in the
    sorted order, slots near 1e-6 (a running prefix some 1e13 times a
    small slot): each slot within float32 rounding of the float64 sum
    (``np.add.at``), as the JAX package's per-slot ``segment_sum`` is.
    A plain float64 prefix difference loses ~1e-9 of such a slot."""
    rng = np.random.default_rng(1)
    ids = np.concatenate([np.full(600, 2), rng.integers(3, 40, 200),
                          rng.integers(0, 2, 40)]).astype(np.int32)
    rng.shuffle(ids)
    rows = np.where(ids[:, None] == 2, rng.uniform(0.5e4, 1.5e4, (len(ids), 3)),
                    rng.uniform(0.5e-6, 1.5e-6, (len(ids), 3))).astype(np.float32)
    rows[ids >= 20, 1] *= -1                      # a sign change within the column
    got = SelectedRows(torch.from_numpy(ids), torch.from_numpy(rows), 50).merged()
    exact = np.zeros((50, 3))
    np.add.at(exact, ids, rows.astype(np.float64))
    uniq = np.unique(ids)
    np.testing.assert_array_equal(got.ids.numpy()[:len(uniq)], uniq)
    np.testing.assert_allclose(got.rows.numpy()[:len(uniq)], exact[uniq],
                               rtol=np.finfo(np.float32).eps, atol=0)
    assert not got.rows.numpy()[len(uniq):].any()


def test_merged_is_idempotent_and_dense_equal():
    ids = torch.tensor([3, 1, 3, 3, 0], dtype=torch.int32)
    rows = torch.randn(5, 2, generator=torch.Generator().manual_seed(0))
    sr = SelectedRows(ids, rows, 6)
    m = sr.merged()
    assert m.merged() is m and m.to(torch.float64).merged().ids is m.ids
    mm = SelectedRows(m.ids, m.rows, 6).merged()
    assert torch.equal(mm.ids, m.ids) and torch.equal(mm.rows, m.rows)
    dense = torch.zeros(6, 2).index_add_(0, ids.long(), rows)
    torch.testing.assert_close(m.to_dense(), dense, atol=1e-6, rtol=0)
    assert m.ids.tolist() == [0, 1, 3, 6, 6]


# ------------------------------------------------- the sparse gradient op

@pytest.mark.parametrize("padding_idx", [None, 3])
def test_sparse_grad_ids_and_densified_against_jax(padding_idx):
    """``lookup_table_grad`` with ``is_sparse``: ``extract_rows`` bit-equal
    (dedup at the source, padded with the height), the densified grad
    (``get_tensor_from_selected_rows``) and ``merge_selected_rows``' rows
    within ATOL of the JAX package's; the padding row's gradient is zero."""
    ids_np = np.array([[2], [2], [5], [3], [0], [5], [11]], np.int64)

    def build(pkg):
        ids = _ids(pkg, 7)
        emb = _table(pkg, ids, padding_idx=padding_idx)
        loss = pkg.layers.reduce_sum(emb * emb)
        pkg.append_backward(loss)
        block = pkg.default_main_program().global_block
        g = block.var("table@GRAD")
        assert g.type == "selected_rows"
        gids = block.create_var(name="gids", shape=(7,), dtype="int32")
        block.append_op("extract_rows", inputs={"X": g}, outputs={"Out": gids})
        dense = block.create_var(name="dense", shape=(VOCAB, DIM), dtype="float32")
        block.append_op("get_tensor_from_selected_rows", inputs={"X": g},
                        outputs={"Out": dense})
        merged = block.create_var(name="merged", shape=(VOCAB, DIM), dtype="float32",
                                  type="selected_rows")
        block.append_op("merge_selected_rows", inputs={"X": g}, outputs={"Out": merged})
        mids = block.create_var(name="mids", shape=(7,), dtype="int32")
        block.append_op("extract_rows", inputs={"X": merged}, outputs={"Out": mids})
        return [gids, dense, mids]

    ja, ta, _, tscope, _ = _run_pair(build, {"ids": ids_np})
    for got, want in zip(ta, ja):
        _close(got, want)
    assert ta[0].tolist() == [0, 2, 3, 5, 11, VOCAB, VOCAB]
    table = tscope.find_var("table").numpy()
    expect = np.zeros((VOCAB, DIM), np.float32)
    for i in ids_np[:, 0]:
        if i != padding_idx:
            expect[i] += 2.0 * table[i]
    np.testing.assert_allclose(ta[1], expect, atol=ATOL)


def test_fetched_selected_rows_stays_sparse():
    """A fetched SelectedRows comes back as one, its ids and rows on the
    host (numpy); ``return_numpy=False`` gives its tensors."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = _ids(pt, 3)
        loss = pt.layers.mean(_table(pt, ids))
        pt.append_backward(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"ids": np.array([[4], [1], [4]], np.int64)}
    (g,) = exe.run(main, feed=feed, fetch_list=["table@GRAD"], scope=scope)
    assert isinstance(g, SelectedRows) and isinstance(g.ids, np.ndarray)
    assert g.ids.tolist() == [1, 4, VOCAB] and g.height == VOCAB
    np.testing.assert_allclose(g.rows[:2], [[1 / 12] * DIM, [2 / 12] * DIM], rtol=1e-6)
    (t,) = exe.run(main, feed=feed, fetch_list=["table@GRAD"], scope=scope, return_numpy=False)
    assert isinstance(t, SelectedRows) and isinstance(t.rows, torch.Tensor)


# ------------------------------------------------------ the update rules

IDS = np.array([[1], [3], [3], [7]], dtype=np.int64)


def _train_port(is_sparse, make_opt, ids_np, steps=3, vocab=10):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = _ids(pt, len(ids_np))
        emb = _table(pt, ids, is_sparse, vocab=vocab, init=pt.initializer.Constant(1.0))
        loss = pt.layers.mean(emb)
        make_opt(pt).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed={"ids": ids_np}, fetch_list=[loss], scope=scope)
    return scope.find_var("table").numpy().copy()


OPTS = {"sgd": lambda pkg: pkg.optimizer.SGD(0.5),
        "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.1),
        "adagrad": lambda pkg: pkg.optimizer.Adagrad(learning_rate=0.5)}


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("ids_np", [IDS, np.array([[9], [4], [9], [9], [0], [4]], np.int64)],
                         ids=["dups", "height_minus_one"])
def test_sparse_update_against_dense_and_jax(opt, ids_np):
    """The port's sparse update against its dense one (every row for SGD;
    the touched rows for Adam and Adagrad, lazy Adam leaving the others
    bit-equal) and against the JAX package's sparse update, 3 steps; the
    second batch holds the last row (height - 1), the padded slots'
    target."""
    dense = _train_port(False, OPTS[opt], ids_np)
    sparse = _train_port(True, OPTS[opt], ids_np)
    touched = sorted(set(ids_np[:, 0].tolist()))
    if opt == "sgd":
        np.testing.assert_allclose(sparse, dense, rtol=1e-6)
    else:
        np.testing.assert_allclose(sparse[touched], dense[touched], rtol=1e-5)
    untouched = [r for r in range(10) if r not in touched]
    assert np.array_equal(sparse[untouched], np.ones((len(untouched), DIM), np.float32))

    def build(pkg):
        ids = _ids(pkg, len(ids_np))
        loss = pkg.layers.mean(_table(pkg, ids, vocab=10))
        OPTS[opt](pkg).minimize(loss)
        return [loss]

    ja, ta, jscope, tscope, names = _run_pair(build, {"ids": ids_np}, steps=3)
    for n in names:
        _close(tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)), STEP_ATOL)


def test_sparse_repeated_ids_sgd_bit_equal_to_dense():
    """A batch of one id repeated: the merged sum applied once, as the
    dense scatter-add applies it (powers of two keep both exact)."""
    ids_np = np.array([[4], [4], [4], [1], [4], [1], [4], [4]], dtype=np.int64)
    dense = _train_port(False, lambda pkg: pkg.optimizer.SGD(0.25), ids_np, vocab=12)
    sparse = _train_port(True, lambda pkg: pkg.optimizer.SGD(0.25), ids_np, vocab=12)
    np.testing.assert_array_equal(sparse, dense)


def test_sum_of_two_sparse_grads_of_one_table():
    """One table read twice: ``sum`` concatenates the two SelectedRows
    (duplicates kept) and SGD adds them; against the JAX package, and the
    summed gradient's type stays sparse."""
    def build(pkg):
        a, b = _ids(pkg, 3, "a"), _ids(pkg, 2, "b")
        ea, eb = _table(pkg, a), _table(pkg, b)
        loss = pkg.layers.elementwise_add(pkg.layers.reduce_sum(ea * ea),
                                          pkg.layers.reduce_mean(eb))
        pkg.optimizer.SGD(0.5).minimize(loss)
        types = [op.type for op in pkg.default_main_program().global_block.ops]
        assert "sum" in types
        return [loss]

    feed = {"a": np.array([[2], [5], [2]], np.int64), "b": np.array([[5], [11]], np.int64)}
    ja, ta, jscope, tscope, names = _run_pair(build, feed, steps=2)
    _close(ta[0], ja[0])
    _close(tscope.find_var("table").numpy(), np.asarray(jscope.find_var("table")), STEP_ATOL)


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_global_norm_clip_and_decay_on_a_sparse_grad(reg):
    """``GradientClipByGlobalNorm`` (the sparse grad's merged rows in the
    norm, ``sparse_scale_rows``) and an L1 / L2 decay of the touched rows
    (``sparse_weight_decay``) on a sparse table beside a dense fc, SGD:
    equal programs, 3 steps' parameters within STEP_ATOL of the JAX
    package's."""
    def build(pkg):
        ids = _ids(pkg, 5)
        emb = _table(pkg, ids)
        out = pkg.layers.fc(input=emb, size=3)
        loss = pkg.layers.reduce_sum(out * out)
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(clip_norm=0.5))
        decay = (pkg.regularizer.L1Decay if reg == "l1" else pkg.regularizer.L2Decay)(0.1)
        pkg.optimizer.SGD(0.25, regularization=decay).minimize(loss)
        types = [op.type for op in pkg.default_main_program().global_block.ops]
        assert "sparse_weight_decay" in types and "sparse_scale_rows" in types
        return [loss]

    feed = {"ids": np.array([[3], [7], [3], [11], [0]], np.int64)}
    ja, ta, jscope, tscope, names = _run_pair(build, feed, steps=3)
    _close(ta[0], ja[0], STEP_ATOL)
    for n in names:
        _close(tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)), STEP_ATOL)


@pytest.mark.parametrize("opt", ["momentum", "rmsprop", "adamax"])
def test_unsupported_sparse_optimizer_raises(opt):
    make = {"momentum": lambda pkg: pkg.optimizer.Momentum(0.1, momentum=0.9),
            "rmsprop": lambda pkg: pkg.optimizer.RMSProp(0.1),
            "adamax": lambda pkg: pkg.optimizer.Adamax(0.1)}[opt]
    with pytest.raises(NotImplementedError, match="sparse"):
        _train_port(True, make, IDS)


def test_sparse_updates_leave_the_multi_tensor_group(monkeypatch):
    """In a step with sparse and dense Adam updates, the multi-tensor call
    (K6 on the card) gets the dense parameters only, and the sparse table
    is updated all the same."""
    from paddle_tpu_torch.ops import optimizer_ops
    seen = []
    real = optimizer_ops.fused_adam_multi

    def spy(entries, *a, **kw):
        seen.append([tuple(e[0].shape) for e in entries])
        return real(entries, *a, **kw)

    monkeypatch.setattr(optimizer_ops, "fused_adam_multi", spy)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = _ids(pt, 4)
        loss = pt.layers.mean(pt.layers.fc(input=_table(pt, ids), size=3))
        pt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.find_var("table").clone()
    exe.run(main, feed={"ids": IDS}, fetch_list=[loss], scope=scope)
    assert seen == [[(DIM, 3), (3,)]]
    after = scope.find_var("table")
    assert not torch.equal(after[[1, 3, 7]], before[[1, 3, 7]])
    assert torch.equal(after[[0, 2, 4]], before[[0, 2, 4]])


def test_the_sparse_step_may_be_one_graph_and_verifies():
    """A DeepFM step with SelectedRows gradients has no graph blocker and
    the verifier finds nothing in it (``verify="error"``)."""
    from paddle_tpu_torch.analysis import verify
    from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
    main, startup, loss, feed = _deepfm_programs(pt, is_test=False)
    st_in, st_out = analyze_state(main.desc.block(0), list(feed))
    assert graph_blockers(main, st_in, st_out) == []
    result = verify(main, fetch_list=[loss], feed_names=list(feed))
    assert not result.findings, result.findings
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), validate="error")
    exe.run(startup, scope=scope)
    assert np.isfinite(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])


# ------------------------------------------------------------ other ops

def test_sigmoid_cross_entropy_with_logits_and_grad():
    x = np.random.RandomState(0).randn(6, 3).astype(np.float32) * 4
    label = (np.random.RandomState(1).rand(6, 3) < 0.4).astype(np.float32)

    def build(pkg):
        xv = pkg.layers.data(name="x", shape=[6, 3], dtype="float32",
                             append_batch_size=False, stop_gradient=False)
        lv = pkg.layers.data(name="label", shape=[6, 3], dtype="float32",
                             append_batch_size=False)
        out = pkg.layers.sigmoid_cross_entropy_with_logits(x=xv, label=lv)
        target = pkg.layers.reduce_sum(pkg.layers.scale(out, scale=1.5))
        return [out] + pkg.calc_gradient(target, [xv])

    ja, ta, _, _, _ = _run_pair(build, {"x": x, "label": label}, carry=False)
    for got, want in zip(ta, ja):
        _close(got, want)


def _op_program(pkg, op_type, feeds, outs, attrs=None, list_feeds=None):
    block = pkg.default_main_program().global_block
    ins = {}
    for slot, (name, arr) in feeds.items():
        pkg.layers.data(name=name, shape=list(arr.shape), dtype=str(arr.dtype),
                        append_batch_size=False)
        ins[slot] = [name]
    for slot, items in (list_feeds or {}).items():
        ins[slot] = []
        for name, arr in items:
            pkg.layers.data(name=name, shape=list(arr.shape), dtype=str(arr.dtype),
                            append_batch_size=False)
            ins[slot].append(name)
    out_map = {}
    for slot, names in outs.items():
        out_map[slot] = list(names)
        for n in names:
            block.create_var(name=n)
    block.append_op(op_type, inputs=ins, outputs=out_map, attrs=attrs or {})
    return [n for ns in outs.values() for n in ns]


def test_row_prefetch_and_gather_rows_against_jax():
    ids_np = np.array([[5], [2], [2], [9], [5], [2]], np.int64)
    w_np = np.arange(48, dtype=np.float32).reshape(12, 4)
    gids = np.array([1, 11, 12, 3], np.int32)

    def build(pkg):
        f = _op_program(pkg, "row_prefetch", {"Ids": ("ids", ids_np)},
                        {"Out": ["uniq"], "UniqueCount": ["cnt"]}, {"height": 16})
        return f + _op_program(pkg, "gather_rows", {"Ids": ("gids", gids), "W": ("w", w_np)},
                               {"Out": ["rows"]})

    ja, ta, _, _, _ = _run_pair(build, {"ids": ids_np, "w": w_np, "gids": gids}, carry=False)
    for got, want in zip(ta, ja):
        _close(got, want)
    assert ta[0].tolist() == [2, 5, 9, 16, 16, 16] and ta[1].tolist() == [3]
    np.testing.assert_array_equal(ta[2][2], np.zeros(4, np.float32))


def test_split_and_merge_ids_against_jax():
    """``split_ids`` to 3 shards (bit-equal), then ``merge_ids`` of the
    shards' rows back into the ids' order (duplicates positional)."""
    ids = np.array([[3], [7], [3], [0], [9], [2], [6]], np.int64)
    table = np.random.RandomState(8).randn(10, 4).astype(np.float32)

    def build(pkg):
        return _op_program(pkg, "split_ids", {"Ids": ("ids", ids)},
                           {"Out": ["s0", "s1", "s2"]})

    ja, ta, _, _, _ = _run_pair(build, {"ids": ids}, carry=False)
    for got, want in zip(ta, ja):
        _close(got, want)
    shards = [np.asarray(s).astype(np.int64) for s in ta]
    rows = [np.where((s >= 0), 1, 0)[:, :1] * table[np.clip(s[:, 0], 0, 9)] for s in shards]
    feed = {"ids2": ids}
    feed.update({f"si{s}": shards[s] for s in range(3)})
    feed.update({f"sr{s}": rows[s].astype(np.float32) for s in range(3)})

    def build2(pkg):
        return _op_program(pkg, "merge_ids", {"Ids": ("ids2", ids)}, {"Out": ["o"]},
                           list_feeds={"X": [(f"si{s}", shards[s]) for s in range(3)],
                                       "Rows": [(f"sr{s}", feed[f"sr{s}"]) for s in range(3)]})

    ja, ta, _, _, _ = _run_pair(build2, feed, carry=False)
    _close(ta[0], ja[0])
    np.testing.assert_allclose(ta[0], table[ids[:, 0]], rtol=1e-6)


def test_split_selected_rows_against_jax():
    """A sparse gradient split into row sections [0, 5) and [5, 12): each
    output's ids rebased (the others padded to the section's height) and
    densified, against the JAX package's."""
    ids_np = np.array([[1], [6], [4], [6], [11]], np.int64)

    def build(pkg):
        ids = _ids(pkg, 5)
        loss = pkg.layers.reduce_sum(_table(pkg, ids) * 3.0)
        pkg.append_backward(loss)
        block = pkg.default_main_program().global_block
        outs = []
        for i in range(2):
            block.create_var(name=f"part{i}", type="selected_rows")
        block.append_op("split_selected_rows", inputs={"X": block.var("table@GRAD")},
                        outputs={"Out": ["part0", "part1"]}, attrs={"height_sections": [5, 7]})
        for i, h in enumerate((5, 7)):
            ids_out = block.create_var(name=f"pids{i}", shape=(5,), dtype="int32")
            block.append_op("extract_rows", inputs={"X": f"part{i}"}, outputs={"Out": ids_out})
            dense = block.create_var(name=f"pdense{i}", shape=(h, DIM), dtype="float32")
            block.append_op("get_tensor_from_selected_rows", inputs={"X": f"part{i}"},
                            outputs={"Out": dense})
            outs += [ids_out, dense]
        return outs

    ja, ta, _, _, _ = _run_pair(build, {"ids": ids_np})
    for got, want in zip(ta, ja):
        _close(got, want)
    assert ta[0].tolist() == [1, 4, 5, 5, 5] and ta[2].tolist() == [7, 7, 1, 6, 7]


# ----------------------------------------------------------------- DeepFM

DEEPFM_VOCAB = [50, 30, 20]
DEEPFM_DIM = 4
DEEPFM_BATCH = 16


def _deepfm_programs(pkg, is_test=True):
    from importlib import import_module
    deepfm = import_module(f"{pkg.__name__}.models.deepfm")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids, dense, label = _deepfm_data(pkg)
        loss, _ = deepfm.train_network(ids, dense, label, DEEPFM_VOCAB,
                                       embed_dim=DEEPFM_DIM, is_test=is_test)
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss, _deepfm_feeds()[0]


def _deepfm_data(pkg):
    ids = [pkg.layers.data(name=f"C{i}", shape=[1], dtype="int64")
           for i in range(len(DEEPFM_VOCAB))]
    dense = pkg.layers.data(name="dense", shape=[13], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="float32")
    return ids, dense, label


def _deepfm_feeds(n=1):
    from paddle_tpu_torch.models.deepfm import synthetic_feed
    feeds = [synthetic_feed(5 + s, DEEPFM_BATCH, DEEPFM_VOCAB) for s in range(n)]
    feeds[0]["C0"][0, 0] = DEEPFM_VOCAB[0] - 1      # the last row of a table
    return feeds


def _dense_grad(g, shape):
    """A fetched gradient as a dense array (a SelectedRows of either
    package added into zeros)."""
    if isinstance(g, np.ndarray) and g.dtype == object:
        g = g.item()                            # the JAX package's SelectedRows
    if isinstance(g, (SelectedRows,)) or hasattr(g, "height"):
        ids, rows = np.asarray(g.ids), np.asarray(g.rows)
        out = np.zeros(shape, np.float32)
        ok = (ids >= 0) & (ids < g.height)
        np.add.at(out, ids[ok], rows[ok])
        return out
    return np.asarray(g)


def test_deepfm_against_jax():
    """DeepFM (3 fields, embed 4, 400-400-400): equal ProgramDescs, the
    step-1 loss and every step-1 gradient (the 6 sparse tables' densified)
    within ATOL, 3 Adam steps' losses within ATOL and every persistable
    within STEP_ATOL of the JAX package's; the table rows no batch touched
    never moved."""
    jm, js, jl, _ = _deepfm_programs(fluid)
    tm, ts, tl, _ = _deepfm_programs(pt)
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    sparse = [v.name for v in tm.list_vars() if v.type == "selected_rows"]
    assert len(sparse) == 2 * len(DEEPFM_VOCAB)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    names = _carry(jscope, tscope, jm)
    params = [p.name for p in tm.global_block.all_parameters()]
    start = {n: tscope.find_var(n).clone() for n in params}
    feeds = _deepfm_feeds(3)
    fetch = [tl.name] + [p + "@GRAD" for p in params]
    for step, feed in enumerate(feeds):
        ja = jexe.run(jm, feed=feed, fetch_list=fetch if step == 0 else [jl], scope=jscope)
        ta = texe.run(tm, feed=feed, fetch_list=fetch if step == 0 else [tl], scope=tscope)
        _close(ta[0], ja[0])
        for n, a, b in zip(params, ta[1:], ja[1:]):
            shape = tuple(start[n].shape)
            _close(_dense_grad(a, shape), _dense_grad(b, shape))
    for n in names:
        _close(tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)), STEP_ATOL)
    for i, v in enumerate(DEEPFM_VOCAB):
        hit = {int(r) for f in feeds for r in f[f"C{i}"][:, 0]}
        rest = [r for r in range(v) if r not in hit]
        for name in (f"fm_w1_{i}", f"fm_emb_{i}"):
            assert torch.equal(tscope.find_var(name)[rest], start[name][rest]), name


def test_deepfm_training_program_keeps_dropout_and_shares_the_backward():
    """``is_test=False`` (the card's training run) adds the three dropouts
    and their grads and nothing else; the sparse tables' gradients are the
    same op types."""
    test_main = _deepfm_programs(pt, is_test=True)[0]
    train_main = _deepfm_programs(pt, is_test=False)[0]
    a = [o.type for o in test_main.desc.block(0).ops]
    b = [o.type for o in train_main.desc.block(0).ops if not o.type.startswith("dropout")]
    assert a == b
    assert sum(o.type == "dropout" for o in train_main.desc.block(0).ops) == 3


def test_deepfm_criteo_widths_and_feed():
    """The Criteo cardinalities (26 fields, 33,762,577 rows) and the
    synthetic feed's ranges (Zipf ids clipped to each field)."""
    from paddle_tpu_torch.models.deepfm import CRITEO_VOCAB, synthetic_feed
    assert len(CRITEO_VOCAB) == 26 and sum(CRITEO_VOCAB) == 33_762_577
    feed = synthetic_feed(0, 2048)
    for i, v in enumerate(CRITEO_VOCAB):
        ids = feed[f"C{i}"]
        assert ids.shape == (2048, 1) and ids.min() >= 0 and ids.max() <= v - 1
    assert feed["dense"].shape == (2048, 13) and feed["label"].shape == (2048, 1)
    assert 0 < feed["label"].mean() < 0.5
    with pytest.raises(NotImplementedError, match="item 12"):
        from paddle_tpu_torch.models import deepfm
        with pt.program_guard(pt.Program(), pt.Program()):
            ids, dense, label = deepfm.data_layers(3)
            deepfm.deepfm(ids, dense, [5, 5, 5], shard_tables=True)
