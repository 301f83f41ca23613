"""The port's executable cache (``paddle_tpu_torch/core/executor.py``) on
the CPU, against the JAX package's ``Executor``.

A 2+2-layer transformer (vocab 1000, d_model 64, 4 heads, d_inner 256,
max_len 32) is built by both packages under ``unique_name.guard()``.  The
same sequence of runs (buckets 1, 2, 1, 4, then a program edit that moves
the version, then a new fetch list) gives equal cache counts in both
executors.  ``precompile`` leaves the scope bit-equal; the fingerprint is
stable across executors and keyed on what changes the entry; a rebound
scope tensor misses and an in-place update hits (a training step updates
in place); the startup program, an Adam step, dropout and the serving
program are classified; warmups give one
record per bucket; served logits stay within ``LOGIT_ATOL`` of the JAX
``Inferencer``.  The CPU has no CUDA graph and no pinned memory: the
entries exist and count as on the card, and lower the block op by op.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.core.executor import RECOMPILE_WARN_THRESHOLD
from paddle_tpu_torch.core import staging
from paddle_tpu_torch.core.staging import (COUNTERS, PINNED_HANDOUT, FetchHandle,
                                           prefetch_to_host)
from paddle_tpu_torch.models import transformer as pt_transformer

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER = 1000, 64, 4, 256, 32, 2
# float32 through 4 layers, different summation orders (XLA vs torch CPU):
# tests/test_torch_serving.py's tolerance
LOGIT_ATOL = 1e-4
SPECS = {"src": ((T, 1), "int64"), "trg": ((T, 1), "int64"),
         "src@SEQ_LEN": ((), "int32"), "trg@SEQ_LEN": ((), "int32")}
RECORD_KEYS = {"fingerprint", "kind", "compile_s", "aot", "reasons"}
COUNT_KEYS = ("executables", "compile_count", "hits", "misses", "runs")


def _model(pkg, mod):
    def infer_func():
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        return mod.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                               d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                               is_test=True)
    return infer_func


def _programs(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = _model(pkg, mod)()
    return main, startup, out


def _feed(rs, rows):
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(1, T + 1, rows)
        ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        ids[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens.astype(np.int32)
    return feed


@pytest.fixture(scope="module")
def inferencers():
    """(JAX Inferencer, port Inferencer on the CPU with the JAX weights)."""
    jax_inf = fluid.Inferencer(infer_func=_model(fluid, jax_transformer))
    pt_inf = pt.Inferencer(_model(pt, pt_transformer), place=pt.CPUPlace())
    params = {v.name: np.asarray(jax_inf.scope.find_var(v.name))
              for v in jax_inf.inference_program.list_vars() if v.persistable}
    pt.params_from_numpy(params, pt_inf.scope, "cpu")
    return jax_inf, pt_inf


def _counts(exe):
    info = exe.cache_info()
    return {k: info[k] for k in COUNT_KEYS}


# ----------------------------------------------------------- the counts


def test_cache_counts_equal_the_jax_executor():
    """Startup, buckets 1, 2, 1, 4, a program edit (a ``scale`` op appended:
    the version moves), then a new fetch list: after every run both
    executors hold the same number of entries, compiles, hits, misses and
    runs."""
    runs = []
    for pkg, mod in ((fluid, jax_transformer), (pt, pt_transformer)):
        main, startup, out = _programs(pkg, mod)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        rs = np.random.RandomState(0)
        seen = [_counts(exe)]
        for rows in (1, 2, 1, 4):
            exe.run(main, feed=_feed(rs, rows), fetch_list=[out], scope=scope)
            seen.append(_counts(exe))
        version = main.desc.version
        with pkg.program_guard(main, startup):
            doubled = pkg.layers.scale(out, scale=2.0, name="doubled")
        assert main.desc.version > version
        exe.run(main, feed=_feed(rs, 1), fetch_list=[out], scope=scope)
        seen.append(_counts(exe))
        got = exe.run(main, feed=_feed(rs, 1), fetch_list=[out, doubled], scope=scope)
        seen.append(_counts(exe))
        np.testing.assert_allclose(got[1], 2.0 * got[0], rtol=1e-6)
        runs.append(seen)
    jax_seen, pt_seen = runs
    assert pt_seen == jax_seen
    assert pt_seen[-1] == {"executables": 6, "compile_count": 6, "hits": 1, "misses": 6,
                           "runs": 7}


def test_pipeline_counters_follow_the_executor():
    main, startup, out = _programs(pt, pt_transformer)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    before = COUNTERS.snapshot()
    exe.run(startup, scope=scope)
    feed = _feed(np.random.RandomState(1), 2)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    after = COUNTERS.snapshot()
    moved = {k: after[k] - before[k] for k in ("compiles", "cache_hits", "cache_misses")}
    assert moved == {"compiles": 2, "cache_hits": 2, "cache_misses": 2}
    info = exe.cache_info()
    assert exe.compile_count == info["compile_count"] == info["fresh_compiles"] == 2
    assert (info["hits"], info["misses"], exe.run_count, info["captures"]) == (2, 2, 4, 0)


def test_recompile_warning_fires_once_per_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3])
        y = pt.layers.scale(x, scale=3.0)
    exe = pt.Executor(pt.CPUPlace())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for rows in range(1, RECOMPILE_WARN_THRESHOLD + 3):
            exe.run(main, feed={"x": np.ones((rows, 3), np.float32)}, fetch_list=[y],
                    scope=pt.Scope())
    hits = [w for w in caught if "distinct cache entries" in str(w.message)]
    assert len(hits) == 1 and exe.compile_count == RECOMPILE_WARN_THRESHOLD + 2


# ------------------------------------------------------------ precompile


def test_precompile_reads_the_scope_and_returns_the_reference_keys(inferencers):
    jax_inf, pt_inf = inferencers
    names = sorted(pt_inf.scope._vars)
    before = {n: pt_inf.scope.find_var(n).clone() for n in names
              if isinstance(pt_inf.scope.find_var(n), torch.Tensor)}
    feed = {k: ((3,) + s, d) for k, (s, d) in SPECS.items()}
    rec = pt_inf.exe.precompile(pt_inf.inference_program, feed=feed,
                                fetch_list=pt_inf.predict_vars, scope=pt_inf.scope)
    ref = jax_inf.exe.precompile(jax_inf.inference_program, feed=feed,
                                 fetch_list=jax_inf.predict_vars, scope=jax_inf.scope)
    assert set(rec) == set(ref) == RECORD_KEYS
    assert sorted(pt_inf.scope._vars) == names
    for n, v in before.items():
        assert torch.equal(pt_inf.scope.find_var(n), v), n
    assert rec["kind"] == "eager" and rec["aot"] is False
    assert rec["reasons"] == ["the CPU runs the block op by op"]


def test_executable_fingerprint_is_the_same_for_two_executors():
    main, startup, out = _programs(pt, pt_transformer)
    feed = {k: ((2,) + s, d) for k, (s, d) in SPECS.items()}
    fps = []
    for _ in range(2):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        fps.append(exe.precompile(main, feed=feed, fetch_list=[out], scope=scope)["fingerprint"])
    assert fps[0] == fps[1] and len(fps[0]) == 40


@pytest.mark.parametrize("change", ["feed_shape", "fetch_list", "amp", "kernels"])
def test_executable_fingerprint_moves_with_what_changes_the_entry(change):
    main, startup, out = _programs(pt, pt_transformer)
    feed = {k: ((2,) + s, d) for k, (s, d) in SPECS.items()}
    kw = {"amp": pt.amp.AmpConfig(bf16=False, quant=True)} if change == "amp" else \
        {"kernels": True} if change == "kernels" else {}
    fetch = [out, "src@SEQ_LEN"] if change == "fetch_list" else [out]
    if change == "feed_shape":
        changed_feed = {k: ((4,) + s, d) for k, (s, d) in SPECS.items()}
    else:
        changed_feed = feed
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    base = pt.Executor(pt.CPUPlace()).precompile(main, feed=feed, fetch_list=[out], scope=scope)
    other = pt.Executor(pt.CPUPlace(), **kw).precompile(main, feed=changed_feed,
                                                        fetch_list=fetch, scope=scope)
    assert other["fingerprint"] != base["fingerprint"]


# ------------------------------------------------------------ the state key


def test_rebound_scope_tensor_misses_and_in_place_update_hits():
    main, startup, out = _programs(pt, pt_transformer)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feed(np.random.RandomState(2), 2)
    (first,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    w = scope.find_var("fc_0.w_0")
    w.mul_(1.5)                                   # the same tensor: a hit
    (in_place,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert _hits_misses(exe) == (1, 2)
    assert not np.array_equal(in_place, first)
    fresh = pt.Executor(pt.CPUPlace())
    np.testing.assert_array_equal(fresh.run(main, feed=feed, fetch_list=[out], scope=scope)[0],
                                  in_place)
    scope.set_var("fc_0.w_0", w.clone())          # a new tensor: a miss
    (rebound,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert _hits_misses(exe) + (exe.compile_count,) == (1, 3, 3)
    # the new entry replaced the one it differs from by an address only
    assert exe.cache_info()["executables"] == 2
    np.testing.assert_array_equal(rebound, in_place)


def test_a_training_program_keys_its_state_by_shape():
    """An Adam step updates every parameter, moment and power in place: its
    entry keys the state by shape, dtype and address, the addresses stay,
    so every step after the first hits."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        loss = pt.layers.mean(pt.layers.fc(input=x, size=4))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(3).randn(5, 8).astype(np.float32)}
    addrs = {n: v.data_ptr() for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(3)]
    assert losses[2] < losses[0]
    assert _hits_misses(exe) == (2, 2)
    assert {n: v.data_ptr() for n, v in scope._vars.items()
            if isinstance(v, torch.Tensor)} == addrs


def test_evaluating_between_training_steps_keeps_one_entry_a_program():
    """A forward-only clone run on the scope after each Adam step (which
    updates every parameter in place) hits after its first run: the cache
    holds three entries however many steps run, and the evaluation reads
    each step's parameters.  The control: two scopes each keep their own
    entry."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        loss = pt.layers.mean(pt.layers.fc(input=x, size=4))
        test = main.clone()
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(6).randn(5, 8).astype(np.float32)}
    sizes, evals = [], []
    for _ in range(4):
        (train_loss,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        (eval_loss,) = exe.run(test, feed=feed, fetch_list=[loss.name], scope=scope)
        sizes.append(exe.cache_info()["executables"])
        evals.append(float(eval_loss))
    assert sizes == [3, 3, 3, 3] and _hits_misses(exe) == (6, 3)
    assert evals[3] < evals[0]
    (fresh,) = pt.Executor(pt.CPUPlace()).run(test, feed=feed, fetch_list=[loss.name],
                                              scope=scope)
    assert float(fresh) == evals[3]
    other = pt.Scope()
    exe.run(startup, scope=other)
    exe.run(test, feed=feed, fetch_list=[loss.name], scope=other)
    assert exe.cache_info()["executables"] == 4


def _hits_misses(exe):
    info = exe.cache_info()
    return info["hits"], info["misses"]


# ------------------------------------------------------- classification


def _entry(exe):
    return exe.cache_info()["entries"][-1]


def test_startup_adam_step_and_serving_program_are_classified():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        loss = pt.layers.mean(pt.layers.fc(input=x, size=4))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    startup_entry = _entry(exe)
    exe.run(main, feed={"x": np.ones((2, 8), np.float32)}, fetch_list=[loss], scope=scope)
    adam_entry = _entry(exe)
    serve_main, serve_startup, out = _programs(pt, pt_transformer)
    exe.run(serve_startup, scope=scope)
    exe.run(serve_main, feed=_feed(np.random.RandomState(4), 1), fetch_list=[out], scope=scope)
    serve_entry = _entry(exe)

    assert (startup_entry["kind"], startup_entry["graph_eligible"]) == ("eager", False)
    # the startup program creates every parameter, moment and power; its
    # random draws do not keep it from a graph
    (init,) = startup_entry["reasons"]
    assert init.startswith("initializes state (") and "vars: " in init
    # an Adam step writes only state it reads: it may be one graph
    assert (adam_entry["kind"], adam_entry["graph_eligible"]) == ("eager", True)
    assert adam_entry["reasons"] == ["the CPU runs the block op by op"]
    assert (serve_entry["kind"], serve_entry["graph_eligible"]) == ("eager", True)
    assert serve_entry["reasons"] == ["the CPU runs the block op by op"]


@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_blocks_a_graph_only_where_it_draws(is_test):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        y = pt.layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(main, feed={"x": np.ones((2, 8), np.float32)}, fetch_list=[y], scope=pt.Scope())
    entry = _entry(exe)
    # a drawing dropout is captured with the executor's generator registered
    # with its graph; either way the CPU runs it op by op
    assert entry["graph_eligible"] is True
    assert entry["reasons"] == ["the CPU runs the block op by op"]


# ---------------------------------------------------------------- warmup


def test_inferencer_warmup_gives_one_precompile_record_per_bucket(inferencers):
    jax_inf, pt_inf = inferencers
    compiles = pt_inf.exe.compile_count
    report = pt_inf.warmup((1, 2, 4), feed_specs=SPECS)
    ref = jax_inf.warmup((1, 2, 4), feed_specs=SPECS)
    assert [r["batch_size"] for r in report] == [r["batch_size"] for r in ref] == [1, 2, 4]
    for r in report:
        assert set(r) == RECORD_KEYS | {"batch_size", "seconds"} and r["seconds"] >= 0
        assert (r["kind"], r["aot"]) == ("eager", False)
    assert pt_inf.exe.compile_count <= compiles + 3
    again = pt_inf.warmup((1, 2, 4), feed_specs=SPECS)        # every bucket hits
    assert [r["fingerprint"] for r in again] == [r["fingerprint"] for r in report]


def test_session_warmup_report_has_one_record_per_bucket():
    def infer_func():
        x = pt.layers.data(name="x", shape=[4])
        return pt.layers.fc(input=x, size=3, act="relu")

    with pt.ServingSession(infer_func=infer_func, place=pt.CPUPlace(),
                           max_batch_size=8) as sess:
        report = sess.warmup_report
        assert [r["batch_size"] for r in report] == [1, 2, 4, 8]
        assert all(set(r) == RECORD_KEYS | {"batch_size", "seconds"} for r in report)
        exe = sess.inferencer.exe
        compiles = exe.compile_count
        (out,) = sess.infer({"x": np.ones((3, 4), np.float32)})
        assert out.shape == (3, 3) and exe.compile_count == compiles


def test_served_logits_equal_the_jax_inferencer(inferencers):
    """Requests through a warmed ServingSession (every bucket's entry built
    before the engine thread starts), from 4 threads, each within
    LOGIT_ATOL of the JAX Inferencer on the same rows; serving builds no
    entry."""
    jax_inf, pt_inf = inferencers
    pt_inf.warmup((1, 2, 4), feed_specs=SPECS)
    compiles = pt_inf.exe.compile_count
    rs = np.random.RandomState(5)
    reqs = [_feed(rs, 1 + i % 2) for i in range(8)]
    results, errors = [None] * 8, []
    with pt.ServingSession(inferencer=pt_inf, max_batch_size=4, max_wait_ms=10.0,
                           warmup=False) as sess:
        def client(t):
            try:
                for i in range(2 * t, 2 * t + 2):
                    (results[i],) = sess.infer(reqs[i], timeout=60)
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    assert pt_inf.exe.compile_count == compiles
    for req, got in zip(reqs, results):
        (want,) = jax_inf.infer(req)
        np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------- the fetches


def test_fetch_handle_reads_like_the_reference_on_the_cpu():
    t = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    h = FetchHandle(t)
    assert prefetch_to_host([h]) == 0                 # a CPU tensor is read as it is
    assert h.ready() and h.block() is h and h.value is t
    assert len(h) == 3 and list(h[1]) == [2.0, 3.0]
    assert [list(r) for r in h] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    assert h.shape == (3, 2) and h.dtype == torch.float32
    one = FetchHandle(torch.tensor(7.5))
    assert one.item() == 7.5 and float(one) == 7.5
    b = FetchHandle(torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    assert b.numpy().dtype == np.float32 and list(b.numpy()) == [1.5, -2.0]


def test_pinned_handout_is_bounded(monkeypatch):
    """Handles marked as holding a pinned buffer (the card's path; the
    CPU's tensors stand in for the buffers) hand out arrays over it until
    the bytes held would pass the limit; past it the value is copied out
    and the handle drops its buffer.  The bytes held go back when every
    array over a buffer is gone."""
    monkeypatch.setattr(staging, "PINNED_HANDOUT_LIMIT", 3000)
    before = PINNED_HANDOUT.snapshot()

    def pinned_handle(n):
        h = FetchHandle(torch.arange(n, dtype=torch.float32))
        h._pinned = True
        return h

    first, second = pinned_handle(300), pinned_handle(300)   # 1200 bytes: 2048-byte blocks
    buf = first.value
    a = first.numpy()
    assert a.ctypes.data == buf.data_ptr() and first.value is buf
    assert PINNED_HANDOUT.snapshot()["bytes"] == before["bytes"] + 2048
    view = a[10:20]
    buf2 = second.value
    b = second.numpy()                      # 4096 > 3000: copied out
    assert not np.shares_memory(b, buf2.numpy()) and list(b[:3]) == [0.0, 1.0, 2.0]
    assert second.value is not buf2 and second.value.data_ptr() == b.ctypes.data
    assert PINNED_HANDOUT.snapshot()["copies"] == before["copies"] + 1
    del a, first
    assert PINNED_HANDOUT.snapshot()["bytes"] == before["bytes"] + 2048   # the view holds it
    del view
    assert PINNED_HANDOUT.snapshot()["bytes"] == before["bytes"]
    third = pinned_handle(300)
    assert np.shares_memory(third.numpy(), third.value.numpy())


def test_batch_mates_reading_one_handle_past_the_limit_copy_once(monkeypatch):
    """Eight threads read one handle at once (a batch's requests), past the
    limit: one copy is made and every thread gets that array."""
    monkeypatch.setattr(staging, "PINNED_HANDOUT_LIMIT", 0)
    h = FetchHandle(torch.arange(1 << 22, dtype=torch.float32))
    h._pinned = True
    copies = PINNED_HANDOUT.snapshot()["copies"]
    barrier, got = threading.Barrier(8), [None] * 8

    def read(i):
        barrier.wait(timeout=30)
        got[i] = h.numpy()

    threads = [threading.Thread(target=read, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert all(a is got[0] for a in got) and got[0][-1] == (1 << 22) - 1
    assert PINNED_HANDOUT.snapshot()["copies"] == copies + 1


def test_run_returns_tensors_handles_or_arrays_on_the_cpu():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3])
        y = pt.layers.scale(x, scale=2.0)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    (a,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    (t,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope, return_numpy=False)
    (h,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope, sync=False)
    assert isinstance(a, np.ndarray) and isinstance(t, torch.Tensor)
    assert isinstance(h, FetchHandle)
    np.testing.assert_array_equal(a, 2 * feed["x"])
    np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(h.numpy(), a)


def test_every_kernel_counter_is_read_around_a_capture():
    """``build.launch_counters()`` lists every counter a kernel wrapper
    keeps, so a capture can set each back and each replay add it."""
    from paddle_tpu_torch.ops.cuda import (build, embedding, flash_attention,
                                           fused_optimizer, int8_matmul, linear_ce)
    listed = {(w, a) for w, a in build.launch_counters()}
    found = set()
    for mod in (embedding, flash_attention, fused_optimizer, int8_matmul, linear_ce):
        for fn in vars(mod).values():
            for attr in ("launches", "bf16_launches"):
                if callable(fn) and isinstance(getattr(fn, attr, None), int):
                    found.add((fn, attr))
    assert found and found == listed
