"""The port's data path on the CPU, held against the JAX package's: RecordIO
(``paddle_tpu_torch/recordio.py`` and its C++ scanners), the in-graph
readers (``layers.py_reader`` / ``open_files`` / ``read_file`` and the
executor's ``read`` binding), ``reader.DeviceLoader``, the ``auc`` op and
``metrics.py``.

- RecordIO: a file written by either package (native or Python writer) is
  byte-equal to the other's and scans the same in both, with either
  scanner; corruption raises in both; ``parallel_scan`` yields every
  record once (one thread: the sequential order); the byte queue;
  ``scans()`` names the scanner that ran.
- In-graph readers: both packages build the same program (equal
  ProgramDescs), the JAX startup's parameters carried into the port's
  scope, and train over the same batches: the losses within
  ``LOSS_RTOL``, two passes through ``EOFException`` / ``reset()``;
  ragged outputs, two readers kept aligned on EOF, the fail-fast cases, an
  error mid-pass, ``open_files``' tail batch.
- ``DeviceLoader`` on the CPU yields CPU tensors equal to the reader's
  batches, in order, and relays the reader's error.
- ``auc`` against the JAX lowering (``AUC_ATOL``) and a float64 numpy
  trapezoid; the ``metrics`` classes equal to the JAX package's and to
  the references ``tests/test_metrics_classes.py`` holds them to.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import metrics as jax_metrics
from paddle_tpu import recordio as jax_recordio
from paddle_tpu_torch import metrics, recordio
from paddle_tpu_torch.reader import DeviceLoader

from _torch_validate import _no_port_validate_findings  # noqa: F401
from test_torch_cnn_ops import descs_equal

# losses of the same SGD steps, XLA against torch: float32 sums in other orders
LOSS_RTOL = 1e-5
# the auc op: float32 rates and trapezoid, XLA against torch and float64
AUC_ATOL = 1e-6


# ------------------------------------------------------------- RecordIO

def _records(n=37, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.bytes(int(rs.randint(0, 40))) for _ in range(n)]


@pytest.mark.parametrize("writer", ["pt_native", "pt_python", "jax_native", "jax_python"])
def test_recordio_bytes_both_ways(tmp_path, writer):
    recs = _records()
    paths = {}
    for name, mod, native in (("pt_native", recordio, True), ("pt_python", recordio, False),
                              ("jax_native", jax_recordio, True),
                              ("jax_python", jax_recordio, False)):
        paths[name] = str(tmp_path / f"{name}.rio")
        with mod.Writer(paths[name], max_chunk_bytes=100, use_native=native) as w:
            for r in recs:
                w.write(r)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert all(d == data[writer] for d in data.values())
    for mod in (recordio, jax_recordio):
        for native in (True, False):
            assert list(mod.scan(paths[writer], use_native=native)) == recs


@pytest.mark.parametrize("damage", ["crc", "magic", "truncated"])
def test_recordio_corruption_raises_in_both(tmp_path, damage):
    p = tmp_path / "bad.rio"
    with recordio.Writer(str(p), max_chunk_bytes=64) as w:
        for r in _records(12):
            w.write(r)
    b = bytearray(p.read_bytes())
    if damage == "crc":
        b[20] ^= 0xFF
    elif damage == "magic":
        b[0] ^= 0xFF
    else:
        b = b[:-3]
    p.write_bytes(bytes(b))
    for mod in (recordio, jax_recordio):
        for native in (True, False):
            with pytest.raises(IOError):
                list(mod.scan(str(p), use_native=native))
    with pytest.raises(IOError):
        list(recordio.parallel_scan([str(p)], num_threads=1))


def _shards(tmp_path, nfiles=4, per_file=50):
    paths, want = [], []
    for i in range(nfiles):
        p = str(tmp_path / f"part-{i}.rio")
        with recordio.Writer(p, max_chunk_bytes=128) as w:
            for j in range(per_file):
                rec = f"file{i}-rec{j}".encode()
                w.write(rec)
                want.append(rec)
        paths.append(p)
    return paths, want


def test_parallel_scan_every_record_once_and_one_thread_in_order(tmp_path):
    paths, want = _shards(tmp_path)
    recordio.reset_scans()
    got = list(recordio.parallel_scan(paths, num_threads=3))
    assert sorted(got) == sorted(want) and len(got) == len(want)
    assert recordio.scans() == {"native": len(want), "python": 0}
    assert list(recordio.parallel_scan(paths, num_threads=1)) == want == \
        list(jax_recordio.parallel_scan(paths, num_threads=1))
    assert list(recordio.parallel_scan([], num_threads=2)) == []
    it = recordio.parallel_scan(paths, num_threads=3, capacity=4)
    assert next(it)
    it.close()                        # returns promptly: the workers stop


def test_parallel_reader_reads_the_flags_default(tmp_path):
    from paddle_tpu_torch.flags import FLAGS
    paths, want = _shards(tmp_path, nfiles=2, per_file=8)
    old = FLAGS.paddle_num_threads
    try:
        FLAGS.paddle_num_threads = 2
        assert sorted(recordio.parallel_reader_creator(paths)()) == sorted(want)
    finally:
        FLAGS.paddle_num_threads = old


def test_scans_name_the_scanner_and_native_true_refuses_without_it(tmp_path, monkeypatch):
    paths, want = _shards(tmp_path, nfiles=1, per_file=9)
    recordio.reset_scans()
    assert list(recordio.reader_creator(paths[0])()) == want
    assert list(recordio.scan(paths[0], use_native=False)) == want
    assert recordio.scans() == {"native": 9, "python": 9}
    monkeypatch.setattr(recordio, "native_library", lambda name="recordio": None)
    with pytest.raises(RuntimeError, match="native recordio unavailable"):
        list(recordio.scan(paths[0], use_native=True))
    recordio.reset_scans()
    assert list(recordio.parallel_scan(paths)) == want          # the Python chain
    assert recordio.scans() == {"native": 0, "python": 9}


def test_native_byte_queue():
    q = recordio.NativeByteQueue(capacity=8)
    want = {f"item-{i}-{j}".encode() for i in range(3) for j in range(20)}

    def producer(i):
        for j in range(20):
            assert q.push(f"item-{i}-{j}".encode())
    ts = [threading.Thread(target=producer, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    got = {q.pop(timeout_ms=5000) for _ in range(len(want))}
    for t in ts:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in ts) and got == want
    q.close()
    assert q.pop() is None
    q = recordio.NativeByteQueue(capacity=1)
    with pytest.raises(TimeoutError):
        q.pop(timeout_ms=50)
    q.push(b"x")
    with pytest.raises(TimeoutError):
        q.push(b"y", timeout_ms=50)
    q.close()
    assert q.pop() == b"x" and q.pop() is None and q.push(b"z") is False


# ------------------------------------------------------ in-graph readers

def _run_readers(build, passes=1, start=True):
    """``build(pkg)`` returns (readers, fetch vars) in fresh programs and a
    fresh scope of each package; both run ``passes`` passes (each reader
    started, steps until ``EOFException``, each reset).  Returns (JAX
    fetches, port fetches) by step, and the port's (exe, main, scope)."""
    out, start_params = {}, None
    for pkg in (fluid, pt):
        main, startup, scope = pkg.Program(), pkg.Program(), pkg.Scope()
        with pkg.scope_guard(scope), pkg.unique_name.guard(), pkg.program_guard(main, startup):
            readers, fetch = build(pkg)
        out[pkg] = {"main": main, "startup": startup, "scope": scope, "fetch": []}
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        params = [p.name for p in main.global_block.all_parameters()]
        if pkg is fluid:
            start_params = {n: np.array(scope.find_var(n)) for n in params}
        else:
            pt.params_from_numpy(start_params, scope, "cpu")
        out[pkg]["exe"] = exe
        for _ in range(passes):
            if start:
                for r in readers:
                    r.start()
            while True:
                try:
                    got = exe.run(main, fetch_list=fetch, scope=scope)
                except pkg.EOFException:
                    for r in readers:
                        r.reset()
                    break
                out[pkg]["fetch"].append([np.asarray(a) for a in got])
    descs_equal(out[fluid]["main"], out[pt]["main"])
    return out[fluid]["fetch"], out[pt]["fetch"], out[pt]


def _regression_batches(n=12, seed=1):
    w = np.random.RandomState(0).randn(6, 1).astype(np.float32)

    def data():
        r = np.random.RandomState(seed)
        for _ in range(n):
            xs = r.randn(8, 6).astype(np.float32)
            yield xs, xs @ w
    return data


def test_py_reader_trains_two_passes_as_jax():
    def build(pkg):
        reader = pkg.layers.py_reader(capacity=4, shapes=[[-1, 6], [-1, 1]],
                                      dtypes=["float32", "float32"])
        x, y = pkg.layers.read_file(reader)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            input=pkg.layers.fc(input=x, size=1), label=y))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
        reader.decorate_paddle_reader(_regression_batches())
        return [reader], [loss]
    ref, got, port = _run_readers(build, passes=2)
    assert len(got) == len(ref) == 24
    np.testing.assert_allclose([g[0] for g in got], [r[0] for r in ref], rtol=LOSS_RTOL)
    assert got[-1][0] < got[0][0]
    # the read op is bound by the executor: its reader is no state, and the
    # step is a cache entry like a fed one (on the card: one graph)
    from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
    main = port["main"]
    st_in, st_out = analyze_state(main.desc.block(0), [])
    reader_var = main.desc.block(0).ops[0].input("Reader")[0]
    assert main.desc.block(0).ops[0].type == "read" and reader_var not in st_in
    assert graph_blockers(main, st_in, st_out) == []
    (entry,) = [e for e in port["exe"].cache_info()["entries"] if e["feeds"]]
    assert sorted(entry["feeds"]) == sorted(main.desc.block(0).ops[0].output("Out"))


def test_py_reader_ragged_outputs_as_jax():
    xs = np.arange(30, dtype=np.float32).reshape(2, 5, 3)
    lens = np.array([2, 4], np.int32)

    def build(pkg):
        reader = pkg.layers.py_reader(capacity=2, shapes=[[-1, 5, 3]], dtypes=["float32"],
                                      lod_levels=[1])
        seq = pkg.layers.read_file(reader)
        pooled = pkg.layers.sequence_pool(input=seq, pool_type="max")
        reader.decorate_paddle_reader(lambda: iter([(xs, lens)]))
        return [reader], [pooled]
    ref, got, _ = _run_readers(build)
    want = np.stack([xs[0, :2].max(0), xs[1, :4].max(0)])
    np.testing.assert_array_equal(got[0][0], want)
    np.testing.assert_array_equal(got[0][0], ref[0][0])


def test_py_reader_seq_len_buckets_pad_and_keep_the_true_lengths_as_jax():
    """A ragged output padded to its bucket (5 -> 8): lengths the batch does
    not carry are taken from its time dim before the pad; a level-2 output
    with buckets raises before the program changes."""
    xs = np.arange(30, dtype=np.float32).reshape(2, 5, 3) - 10.0

    def build(pkg):
        reader = pkg.layers.py_reader(capacity=2, shapes=[[-1, -1, 3]], dtypes=["float32"],
                                      lod_levels=[1], seq_len_buckets=[4, 8])
        seq = pkg.layers.read_file(reader)
        reader.decorate_paddle_reader(lambda: iter([(xs,)]))
        return [reader], [seq, pkg.layers.sequence_pool(input=seq, pool_type="max")]
    ref, got, _ = _run_readers(build)
    assert got[0][0].shape == (2, 8, 3)
    np.testing.assert_array_equal(got[0][1], xs.max(1))
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g, r)
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            with pytest.raises(ValueError, match="lod_level>=2"):
                pkg.layers.py_reader(capacity=2, shapes=[[-1, -1, -1, 3]], dtypes=["float32"],
                                     lod_levels=[2], seq_len_buckets="pow2")


def test_two_readers_stay_aligned_on_eof():
    """Reader B is shorter: A's popped batch goes back on EOF, so after B
    restarts, A goes on from its third batch."""
    a_batches = [np.full((1, 2), i, np.float32) for i in range(3)]
    b_batches = [np.full((1, 2), 10 * i, np.float32) for i in range(2)]
    cells = {}

    def build(pkg):
        ra = pkg.layers.py_reader(capacity=4, shapes=[[-1, 2]], dtypes=["float32"])
        rb = pkg.layers.py_reader(capacity=4, shapes=[[-1, 2]], dtypes=["float32"])
        s = pkg.layers.elementwise_add(pkg.layers.read_file(ra), pkg.layers.read_file(rb))
        ra.decorate_paddle_reader(lambda: ((x,) for x in a_batches))
        rb.decorate_paddle_reader(lambda: ((x,) for x in b_batches))
        cells[pkg] = (ra, rb, s)
        return [], [s]
    for pkg in (fluid, pt):
        main, startup, scope = pkg.Program(), pkg.Program(), pkg.Scope()
        with pkg.scope_guard(scope), pkg.unique_name.guard(), pkg.program_guard(main, startup):
            build(pkg)
        ra, rb, s = cells[pkg]
        exe = pkg.Executor(pkg.CPUPlace())
        ra.start()
        rb.start()
        got = []
        while True:
            try:
                got.append(float(np.asarray(exe.run(main, fetch_list=[s], scope=scope)[0])[0, 0]))
            except pkg.EOFException:
                break
        assert got == [0.0, 11.0], pkg
        rb.start()
        assert float(np.asarray(exe.run(main, fetch_list=[s], scope=scope)[0])[0, 0]) == 2.0


def _one_reader(pkg, data, scope, start=True):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.scope_guard(scope), pkg.unique_name.guard(), pkg.program_guard(main, startup):
        r = pkg.layers.py_reader(capacity=2, shapes=[[-1, 4]], dtypes=["float32"])
        out = pkg.layers.scale(pkg.layers.read_file(r), scale=1.0)
    r.decorate_paddle_reader(data)
    if start:
        r.start()
    return main, out


def _broken():
    yield (np.zeros((2, 4), np.float32),)
    raise IOError("disk on fire")


@pytest.mark.parametrize("case", ["bare_array", "never_started", "error_mid_pass",
                                  "other_scope"])
def test_reader_failures_fail_fast_as_jax(case):
    for pkg in (fluid, pt):
        scope = pkg.Scope()
        data = {"bare_array": lambda: iter([np.zeros((2, 4), np.float32)]),
                "error_mid_pass": _broken}.get(case, _broken)
        main, out = _one_reader(pkg, data, scope, start=case != "never_started")
        exe = pkg.Executor(pkg.CPUPlace())
        run_scope = pkg.Scope() if case == "other_scope" else scope
        if case == "error_mid_pass":
            exe.run(main, fetch_list=[out], scope=scope)        # batch 1 is fine
        match = {"never_started": "never started", "other_scope": "no queue"}.get(
            case, "pipeline failed")
        with pytest.raises(RuntimeError, match=match) as ei:
            exe.run(main, fetch_list=[out], scope=run_scope)
        if case == "error_mid_pass":
            assert "disk on fire" in str(ei.value.__cause__)


def _rio_dataset(tmp_path, nfiles=2, per_file=20):
    rs = np.random.RandomState(0)
    paths = []
    for fi in range(nfiles):
        p = str(tmp_path / f"part-{fi}.rio")
        with recordio.Writer(p) as w:
            for _ in range(per_file):
                x = rs.rand(6).astype(np.float32)
                w.write(x.tobytes() + np.array([x.sum()], np.float32).tobytes())
        paths.append(p)
    return paths


def test_open_files_trains_as_jax_over_three_passes(tmp_path):
    """The native parallel scanner (one thread: the files' order) feeds the
    in-graph reader of each package; 40 records of 8 a batch, 3 passes."""
    paths = _rio_dataset(tmp_path)

    def build(pkg):
        reader = pkg.layers.open_files(paths, shapes=[[6], [1]], dtypes=["float32", "float32"],
                                       thread_num=1, batch_size=8)
        x, y = pkg.layers.read_file(reader)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            input=pkg.layers.fc(input=x, size=1), label=y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [reader], [loss]
    recordio.reset_scans()
    ref, got, _ = _run_readers(build, passes=3)
    assert len(got) == len(ref) == 15
    assert recordio.scans()["native"] == 3 * 40
    np.testing.assert_allclose([g[0] for g in got], [r[0] for r in ref], rtol=LOSS_RTOL)
    assert got[-1][0] < got[0][0]


def test_open_files_tail_batch_and_open_recordio_file(tmp_path):
    p = str(tmp_path / "tail.rio")
    with recordio.Writer(p) as w:
        for i in range(5):
            w.write(np.full((2,), float(i), np.float32).tobytes())

    def build(pkg):
        reader = pkg.layers.open_recordio_file(p, shapes=[[2]], dtypes=["float32"])
        reader.decorate_paddle_reader(reader._paddle_reader)     # batch_size 1
        tail = pkg.layers.open_files([p], shapes=[[2]], dtypes=["float32"], batch_size=2)
        return [reader, tail], [pkg.layers.read_file(reader), pkg.layers.read_file(tail)]
    ref, got, _ = _run_readers(build)
    # the two readers run in step: EOF comes with the tail reader's 3rd batch
    assert [g[1].shape[0] for g in got] == [2, 2, 1] == [r[1].shape[0] for r in ref]
    assert [float(g[0][0, 0]) for g in got] == [0.0, 1.0, 2.0]


def test_random_data_generator_and_double_buffer():
    main, startup, scope = pt.Program(), pt.Program(), pt.Scope()
    with pt.scope_guard(scope), pt.unique_name.guard(), pt.program_guard(main, startup):
        reader = pt.layers.double_buffer(pt.layers.random_data_generator(
            0.0, 1.0, shapes=[[4, 3]], batches_per_pass=5))
        s = pt.layers.reduce_sum(pt.layers.read_file(reader))
    exe = pt.Executor(pt.CPUPlace())
    reader.start()
    got = [exe.run(main, fetch_list=[s], scope=scope)[0] for _ in range(5)]
    assert all(0.0 < float(v) < 12.0 for v in got)
    with pytest.raises(pt.EOFException):
        exe.run(main, fetch_list=[s], scope=scope)


def test_precompile_of_a_read_program_pops_nothing():
    scope = pt.Scope()
    main, out = _one_reader(pt, lambda: iter([(np.ones((2, 4), np.float32),)]), scope)
    exe = pt.Executor(pt.CPUPlace())
    (name,) = main.desc.block(0).ops[0].output("Out")
    rec = exe.precompile(main, feed={name: ((2, 4), "float32")}, fetch_list=[out], scope=scope)
    assert rec["kind"] == "eager"
    np.testing.assert_array_equal(exe.run(main, fetch_list=[out], scope=scope)[0],
                                  np.ones((2, 4), np.float32))


# --------------------------------------------------------- DeviceLoader

def test_device_loader_on_the_cpu_yields_the_batches_in_order():
    batches = [(np.full((2, 3), i, np.float32), {"ids": np.arange(i, i + 4)}) for i in range(5)]
    loader = DeviceLoader(lambda: iter(batches), capacity=2, device="cpu")
    got = list(loader())
    assert len(got) == 5
    for (x, d), (wx, wd) in zip(got, batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(d["ids"].numpy(), wd["ids"])
    with pytest.raises(NotImplementedError, match="item 12"):
        DeviceLoader(lambda: iter(batches), sharding=object(), device="cpu")


def test_device_loader_relays_the_readers_error_and_stops_early():
    def broken():
        yield (np.zeros(2, np.float32),)
        raise IOError("bad shard")
    with pytest.raises(IOError, match="bad shard"):
        list(DeviceLoader(broken, device="cpu"))

    def endless():
        i = 0
        while True:
            i += 1
            yield (np.full(2, i, np.float32),)
    it = iter(DeviceLoader(endless, capacity=3, device="cpu"))
    assert float(next(it)[0][0]) == 1.0
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 5.0


# ------------------------------------------------------------- auc, metrics

def _auc_both(predict, label):
    def build(pkg):
        p = pkg.layers.data(name="p", shape=list(predict.shape), dtype="float32",
                            append_batch_size=False)
        lab = pkg.layers.data(name="l", shape=list(label.shape), dtype=str(label.dtype),
                              append_batch_size=False)
        return [pkg.layers.auc(input=p, label=lab)]
    out = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            fetch = build(pkg)
        out.append((main, float(np.asarray(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"p": predict, "l": label}, fetch_list=fetch)[0]))))
    descs_equal(out[0][0], out[1][0])
    return out[0][1], out[1][1]


def _auc_f64(pos_score, label, n=200):
    thr = np.linspace(0.0, 1.0, n)
    pos = pos_score[None, :].astype(np.float64) > thr[:, None].astype(np.float32)
    lbl = label.reshape(-1).astype(np.float64)
    tpr = (pos * lbl).sum(1) / max(lbl.sum(), 1.0)
    fpr = (pos * (1 - lbl)).sum(1) / max((1 - lbl).sum(), 1.0)
    return -np.trapezoid(tpr, fpr)


@pytest.mark.parametrize("case", ["two_columns", "one_column", "one_class", "perfect"])
def test_auc_against_jax_and_float64(case):
    rs = np.random.RandomState(3)
    n = 512
    label = rs.randint(0, 2, (n, 1)).astype(np.int64)
    score = np.clip(label[:, 0] * 0.3 + rs.rand(n) * 0.7, 0, 1).astype(np.float32)
    if case == "one_class":
        label[:] = 1
    if case == "perfect":
        score = (0.25 + 0.5 * label[:, 0]).astype(np.float32)
    predict = np.stack([1 - score, score], 1) if case != "one_column" else score
    ref, got = _auc_both(predict, label)
    assert abs(got - ref) <= AUC_ATOL
    assert abs(got - _auc_f64(score, label)) <= AUC_ATOL
    m = metrics.Auc(num_thresholds=199)       # the op's 200 thresholds' buckets
    m.update(np.stack([1 - score, score], 1), label)
    if case == "one_class":
        assert m.eval() == 0.0 and got == 0.0
    else:
        assert abs(got - m.eval()) <= AUC_ATOL
    if case == "perfect":
        assert got == 1.0


def _metric_cases():
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 2, 4000)
    scores = np.clip(labels * 0.3 + rs.rand(4000) * 0.7, 0, 1)
    det = np.array([[[0, 0.9, 0, 0, 2, 2], [1, 0.8, 1, 1, 3, 3], [0, 0.3, 5, 5, 6, 6]]], float)
    gt = np.array([[[0, 0, 0, 2, 2, 0], [1, 1, 1, 3, 3, 0]]], float)
    return {
        "Accuracy": ({}, [(0.5, 10), (1.0, 10)]),
        "Precision": ({}, [(np.array([1, 1, 0, 1, 0, 0]), np.array([1, 0, 1, 1, 0, 1]))] * 2),
        "Recall": ({}, [(np.array([1, 1, 0, 1, 0, 0]), np.array([1, 0, 1, 1, 0, 1]))] * 2),
        "Auc": ({}, [(scores, labels)]),
        "EditDistance": ({}, [(np.array([1.0, 0.0, 2.0]), 3), (np.array([4.0]), 1)]),
        "ChunkEvaluator": ({}, [(np.array(10), np.array(8), np.array(6))]),
        "DetectionMAP": ({"class_num": 2}, [(det, np.array([3]), gt, np.array([2]))]),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metric_classes_equal_to_jax(name):
    kw, updates = _metric_cases()[name]
    mine, theirs = getattr(metrics, name)(**kw), getattr(jax_metrics, name)(**kw)
    for u in updates:
        mine.update(*u)
        theirs.update(*u)
    assert mine.eval() == theirs.eval()
    want = {"Accuracy": 0.75, "Precision": 2 / 3, "Recall": 0.5, "EditDistance": (1.75, 0.75),
            "ChunkEvaluator": (0.6, 0.75, 2 * 0.6 * 0.75 / 1.35), "DetectionMAP": 1.0}.get(name)
    if name == "Auc":
        s, lab = updates[0]
        pos, neg = s[lab == 1], s[lab == 0]
        want = ((pos[:, None] > neg[None, :]).sum()
                + 0.5 * (pos[:, None] == neg[None, :]).sum()) / (len(pos) * len(neg))
        assert mine.eval() == pytest.approx(want, abs=2e-3)
    else:
        assert mine.eval() == pytest.approx(want)
    mine.reset()
    theirs.reset()
    if name in ("Precision", "Recall"):
        assert mine.eval() == theirs.eval() == 0.0
    elif name in ("Accuracy", "EditDistance", "DetectionMAP"):
        for m in (mine, theirs):
            with pytest.raises(ValueError, match="no data"):
                m.eval()


def test_composite_metric():
    c = metrics.CompositeMetric()
    c.add_metric(metrics.Precision())
    c.add_metric(metrics.Recall())
    c.update(np.array([1, 0, 1]), np.array([1, 1, 1]))
    assert c.eval() == pytest.approx([1.0, 2 / 3])
