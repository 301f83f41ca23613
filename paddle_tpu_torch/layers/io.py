"""In-graph reader layers: the py_reader feed contract, copied from the JAX
package's ``layers/io.py``.

Fluid's ``layers.py_reader`` (python/paddle/fluid/layers/io.py:474-647)
creates a ``LoDTensorBlockingQueue``; a user thread pushes batches, the
in-graph ``read`` op pops, a double-buffer reader prefetches to the
device, and exhaustion raises ``EOFException`` so the train loop can
``reader.reset()``.

Here the queue lives on the host in the Scope as the reader variable's
value.  The ``read`` op has no lowering: the executor pops one batch
before each run and binds it as the step's feeds
(``Executor._pop_readers``), so on the card the batch goes through the
same input copy as a fed batch and a step with a ``read`` op is still one
CUDA graph replay.  Exhaustion raises
:class:`paddle_tpu_torch.core.executor.EOFException`.  ``open_files``
scans RecordIO shards with the native parallel scanner
(``recordio.parallel_scan``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List, Optional

from ..core import unique_name
from ..core.framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["py_reader", "read_file", "PyReader", "open_files",
           "open_recordio_file", "random_data_generator", "double_buffer",
           "batch", "shuffle"]


class _BlockingQueue:
    """LoDTensorBlockingQueue analogue (Fluid's
    operators/reader/lod_tensor_blocking_queue.h): bounded, closable.
    Close is flag-based (no sentinels) so a closed queue still drains its
    remaining items before pop() reports end-of-stream, and a producer
    blocked on a full queue aborts promptly."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._back: list = []          # unpop()ped items, served first
        self._closed = False
        self._lock = threading.Lock()
        self.started = False           # set by PyReader.start()
        self.error: Optional[BaseException] = None  # producer failure

    def _is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def push(self, item) -> bool:
        while True:
            if self._is_closed():
                return False
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue

    def close(self):
        with self._lock:
            self._closed = True

    def pop(self):
        """Next batch; None once closed AND drained (end-of-stream)."""
        with self._lock:
            if self._back:
                return self._back.pop()
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._is_closed():
                    # the producer may have pushed its final batch between
                    # our timeout and the closed check — drain once more
                    # so "closed AND drained" actually holds
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        return None

    def unpop(self, item):
        """Return a popped batch to the FRONT of the queue (used when a
        sibling reader hits EOF mid-run, so streams stay aligned)."""
        with self._lock:
            self._back.append(item)


class PyReader:
    """The object returned by :func:`py_reader` (Fluid returns a reader
    Variable monkey-patched with these methods, layers/io.py:540-620)."""

    def __init__(self, reader_var: Variable, out_vars: List[Variable],
                 q: _BlockingQueue, lod_levels: List[int], scope,
                 seq_len_buckets=None):
        self._var = reader_var
        self._outs = out_vars
        self._queue = q
        self._scope = scope
        self._lod_levels = lod_levels
        if seq_len_buckets is not None and any(ll >= 2 for ll in lod_levels):
            # py_reader() validates before building the graph; this guard
            # covers direct PyReader construction
            raise ValueError(
                "seq_len_buckets is not supported with lod_level>=2 "
                "py_reader outputs: only level-1 lengths survive the pad "
                "(the @SEQ_LEN channel).")
        self._seq_len_buckets = seq_len_buckets
        if seq_len_buckets is not None:
            # verifier R401 stamp (see DataFeeder): the ragged time dims
            # of these outputs are bucketed, so no recompile hazard
            for v, ll in zip(out_vars, lod_levels):
                if ll > 0:
                    v.desc.attrs["seq_len_buckets"] = (
                        seq_len_buckets if isinstance(seq_len_buckets, str)
                        else list(seq_len_buckets))
        self._feeder_thread: Optional[threading.Thread] = None
        self._paddle_reader: Optional[Callable[[], Iterable]] = None

    def _bucket_batch(self, batch):
        """Pad each ragged output's time dim up to a bucket boundary so an
        epoch of varying lengths compiles at most once per bucket (see
        data_feeder.bucketed_len).  True lengths must survive the pad: when
        the batch carries no appended @SEQ_LEN arrays (the executor would
        default to full-length masking), they are synthesized from the
        PRE-pad time dim first — otherwise pad columns would read as real
        tokens."""
        if self._seq_len_buckets is None:
            return tuple(batch)
        import numpy as np
        from ..data_feeder import bucketed_len
        n_out = len(self._lod_levels)
        n_lod = sum(1 for ll in self._lod_levels if ll > 0)
        out = list(batch)
        if n_lod and len(out) == n_out:
            # no lengths appended: record each ragged output's true
            # (pre-pad) length per row, in lod order — matching the
            # executor's batch-tuple contract (_pop_readers)
            for i, ll in enumerate(self._lod_levels):
                if ll > 0:
                    a = np.asarray(out[i])
                    out.append(np.full((a.shape[0],), a.shape[1],
                                       np.int32))
        for i, ll in enumerate(self._lod_levels):
            if ll > 0 and i < n_out:
                # ll is 1 here: __init__ rejects seq_len_buckets+lod_level>=2
                a = np.asarray(out[i])
                if a.ndim >= 2:
                    # only the level-1 time axis buckets — its true lengths
                    # are carried/synthesized above
                    pad = [(0, 0)] * a.ndim
                    want = bucketed_len(a.shape[1], self._seq_len_buckets)
                    pad[1] = (0, want - a.shape[1])
                    if pad[1][1]:
                        out[i] = np.pad(a, pad)
        return tuple(out)

    # -- python-side feeding -------------------------------------------
    def decorate_paddle_reader(self, reader: Callable[[], Iterable]):
        """``reader()`` yields tuples of numpy arrays, one per output var
        (+ optionally the @SEQ_LEN arrays appended for lod outputs)."""
        self._paddle_reader = reader

    decorate_tensor_provider = decorate_paddle_reader

    def _retire(self):
        """Fully shut down the current pass: closing the queue aborts a
        producer blocked on a full queue, then the thread is joined."""
        self._queue.close()
        if self._feeder_thread is not None:
            self._feeder_thread.join(timeout=10)
            self._feeder_thread = None

    def start(self):
        """Start pumping the decorated reader into a FRESH queue (a stale
        producer from a previous pass can never leak batches into the new
        one) — Fluid's py_reader.start."""
        if self._paddle_reader is None:
            raise RuntimeError("decorate_paddle_reader first")
        self._retire()
        q = _BlockingQueue(self._queue.capacity)
        q.started = True
        self._queue = q
        self._scope.set_var(self._var.name, q)

        def pump():
            try:
                for batch in self._paddle_reader():
                    if not isinstance(batch, (tuple, list)):
                        raise TypeError(
                            f"py_reader {self._var.name!r}: the reader must "
                            f"yield a tuple/list of arrays (one per output"
                            f"), got {type(batch).__name__} — yield "
                            f"(arr,) for a single output")
                    if not q.push(self._bucket_batch(batch)):
                        return
            except BaseException as e:   # surfaced by the executor — a
                q.error = e              # broken pipeline must not look
                raise                    # like a clean end-of-epoch
            finally:
                q.close()

        self._feeder_thread = threading.Thread(target=pump, daemon=True)
        self._feeder_thread.start()

    def reset(self):
        """After EOFException: shut the pass down so start() can begin a
        new one (Fluid's py_reader.reset)."""
        self._retire()

    # -- graph side ----------------------------------------------------
    @property
    def queue(self) -> _BlockingQueue:
        return self._queue

    @property
    def name(self) -> str:
        return self._var.name

    def outputs(self) -> List[Variable]:
        return list(self._outs)


def py_reader(capacity: int, shapes, dtypes, lod_levels=None,
              name=None, use_double_buffer: bool = True,
              seq_len_buckets=None) -> PyReader:
    """Create an in-graph reader fed from Python (reference
    layers/io.py:474).  ``shapes`` use -1 for the batch (and ragged time)
    dims; ``lod_levels[i] > 0`` marks output i as ragged — its batch tuple
    may carry a matching lengths array appended after the data arrays, or
    the executor defaults to full-length.

    Returns a :class:`PyReader`; get the output vars with
    :func:`read_file`, push data with ``decorate_paddle_reader`` +
    ``start()``, catch ``EOFException`` and ``reset()`` per pass.
    ``use_double_buffer`` is API parity: the executor copies the popped
    batch to the card as it copies feeds."""
    lod_levels = list(lod_levels or [0] * len(shapes))
    # validate BEFORE mutating the program: a raise below would leave a
    # dangling read op + orphan vars behind the exception
    if seq_len_buckets is not None and any(ll >= 2 for ll in lod_levels):
        raise ValueError(
            "seq_len_buckets is not supported with lod_level>=2 "
            "py_reader outputs: only level-1 lengths survive the pad "
            "(the @SEQ_LEN channel).  Bucket manually and feed explicit "
            "@SEQ_LEN@k arrays, or drop seq_len_buckets.")
    helper = LayerHelper("py_reader", name=name)
    main_block = helper.main_program.global_block
    reader_var = main_block.create_var(
        name=name or unique_name.generate("py_reader"), persistable=True)
    outs = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        v = main_block.create_var(
            name=unique_name.generate(f"{reader_var.name}_out{i}"),
            shape=tuple(shape), dtype=dtype,
            lod_level=lod_levels[i])
        outs.append(v)
    helper.append_op("read", inputs={"Reader": reader_var},
                     outputs={"Out": outs},
                     attrs={"lod_levels": lod_levels})
    q = _BlockingQueue(capacity)
    from ..core.scope import global_scope
    scope = global_scope()
    scope.set_var(reader_var.name, q)
    return PyReader(reader_var, outs, q, lod_levels, scope,
                    seq_len_buckets=seq_len_buckets)


def read_file(reader: PyReader) -> List[Variable]:
    """Fluid's layers/io.py read_file: the reader's output variables."""
    outs = reader.outputs()
    return outs[0] if len(outs) == 1 else outs


# --------------------------------------------------------------- file readers
def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       capacity=64, thread_num=1):
    """In-graph reader over a recordio file (Fluid's layers/io.py
    open_recordio_file -> create_recordio_file_reader op).  Record format:
    each record is the C-order byte concatenation of one sample's arrays
    in declaration order.  Returns a started PyReader; read with
    :func:`read_file`."""
    return open_files([filename], shapes, dtypes, lod_levels=lod_levels,
                      capacity=capacity, thread_num=thread_num)


def open_files(filenames, shapes, dtypes, thread_num=None, buffer_size=64,
               lod_levels=None, capacity=64, batch_size=1):
    """Multi-file reader (Fluid's layers/io.py open_files ->
    open_files_op): files are scanned concurrently by the NATIVE parallel
    recordio scanner (csrc/host/concurrency.cpp worker threads), decoded,
    grouped into ``batch_size`` batches, and fed through a py_reader
    queue.  ``shapes`` are per-sample (batch dim excluded or -1); record
    format: the C-order byte concatenation of one sample's arrays in
    declaration order.  Call ``.start()``, read via :func:`read_file`,
    catch ``EOFException`` per pass."""
    import numpy as np

    from .. import recordio

    batch_shapes = [[-1] + [int(d) for d in s if d != -1] for s in shapes]
    reader_obj = py_reader(capacity=capacity, shapes=batch_shapes,
                           dtypes=dtypes, lod_levels=lod_levels,
                           use_double_buffer=True)
    sample_shapes = [tuple(int(d) for d in s if d != -1) for s in shapes]
    np_dtypes = [np.dtype(d) for d in dtypes]
    sizes = [int(np.prod(s)) * dt.itemsize
             for s, dt in zip(sample_shapes, np_dtypes)]

    def decode(rec):
        out, off = [], 0
        for s, dt, nb in zip(sample_shapes, np_dtypes, sizes):
            out.append(np.frombuffer(rec, dtype=dt,
                                     count=nb // dt.itemsize,
                                     offset=off).reshape(s))
            off += nb
        return tuple(out)

    def batch_reader():
        cur = []

        def flush():
            return tuple(np.stack([c[i] for c in cur])
                         for i in range(len(sample_shapes)))

        for rec in recordio.parallel_scan(list(filenames),
                                          num_threads=thread_num,
                                          capacity=buffer_size):
            cur.append(decode(rec))
            if len(cur) == batch_size:
                yield flush()
                cur = []
        if cur:                      # tail batch (decorator.batch parity)
            yield flush()

    reader_obj.decorate_paddle_reader(batch_reader)
    return reader_obj


def random_data_generator(low, high, shapes, lod_levels=None,
                          batches_per_pass=64):
    """Uniform random in-graph reader (reference
    create_random_data_generator_op — benchmarking without IO).
    ``shapes`` are full batch shapes."""
    import numpy as np

    reader_obj = py_reader(capacity=8, shapes=shapes,
                           dtypes=["float32"] * len(shapes),
                           lod_levels=lod_levels)
    full_shapes = [tuple(int(d) for d in s) for s in shapes]
    rng = np.random.RandomState(0)

    def batch_reader():
        for _ in range(batches_per_pass):
            yield tuple(rng.uniform(low, high, s).astype(np.float32)
                        for s in full_shapes)

    reader_obj.decorate_paddle_reader(batch_reader)
    return reader_obj


def double_buffer(reader, place=None, name=None):
    """API parity (Fluid's double_buffer): the executor copies each popped
    batch to the card as it copies feeds, so this returns the reader
    unchanged."""
    return reader


def batch(reader, batch_size):
    """In-graph reader batching (Fluid's layers/io.py batch): thin
    re-export of the decorator over PyReader sources."""
    from ..reader.decorator import batch as _batch
    return _batch(reader, batch_size)


def shuffle(reader, buffer_size):
    from ..reader.decorator import shuffle as _shuffle
    return _shuffle(reader, buffer_size)
