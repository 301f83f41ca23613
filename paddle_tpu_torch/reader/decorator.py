"""Functional reader combinators
(Fluid's python/paddle/reader/decorator.py:33-240):
a *reader creator* is a zero-arg callable returning an iterator of samples.
These compose the host-side input pipeline that keeps the card fed; the
device half (pinned buffers and a copy stream) is ``core/staging.py``'s
``FeedStager``.  A copy of the JAX package's module."""
from __future__ import annotations

import itertools
import os
import queue as _queue
import random
import threading
from typing import Callable, Iterable, List, Optional


def map_readers(func, *readers):
    """Apply func elementwise over zipped readers (reference :33)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size: int):
    """Pool-shuffle within a sliding buffer (reference :61)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers (reference :91)."""

    def reader():
        for r in readers:
            yield from r()

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment: bool = True):
    """Zip readers into tuple samples (reference :124); with
    ``check_alignment`` raise ComposeNotAligned when readers have different
    lengths instead of silently truncating."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        for outputs in itertools.zip_longest(*rs):
            if any(o is None for o in outputs):
                if check_alignment and not all(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                break
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size: int):
    """Background-thread prefetch buffer (reference :165) — this is the host
    half of the double-buffering that keeps the card from data-starving."""

    class EndSignal:
        def __init__(self, exc=None):
            self.exc = exc

    def read_worker(r, q):
        try:
            for d in r:
                q.put(d)
            q.put(EndSignal())
        except BaseException as e:  # propagate to consumer, don't deadlock
            q.put(EndSignal(e))

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q), daemon=True)
        t.start()
        e = q.get()
        while not isinstance(e, EndSignal):
            yield e
            e = q.get()
        if e.exc is not None:
            raise e.exc

    return data_reader


def firstn(reader, n: int):
    """First n samples (reference :206)."""

    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def cache(reader):
    """Materialize once, replay from memory."""
    all_data: List = []
    filled = [False]

    def data_reader():
        if not filled[0]:
            for d in reader():
                all_data.append(d)
            filled[0] = True
        yield from all_data

    return data_reader


def xmap_readers(mapper, reader, process_num: Optional[int] = None,
                 buffer_size: int = 64, order: bool = False):
    """Parallel map over samples with worker threads (reference :240).

    ``process_num=None`` sizes the pool from FLAGS_paddle_num_threads
    (0 = cpu count), the reference's host-threading knob."""
    if process_num is None:
        from ..flags import FLAGS
        process_num = int(FLAGS.paddle_num_threads) or (os.cpu_count() or 4)
    end = object()

    def data_reader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                try:
                    out_q.put((i, mapper(sample)))
                except BaseException as e:
                    out_q.put(("__error__", e))
                    out_q.put(end)
                    return

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            i, mapped = item
            if i == "__error__":
                raise mapped
            if not order:
                yield mapped
            else:
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return data_reader


def multiprocess_reader(readers, use_pipe: bool = True, queue_size: int = 1000):
    """Thread-based merge of multiple readers (the reference uses processes;
    the host feeds via threads since numpy batching releases the GIL)."""

    def data_reader():
        q = _queue.Queue(queue_size)
        end = object()

        def work(r):
            try:
                for sample in r():
                    q.put(sample)
                q.put(end)
            except BaseException as e:
                q.put(("__reader_error__", e))
                q.put(end)

        for r in readers:
            threading.Thread(target=work, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if item is end:
                finished += 1
            elif (isinstance(item, tuple) and len(item) == 2
                  and item[0] == "__reader_error__"):
                raise item[1]
            else:
                yield item

    return data_reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (reference python/paddle/v2/minibatch.py /
    paddle.batch)."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
