"""Host-to-device prefetch (the JAX package's ``reader/device_loader.py``).

Fluid's create_double_buffer_reader / BufferedReader
(operators/reader/buffered_reader.cc): a background thread copies the next
batch to the device while the current one is consumed, so input transfer
overlaps compute.

Here a host thread runs the Python reader ahead (hiding its decoding, as
Fluid's ThreadedReader does) and copies each batch's arrays into pinned
host memory.  The consumer keeps ``capacity`` batches in flight: each is
copied to the card with ``non_blocking`` copies on a side stream, and an
event is recorded behind its copies.  A batch is handed out only after the
consumer's current stream waits on its event, and each of its tensors is
marked as used by that stream, so nothing reads it before it landed and
its memory is not reused before the reader's work is done.  On the CPU
the batches are CPU tensors (views of the reader's arrays where they
can be).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["DeviceLoader"]


def _map(fn, batch):
    """``fn`` over the arrays of a batch: a tuple, list or dict of them (any
    depth), or one array."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (tuple, list)):
        for v in batch:
            yield from _leaves(v)
    else:
        yield batch


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class DeviceLoader:
    """Wrap a batch reader; yield batches on ``device`` with prefetch.

    ``reader``   -- callable returning an iterator of batches: tuples, lists
                    or dicts of numpy arrays (the paddle.reader contract).
    ``capacity`` -- batches in flight (2 = the classic double buffer).
    ``device``   -- where the batches go: a CUDA device (the default, the
                    current one) or ``"cpu"``.
    ``sharding`` -- a mesh placement: not ported yet (ROADMAP §A item 12).
    """

    def __init__(self, reader: Callable[[], Iterable], capacity: int = 2, sharding=None,
                 device=None):
        if sharding is not None:
            raise NotImplementedError("DeviceLoader(sharding=) needs a mesh, which is not "
                                      "ported to paddle_tpu_torch yet (ROADMAP §A item 12)")
        self.reader = reader
        self.capacity = max(1, int(capacity))
        self.device = torch.device(device) if device is not None \
            else torch.device("cuda", torch.cuda.current_device())
        self._stream = None

    def __call__(self) -> Iterator:
        return iter(self)

    def _stage(self, batch):
        """Convert a batch on the producer thread: tensors (pinned on the
        way to the card)."""
        if self.device.type == "cuda":
            return _map(lambda x: _host_tensor(x).pin_memory(), batch)
        return _map(_host_tensor, batch)

    def _put(self, host):
        """Enqueue the copies of one staged batch: (device batch, event)."""
        if self.device.type != "cuda":
            return host, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = _map(lambda t: t.to(self.device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _hand_out(self, item):
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in _leaves(batch):
                t.record_stream(cur)
        return batch

    def __iter__(self) -> Iterator:
        host_q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        end = object()
        stop = threading.Event()
        error = []

        def producer():
            try:
                for batch in self.reader():
                    staged = self._stage(batch)
                    while not stop.is_set():
                        try:
                            host_q.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 -- handed to the consumer
                error.append(e)
            finally:
                while True:
                    try:
                        host_q.put(end, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=producer, daemon=True, name="paddle_tpu_torch-device-loader")
        t.start()
        try:
            inflight = []
            done = False
            while True:
                while not done and len(inflight) < self.capacity:
                    item = host_q.get()
                    if item is end:
                        done = True
                        break
                    inflight.append(self._put(item))
                if done and error:
                    raise error[0]
                if not inflight:
                    return
                yield self._hand_out(inflight.pop(0))
        finally:
            # unblock the producer if the consumer leaves early
            stop.set()
            while not host_q.empty():
                try:
                    host_q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
