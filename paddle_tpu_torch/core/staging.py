"""The executor's pipeline plumbing: counters, feed staging, pinned
fetches and the executable fingerprint.

* :data:`COUNTERS` -- process-wide pipeline counters (cache hits and
  misses, compiles, staged batches, reused buffers, sync stalls, fetch
  timeouts), shared by every executor and shown by
  ``Executor.cache_info``.  They live in the telemetry registry's
  ``"pipeline"`` scope under the JAX package's names
  (``paddle_tpu/core/staging.py`` ``PipelineCounters``).
* :class:`FeedStager` -- a bounded ring that converts batch N+1 on a
  background thread while step N runs.  On the card each value is coerced
  on that thread into a pinned host buffer (:func:`host_to_device_copy`)
  and copied to the device on the stager's own stream; the
  :class:`StagedBatch` carries an event the executor's stream waits on
  before it reads the batch.  A host object fed again reuses its staged
  tensor.  While the timeline is enabled the stager thread's lane carries a
  ``stage[<seq>]`` span a batch (``stage::convert(<name>)`` inside it) and
  the tail of a flow whose head lands on the step that reads the batch.
* :class:`FetchHandle` -- the value of a fetch.  On the card
  :func:`prefetch_to_host` enqueues its device-to-host copy into pinned
  host memory on the step's stream, right after the step, and records an
  event; the handle waits on that event when it is first read and hands
  out an array over the pinned buffer (a bf16 value as float32: numpy has
  no bfloat16).  Until then the step may still be running on the card, so
  the caller (the serving dispatcher) can enqueue the next batch meanwhile.
  A CPU tensor is read as it is.  A handle keeps the trace context active
  where it was made; the executor stamps the first handle of a step with
  its label and dispatch time, and its first read records the step's span
  on the timeline's device lane (dispatch to ready).  A bounded read that
  times out (``result(timeout=)``) counts ``fetch_timeouts`` and calls the
  hooks of :func:`add_fetch_timeout_hook` (the health stream's event, the
  Trainer's save-and-stop).
* :data:`PINNED_HANDOUT` -- the pinned bytes that arrays handed out hold,
  bounded by :data:`PINNED_HANDOUT_LIMIT`: past it a fetch is copied out to
  pageable memory when it is read, so a caller that keeps its answers does
  not pin host memory without end.
* :func:`executable_fingerprint` -- a canonical hash of one cache entry's
  inputs, stable across processes and executors.
"""
from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import REGISTRY, TIMELINE, current_trace, next_flow_id
from .dtypes import to_numpy
from .selected_rows import SelectedRows

__all__ = ["COUNTERS", "PipelineCounters", "PINNED_HANDOUT", "PINNED_HANDOUT_LIMIT",
           "FeedStager", "StagedBatch", "stager_stats", "host_to_device_copy",
           "FetchHandle", "FetchTimeoutError", "add_fetch_timeout_hook", "prefetch_to_host",
           "executable_fingerprint"]


class PipelineCounters:
    """Named integer counters of the pipeline, backed by the telemetry
    :data:`~paddle_tpu_torch.telemetry.REGISTRY` under the ``"pipeline"``
    scope; one instance (:data:`COUNTERS`) is shared by every executor.
    The JAX package's counters that have no counterpart here (the
    persistent compile cache's, a mesh's global assembly) are left out."""

    _FIELDS = ("compiles", "cache_hits", "cache_misses", "staged_batches",
               "reused_buffers", "buffer_reuse_misses", "feed_fastpath_hits",
               "sync_stalls", "fetch_timeouts")

    SCOPE = "pipeline"

    def __init__(self, scope: str = SCOPE):
        self._scope = scope
        for k in self._FIELDS:
            REGISTRY.counter(k, scope=scope)   # pre-registered: snapshots total

    def inc(self, name: str, n: int = 1):
        REGISTRY.counter(name, scope=self._scope).inc(n)

    def get(self, name: str) -> int:
        return REGISTRY.counter(name, scope=self._scope).value

    def snapshot(self) -> Dict[str, int]:
        return dict(REGISTRY.snapshot(scope=self._scope))

    def reset(self):
        REGISTRY.reset(scope=self._scope)


COUNTERS = PipelineCounters()

# bytes of pinned blocks that arrays handed out by fetch handles may hold at
# once; a read past it copies the value out to pageable memory
PINNED_HANDOUT_LIMIT = 2 << 30


def _block_bytes(t: torch.Tensor) -> int:
    """The pinned block ``t`` occupies: torch's caching host allocator
    rounds every request up to a power of two."""
    n = t.numel() * t.element_size()
    return 1 << (n - 1).bit_length() if n > 1 else n


class PinnedHandout:
    """The pinned blocks that arrays handed out by :class:`FetchHandle`
    hold (``bytes``: counted from a handout until the array and every view
    of it are gone), and the reads copied out to pageable memory because
    the limit was reached (``copies``).  One instance,
    :data:`PINNED_HANDOUT`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes = 0
        self.copies = 0

    def take(self, n: int) -> bool:
        """Count ``n`` bytes handed out, unless that would pass
        :data:`PINNED_HANDOUT_LIMIT` (then count a copy)."""
        with self._lock:
            if self.bytes + n > PINNED_HANDOUT_LIMIT:
                self.copies += 1
                return False
            self.bytes += n
            return True

    def give_back(self, n: int):
        with self._lock:
            self.bytes -= n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": self.bytes, "copies": self.copies,
                    "limit": PINNED_HANDOUT_LIMIT}


PINNED_HANDOUT = PinnedHandout()


class FetchTimeoutError(TimeoutError):
    """A bounded :meth:`FetchHandle.result` wait expired before the device
    produced the value."""


# Observers of fetch timeouts (``health.py`` registers one that records a
# ``fetch-timeout`` event in the health stream; ``Trainer(checkpoint=
# CheckpointConfig(save_on_fetch_timeout=True))`` one that saves and stops).
# A hook's failure is swallowed: observers never break the fetch path.
_FETCH_TIMEOUT_HOOKS: list = []


def add_fetch_timeout_hook(hook):
    """Register ``hook(label=..., timeout=..., trace=...)`` to run whenever
    a bounded :meth:`FetchHandle.result` wait expires (idempotent).
    ``label`` is the handle's step label (None when untraced), ``trace``
    its :class:`~paddle_tpu_torch.telemetry.TraceContext` (or None)."""
    if hook not in _FETCH_TIMEOUT_HOOKS:
        _FETCH_TIMEOUT_HOOKS.append(hook)


def _notify_fetch_timeout(label, timeout, trace=None):
    COUNTERS.inc("fetch_timeouts")
    for hook in list(_FETCH_TIMEOUT_HOOKS):
        try:
            hook(label=label, timeout=timeout, trace=trace)
        except Exception:  # noqa: BLE001 -- observability only
            pass


class FetchHandle:
    """A fetched value that materializes to numpy on first access
    (``np.asarray(h)``, ``float(h)``, ``h.numpy()``).

    ``value`` is the tensor the handle reads: the pinned host copy once
    :func:`prefetch_to_host` has enqueued it (it may still be being
    written; :meth:`block` waits), else the fetched tensor.  A pinned
    value is handed out as an array over its buffer while
    :data:`PINNED_HANDOUT` is under its limit, else copied out to pageable
    memory (``value`` then becomes that copy).

    ``trace`` is the trace context active when the handle was made (the
    serving batch's span; None when untraced).  A handle given a ``label``
    and ``dispatch_us`` (the executor's first handle of a step, while the
    timeline is enabled) records ``[dispatch, ready]`` on the device lane
    when it is first read: ready is the moment the host saw the value,
    exact after a stall and an upper bound otherwise."""

    __slots__ = ("_val", "_event", "_np", "_pinned", "_lock", "_label", "_dispatch_us",
                 "_span_done", "trace")

    def __init__(self, val: torch.Tensor, label: Optional[str] = None,
                 dispatch_us: Optional[float] = None):
        self._val = val
        self._event: Optional[torch.cuda.Event] = None
        self._np = None
        self._pinned = False
        # batch-mates read one handle from several threads: one of them
        # makes the array (a copy, past the limit), the others reuse it
        self._lock = threading.Lock()
        self._label = label
        self._dispatch_us = dispatch_us
        self._span_done = False
        self.trace = current_trace()

    def _record_device_span(self, stalled: bool):
        """The first completion records the step's span on the device lane."""
        if self._span_done:
            return
        self._span_done = True
        if not TIMELINE.enabled:
            return
        now = TIMELINE.now_us()
        args: Dict[str, Any] = {"stalled": stalled}
        if self.trace is not None:
            args["trace_id"] = self.trace.trace_id
            args["span_id"] = self.trace.span_id
        TIMELINE.record_device_span(self._label or "device_step", self._dispatch_us,
                                    max(0.0, now - self._dispatch_us), args=args)

    @property
    def value(self) -> torch.Tensor:
        return self._val

    def ready(self) -> bool:
        return self._np is not None or self._event is None or self._event.query()

    def block(self) -> "FetchHandle":
        """Wait until the value is on the host."""
        stalled = self._dispatch_us is not None and not self.ready()
        if self._event is not None:
            self._event.synchronize()
        if self._dispatch_us is not None:
            self._record_device_span(stalled)
        return self

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The host value, waiting at most ``timeout`` seconds for the
        device (``None`` blocks).  Raises :class:`FetchTimeoutError` instead
        of hanging on a wedged device queue."""
        if timeout is not None and not self.ready():
            deadline = time.monotonic() + timeout
            pause = 5e-5
            while not self.ready():
                if time.monotonic() >= deadline:
                    _notify_fetch_timeout(self._label, timeout, self.trace)
                    raise FetchTimeoutError(
                        f"fetch not ready after {timeout:.3f}s (device queue "
                        f"wedged or overloaded)")
                time.sleep(pause)
                pause = min(pause * 2, 2e-3)
        return self.numpy()

    def numpy(self) -> np.ndarray:
        if self._np is None:
            if not self.ready():
                # the host waits for the device: counted as the JAX package counts it
                COUNTERS.inc("sync_stalls")
            self.block()
            with self._lock:
                if self._np is None:
                    self._np = self._host_array()
        return self._np

    def _host_array(self) -> np.ndarray:
        v = self._val
        if isinstance(v, SelectedRows):
            # a fetched sparse gradient stays sparse: its ids and rows on the host
            return SelectedRows(to_numpy(v.ids).copy(), to_numpy(v.rows).copy(), v.height)
        if not self._pinned or v.dtype == torch.bfloat16:
            return to_numpy(v)          # bf16: widened into a new array
        n = _block_bytes(v)
        if PINNED_HANDOUT.take(n):
            a = v.numpy()
            weakref.finalize(a, PINNED_HANDOUT.give_back, n)
            return a
        a = v.numpy().copy()
        self._val = torch.from_numpy(a)   # the pinned block goes back to the allocator
        return a

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return np.asarray(a, dtype=dtype) if dtype is not None else a

    def item(self):
        return self.numpy().item()

    def __float__(self):
        return float(self.numpy())

    def __len__(self):
        return len(self.numpy())

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __iter__(self):
        return iter(self.numpy())

    @property
    def shape(self):
        return tuple(self._val.shape)

    @property
    def dtype(self):
        return self._val.dtype

    def __repr__(self):
        state = "ready" if self.ready() else "pending"
        return f"FetchHandle(shape={self.shape}, dtype={self.dtype}, {state})"


def prefetch_to_host(handles: Sequence[FetchHandle]) -> int:
    """Enqueue the device-to-host copy of every handle that holds a CUDA
    tensor, each into a new pinned host buffer, on the current stream, and
    record one event after them; return how many were started (a CPU
    tensor, or a handle already copied, is skipped).  The handles drop
    their device tensors, so a replayed graph may overwrite its outputs
    once the copies are enqueued before its next replay.

    A pinned buffer comes from torch's caching host allocator: it is
    reused once every array over it is gone and its copy has finished
    (the handle's read bounds how many arrays hold one: see
    :class:`PinnedHandout`)."""
    started, device = [], None

    def pinned(v):
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        return host

    for h in handles:
        v = h._val
        if isinstance(v, torch.Tensor) and v.is_cuda:
            h._val, h._pinned, device = pinned(v), True, v.device
            started.append(h)
        elif isinstance(v, SelectedRows) and v.rows.is_cuda:
            h._val = SelectedRows(pinned(v.ids), pinned(v.rows), v.height)
            h._pinned, device = True, v.rows.device
            started.append(h)
    if started:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        for h in started:
            h._event = event
    return len(started)


# ------------------------------------------------------------ feed staging

def host_to_device_copy(value, device, dtype: Optional[torch.dtype] = None,
                        pinned: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``value`` (a numpy array or a tensor) as a new tensor on ``device`` in
    ``dtype`` (default: its own), and the pinned buffer it went through.

    On the card a host value is coerced on the host straight into a pinned
    buffer (``pinned`` when its shape and dtype fit, else a new one), and
    the copy to the device is enqueued on the current stream without
    blocking the host: the caller keeps the buffer unwritten until that
    copy has finished (an event recorded after it).  A value already on the
    device is converted there; on the CPU the value is only coerced (no
    pinned buffer: ``None``).  The JAX package's counterpart places a host
    array as an executable's output (``device_put`` in its stager)."""
    device = torch.device(device)
    src = value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(value))
    dtype = dtype or src.dtype
    if device.type != "cuda" or src.is_cuda:
        return src.to(device=device, dtype=dtype), None
    if pinned is None or pinned.shape != src.shape or pinned.dtype != dtype:
        pinned = torch.empty(src.shape, dtype=dtype, pin_memory=True)
    pinned.copy_(src)
    out = torch.empty(src.shape, dtype=dtype, device=device)
    out.copy_(pinned, non_blocking=True)
    return out, pinned


class _EndOfStream:
    pass


_EOS = _EndOfStream()


class StagedBatch(dict):
    """A staged feed dict (tensors on the executor's device): ``seq``
    (staging order), ``nbytes`` (the bytes of its tensors) and
    ``donatable`` (its tensors are not kept by the stager's reuse cache).
    On the card ``event`` is recorded on the stager's stream after the
    batch's copies: the executor's stream waits on it before reading the
    batch.  ``flow_id`` (set while the timeline is enabled) ties the
    batch's stage span to the span of the step that reads it.
    ``prefetched`` is ``{table: unique ids}`` where a ``RowPrefetcher``
    rides the stager's thread (embedding/prefetch.py), else None.  A plain
    dict everywhere else."""

    __slots__ = ("flow_id", "seq", "nbytes", "donatable", "event", "prefetched")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.flow_id: Optional[int] = None
        self.seq: int = -1
        self.nbytes: int = 0
        self.donatable: bool = False
        self.event: Optional["torch.cuda.Event"] = None
        self.prefetched: Optional[dict] = None


# live stagers, for queue-depth / bytes-in-flight readings: weak, so a
# dropped stager never lingers in the stats
_LIVE_STAGERS: "weakref.WeakSet" = weakref.WeakSet()


def stager_stats() -> Dict[str, int]:
    """Queue depth and staged bytes in flight over every live
    :class:`FeedStager`."""
    depth = in_flight = n = 0
    for s in list(_LIVE_STAGERS):
        if s._stop.is_set():
            continue
        n += 1
        depth += s.queue_depth
        in_flight += s.bytes_in_flight
    return {"stagers": n, "queue_depth": depth, "bytes_in_flight": in_flight}


class _Slot:
    """One pinned host buffer of a stager's ring and the event after the
    last copy out of it."""

    __slots__ = ("pinned", "event")

    def __init__(self):
        self.pinned: Optional[torch.Tensor] = None
        self.event: Optional["torch.cuda.Event"] = None


class FeedStager:
    """Double-buffered feed staging: a daemon thread pulls host feed dicts
    from ``feeds``, converts each value and parks up to ``depth`` staged
    batches in a bounded queue, so the executor's feed phase is a dict
    passthrough.

    ``convert(name, value)`` returns ``(host, dtype)``: the value as a
    tensor (a view of a numpy array where it can be) and the dtype the
    executor runs it in.  On the CPU the stager coerces ``host`` to
    ``dtype``.  On a CUDA ``device`` the thread sets that device and a copy
    stream of its own as current (both are per thread), coerces each value
    into a pinned buffer from a ring of ``depth + 2`` per feed name, and
    enqueues its copy to the device on that stream; one event recorded
    after the batch's copies travels in the :class:`StagedBatch`.  Before
    the ring writes a buffer again the thread waits on the event of its
    last copy, so no buffer is overwritten while a copy out of it is in
    flight.

    Staged tensors are reused when the *same host object* is fed again
    (per feed name, keyed by identity through a weakref and by dtype), so
    epoch-cycled pools pay one copy per distinct buffer; a conversion the
    cache could not serve counts as ``buffer_reuse_misses``.
    ``reuse=False`` turns the cache off and marks batches ``donatable``.
    ``on_batch(host_feed, staged)``, where given, runs on the thread after
    each batch is staged (a ``RowPrefetcher``'s dedup of the host ids).
    An error in ``convert``, ``on_batch`` or ``feeds`` reaches the
    consumer."""

    # staged tensors kept per feed name for reuse
    REUSE_DEPTH = 8

    def __init__(self, convert: Callable[[str, Any], Tuple[torch.Tensor, torch.dtype]],
                 feeds: Iterable[dict], depth: int = 2, reuse: bool = True, device=None,
                 on_batch: Optional[Callable[[dict, "StagedBatch"], None]] = None):
        if depth < 1:
            raise ValueError(f"FeedStager depth must be >= 1, got {depth}")
        self._convert = convert
        self._on_batch = on_batch
        self._reuse_enabled = reuse
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._cuda = self.device.type == "cuda"
        self._stream: Optional["torch.cuda.Stream"] = None   # made on the thread
        self._ring_depth = depth + 2
        # name -> (slots, next index)
        self._ring: Dict[str, List[Any]] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # name -> {(id(src), dtype): (weakref(src), staged tensor)}; identity
        # is checked through the weakref (an id() alone can be recycled);
        # values that take no weakref are never cached
        self._reuse: Dict[str, "OrderedDict[tuple, tuple]"] = {}
        self._bytes_lock = threading.Lock()
        self._bytes_in_flight = 0
        _LIVE_STAGERS.add(self)
        self._thread = threading.Thread(target=self._worker, args=(iter(feeds),),
                                        daemon=True, name="paddle_tpu_torch-feed-stager")
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        """Staged batches parked now (approximate, lock-free)."""
        return self._q.qsize()

    @property
    def bytes_in_flight(self) -> int:
        return self._bytes_in_flight

    def _add_bytes(self, n: int):
        with self._bytes_lock:
            self._bytes_in_flight += n

    # -- background side ---------------------------------------------------
    def _slot(self, name: str) -> _Slot:
        """The next ring slot of ``name``, its last copy finished."""
        ring = self._ring.get(name)
        if ring is None:
            ring = self._ring[name] = [[_Slot() for _ in range(self._ring_depth)], 0]
        slots, i = ring
        ring[1] = (i + 1) % len(slots)
        slot = slots[i]
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def _to_device(self, name: str, val, used: List[_Slot]) -> torch.Tensor:
        host, dtype = self._convert(name, val)
        if not self._cuda:
            return host.to(dtype=dtype)
        slot = self._slot(name)
        out, slot.pinned = host_to_device_copy(host, self.device, dtype, slot.pinned)
        used.append(slot)
        return out

    def _stage_one(self, feed: dict, seq: int) -> StagedBatch:
        t0 = TIMELINE.now_us() if TIMELINE.enabled else 0.0
        reused = 0
        staged = StagedBatch()
        staged.seq = seq
        staged.donatable = not self._reuse_enabled
        used: List[_Slot] = []
        for name, val in feed.items():
            ent_map = self._reuse.setdefault(name, OrderedDict())
            key = (id(val), str(getattr(val, "dtype", type(val).__name__))) \
                if self._reuse_enabled else None
            if key is not None:
                ent = ent_map.get(key)
                if ent is not None and ent[0]() is val:
                    ent_map.move_to_end(key)
                    staged[name] = ent[1]
                    COUNTERS.inc("reused_buffers")
                    reused += 1
                    continue
                # a conversion the enabled cache could not serve (reuse=False
                # converts by design and does not count)
                COUNTERS.inc("buffer_reuse_misses")
            if TIMELINE.enabled:
                # coercion and the copy's enqueue, on this (stager) thread:
                # a sub-span of the stage span
                tc = TIMELINE.now_us()
                dev = self._to_device(name, val, used)
                TIMELINE.record_complete(f"stage::convert({name})", tc,
                                         TIMELINE.now_us() - tc, cat="staging")
            else:
                dev = self._to_device(name, val, used)
            staged[name] = dev
            if key is None:
                continue
            try:
                ent_map[key] = (weakref.ref(val), dev)
            except TypeError:
                continue           # not weakrefable: identity unverifiable
            while len(ent_map) > self.REUSE_DEPTH:
                ent_map.popitem(last=False)
        if self._cuda:
            staged.event = torch.cuda.Event()
            staged.event.record(self._stream)
            for slot in used:
                slot.event = staged.event
        staged.nbytes = sum(int(v.numel() * v.element_size()) for v in staged.values()
                            if isinstance(v, torch.Tensor))
        if TIMELINE.enabled:
            now = TIMELINE.now_us()
            TIMELINE.record_complete(f"stage[{seq}]", t0, now - t0, cat="staging",
                                     args={"reused_buffers": reused, "feeds": len(feed)})
            # the flow's tail, on the stage span; the executor step that
            # reads this batch records its head
            staged.flow_id = next_flow_id()
            TIMELINE.record_flow("s", "staged_batch", staged.flow_id, now - 1.0)
        if self._on_batch is not None:
            self._on_batch(feed, staged)
        return staged

    def _worker(self, it: Iterator[dict]):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
                torch.cuda.set_stream(self._stream)
            for seq, feed in enumerate(it):
                if self._stop.is_set():
                    return
                staged = self._stage_one(feed, seq)
                COUNTERS.inc("staged_batches")
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        self._add_bytes(staged.nbytes)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 -- relayed to the consumer
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_EOS, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer side -----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> StagedBatch:
        if self._q.empty() and self._thread.is_alive():
            # the device raced ahead of host staging: an observable, not an error
            COUNTERS.inc("sync_stalls")
        while True:
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # closed (queue drained) or the worker died: end cleanly
                    if self._error is not None:
                        raise self._error
                    raise StopIteration
        if isinstance(item, _EndOfStream):
            self.close()
            if self._error is not None:
                raise self._error
            raise StopIteration
        self._add_bytes(-item.nbytes)
        return item

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the staging thread and drop parked batches (safe to call
        repeatedly; used on early exit from a training loop).  The queue is
        drained again after the thread has ended: a batch it parked while
        stopping would otherwise stay counted in flight."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=2.0)
        self._drain()
        with self._bytes_lock:
            self._bytes_in_flight = 0


def executable_fingerprint(program_fp: str, feed_sig, state_sig,
                           fetch_names: Sequence[str], amp,
                           passes_fp: Optional[str], kernels_fp: Optional[str],
                           device: str, matmul_flags: Dict[str, Any]) -> str:
    """Canonical fingerprint of one cache entry: the program's
    fingerprint, the feeds' and state's (name, shape, dtype), the fetch
    names, the amp descriptor, the pass and kernel-policy fingerprints,
    the torch version, the device's name and the matmul flags a capture
    bakes in (TF32, reduced-precision reductions).  Stable across
    processes and executors: it holds no address."""
    payload = json.dumps({
        "program": program_fp,
        "feeds": list(feed_sig),
        "state": list(state_sig),
        "fetches": list(fetch_names),
        "amp": amp if isinstance(amp, str) else bool(amp),
        "passes": passes_fp,
        "kernels": kernels_fp,
        "torch": torch.__version__,
        "device": device,
        "matmul": matmul_flags,
    }, sort_keys=True, default=str)
    return hashlib.sha1(payload.encode()).hexdigest()
