"""Dynamic micro-batching engine: coalesce concurrent inference requests
into one padded device batch.

Callers :meth:`BatchingEngine.submit` row-major feed dicts and get a
``concurrent.futures.Future``.  A dispatcher thread pops requests off a
bounded queue, waits up to ``max_wait_ms`` for more (first come first
batched, never splitting a request), concatenates the rows, pads with zero
rows to the next bucketed batch size (powers of two by default) and makes
ONE ``runner(feed)`` call -- normally ``Inferencer.infer(feed, sync=False)``,
which returns :class:`~paddle_tpu_torch.core.staging.FetchHandle`\\ s as
soon as the batch is enqueued on the card.  Each future resolves to a
:class:`BatchSlice` holding the shared handles plus that request's row
window, so the batch is copied to the host once and each caller gets only
its own rows.

Admission control: the queue is bounded (:class:`ServingOverloaded` on
overflow) and every request carries a deadline; requests that expire while
queued are dropped at dispatch with :class:`RequestTimeout`.

Counters are per engine (:meth:`BatchingEngine.stats`), and mirrored
process-wide in the telemetry registry's ``"serving"`` scope (with the
``batch_size`` and ``request_latency_s`` histograms and the ``queue_depth``
gauge), which ``telemetry.snapshot()``, ``prometheus_text()`` and
``tools/stats.py`` read.  Each request gets a trace context at submit, a
child of the caller's active one (a new root when there is none and
tracing is on: ``PADDLE_TPU_TELEMETRY_DIR`` set); a dispatched batch's
span is a child of its first member's, with ``links`` to every member.
``infer`` writes a ``kind: request`` row (latency split into queue,
device and demux seconds) and each batch a ``kind: batch`` row to
``serving_<pid>.jsonl``, which ``tools/trace_tool.py`` assembles into
trees.  While the timeline is enabled, ``serve::submit`` and
``serve::batch[<seq>]`` spans are joined by ``serve_request`` flows.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..core.staging import FetchHandle
from ..telemetry import REGISTRY, TIMELINE, next_flow_id

__all__ = ["BatchingEngine", "BatchSlice", "ServingError", "ServingOverloaded",
           "RequestTimeout", "ServingNonFinite", "ServingClosed", "pow2_buckets",
           "SERVING_SCOPE"]

SERVING_SCOPE = "serving"

# batch-size histogram edges: exact powers of two (the default buckets), so
# the histogram shows one row a dispatched bucket size
_BATCH_HIST_BUCKETS = tuple(float(1 << i) for i in range(13))

_COUNTERS = ("requests", "requests_dispatched", "requests_expired",
             "requests_rejected", "batches", "rows_dispatched", "padded_rows",
             "dispatch_errors", "requests_nonfinite")


class ServingError(RuntimeError):
    """Base class for serving-side request failures."""


class ServingOverloaded(ServingError):
    """The bounded request queue is full."""


class ServingClosed(ServingError):
    """The engine was closed before the request could dispatch."""


class RequestTimeout(ServingError, TimeoutError):
    """The request's deadline expired before its batch completed.
    ``where``: ``"queue"``, ``"dispatch"`` or ``"device"``."""

    def __init__(self, msg: str = "", where: str = "unknown"):
        super().__init__(msg)
        self.where = where


class ServingNonFinite(ServingError):
    """The NaN-output guard tripped on this request's rows."""

    def __init__(self, msg: str, fetch_indices=(), batch_seq: int = -1):
        super().__init__(msg)
        self.fetch_indices = tuple(fetch_indices)
        self.batch_seq = batch_seq


def pow2_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two batch sizes up to and including ``max_batch_size``."""
    out: List[int] = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b <<= 1
    out.append(max_batch_size)
    return tuple(out)


class _Request:
    __slots__ = ("inputs", "rows", "future", "deadline", "enqueued_at", "flow_id",
                 "trace")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline: Optional[float], flow_id: Optional[int],
                 trace: Optional[telemetry.TraceContext]):
        self.inputs = inputs
        self.rows = rows
        self.future: "Future[BatchSlice]" = Future()
        self.deadline = deadline
        self.enqueued_at = time.perf_counter()
        self.flow_id = flow_id
        # the request's span, a child of the caller's active context; None
        # when untraced
        self.trace = trace


class BatchSlice:
    """One request's window ``[start, stop)`` into a dispatched batch.
    ``materialize`` waits for the device result (the first caller pays
    the copy; batch-mates reuse it) and returns only this request's rows."""

    __slots__ = ("handles", "start", "stop", "batch_seq", "bucket")

    def __init__(self, handles: Sequence[Any], start: int, stop: int,
                 batch_seq: int, bucket: int):
        self.handles = handles
        self.start = start
        self.stop = stop
        self.batch_seq = batch_seq
        self.bucket = bucket

    def materialize(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        out = []
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        for h in self.handles:
            if isinstance(h, FetchHandle):
                t = None if deadline is None else max(0.0, deadline - time.monotonic())
                a = h.result(timeout=t)
            else:
                a = np.asarray(h)
            out.append(a[self.start:self.stop])
        return out


class BatchingEngine:
    """Coalesce concurrent ``infer`` requests into padded device batches.

    * ``max_batch_size`` -- rows per dispatched batch (and the largest
      bucket); a single request above it is rejected.
    * ``max_wait_ms`` -- how long the first request of a batch is held
      open for batch-mates.
    * ``max_queue`` -- admission bound on queued requests.
    * ``default_timeout_s`` -- per-request deadline when none is given.
    * ``buckets`` -- allowed padded batch sizes (default powers of two).
    """

    def __init__(self, runner: Callable[[dict], Sequence[Any]],
                 max_batch_size: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = 30.0,
                 buckets: Optional[Sequence[int]] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 nan_guard: bool = False):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._runner = runner
        self.nan_guard = bool(nan_guard)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.default_timeout_s = default_timeout_s
        self.buckets: Tuple[int, ...] = tuple(sorted(
            int(b) for b in (buckets or pow2_buckets(self.max_batch_size))))
        if self.buckets[-1] < self.max_batch_size:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch_size "
                f"{self.max_batch_size}: the fullest batch has no shape")
        self._feed_names = frozenset(feed_names) if feed_names else None
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._carry: Optional[_Request] = None
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._counts = dict.fromkeys(_COUNTERS, 0)
        self._counts_lock = threading.Lock()
        self._seq = 0
        # the process-wide mirror of the counters (shared by every engine)
        self._m = {name: REGISTRY.counter(name, scope=SERVING_SCOPE) for name in _COUNTERS}
        self._h_batch = REGISTRY.histogram("batch_size", scope=SERVING_SCOPE,
                                           buckets=_BATCH_HIST_BUCKETS)
        self._h_latency = REGISTRY.histogram("request_latency_s", scope=SERVING_SCOPE)
        self._g_depth = REGISTRY.gauge("queue_depth", scope=SERVING_SCOPE)
        self._records = telemetry.StepTelemetry(capacity=4096, prefix="serving")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="paddle_tpu_torch-serving-dispatch")
        self._thread.start()

    def _inc(self, name: str, n: int = 1):
        with self._counts_lock:
            self._counts[name] += n
        self._m[name].inc(n)

    def stats(self) -> Dict[str, Any]:
        """Counter snapshot plus ``coalesce_ratio`` (dispatched requests per
        batch) and the current ``queue_depth``."""
        with self._counts_lock:
            s: Dict[str, Any] = dict(self._counts)
        s["coalesce_ratio"] = (s["requests_dispatched"] / s["batches"]
                               if s["batches"] else 0.0)
        s["queue_depth"] = self.queue_depth
        return s

    @property
    def queue_depth(self) -> int:
        return self._q.qsize() + (1 if self._carry is not None else 0)

    # ------------------------------------------------------------- ingress
    def submit(self, inputs: Dict[str, Any],
               timeout: Optional[float] = None) -> "Future[BatchSlice]":
        """Enqueue one request (a feed dict whose values share a leading
        row dim) and return its future."""
        return self._submit(inputs, timeout=timeout).future

    def _submit(self, inputs: Dict[str, Any],
                timeout: Optional[float] = None) -> _Request:
        if self._stop.is_set():
            raise ServingClosed("engine is closed")
        if not inputs:
            raise ValueError("empty feed dict")
        if self._feed_names is not None:
            missing = self._feed_names - set(inputs)
            # @SEQ_LEN length channels ride along with ragged feeds
            extra = {n for n in set(inputs) - self._feed_names
                     if "@SEQ_LEN" not in n}
            if missing or extra:
                raise ValueError(
                    f"feed names {sorted(inputs)} do not match the engine's "
                    f"model signature {sorted(self._feed_names)} "
                    f"(missing={sorted(missing)}, unexpected={sorted(extra)})")
        arrays: Dict[str, np.ndarray] = {}
        rows = None
        for k, v in inputs.items():
            a = v if isinstance(v, np.ndarray) else np.asarray(v)
            if a.ndim == 0:
                raise ValueError(f"feed {k!r} is a scalar -- serving "
                                 f"requests are row-major (rank >= 1)")
            if rows is None:
                rows = int(a.shape[0])
            elif int(a.shape[0]) != rows:
                raise ValueError(
                    f"inconsistent row counts in request: feed {k!r} has "
                    f"{a.shape[0]} rows, expected {rows}")
            arrays[k] = a
        if rows == 0:
            raise ValueError("empty request (0 rows)")
        if rows > self.max_batch_size:
            raise ServingError(
                f"request of {rows} rows exceeds max_batch_size="
                f"{self.max_batch_size}; split it client-side")
        if timeout is None:
            timeout = self.default_timeout_s
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        flow_id = None
        if TIMELINE.enabled:
            # the flow's tail on the caller's lane: the arrow to the batch
            # that carries this request
            ts = TIMELINE.now_us()
            TIMELINE.record_complete("serve::submit", ts, 1.0, cat="serving",
                                     args={"rows": rows})
            flow_id = next_flow_id()
            TIMELINE.record_flow("s", "serve_request", flow_id, ts + 0.5)
        ctx = telemetry.current_trace()
        trace = ctx.child() if ctx is not None else (
            telemetry.TraceContext.new_root() if telemetry.tracing_enabled() else None)
        req = _Request(arrays, rows, deadline, flow_id, trace)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._inc("requests_rejected")
            raise ServingOverloaded(
                f"request queue full ({self._q.maxsize} waiting); retry "
                f"with backoff or raise max_queue") from None
        self._inc("requests")
        self._g_depth.set(self.queue_depth)
        if self._drained.is_set():
            # close() raced this submit: nothing will pop the request
            self._fail_parked()
        return req

    def infer(self, inputs: Dict[str, Any],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous request: submit, wait for the batch, return ONLY
        this request's rows (one array per model fetch).  Raises
        :class:`RequestTimeout` when the deadline lapses first.  Writes a
        ``kind: request`` record: ``latency_s`` = ``queue_s`` (submit to
        dispatched) + ``device_s`` (waiting for the device result) +
        ``demux_s`` (slicing and the NaN guard)."""
        t0 = time.perf_counter()
        if timeout is None:
            timeout = self.default_timeout_s
        req = self._submit(inputs, timeout=timeout)
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        try:
            sl = req.future.result(timeout=timeout)
        except (TimeoutError, _FutureTimeout) as e:
            if isinstance(e, RequestTimeout):
                raise
            raise RequestTimeout(
                f"request not dispatched within {timeout}s "
                f"(queue_depth={self.queue_depth})", where="queue") from None
        queue_s = time.perf_counter() - t0
        rest = None if deadline is None else max(0.0, deadline - time.monotonic())
        try:
            out = sl.materialize(timeout=rest)
        except TimeoutError as e:
            if isinstance(e, RequestTimeout):
                raise
            self._inc("requests_expired")
            raise RequestTimeout(
                f"device result not ready within {timeout}s (batch "
                f"{sl.batch_seq}): {e}", where="device") from None
        device_s = time.perf_counter() - t0 - queue_s
        trace = req.trace.fields() if req.trace else {}
        if self.nan_guard:
            bad = [i for i, a in enumerate(out)
                   if a.dtype.kind == "f" and not bool(np.isfinite(a).all())]
            if bad:
                self._inc("requests_nonfinite")
                guard = time.perf_counter() - t0
                self._records.record(
                    kind="event", event="non-finite-output", fetch_indices=bad,
                    rows=sl.stop - sl.start, batch_seq=sl.batch_seq, bucket=sl.bucket,
                    latency_s=round(guard, 6), queue_s=round(queue_s, 6),
                    device_s=round(device_s, 6),
                    demux_s=round(guard - queue_s - device_s, 6), **trace)
                raise ServingNonFinite(
                    f"model produced non-finite values in output fetch(es) "
                    f"{bad} for this request (batch {sl.batch_seq}); response "
                    f"withheld by the NaN guard", fetch_indices=bad,
                    batch_seq=sl.batch_seq)
        latency = time.perf_counter() - t0
        self._h_latency.observe(latency)
        self._records.record(kind="request", latency_s=round(latency, 6),
                             rows=sl.stop - sl.start, batch_seq=sl.batch_seq,
                             bucket=sl.bucket, queue_s=round(queue_s, 6),
                             device_s=round(device_s, 6),
                             demux_s=round(latency - queue_s - device_s, 6), **trace)
        return out

    # ---------------------------------------------------------- dispatcher
    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if b >= rows:
                return b
        return self.buckets[-1]

    def _take(self, block_s: float) -> Optional[_Request]:
        try:
            return self._q.get(timeout=block_s) if block_s > 0 \
                else self._q.get_nowait()
        except queue.Empty:
            return None

    def _worker(self):
        while True:
            first = self._carry
            self._carry = None
            while first is None:
                if self._stop.is_set() and self._q.empty():
                    self._drained.set()
                    return
                first = self._take(0.05)
            batch, rows = [first], first.rows
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch_size:
                # draining (close) skips the coalesce wait
                wait = 0.0 if self._stop.is_set() else deadline - time.monotonic()
                nxt = self._take(max(0.0, wait))
                if nxt is None:
                    break
                if rows + nxt.rows > self.max_batch_size:
                    self._carry = nxt   # head of the NEXT batch
                    break
                batch.append(nxt)
                rows += nxt.rows
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 -- the engine survives a bad batch
                self._inc("dispatch_errors")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _dispatch(self, batch: List[_Request]):
        now = time.monotonic()
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                self._inc("requests_expired")
                r.future.set_exception(RequestTimeout(
                    f"deadline expired after "
                    f"{time.perf_counter() - r.enqueued_at:.3f}s in queue",
                    where="dispatch"))
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        bucket = self._bucket_for(rows)
        pad = bucket - rows
        t0 = time.perf_counter()
        ts = TIMELINE.now_us() if TIMELINE.enabled else None
        self._seq += 1
        feed: Dict[str, np.ndarray] = {}
        for name in live[0].inputs:
            parts = [r.inputs[name] for r in live]
            if pad:
                # padded rows carry zeros; demux slices them away
                parts.append(np.zeros((pad,) + parts[0].shape[1:],
                                      dtype=parts[0].dtype))
            feed[name] = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        assemble_s = time.perf_counter() - t0
        # one batch span fans in the requests' spans: a child of the first
        # member's, with links to every member.  It is active around the
        # runner, so capture records and fetch handles inherit it.
        first = next((r.trace for r in live if r.trace is not None), None)
        btrace = first.child() if first is not None else None
        with telemetry.use_trace(btrace):
            handles = list(self._runner(feed))
        dispatch_s = time.perf_counter() - t0 - assemble_s
        start = 0
        for r in live:
            r.future.set_result(BatchSlice(handles, start, start + r.rows,
                                           self._seq, bucket))
            start += r.rows
        self._inc("requests_dispatched", len(live))
        self._inc("batches")
        self._inc("rows_dispatched", rows)
        self._inc("padded_rows", pad)
        self._h_batch.observe(bucket)
        self._g_depth.set(self.queue_depth)
        if ts is not None:
            end = TIMELINE.now_us()
            TIMELINE.record_complete(f"serve::batch[{self._seq}]", ts, end - ts, cat="serving",
                                     args={"requests": len(live), "rows": rows,
                                           "bucket": bucket, "padded_rows": pad})
            for r in live:      # the flows' heads land on this batch's span
                if r.flow_id is not None:
                    TIMELINE.record_flow("f", "serve_request", r.flow_id, ts + (end - ts) / 2.0)
        extra: Dict[str, Any] = btrace.fields() if btrace is not None else {}
        links = [{"trace_id": r.trace.trace_id, "span_id": r.trace.span_id}
                 for r in live if r.trace is not None]
        if links:
            extra["links"] = links
        self._records.record(kind="batch", batch_seq=self._seq, requests=len(live),
                             rows=rows, bucket=bucket, padded_rows=pad,
                             queue_depth=self.queue_depth, assemble_s=round(assemble_s, 6),
                             dispatch_s=round(dispatch_s, 6), **extra)

    # ------------------------------------------------------------ lifecycle
    def _fail_parked(self):
        """Fail every request still queued or carried with ServingClosed."""
        leftovers = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        try:
            while True:
                leftovers.append(self._q.get_nowait())
        except queue.Empty:
            pass
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(ServingClosed(
                    "engine closed before the request could dispatch"))

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Reject new submits; with ``drain`` finish every queued request
        first.  Stragglers that raced the close get ServingClosed."""
        self._stop.set()
        if drain:
            self._drained.wait(timeout=timeout)
        self._thread.join(timeout=max(0.0, timeout))
        self._fail_parked()
        self._records.reopen()     # closes this engine's serving_<pid>.jsonl handle

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
