"""Unified telemetry: metrics registry, multi-lane trace timeline, and
step-level training records.

A copy of the JAX package's ``telemetry`` module, which is stdlib-only:
the same registry, timeline and step records, the same JSONL schema and
the same ``PADDLE_TPU_TELEMETRY_DIR`` export, so ``tools/stats.py`` reads
the port's step records unedited.  Feed staging and fetches run off the
main thread, where a single-lane host profiler cannot see them.  This
module is the shared substrate every observability surface sits on:

1. :class:`MetricsRegistry` — process-wide counters / gauges / histograms
   with *scopes* (one scope per executor, one for the pipeline, one per
   trainer), generalizing the ad-hoc ``PipelineCounters`` singleton.
   Always on, lock-cheap, JSON-serializable snapshots.
2. :class:`Timeline` — the chrome://tracing event buffer behind
   ``profiler.RecordEvent``: complete spans on *named lanes* (stable small
   tids assigned per thread by :class:`_TidRegistry` — no more
   ``get_ident() & 0xFFFF`` aliasing), flow events linking a staged batch
   to the step that consumed it, and synthetic lanes (the derived device
   lane built from FetchHandle dispatch→ready timestamps).
3. :class:`StepTelemetry` — an in-memory ring of per-step training records
   (step time, examples/sec, stall time, cache state) with JSONL export
   when ``PADDLE_TPU_TELEMETRY_DIR`` is set; ``tools/stats.py`` renders
   summaries from the JSONL, :func:`snapshot` from the live process.

Deliberately stdlib-only (no torch, no numpy).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "Timeline", "TIMELINE", "StepTelemetry", "STEPS", "snapshot",
    "next_flow_id", "telemetry_dir", "process_rank", "reset_scope",
    "TraceContext", "current_trace", "use_trace", "start_span",
    "tracing_enabled", "prometheus_text",
]


def telemetry_dir() -> Optional[str]:
    """The JSONL export directory (``PADDLE_TPU_TELEMETRY_DIR``), or None
    when export is disabled."""
    d = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    return d or None


def process_rank() -> int:
    """This process's trainer rank, for stamping telemetry records so the
    cross-rank tools (``tools/health_report.py``) can merge per-rank JSONL
    without filename heuristics.  ``PADDLE_TRAINER_ID`` wins (the
    reference env contract); otherwise the ``torch.distributed`` rank when
    a process group is initialized (this module never imports torch); else
    0.  Computed per record — rank can change when a group is set up
    mid-process."""
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    import sys
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:  # noqa: BLE001 — stamping must never raise
            pass
    return 0


# ------------------------------------------------------------------ tracing

class TraceContext:
    """One span's identity in a Dapper-style distributed trace.

    ``trace_id`` names the whole causal tree (one request, one dispatch
    task); ``span_id`` names this unit of work inside it; ``parent_id``
    links upward.  Contexts are immutable — :meth:`child` mints the next
    hop.  The wire encoding is W3C traceparent
    (``00-<32 hex trace>-<16 hex span>-01``), so the HTTP front door and
    the dispatch line-JSON protocol carry the same string.

    Every :class:`StepTelemetry` record written while a context is active
    (see :func:`use_trace`) is stamped with its three ids, which is what
    lets ``tools/trace_tool.py`` reassemble per-process JSONL streams
    into one tree.  Records that *define* a span pass the ids explicitly
    via :meth:`fields`; explicit fields always win over the ambient
    context."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id or os.urandom(8).hex()
        self.parent_id = parent_id

    @classmethod
    def new_root(cls) -> "TraceContext":
        """A fresh trace: new 128-bit trace_id, no parent."""
        return cls(os.urandom(16).hex())

    def child(self) -> "TraceContext":
        """The next span down: same trace, new span_id, parented here."""
        return TraceContext(self.trace_id, parent_id=self.span_id)

    def fields(self) -> Dict[str, str]:
        """The JSONL stamping dict (``parent_id`` omitted on roots)."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        return d

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: Optional[str]
                         ) -> Optional["TraceContext"]:
        """Parse a traceparent header into the REMOTE side's context
        (callers make a :meth:`child` for their own work).  Returns None
        on anything malformed — propagation must never raise."""
        if not header:
            return None
        parts = str(header).strip().split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id = parts[0], parts[1], parts[2]
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16)
            int(span_id, 16)
        except ValueError:
            return None
        return cls(trace_id, span_id=span_id)

    def __repr__(self):
        return (f"TraceContext(trace={self.trace_id[:8]}…, "
                f"span={self.span_id}, parent={self.parent_id})")


_TRACE: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("paddle_tpu_trace", default=None)


def current_trace() -> Optional[TraceContext]:
    """The contextvar-propagated active span, or None when untraced."""
    return _TRACE.get()


def tracing_enabled() -> bool:
    """Whether NEW root traces should be minted.  Tied to the telemetry
    dir: without a JSONL sink there is nowhere for spans to land, so
    tracing stays zero-cost.  An already-propagated remote context is
    always honored regardless (the sender paid for it)."""
    return telemetry_dir() is not None


@contextlib.contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Activate ``ctx`` for the dynamic extent of the with-block (records
    written inside inherit its ids).  ``None`` is a no-op, so call sites
    never need to branch."""
    if ctx is None:
        yield None
        return
    token = _TRACE.set(ctx)
    try:
        yield ctx
    finally:
        _TRACE.reset(token)


@contextlib.contextmanager
def start_span(parent: Optional[TraceContext] = None, *,
               root: bool = False):
    """The common span-opening move: child of ``parent`` (default: the
    ambient context), else — when ``root`` and :func:`tracing_enabled` —
    a fresh root, else None (untraced, zero allocations)."""
    base = parent if parent is not None else _TRACE.get()
    if base is not None:
        ctx: Optional[TraceContext] = base.child()
    elif root and tracing_enabled():
        ctx = TraceContext.new_root()
    else:
        ctx = None
    with use_trace(ctx):
        yield ctx


# ------------------------------------------------------------------ metrics

class Counter:
    """Monotonic counter.  ``inc`` is a locked add — cheap enough for the
    hot path (the GIL serializes the reads anyway; the lock makes the
    read-modify-write atomic under free-threading too)."""

    __slots__ = ("name", "scope", "_v", "_lock")

    def __init__(self, name: str, scope: str = ""):
        self.name = name
        self.scope = scope
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        if not n:
            return
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self):
        with self._lock:
            self._v = 0

    def snap(self):
        return self._v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache bytes)."""

    __slots__ = ("name", "scope", "_v")

    def __init__(self, name: str, scope: str = ""):
        self.name = name
        self.scope = scope
        self._v = 0.0

    def set(self, v: float):
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def reset(self):
        self._v = 0.0

    def snap(self):
        return self._v


# default bucket boundaries: 1µs .. ~1000s in x4 steps (seconds) — wide
# enough for step times and stage spans alike; pass explicit buckets for
# anything else
DEFAULT_BUCKETS = tuple(1e-6 * 4 ** i for i in range(15))


class Histogram:
    """Fixed-boundary histogram: ``len(buckets)+1`` counts (the last is the
    +inf overflow), plus exact count/sum/min/max.  ``percentile`` linearly
    interpolates inside the winning bucket — the always-on cheap estimate;
    exact percentiles come from the raw JSONL records."""

    __slots__ = ("name", "scope", "buckets", "counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name: str, scope: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.scope = scope
        self.buckets: Tuple[float, ...] = tuple(
            sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket_index(self, v: float) -> int:
        # first boundary >= v (boundaries are upper-inclusive edges)
        import bisect
        return bisect.bisect_left(self.buckets, v)

    def observe(self, v: float):
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0,1]) by linear interpolation within
        the bucket containing the target rank; exact at the recorded min
        and max."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
            lo, hi = self.min, self.max
        if not total:
            return 0.0
        if q <= 0:
            return lo
        if q >= 1:
            return hi
        target = q * total
        acc = 0.0
        for i, c in enumerate(counts):
            if acc + c >= target and c:
                left = self.buckets[i - 1] if i > 0 else min(lo, self.buckets[0])
                right = self.buckets[i] if i < len(self.buckets) else hi
                left = max(left, lo)
                right = min(right, hi) if right >= left else left
                frac = (target - acc) / c
                return left + (right - left) * frac
            acc += c
        return hi

    def reset(self):
        with self._lock:
            self.counts = [0] * (len(self.buckets) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf

    def snap(self) -> Dict[str, Any]:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            d = {"count": self.count, "sum": self.sum,
                 "min": self.min, "max": self.max,
                 "mean": self.sum / self.count}
        d["p50"] = self.percentile(0.5)
        d["p95"] = self.percentile(0.95)
        return d


class MetricsRegistry:
    """Process-wide named metrics, grouped by *scope*.

    A scope is a free-form string key — ``"pipeline"`` for the process-wide
    pipeline counters, ``"executor:3"`` for one executor's cache counters,
    ``"trainer"`` for step-time histograms — so two executors' ``compiles``
    never collide and ``snapshot()`` can render either one scope flat or
    everything nested.  Metric identity is (scope, name); re-requesting an
    existing metric returns the same object (type mismatch raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str], Any] = {}

    def _get(self, cls, name: str, scope: str, **kw):
        key = (scope, name)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, scope, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} in scope {scope!r} already registered "
                    f"as {type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, scope: str = "") -> Counter:
        return self._get(Counter, name, scope)

    def gauge(self, name: str, scope: str = "") -> Gauge:
        return self._get(Gauge, name, scope)

    def histogram(self, name: str, scope: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get(Histogram, name, scope, buckets=buckets)

    def scopes(self) -> List[str]:
        with self._lock:
            return sorted({s for s, _ in self._metrics})

    def snapshot(self, scope: Optional[str] = None) -> Dict[str, Any]:
        """``snapshot(scope)`` → flat {name: value} for that scope;
        ``snapshot()`` → nested {scope: {name: value}} over every scope.
        Values are ints/floats (counters, gauges) or dicts (histograms) —
        JSON-serializable throughout."""
        with self._lock:
            items = list(self._metrics.items())
        if scope is not None:
            return {n: m.snap() for (s, n), m in items if s == scope}
        out: Dict[str, Dict[str, Any]] = {}
        for (s, n), m in items:
            out.setdefault(s, {})[n] = m.snap()
        return out

    def reset(self, scope: Optional[str] = None):
        with self._lock:
            items = list(self._metrics.items())
        for (s, _), m in items:
            if scope is None or s == scope:
                m.reset()


REGISTRY = MetricsRegistry()


def reset_scope(*scopes: str):
    """Zero every counter/gauge/histogram in the named scope(s) of the
    process-wide :data:`REGISTRY`.

    Scoped metrics are process-global by design (the serving engine's
    ``"serving"`` counters, the checkpoint manager's ``"checkpoint"``
    scope, ...), so a test that asserts ABSOLUTE counter values inherits
    whatever earlier tests in the process accumulated.  Call this first
    (the ``reset_telemetry_scope`` conftest fixture wraps it) so such
    assertions never depend on execution order."""
    for s in scopes:
        REGISTRY.reset(scope=s)


# ----------------------------------------------------------------- timeline

class _TidRegistry:
    """Stable small tids for trace lanes.

    ``threading.get_ident() & 0xFFFF`` could alias two threads into one
    lane; here every thread gets the next integer on first use, keyed by
    full ident, and carries its thread *name* into chrome-trace
    ``thread_name`` metadata.  Synthetic lanes (the derived device lane)
    reserve tids from the same sequence via :meth:`lane`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_ident: Dict[int, int] = {}
        self._names: Dict[int, str] = {}
        self._lanes: Dict[str, int] = {}
        self._next = 0
        # lane 0 is always the main host thread, even if a worker records
        # the first event
        main = threading.main_thread()
        self._by_ident[main.ident] = 0
        self._names[0] = "main"
        self._next = 1

    def tid_for_current(self) -> int:
        ident = threading.get_ident()
        name = threading.current_thread().name
        with self._lock:
            tid = self._by_ident.get(ident)
            if tid is not None and tid != 0 \
                    and self._names.get(tid) != name:
                # the OS recycles thread idents: a dead worker's ident can
                # resurface on a brand-new thread (a FeedStager inheriting
                # a finished serving dispatcher's lane).  A name mismatch
                # means this ident belongs to a different thread now —
                # re-key it.  Lane 0 (main) is exempt: it is pre-named
                # "main" and the main thread outlives the registry.
                tid = None
            if tid is None:
                tid = self._next
                self._next += 1
                self._by_ident[ident] = tid
                self._names[tid] = name
            return tid

    def lane(self, name: str) -> int:
        """Tid of a synthetic (non-thread) lane, created on first use."""
        with self._lock:
            tid = self._lanes.get(name)
            if tid is None:
                tid = self._next
                self._next += 1
                self._lanes[name] = tid
                self._names[tid] = name
            return tid

    def names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._names)


_flow_ids = itertools.count(1)


def next_flow_id() -> int:
    """Process-unique id tying a flow's 's' and 'f' events together."""
    return next(_flow_ids)


class Timeline:
    """Thread-safe chrome://tracing event buffer.

    Spans are recorded only while ``enabled`` (profiler start/stop), so the
    hot path costs one attribute read when profiling is off.  Timestamps
    are µs relative to the last ``reset()``."""

    DEVICE_LANE = "device"

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0 = time.perf_counter()
        self.tids = _TidRegistry()

    # -- clock -------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        with self._lock:
            self._events = []
        self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------
    def record_complete(self, name: str, ts: float, dur: float,
                        tid: Optional[int] = None, cat: str = "host",
                        args: Optional[dict] = None):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "pid": 0,
              "tid": self.tids.tid_for_current() if tid is None else tid,
              "ts": ts, "dur": dur}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def record_flow(self, phase: str, name: str, flow_id: int, ts: float,
                    tid: Optional[int] = None, cat: str = "flow"):
        """``phase`` is 's' (start) or 'f' (finish).  The finish side binds
        to the enclosing slice ('bp': 'e'), which is how the staged batch
        arrow lands on the consuming step's span."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": phase, "pid": 0,
              "tid": self.tids.tid_for_current() if tid is None else tid,
              "ts": ts, "id": flow_id}
        if phase == "f":
            ev["bp"] = "e"
        with self._lock:
            self._events.append(ev)

    def record_device_span(self, name: str, ts: float, dur: float,
                           args: Optional[dict] = None):
        """A span on the derived device lane (FetchHandle dispatch→ready)."""
        self.record_complete(name, ts, dur,
                             tid=self.tids.lane(self.DEVICE_LANE),
                             cat="device", args=args)

    # -- export ------------------------------------------------------------
    def events(self, ph: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if ph is not None:
            evs = [e for e in evs if e["ph"] == ph]
        return evs

    def chrome_trace(self) -> dict:
        """The tools/timeline.py output contract, extended: thread_name /
        process_name metadata events name every lane that recorded; spans
        and flow events follow.  Empty when nothing was recorded (so an
        idle export stays ``traceEvents == []``)."""
        evs = self.events()
        if not evs:
            return {"displayTimeUnit": "ms", "traceEvents": []}
        used_tids = {e["tid"] for e in evs}
        meta: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0,
            "args": {"name": "paddle_tpu"}}]
        for tid, name in sorted(self.tids.names().items()):
            if tid in used_tids:
                meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                             "tid": tid, "args": {"name": name}})
                meta.append({"name": "thread_sort_index", "ph": "M",
                             "pid": 0, "tid": tid,
                             "args": {"sort_index": tid}})
        return {"displayTimeUnit": "ms", "traceEvents": meta + evs}


TIMELINE = Timeline()


# ----------------------------------------------------------- step telemetry

class StepTelemetry:
    """Ring buffer of per-step training records + optional JSONL export.

    A record is a flat JSON-serializable dict; the canonical fields the
    Trainer emits (``tools/stats.py`` keys off them):

    * ``step_time_s`` — wall time of the full step (wait + run + handler);
    * ``wait_s`` — time blocked waiting on the staged batch (host starved);
    * ``run_s`` / ``handler_s`` — executor dispatch / event-handler time;
    * ``examples`` / ``examples_per_sec``;
    * ``sync_stalls`` — sync-stall counter delta attributed to this step;
    * ``compiles`` — executor compile_count after the step (cache state).

    When ``PADDLE_TPU_TELEMETRY_DIR`` is set each record is appended to
    ``<prefix>_<pid>.jsonl`` in that directory as it happens, so a crashed
    or killed run keeps everything already written.  ``prefix`` defaults
    to ``"steps"`` (the Trainer stream); other record families reuse the
    same ring+sink machinery under their own prefix (the serving engine
    writes ``serving_<pid>.jsonl``)."""

    def __init__(self, capacity: int = 4096, prefix: str = "steps"):
        self._lock = threading.Lock()
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._sink = None          # lazily-opened JSONL file object
        self._sink_path: Optional[str] = None
        self._sink_failed = False
        self.prefix = prefix
        self.hist = REGISTRY.histogram("step_time_s", scope="trainer")

    # -- sink --------------------------------------------------------------
    def _ensure_sink(self):
        if self._sink is not None or self._sink_failed:
            return self._sink
        d = telemetry_dir()
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            self._sink_path = os.path.join(
                d, f"{self.prefix}_{os.getpid()}.jsonl")
            self._sink = open(self._sink_path, "a", buffering=1)
        except OSError:
            self._sink_failed = True      # telemetry must never kill a run
            self._sink = None
        return self._sink

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    # -- recording ---------------------------------------------------------
    def record(self, **fields):
        # rank/pid stamped into every record: cross-rank readers
        # (tools/health_report.py) merge per-rank streams by these, not
        # by parsing pids out of filenames.  t_mono rides along so the
        # cross-process merger can estimate each pid's wall-clock offset
        # (median of ts - t_mono) instead of trusting skewed wall clocks.
        rec = {"ts": time.time(), "t_mono": time.monotonic(),
               "pid": os.getpid(), "rank": process_rank()}
        rec.update(fields)
        if "trace_id" not in rec:
            ctx = _TRACE.get()
            if ctx is not None:
                rec["trace_id"] = ctx.trace_id
                rec["span_id"] = ctx.span_id
                if ctx.parent_id:
                    rec["parent_id"] = ctx.parent_id
        st = rec.get("step_time_s")
        if st is not None:
            self.hist.observe(st)
        with self._lock:
            self._ring.append(rec)
            sink = self._ensure_sink()
            if sink is not None:
                try:
                    sink.write(json.dumps(rec) + "\n")
                except OSError:
                    self._sink_failed = True
        return rec

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    # -- summary -----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return summarize_step_records(self.records())


def summarize_step_records(records: List[dict]) -> Dict[str, Any]:
    """Aggregate per-step records into the stats the ISSUE contract names:
    step-time p50/p95/max, examples/sec, stall totals.  Shared by the live
    :func:`snapshot` and ``tools/stats.py`` (which feeds it JSONL rows)."""
    recs = [r for r in records if r.get("step_time_s") is not None]
    out: Dict[str, Any] = {"steps": len(recs)}
    if not recs:
        return out
    times = sorted(float(r["step_time_s"]) for r in recs)

    def pct(q: float) -> float:
        if len(times) == 1:
            return times[0]
        pos = q * (len(times) - 1)
        i = int(pos)
        frac = pos - i
        j = min(i + 1, len(times) - 1)
        return times[i] * (1 - frac) + times[j] * frac

    total_time = sum(times)
    examples = sum(int(r.get("examples", 0)) for r in recs)
    out.update({
        "step_time_ms": {"p50": pct(0.5) * 1e3, "p95": pct(0.95) * 1e3,
                         "max": times[-1] * 1e3, "mean": total_time
                         / len(times) * 1e3},
        "examples": examples,
        "examples_per_sec": (examples / total_time) if total_time > 0
        else 0.0,
        "stalls": {
            "sync_stalls": sum(int(r.get("sync_stalls", 0)) for r in recs),
            "wait_s": sum(float(r.get("wait_s", 0.0)) for r in recs),
        },
        "compiles": max((int(r.get("compiles", 0)) for r in recs),
                        default=0),
    })
    return out


STEPS = StepTelemetry()


# -------------------------------------------------------- prometheus export

def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s or "_"


def _prom_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The :class:`MetricsRegistry` in Prometheus text exposition format
    (``GET /metrics`` on the FleetHTTPServer serves exactly this).

    Every metric becomes a ``paddle_tpu_<name>`` family with the scope as
    a label, so the same counter across two executors lands in one family
    with two label sets.  Histograms export cumulative ``_bucket`` series
    plus ``_sum``/``_count``.  A name registered as two different metric
    types in different scopes gets a type-suffixed family (Prometheus
    forbids mixed-type families)."""
    reg = registry if registry is not None else REGISTRY
    with reg._lock:
        items = sorted(reg._metrics.items())
    kinds = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
    by_name: Dict[str, List[str]] = {}
    for (scope, name), m in items:
        by_name.setdefault(name, []).append(kinds[type(m)])
    families: Dict[Tuple[str, str], List[Tuple[str, Any]]] = {}
    for (scope, name), m in items:
        kind = kinds[type(m)]
        fam = "paddle_tpu_" + _prom_name(name)
        if len(set(by_name[name])) > 1:
            fam = f"{fam}_{kind}"
        families.setdefault((fam, kind), []).append((scope, m))
    lines: List[str] = []
    for (fam, kind), members in sorted(families.items()):
        lines.append(f"# TYPE {fam} {kind}")
        for scope, m in members:
            lbl = f'{{scope="{_prom_label(m.scope)}"}}' if m.scope else ""
            if kind in ("counter", "gauge"):
                lines.append(f"{fam}{lbl} {_prom_num(m.snap())}")
                continue
            with m._lock:
                counts = list(m.counts)
                count, total = m.count, m.sum
            base = f'scope="{_prom_label(m.scope)}",' if m.scope else ""
            acc = 0
            for edge, c in zip(m.buckets, counts):
                acc += c
                lines.append(
                    f'{fam}_bucket{{{base}le="{_prom_num(edge)}"}} {acc}')
            lines.append(f'{fam}_bucket{{{base}le="+Inf"}} {count}')
            sfx = f"{{{base[:-1]}}}" if base else ""
            lines.append(f"{fam}_sum{sfx} {_prom_num(total)}")
            lines.append(f"{fam}_count{sfx} {count}")
    return "\n".join(lines) + "\n"


def snapshot() -> Dict[str, Any]:
    """One JSON-serializable view of everything telemetry knows right now:
    per-scope metrics, the step-record summary, and timeline size — the
    ``Executor.cache_info()`` analogue for the whole process."""
    return {
        "metrics": REGISTRY.snapshot(),
        "steps": STEPS.summary(),
        "trace_events": len(TIMELINE.events()),
        "telemetry_dir": telemetry_dir(),
    }
