"""Profiler: host spans, chrome-trace export, per-op breakdowns and device
traces.

The port of the JAX package's ``profiler`` module, with Fluid's user
contract (``fluid.profiler.profiler(state, sorted_key, profile_path)``):

1. :class:`RecordEvent` spans and the executor's phase spans
   (``executor::feed`` / ``executor::run(...)`` / ``executor::fetch``, the
   stager's ``stage[<seq>]``) on named lanes of
   :data:`~paddle_tpu_torch.telemetry.TIMELINE` (one lane per thread, plus
   the device lane derived from fetch handles' dispatch and ready times),
   with flow events from each staged batch to the step that read it;
2. :func:`profiler`, the context manager: on exit it prints a summary
   table sorted by ``sorted_key`` and writes chrome://tracing JSON to
   ``profile_path``;
3. :func:`profile_ops` -- block 0 run op by op, each op timed to its
   outputs being ready on the device, as ``op::<type>`` spans; it runs on
   clones of the state it writes, so the scope is left as it was (the
   sampled per-op profiler is ``paddle_tpu_torch.profiling``);
4. :func:`device_trace` -- ``torch.profiler`` over the CPU and the card,
   exported as a Chrome/Perfetto trace.  While it is active every op the
   executor lowers is a ``record_function`` range named
   ``op<idx>:<type>@<file.py:line>``.  A replayed CUDA graph launches its
   kernels without running the ranges, so a trace of a replayed step shows
   the kernels but no op names; those come from eager runs and from the
   per-op profiler.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
from typing import Any, Dict, Optional

from .telemetry import TIMELINE

__all__ = [
    "RecordEvent", "profiler", "start_profiler", "stop_profiler",
    "reset_profiler", "export_chrome_tracing", "profile_ops",
    "device_trace", "DeviceTrace", "cuda_profiler", "get_pipeline_counters",
]


def get_pipeline_counters() -> Dict[str, int]:
    """Snapshot of the executor pipeline's process-wide counters (cache
    hits and misses, compiles, staged batches, reused buffers, sync
    stalls), counted in ``core/staging.py``."""
    from .core.staging import COUNTERS
    return COUNTERS.snapshot()


class RecordEvent:
    """A host span (Fluid's ``platform::RecordEvent``): records nothing
    unless the timeline is enabled.  The span lands on the calling
    thread's lane."""

    def __init__(self, name: str):
        self.name = name
        self._start = 0.0
        self._armed = False

    def __enter__(self):
        # armed at entry only: a span straddling start_profiler() must not
        # record a duration from a zero start
        self._armed = TIMELINE.enabled
        if self._armed:
            self._start = TIMELINE.now_us()
        return self

    def __exit__(self, *exc):
        if self._armed and TIMELINE.enabled:
            TIMELINE.record_complete(self.name, self._start,
                                     TIMELINE.now_us() - self._start)
        return False


def start_profiler(state: str = "All"):
    """Fluid's ``start_profiler``; ``state`` (CPU/GPU/All) is kept for the
    signature: there is one host timeline."""
    reset_profiler()
    TIMELINE.enabled = True


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: str = "/tmp/profile"):
    """Fluid's ``stop_profiler``: print the summary and write the
    chrome://tracing JSON to ``profile_path``."""
    TIMELINE.enabled = False
    _print_summary(sorted_key)
    export_chrome_tracing(profile_path)


def reset_profiler():
    TIMELINE.reset()


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: str = "/tmp/profile"):
    """Fluid's context manager::

        with profiler.profiler('All', 'total', '/tmp/profile'):
            for batch in data:
                exe.run(...)

    On exit prints the span summary (sorted by ``sorted_key``: calls /
    total / max / min / ave) and writes chrome://tracing JSON to
    ``profile_path``."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*args, **kwargs):
    """Fluid's ``cuda_profiler`` (it wrapped nvprof): on the card, the
    CUDA profiler API's start and stop around the block
    (``torch.cuda.profiler.profile``), for an external profiler attached
    to the process; on the CPU it warns and does nothing.  The arguments
    are Fluid's and are not used."""
    import torch
    if torch.cuda.is_available():
        with torch.cuda.profiler.profile():
            yield
        return
    import warnings
    warnings.warn("cuda_profiler does nothing without a CUDA device; use "
                  "profiler.device_trace(logdir) for a trace", stacklevel=3)
    yield


class DeviceTrace:
    """What :func:`device_trace` yields: ``profile``, the
    ``torch.profiler.profile`` object (its ``key_averages()`` and events
    are readable after the block), and ``path``, the exported trace
    (set when the block ends)."""

    def __init__(self, profile, path: str):
        self.profile = profile
        self.path: Optional[str] = None
        self._path = path


_TRACE_SEQ = itertools.count(1)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """The device's kernel timeline beside the host's: ``torch.profiler``
    over the CPU and, where there is one, the card, exported as a
    Chrome/Perfetto trace ``trace_<pid>_<n>.json`` into ``logdir``.

    ``logdir`` defaults to ``$PADDLE_TPU_TELEMETRY_DIR/xplane`` (the JAX
    package's directory name), so the trace lands beside the JSONL records
    of the same run; with neither, it raises."""
    from .telemetry import telemetry_dir
    if logdir is None:
        d = telemetry_dir()
        if d is None:
            raise ValueError(
                "device_trace needs a logdir: pass one explicitly or set "
                "PADDLE_TPU_TELEMETRY_DIR (the trace then defaults to its "
                "xplane/ subdir)")
        logdir = os.path.join(d, "xplane")
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    prof = profile(activities=activities)
    out = DeviceTrace(prof, path)
    with prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    out.path = path


# ---------------------------------------------------------------- reporting

def _summarize() -> Dict[str, dict]:
    rows: Dict[str, dict] = {}
    # the derived device lane re-plots time the host spans already count:
    # it belongs on the timeline, not in the host summary
    events = [e for e in TIMELINE.events(ph="X")
              if e.get("cat") != "device"]
    for ev in events:
        r = rows.setdefault(ev["name"],
                            {"calls": 0, "total": 0.0, "max": 0.0,
                             "min": float("inf")})
        r["calls"] += 1
        r["total"] += ev["dur"]
        r["max"] = max(r["max"], ev["dur"])
        r["min"] = min(r["min"], ev["dur"])
    for r in rows.values():
        r["ave"] = r["total"] / r["calls"]
    return rows


_SORT_KEYS = {"calls": "calls", "total": "total", "max": "max",
              "min": "min", "ave": "ave", "default": "total", None: "total"}


def _print_summary(sorted_key: Optional[str]):
    rows = _summarize()
    if not rows:
        return
    key = _SORT_KEYS.get(sorted_key, "total")
    order = sorted(rows.items(), key=lambda kv: kv[1][key], reverse=True)
    hdr = f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}{'Ave(us)':>12}" \
          f"{'Max(us)':>12}{'Min(us)':>12}"
    print("-" * len(hdr))
    print(hdr)
    print("-" * len(hdr))
    for name, r in order:
        print(f"{name[:39]:<40}{r['calls']:>8}{r['total']:>14.1f}"
              f"{r['ave']:>12.1f}{r['max']:>12.1f}{r['min']:>12.1f}")
    print("-" * len(hdr))
    counters = get_pipeline_counters()
    if any(counters.values()):
        print("pipeline counters: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counters.items())))


def export_chrome_tracing(path: str):
    """Write the collected multi-lane timeline as chrome://tracing JSON,
    with a thread_name per lane and the flow events (staged batch ->
    consuming step, request -> batch)."""
    with open(path, "w") as f:
        json.dump(TIMELINE.chrome_trace(), f)


# ---------------------------------------------------------- per-op profile

def profile_ops(program, feed: dict, scope=None, fetch_list=None,
                repeat: int = 1, executor=None):
    """Block 0 of ``program`` run op by op ``repeat`` times, each op timed
    to its outputs being ready (``torch.cuda.synchronize`` on the card) as
    an ``op::<type>`` span of the active timeline.  Each run lowers over
    clones of the state the block writes and draws from a generator of its
    own, so the scope and every generator are left as they were.

    Returns ``{op_type: {"calls", "total", "ave", "max", "min"}}`` in
    microseconds, derived from this call's spans.  ``executor`` coerces
    the feeds and picks the device (default: the state's device)."""
    from .core.lower import _SKIP_OPS
    from .profiling.op_profiler import _Replay

    block = program.desc.block(0)
    idx = [i for i, op in enumerate(block.ops) if op.type not in _SKIP_OPS]
    replay = _Replay(program, feed, scope, executor, idx)
    was_enabled = TIMELINE.enabled
    TIMELINE.enabled = True
    start = len(TIMELINE.events())
    try:
        for _ in range(max(1, int(repeat))):
            replay.run(span_prefix="op::")
    finally:
        TIMELINE.enabled = was_enabled
    events = [e for e in TIMELINE.events()[start:]
              if e["ph"] == "X" and e["name"].startswith("op::")]
    timings: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        r = timings.setdefault(ev["name"][len("op::"):],
                               {"calls": 0, "total": 0.0, "max": 0.0,
                                "min": float("inf")})
        r["calls"] += 1
        r["total"] += ev["dur"]
        r["max"] = max(r["max"], ev["dur"])
        r["min"] = min(r["min"], ev["dur"])
    for r in timings.values():
        r["ave"] = r["total"] / r["calls"]
    return timings
