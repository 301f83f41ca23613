"""The executor's pipeline plumbing: counters, pinned fetches and the
executable fingerprint.

* :data:`COUNTERS` -- process-wide pipeline counters (cache hits and
  misses, compiles, sync stalls, fetch timeouts), shared by every
  executor and shown by ``Executor.cache_info``.  The names are the JAX
  package's (``paddle_tpu/core/staging.py`` ``PipelineCounters``), so the
  telemetry registry can take them over when it is ported.
* :class:`FetchHandle` -- the value of a fetch.  On the card
  :func:`prefetch_to_host` enqueues its device-to-host copy into pinned
  host memory on the step's stream, right after the step, and records an
  event; the handle waits on that event when it is first read and hands
  out an array over the pinned buffer (a bf16 value as float32: numpy has
  no bfloat16).  Until then the step may still be running on the card, so
  the caller (the serving dispatcher) can enqueue the next batch meanwhile.
  A CPU tensor is read as it is.
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
import threading
import time
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .dtypes import to_numpy

__all__ = ["COUNTERS", "PipelineCounters", "PINNED_HANDOUT", "PINNED_HANDOUT_LIMIT",
           "FetchHandle", "FetchTimeoutError", "prefetch_to_host", "executable_fingerprint"]


class PipelineCounters:
    """Named integer counters of the pipeline, one instance
    (:data:`COUNTERS`) shared by every executor."""

    _FIELDS = ("compiles", "cache_hits", "cache_misses", "sync_stalls",
               "fetch_timeouts")

    def __init__(self):
        self._lock = threading.Lock()
        self._values = dict.fromkeys(self._FIELDS, 0)

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self._values[name] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._values)


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


class FetchHandle:
    """A fetched value that materializes to numpy on first access
    (``np.asarray(h)``, ``float(h)``, ``h.numpy()``).

    ``value`` is the tensor the handle reads: the pinned host copy once
    :func:`prefetch_to_host` has enqueued it (it may still be being
    written; :meth:`block` waits), else the fetched tensor.  A pinned
    value is handed out as an array over its buffer while
    :data:`PINNED_HANDOUT` is under its limit, else copied out to pageable
    memory (``value`` then becomes that copy)."""

    __slots__ = ("_val", "_event", "_np", "_pinned", "_lock")

    def __init__(self, val: torch.Tensor):
        self._val = val
        self._event: Optional[torch.cuda.Event] = None
        self._np = None
        self._pinned = False
        # batch-mates read one handle from several threads: one of them
        # makes the array (a copy, past the limit), the others reuse it
        self._lock = threading.Lock()

    @property
    def value(self) -> torch.Tensor:
        return self._val

    def ready(self) -> bool:
        return self._np is not None or self._event is None or self._event.query()

    def block(self) -> "FetchHandle":
        """Wait until the value is on the host."""
        if self._event is not None:
            self._event.synchronize()
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
                    COUNTERS.inc("fetch_timeouts")
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
    for h in handles:
        v = h._val
        if isinstance(v, torch.Tensor) and v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            h._val, h._pinned, device = host, True, v.device
            started.append(h)
    if started:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        for h in started:
            h._event = event
    return len(started)


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
