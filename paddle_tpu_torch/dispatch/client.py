"""Worker side of the elastic data dispatch: the lease-loop client, the
paddle-style :class:`DispatchReader`, and the recordio chunk helpers that
turn a dataset into master tasks.

``DispatchClient`` speaks the master's line-JSON protocol with
reconnect + deterministic backoff around every call — a master restart
(new port, recovered queue) is invisible to the worker beyond added
latency, because the address file is re-read on every reconnect.

``DispatchReader`` adapts the lease loop to the ``paddle.reader``
contract (a zero-arg callable returning an iterator), so
``Trainer.train`` consumes dispatched data through the exact same path
as a local reader: get_task → heartbeat-renew while the samples stage →
task_finished; failures requeue via ``task_failed`` or, when the worker
dies outright, via the master's lease-expiry sweep.

Fault-injection sites (:mod:`paddle_tpu_torch.faults`):

* ``dispatch.task_start`` — fired before consuming each task
  (``kill@dispatch.task_start:n=3`` is the chaos worker death);
* ``dispatch.renew`` — each heartbeat (``drop``/``delay`` model lost or
  slow renewals);
* ``dispatch.finish`` — each ``task_finished`` callback (``fail``
  models a lost retirement: the lease expires and the task re-serves);
* ``dispatch.read`` — each yielded sample (``delay`` is the slow-reader
  stall).

Stdlib-only: jax-free chaos workers load this next to the master.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional

from .. import faults
from ..telemetry import TraceContext, process_rank
from .master import read_addr_file
from .taskqueue import DispatchError, make_range_tasks

__all__ = ["DispatchClient", "DispatchReader", "DispatchConfig",
           "DispatchUnavailable", "MasterUnreachable",
           "chunk_offsets", "read_chunk",
           "make_recordio_tasks", "recordio_task_reader",
           "make_range_tasks", "range_task_reader"]


class DispatchUnavailable(DispatchError):
    """The master stayed unreachable for the whole retry window."""


class MasterUnreachable(DispatchUnavailable):
    """The master is gone for good, not just restarting: the per-call
    reconnect loop exhausted its TOTAL budget — ``max_reconnect``
    consecutive reconnect attempts and/or ``total_deadline_s`` across
    calls — without ever reaching it.  Distinct from the per-call
    :class:`DispatchUnavailable` (one slow window) so orchestration can
    stop re-reading a stale address file forever and fail the worker
    over.  Carries ``attempts`` and ``elapsed_s``."""

    def __init__(self, msg: str, attempts: int = 0,
                 elapsed_s: float = 0.0):
        super().__init__(msg)
        self.attempts = int(attempts)
        self.elapsed_s = float(elapsed_s)


class DispatchClient:
    """One worker's connection to the master.  Every call is
    retried-with-backoff across reconnects until ``retry_window_s``
    lapses; the address is re-resolved (``addr_file``) on each reconnect
    so a restarted master on a new port is found automatically.

    Unbounded hope is bounded by ``max_reconnect`` (consecutive failed
    reconnect attempts, across calls — any success resets it) and
    ``total_deadline_s`` (wall clock since the first of those failures):
    when either trips, calls raise :class:`MasterUnreachable` instead of
    re-reading the address file forever for a master that is never
    coming back.  Both default to None (the old keep-trying behavior)."""

    def __init__(self, addr: Optional[str] = None, *,
                 addr_file: Optional[str] = None,
                 worker: Optional[str] = None, timeout_s: float = 10.0,
                 retry_window_s: float = 60.0,
                 retry_backoff_s: float = 0.05,
                 max_reconnect: Optional[int] = None,
                 total_deadline_s: Optional[float] = None):
        if not addr and not addr_file:
            raise ValueError("DispatchClient needs addr or addr_file")
        self._addr = addr
        self._addr_file = addr_file
        self.worker = worker or f"rank{process_rank()}:{os.getpid()}"
        self.timeout_s = float(timeout_s)
        self.retry_window_s = float(retry_window_s)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_reconnect = None if max_reconnect is None \
            else max(1, int(max_reconnect))
        self.total_deadline_s = None if total_deadline_s is None \
            else float(total_deadline_s)
        self._consecutive_failures = 0
        self._first_failure_at: Optional[float] = None
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._lock = threading.Lock()     # one in-flight call at a time

    # ----------------------------------------------------------- transport
    def _resolve(self) -> tuple:
        if self._addr_file:
            got = read_addr_file(self._addr_file)
            if got is not None:
                return got
        if self._addr:
            host, _, port = self._addr.rpartition(":")
            return host, int(port)
        raise DispatchUnavailable(
            f"no master address yet (addr_file {self._addr_file!r} "
            f"missing or torn)")

    def _disconnect(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    def _connect(self):
        host, port = self._resolve()
        s = socket.create_connection((host, port), timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        self._sock = s
        self._rfile = s.makefile("rb")

    def _call(self, op: str, **kw) -> Dict[str, Any]:
        req = dict(kw)
        req["op"] = op
        req.setdefault("worker", self.worker)
        payload = (json.dumps(req) + "\n").encode()
        deadline = time.monotonic() + self.retry_window_s
        backoff = self.retry_backoff_s
        last_err: Optional[Exception] = None
        with self._lock:
            while True:
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(payload)
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("master closed connection")
                    resp = json.loads(line)
                    if resp.get("ok") is False and resp.get("error"):
                        raise DispatchError(resp["error"])
                    self._consecutive_failures = 0
                    self._first_failure_at = None
                    return resp
                except DispatchError:
                    raise
                except (OSError, ValueError) as e:
                    last_err = e
                    self._disconnect()
                    self._consecutive_failures += 1
                    now = time.monotonic()
                    if self._first_failure_at is None:
                        self._first_failure_at = now
                    elapsed = now - self._first_failure_at
                    if (self.max_reconnect is not None
                            and self._consecutive_failures
                            >= self.max_reconnect) or \
                            (self.total_deadline_s is not None
                             and elapsed >= self.total_deadline_s):
                        raise MasterUnreachable(
                            f"master gone: "
                            f"{self._consecutive_failures} consecutive "
                            f"reconnect failures over {elapsed:.1f}s "
                            f"({op}): {type(e).__name__}: {e}",
                            attempts=self._consecutive_failures,
                            elapsed_s=elapsed) from e
                    if now >= deadline:
                        raise DispatchUnavailable(
                            f"master unreachable for "
                            f"{self.retry_window_s:.0f}s ({op}): "
                            f"{type(e).__name__}: {e}") from e
                    time.sleep(backoff)
                    backoff = min(1.0, backoff * 2)

    def close(self):
        with self._lock:
            self._disconnect()

    # ------------------------------------------------------------ protocol
    def ping(self) -> Dict[str, Any]:
        return self._call("ping")

    def stats(self) -> Dict[str, Any]:
        return self._call("stats")

    def get_task(self, poll_cap_s: float = 0.5) -> Optional[Dict[str, Any]]:
        """Block until a task leases to this worker; None once the epoch
        is done.  Waits follow the master's ``retry_after`` hints (capped
        so a lease freed early is picked up promptly)."""
        while True:
            resp = self._call("get_task")
            task = resp.get("task")
            if task is not None:
                task = dict(task)
                task["lease_id"] = resp["lease_id"]
                task["lease_timeout_s"] = resp.get("lease_timeout_s")
                if resp.get("traceparent"):
                    task["traceparent"] = resp["traceparent"]
                return task
            if resp.get("done"):
                return None
            wait = resp.get("retry_after")
            time.sleep(min(poll_cap_s, max(0.01, float(wait or 0.1))))

    @staticmethod
    def _trace_kw(task: Dict[str, Any]) -> Dict[str, str]:
        # the worker's consume-span traceparent (set by DispatchReader)
        # rides every lease-lifecycle call so the master's task rows can
        # name both sides of the process boundary
        tp = task.get("worker_traceparent")
        return {"traceparent": tp} if tp else {}

    def renew(self, task: Dict[str, Any]) -> Optional[bool]:
        """One heartbeat.  None = the renewal was dropped by fault
        injection (not sent); False = the lease is stale (the master
        requeued the task — abandon it); True = extended."""
        if faults.fire("dispatch.renew"):
            return None
        resp = self._call("renew", task_id=task["task_id"],
                          lease_id=task["lease_id"],
                          **self._trace_kw(task))
        return not resp.get("stale")

    def task_finished(self, task: Dict[str, Any]) -> Dict[str, Any]:
        faults.fire("dispatch.finish")
        return self._call("task_finished", task_id=task["task_id"],
                          lease_id=task["lease_id"],
                          **self._trace_kw(task))

    def task_failed(self, task: Dict[str, Any],
                    error: Optional[str] = None) -> Dict[str, Any]:
        return self._call("task_failed", task_id=task["task_id"],
                          lease_id=task["lease_id"], error=error,
                          **self._trace_kw(task))

    def reap_worker(self, target: Optional[str] = None) -> List[int]:
        """Reap every live lease of ``target`` (default: this worker's
        own id — the warm-restart self-reap) so survivors re-serve them
        immediately instead of waiting out the lease."""
        resp = self._call("reap_worker", target=target or self.worker)
        return list(resp.get("reaped") or [])

    def begin_epoch(self, epoch: int, poll_cap_s: float = 0.5,
                    traceparent: Optional[str] = None) -> int:
        """Declare (and if first, trigger) epoch ``epoch``; blocks while
        stragglers still hold leases of the previous one.  Returns the
        master's current epoch.  ``traceparent`` (optional) proposes the
        epoch's root trace context — the master adopts it if THIS call
        triggers the epoch reset."""
        extra = {"traceparent": traceparent} if traceparent else {}
        while True:
            resp = self._call("begin_epoch", epoch=int(epoch), **extra)
            if resp.get("ok"):
                return int(resp["epoch"])
            time.sleep(min(poll_cap_s, max(0.01,
                                           float(resp.get("wait") or 0.1))))


# ----------------------------------------------------------------- reader

class _Heartbeat:
    """Renews one task's lease on a fixed cadence while the reader
    stages/yields its samples.  A stale renewal (the master already
    requeued the task) sets ``lost`` and stops — the reader must abandon
    the task without finishing it."""

    def __init__(self, client: DispatchClient, task: Dict[str, Any],
                 interval_s: float):
        self.lost = threading.Event()
        self._stop = threading.Event()
        self._client = client
        self._task = task
        self._interval = interval_s
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"paddle_tpu-dispatch-hb-{task['task_id']}")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                ok = self._client.renew(self._task)
            except Exception:  # noqa: BLE001 — unreachable master: let the
                continue       # lease expire; the sweep requeues the task
            if ok is False:
                self.lost.set()
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


class DispatchReader:
    """A paddle-style reader creator over the lease loop: calling the
    instance returns one epoch's iterator of whatever ``task_reader``
    yields for each leased payload (samples, or pre-built batches).

    Each call declares the next epoch to the master (``begin_epoch``), so
    multi-epoch training works unchanged; a fresh process joining a
    half-done epoch simply consumes what remains of it."""

    def __init__(self, task_reader: Callable[[Dict[str, Any]],
                                             Iterable[Any]],
                 client: Optional[DispatchClient] = None, *,
                 addr: Optional[str] = None,
                 addr_file: Optional[str] = None,
                 worker: Optional[str] = None,
                 heartbeat_s: Optional[float] = None):
        if client is None:
            client = DispatchClient(addr, addr_file=addr_file,
                                    worker=worker)
        self.client = client
        self.task_reader = task_reader
        self.heartbeat_s = heartbeat_s
        self._next_epoch = 0
        self.tasks_finished = 0
        self.tasks_failed = 0
        #: the task currently being consumed ({task_id, payload,
        #: lease_id, ...}) — task_readers that log per-task delivery
        #: (the chaos smoke's exactly-once join) read it here
        self.current_task: Optional[Dict[str, Any]] = None
        #: the worker-side consume span of the current task (a child of
        #: the master's task span, adopted from the lease reply's
        #: traceparent).  The Trainer stamps it into step records
        #: EXPLICITLY — the reader generator runs on the staging thread,
        #: so a contextvar could never reach the training loop's records.
        self.current_trace: Optional[TraceContext] = None
        #: the id of every task this reader began consuming, in order (a
        #: control run replays the same batches in the same order)
        self.consumed: List[int] = []

    def _interval(self, task: Dict[str, Any]) -> float:
        if self.heartbeat_s is not None:
            return self.heartbeat_s
        lease = float(task.get("lease_timeout_s") or 30.0)
        return max(0.02, lease / 3.0)

    def __call__(self):
        from .. import telemetry
        amb = telemetry.current_trace()
        epoch = self.client.begin_epoch(
            self._next_epoch,
            traceparent=amb.to_traceparent() if amb is not None else None)
        self._next_epoch = epoch + 1
        while True:
            task = self.client.get_task()
            if task is None:
                self.current_trace = None
                return
            remote = TraceContext.from_traceparent(
                task.get("traceparent"))
            ctx = remote.child() if remote is not None else None
            self.current_trace = ctx
            if ctx is not None:
                # lease-lifecycle calls (renew/finish/fail) carry this
                # span back to the master — see DispatchClient._trace_kw
                task["worker_traceparent"] = ctx.to_traceparent()
            self.current_task = task
            faults.fire("dispatch.task_start")
            self.consumed.append(int(task["task_id"]))
            hb = _Heartbeat(self.client, task, self._interval(task))
            error: Optional[str] = None
            lost = False
            try:
                for sample in self.task_reader(task["payload"]):
                    if hb.lost.is_set():
                        lost = True
                        break
                    faults.fire("dispatch.read")
                    yield sample
            except GeneratorExit:
                # consumer closed the epoch early: stop heartbeating and
                # let the lease expire — the task re-serves elsewhere
                hb.stop()
                raise
            except Exception as e:  # noqa: BLE001 — a bad task must not
                error = f"{type(e).__name__}: {e}"   # kill the epoch loop
            hb.stop()
            if lost or hb.lost.is_set():
                continue        # master already requeued it — not ours
            if error is not None:
                self.tasks_failed += 1
                try:
                    self.client.task_failed(task, error)
                except Exception:  # noqa: BLE001
                    pass        # lease expiry will requeue it
                continue
            try:
                self.client.task_finished(task)
                self.tasks_finished += 1
            except Exception:  # noqa: BLE001 — lost retirement: the lease
                pass           # expires and the task re-serves (at-least-
                               # once delivery, exactly-once accounting)


class DispatchConfig:
    """``Trainer(dispatch=DispatchConfig(...))``: where the master lives
    (``addr`` or ``addr_file``), how to turn a task payload into samples
    (``task_reader``; batches are fine — the Trainer feeds whatever it
    yields), and the worker identity (default ``rank<k>:<pid>``).

    ``reap_on_start`` (default True) closes the elasticity loop: a
    warm-restarted trainer reaps the leases its previous incarnation (or
    a dead rank it replaces, via ``reap_worker_id``) still holds, so
    those in-flight tasks re-serve immediately instead of waiting out the
    lease timeout."""

    def __init__(self, addr: Optional[str] = None, *,
                 addr_file: Optional[str] = None,
                 task_reader: Optional[Callable] = None,
                 worker: Optional[str] = None,
                 heartbeat_s: Optional[float] = None,
                 reap_on_start: bool = True,
                 reap_worker_id: Optional[str] = None,
                 timeout_s: float = 10.0, retry_window_s: float = 60.0,
                 max_reconnect: Optional[int] = None,
                 total_deadline_s: Optional[float] = None):
        if not addr and not addr_file:
            raise ValueError("DispatchConfig needs addr or addr_file")
        if task_reader is None:
            raise ValueError("DispatchConfig needs task_reader "
                             "(payload -> iterable of samples/batches)")
        self.addr = addr
        self.addr_file = addr_file
        self.task_reader = task_reader
        self.worker = worker or f"rank{process_rank()}"
        self.heartbeat_s = heartbeat_s
        self.reap_on_start = reap_on_start
        self.reap_worker_id = reap_worker_id
        self.timeout_s = timeout_s
        self.retry_window_s = retry_window_s
        self.max_reconnect = max_reconnect
        self.total_deadline_s = total_deadline_s

    def make_client(self) -> DispatchClient:
        return DispatchClient(self.addr, addr_file=self.addr_file,
                              worker=self.worker, timeout_s=self.timeout_s,
                              retry_window_s=self.retry_window_s,
                              max_reconnect=self.max_reconnect,
                              total_deadline_s=self.total_deadline_s)

    def make_reader(self, client: Optional[DispatchClient] = None
                    ) -> DispatchReader:
        return DispatchReader(self.task_reader, client or
                              self.make_client(),
                              heartbeat_s=self.heartbeat_s)


# ------------------------------------------------------- recordio sharding

_RIO_MAGIC = 0x50545231


def chunk_offsets(path: str) -> List[Dict[str, int]]:
    """Index a recordio file's chunks WITHOUT reading payloads: walk the
    16-byte headers, seek over data.  Returns
    ``[{"offset": o, "nrecords": n}, ...]`` — the master's shardable unit
    (the Go master dispatches chunk lists exactly like this)."""
    out = []
    with open(path, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(16)
            if not header:
                return out
            if len(header) != 16:
                raise IOError(f"{path}: truncated chunk header at "
                              f"{offset}")
            magic, _crc, n, datalen = struct.unpack("<IIII", header)
            if magic != _RIO_MAGIC:
                raise IOError(f"{path}: bad chunk magic at {offset}")
            out.append({"offset": offset, "nrecords": int(n)})
            f.seek(datalen, os.SEEK_CUR)


def read_chunk(path: str, offset: int) -> Iterable[bytes]:
    """Yield the records of the single chunk at ``offset`` (CRC-checked,
    same framing as :mod:`paddle_tpu_torch.recordio`)."""
    with open(path, "rb") as f:
        f.seek(int(offset))
        header = f.read(16)
        if len(header) != 16:
            raise IOError(f"{path}: truncated chunk header at {offset}")
        magic, crc, n, datalen = struct.unpack("<IIII", header)
        if magic != _RIO_MAGIC:
            raise IOError(f"{path}: bad chunk magic at {offset}")
        data = f.read(datalen)
        if len(data) != datalen:
            raise IOError(f"{path}: truncated chunk at {offset}")
        if zlib.crc32(data) != crc:
            raise IOError(f"{path}: crc mismatch at {offset}")
    pos = 0
    for _ in range(n):
        (rec_len,) = struct.unpack_from("<I", data, pos)
        pos += 4
        yield data[pos:pos + rec_len]
        pos += rec_len


def make_recordio_tasks(paths: Iterable[str], chunks_per_task: int = 1
                        ) -> List[Dict[str, Any]]:
    """Shard recordio files into task payloads of up to
    ``chunks_per_task`` chunks each (never spanning files)::

        {"kind": "recordio", "path": p,
         "chunks": [{"offset": o, "nrecords": n}, ...]}
    """
    if chunks_per_task < 1:
        raise ValueError("chunks_per_task must be >= 1")
    out: List[Dict[str, Any]] = []
    for path in paths:
        chunks = chunk_offsets(path)
        for i in range(0, len(chunks), chunks_per_task):
            out.append({"kind": "recordio", "path": path,
                        "chunks": chunks[i:i + chunks_per_task]})
    return out


def recordio_task_reader(decode: Optional[Callable[[bytes], Any]] = None
                         ) -> Callable[[Dict[str, Any]], Iterable[Any]]:
    """A ``task_reader`` for :func:`make_recordio_tasks` payloads; each
    raw record optionally passes through ``decode``."""

    def task_reader(payload: Dict[str, Any]):
        for ch in payload["chunks"]:
            for rec in read_chunk(payload["path"], ch["offset"]):
                yield decode(rec) if decode is not None else rec

    return task_reader


def range_task_reader(sample_fn: Callable[[int], Any]
                      ) -> Callable[[Dict[str, Any]], Iterable[Any]]:
    """A ``task_reader`` for :func:`make_range_tasks` payloads: yields
    ``sample_fn(i)`` for each index of the task's range."""

    def task_reader(payload: Dict[str, Any]):
        start = int(payload["start"])
        for i in range(start, start + int(payload["count"])):
            yield sample_fn(i)

    return task_reader
