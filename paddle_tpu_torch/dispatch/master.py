"""DispatchMaster: the elastic data-dispatch service — the reference Go
master (go/master/service.go) rebuilt over :mod:`.taskqueue`.

One master process/thread owns a :class:`~.taskqueue.TaskQueue` and
serves it over a line-delimited-JSON TCP protocol (one request object in,
one response object out, any number per connection)::

    {"op": "get_task", "worker": "rank0"}
    {"op": "renew" | "task_finished" | "task_failed",
     "task_id": 3, "lease_id": 17, "worker": "rank0"}
    {"op": "reap_worker", "worker": "rank1"}     # topology change
    {"op": "begin_epoch", "epoch": 1, "worker": "rank0"}
    {"op": "stats"} | {"op": "snapshot"} | {"op": "ping"}

Trace propagation: ``begin_epoch`` may carry a W3C ``traceparent`` (the
epoch's root context); ``get_task`` replies carry the task span's
``traceparent`` (the worker's consume span parents on it); ``renew`` /
``task_finished`` / ``task_failed`` carry the worker span back so the
master's task rows name both sides of the process boundary.

Around the queue it runs the production machinery the pure state machine
deliberately omits:

* a **timeout sweep** thread reaping expired leases on a fixed cadence
  (requeue with exponential backoff; quarantine at the failure cap);
* **snapshot-on-mutation** to ``snapshot_dir`` (tmp-write→rename,
  manifest-last — :func:`~.taskqueue.save_snapshot`), so a master restart
  mid-epoch recovers every pending/leased/failed/dead task;
* an **address file** (``tmp-write→rename``) clients poll, so a restarted
  master on a fresh port is rediscovered without coordination;
* the ``"dispatch"`` telemetry scope (tasks served/finished/failed/
  requeued/dead, lease_expiry, queue_depth + tasks_leased gauges, a
  task-latency histogram) and ``dispatch_<pid>.jsonl`` records for the
  jax-free tools (``stats.py``, ``health_report.py``).

Stdlib-only: the master imports nothing but :mod:`paddle_tpu_torch.telemetry`
(itself stdlib-only), so a dedicated master process starts in
milliseconds — no jax, no numpy.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..telemetry import (REGISTRY, StepTelemetry, TraceContext,
                         tracing_enabled)
from .taskqueue import (DispatchError, TaskQueue, load_snapshot,
                        save_snapshot)

__all__ = ["DISPATCH_SCOPE", "DispatchMaster", "write_addr_file",
           "read_addr_file"]

DISPATCH_SCOPE = "dispatch"

_COUNTERS = ("tasks_total", "tasks_served", "tasks_finished",
             "tasks_failed", "tasks_requeued", "tasks_dead",
             "lease_expiry", "stale_finish", "stale_renew",
             "worker_reaps", "snapshots", "recovers", "epochs")


def write_addr_file(path: str, host: str, port: int):
    """Publish ``host:port`` atomically (tmp-write→rename): a client that
    races a master restart reads either the old address (connect fails,
    retry re-reads) or the new one — never a torn line."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_addr_file(path: str) -> Optional[tuple]:
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return None
    host, _, port = text.rpartition(":")
    if not host or not port.isdigit():
        return None
    return host, int(port)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        master: "DispatchMaster" = self.server.master  # type: ignore
        while not master._stop.is_set():
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
                resp = master.handle(req)
            except Exception as e:  # noqa: BLE001 — protocol must answer
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
            except OSError:
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._conns = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self):
        """Hard-close every ESTABLISHED connection.  ``shutdown()`` only
        stops the accept loop — without this a client holding a live
        socket keeps mutating a master that believes it retired (and, on
        restart-in-the-same-process tests, stomps the successor's
        snapshots)."""
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class DispatchMaster:
    """See module docstring.  ``payloads`` seeds a fresh queue; with
    ``snapshot_dir`` holding a committed snapshot, recovery wins and
    ``payloads`` is ignored (the restart path)."""

    def __init__(self, payloads: Optional[List[Dict[str, Any]]] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 addr_file: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 1,
                 lease_timeout_s: float = 30.0, max_failures: int = 3,
                 backoff_base_s: float = 1.0, backoff_mult: float = 2.0,
                 backoff_cap_s: float = 60.0,
                 sweep_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.snapshot_dir = snapshot_dir
        self.addr_file = addr_file
        self._snapshot_every = max(1, int(snapshot_every))
        self._mutations = 0
        self._snap_seq = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        recovered = False
        queue: Optional[TaskQueue] = None
        if snapshot_dir:
            snap = load_snapshot(snapshot_dir)
            if snap is not None:
                queue = TaskQueue.from_snapshot(snap, clock=clock)
                self._snap_seq = int(snap.get("_seq", 0))
                recovered = True
        if queue is None:
            if payloads is None:
                raise DispatchError(
                    "no committed snapshot to recover and no payloads — "
                    "a fresh master needs its task list")
            queue = TaskQueue(
                payloads, lease_timeout_s=lease_timeout_s,
                max_failures=max_failures, backoff_base_s=backoff_base_s,
                backoff_mult=backoff_mult, backoff_cap_s=backoff_cap_s,
                clock=clock)
        self.queue = queue
        self.sweep_interval_s = sweep_interval_s if sweep_interval_s \
            is not None else max(0.05, self.queue.lease_timeout_s / 4.0)

        # "dispatch"-scope metrics, pre-registered like the serving scope
        for name in _COUNTERS:
            REGISTRY.counter(name, scope=DISPATCH_SCOPE)
        self._g_depth = REGISTRY.gauge("queue_depth", scope=DISPATCH_SCOPE)
        self._g_leased = REGISTRY.gauge("tasks_leased",
                                        scope=DISPATCH_SCOPE)
        self._h_latency = REGISTRY.histogram("task_latency_s",
                                             scope=DISPATCH_SCOPE)
        self._records = StepTelemetry(capacity=4096, prefix="dispatch")
        # per-task trace spans (created lazily at first serve, parented
        # on the epoch trace when one was propagated via begin_epoch's
        # traceparent) — the master side of the task's causal story; the
        # worker's consume span parents on these over the wire
        self._traces: Dict[Any, TraceContext] = {}
        self._epoch_trace: Optional[TraceContext] = None
        self._inc("tasks_total", len(self.queue.tasks))
        if recovered:
            self._inc("recovers")
            self._record("lifecycle", event="recover",
                         snapshot_seq=self._snap_seq,
                         **self.queue.counts())

        self._server = _Server((host, port), _Handler)
        self._server.master = self
        self.host, self.port = self._server.server_address[:2]
        if addr_file:
            write_addr_file(addr_file, self.host, self.port)
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="paddle_tpu-dispatch-master")
        self._serve_thread.start()
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop, daemon=True,
            name="paddle_tpu-dispatch-sweep")
        self._sweep_thread.start()
        self._record("lifecycle", event="start", recovered=recovered,
                     addr=f"{self.host}:{self.port}",
                     **self.queue.counts())
        self._set_gauges()

    # ----------------------------------------------------------- telemetry
    @staticmethod
    def _inc(name: str, n: int = 1):
        REGISTRY.counter(name, scope=DISPATCH_SCOPE).inc(n)

    def _record(self, kind: str, **fields):
        self._records.record(kind=kind, **fields)

    def _set_gauges(self):
        c = self.queue.counts()
        self._g_depth.set(c["pending"])
        self._g_leased.set(c["leased"])

    def _task_trace(self, task_id) -> Optional[TraceContext]:
        """This task's span (lazily minted at first serve): a child of
        the epoch trace when a begin_epoch propagated one, else a fresh
        root when tracing is on, else None.  Stable across re-serves —
        a requeued task's whole lease lifecycle shares one span."""
        tr = self._traces.get(task_id)
        if tr is None:
            if self._epoch_trace is not None:
                tr = self._epoch_trace.child()
            elif tracing_enabled():
                tr = TraceContext.new_root()
            if tr is not None:
                self._traces[task_id] = tr
        return tr

    def _task_row(self, event: str, task_id, worker, **extra):
        c = self.queue.counts()
        tr = self._traces.get(task_id)
        if tr is not None:
            extra.update(tr.fields())
        self._record("task", event=event, task_id=task_id, worker=worker,
                     queue_depth=c["pending"], leased=c["leased"],
                     finished=c["finished"], dead=c["dead"], **extra)

    def stats(self) -> Dict[str, Any]:
        """Counts + the flat ``"dispatch"`` metric scope — the live view
        ``tools/stats.py`` reads post-hoc from the JSONL."""
        with self._lock:
            out = {"counts": self.queue.counts(),
                   "counters": dict(self.queue.counters),
                   "epoch": self.queue.epoch,
                   "done": self.queue.done,
                   "dead_tasks": [t.task_id for t in
                                  self.queue.dead_tasks()],
                   "metrics": REGISTRY.snapshot(scope=DISPATCH_SCOPE)}
        return out

    # ------------------------------------------------------------ mutation
    def _mutated(self, n: int = 1):
        """Called under the lock after state changed: snapshot on the
        configured cadence (default: every mutation — the smoke's
        restart-loses-nothing setting)."""
        self._mutations += n
        if self.snapshot_dir and self._mutations >= self._snapshot_every:
            self._mutations = 0
            self._snapshot_locked()
        self._set_gauges()

    def _snapshot_locked(self):
        self._snap_seq += 1
        save_snapshot(self.snapshot_dir, self.queue.to_snapshot(),
                      self._snap_seq)
        self._inc("snapshots")

    def snapshot(self) -> Optional[int]:
        """Force one committed snapshot; returns its seq (None when no
        snapshot_dir is configured)."""
        if not self.snapshot_dir:
            return None
        with self._lock:
            self._snapshot_locked()
            return self._snap_seq

    # ---------------------------------------------------------------- ops
    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        worker = str(req.get("worker", "?"))
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        if op == "stats":
            return {"ok": True, **self.stats()}
        if op == "snapshot":
            return {"ok": True, "seq": self.snapshot()}
        if op == "get_task":
            with self._lock:
                res = self.queue.get_task(worker)
                if res.get("task") is not None:
                    tid = res["task"]["task_id"]
                    tr = self._task_trace(tid)
                    if tr is not None:
                        # the wire half of the tentpole: the lease reply
                        # carries the task span so the worker's consume
                        # span (and its step records) parent on it
                        res["traceparent"] = tr.to_traceparent()
                    self._inc("tasks_served")
                    self._task_row("served", tid, worker,
                                   lease_id=res["lease_id"])
                    self._mutated()
            return {"ok": True, **res}
        if op == "renew":
            with self._lock:
                res = self.queue.renew(req["task_id"], req["lease_id"],
                                       worker)
                if res.get("stale"):
                    self._inc("stale_renew")
                else:
                    self._mutated()
            return {"ok": True, **res}
        if op == "task_finished":
            # the worker's consume-span traceparent rides the retirement
            # call: the finished row names BOTH sides of the boundary
            wp = TraceContext.from_traceparent(req.get("traceparent"))
            with self._lock:
                res = self.queue.finish(req["task_id"], req["lease_id"],
                                        worker)
                if res.get("stale"):
                    self._inc("stale_finish")
                    self._task_row("stale_finish", req["task_id"], worker)
                else:
                    self._inc("tasks_finished")
                    if res.get("latency_s") is not None:
                        self._h_latency.observe(res["latency_s"])
                    extra = {"worker_span_id": wp.span_id} if wp else {}
                    self._task_row("finished", req["task_id"], worker,
                                   latency_s=res.get("latency_s"),
                                   **extra)
                    self._traces.pop(req["task_id"], None)
                    self._mutated()
            return {"ok": True, **res}
        if op == "task_failed":
            wp = TraceContext.from_traceparent(req.get("traceparent"))
            with self._lock:
                res = self.queue.fail(req["task_id"], req["lease_id"],
                                      worker, error=req.get("error"))
                if res.get("stale"):
                    self._task_row("stale_fail", req["task_id"], worker)
                else:
                    self._inc("tasks_failed")
                    self._after_requeue("failed", req["task_id"], worker,
                                        res, error=req.get("error"),
                                        worker_span_id=wp.span_id
                                        if wp else None)
                    self._mutated()
            return {"ok": True, **res}
        if op == "reap_worker":
            target = str(req.get("target", worker))
            with self._lock:
                reaped = self.queue.reap_worker(target)
                for r in reaped:
                    self._inc("worker_reaps")
                    self._after_requeue("reaped", r["task_id"], target, r)
                if reaped:
                    self._mutated(len(reaped))
            return {"ok": True, "reaped": [r["task_id"] for r in reaped]}
        if op == "begin_epoch":
            remote = TraceContext.from_traceparent(req.get("traceparent"))
            with self._lock:
                res = self.queue.begin_epoch(int(req.get("epoch", 0)))
                if res.get("reset"):
                    # a NEW epoch: adopt the initiator's trace as its
                    # root (the trainer's traceparent), else mint one;
                    # task spans of the old epoch die with its leases
                    if remote is not None:
                        self._epoch_trace = remote
                    elif tracing_enabled():
                        self._epoch_trace = TraceContext.new_root()
                    self._traces.clear()
                    self._inc("epochs")
                    ep_tr = self._epoch_trace
                    self._record("lifecycle", event="epoch",
                                 epoch=self.queue.epoch,
                                 **self.queue.counts(),
                                 **(ep_tr.fields() if ep_tr else {}))
                    self._mutated()
                elif res.get("ok") and remote is not None \
                        and self._epoch_trace is None:
                    # joining the CURRENT epoch (a fresh master is
                    # already at epoch 0, so the first begin_epoch never
                    # resets): the first worker to propose a root wins,
                    # and only tasks not yet served parent on it
                    self._epoch_trace = remote
                    self._record("lifecycle", event="epoch-trace",
                                 epoch=self.queue.epoch,
                                 **remote.fields())
            return {"ok": True, **res}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _after_requeue(self, cause: str, task_id, worker,
                       res: Dict[str, Any], error: Optional[str] = None,
                       worker_span_id: Optional[str] = None):
        """Shared accounting for fail/expiry/reap outcomes (under lock)."""
        from .taskqueue import DEAD
        extra = {"worker_span_id": worker_span_id} if worker_span_id \
            else {}
        if res.get("state") == DEAD:
            self._inc("tasks_dead")
            self._task_row("dead", task_id, worker, cause=cause,
                           failure_count=res.get("failure_count"),
                           error=error, **extra)
            self._traces.pop(task_id, None)
        else:
            self._inc("tasks_requeued")
            self._task_row("requeued", task_id, worker, cause=cause,
                           failure_count=res.get("failure_count"),
                           backoff_until=res.get("backoff_until"),
                           error=error, **extra)

    # --------------------------------------------------------------- sweep
    def _sweep_loop(self):
        while not self._stop.wait(self.sweep_interval_s):
            self.sweep()

    def sweep(self) -> List[Dict[str, Any]]:
        """One expiry pass (the background thread's body, callable
        directly by tests with a fake clock)."""
        with self._lock:
            expired = self.queue.reap_expired()
            for r in expired:
                self._inc("lease_expiry")
                self._task_row("expired", r["task_id"], r.get("worker"))
                self._after_requeue("expiry", r["task_id"], r.get("worker"),
                                    r, error="lease expired")
            if expired:
                self._mutated(len(expired))
        return expired

    # ----------------------------------------------------------- lifecycle
    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self, final_snapshot: bool = True):
        """Graceful stop: sweep thread down, server down, one final
        committed snapshot (a SIGKILLed master skips all of this — that
        is what snapshot-on-mutation exists for)."""
        self._stop.set()
        try:
            self._server.shutdown()
            self._server.close_all_connections()
            self._server.server_close()
        except OSError:
            pass
        self._sweep_thread.join(timeout=5.0)
        if final_snapshot and self.snapshot_dir:
            with self._lock:
                self._snapshot_locked()
        self._record("lifecycle", event="shutdown", **self.queue.counts())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
