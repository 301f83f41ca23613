"""Elastic data-dispatch master — the Go master's task queue.

Reference: Paddle's go/master/service.go — the dataset is split
into chunk tasks (``SetDataset`` :280 + ``partition``); trainers pull with
``GetTask`` and report ``TaskFinished``/``TaskFailed``; a per-task timeout
(:341 ``checkTimeoutFunc``) and failure counter re-dispatch a dead
trainer's pending tasks to survivors (:313 ``processFailedTask``, discard
after ``failureMax``); state snapshots to etcd (:165-213) so the master
itself can recover.

Design: a small in-process queue with the same state machine
(todo / pending / done / failed, epoch-stamped leases) plus a JSON-lines
TCP server/client pair for multi-process clusters — coordination is
host-side Python (it dispatches *data*, never tensors), while the training
step itself stays one program on the device.  Snapshots go to a local file
(the etcd analogue; point it at shared storage for real clusters).
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Any, List, Optional, Tuple

from ._transport import recv_msg as _recv_msg, send_msg as _send_msg, \
    start_server

__all__ = ["Master", "MasterServer", "MasterClient", "NoMoreTasks"]


class NoMoreTasks(Exception):
    """All tasks are done (or discarded as permanently failed)."""


class _Task:
    __slots__ = ("task_id", "chunk", "epoch", "failures", "deadline")

    def __init__(self, task_id: int, chunk):
        self.task_id = task_id
        self.chunk = chunk
        self.epoch = 0          # lease generation (go Task.Meta.Epoch)
        self.failures = 0
        self.deadline = 0.0


class Master:
    """Chunk-task queue with timeout re-dispatch (go/master/service.go)."""

    def __init__(self, chunks: List[Any], timeout_s: float = 30.0,
                 max_failures: int = 3, snapshot_path: Optional[str] = None):
        self._timeout = timeout_s
        self._max_failures = max_failures
        self._snapshot_path = snapshot_path
        self._lock = threading.Lock()
        self._todo: List[_Task] = [_Task(i, c) for i, c in enumerate(chunks)]
        self._pending: dict = {}
        self._done: List[_Task] = []
        self._failed: List[_Task] = []
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # ------------------------------------------------------------ client API
    def lease_task(self):
        """(task_id, chunk, epoch) — the epoch stamps THIS lease; reports
        carrying a stale epoch are ignored (go Task.Meta.Epoch check,
        service.go:313-318).  (None, None, None) = outstanding leases
        elsewhere, retry; NoMoreTasks = everything done/discarded."""
        with self._lock:
            self._requeue_timed_out()
            if self._todo:
                t = self._todo.pop(0)
                t.epoch += 1
                t.deadline = time.monotonic() + self._timeout
                self._pending[t.task_id] = t
                return t.task_id, t.chunk, t.epoch
            if self._pending:
                return None, None, None         # retry later
            raise NoMoreTasks()

    def get_task(self) -> Tuple[int, Any]:
        tid, chunk, _ = self.lease_task()
        return tid, chunk

    def _pop_if_current(self, task_id: int, epoch: Optional[int]):
        t = self._pending.get(task_id)
        if t is None:
            return None                         # unknown / already settled
        if epoch is not None and t.epoch != epoch:
            return None                         # stale lease: a timed-out
        return self._pending.pop(task_id)       # worker reporting late

    def task_finished(self, task_id: int, epoch: Optional[int] = None):
        with self._lock:
            t = self._pop_if_current(task_id, epoch)
            if t is not None:
                self._done.append(t)
                self._snapshot()

    def task_failed(self, task_id: int, epoch: Optional[int] = None):
        """Explicit failure report (go TaskFailed): re-dispatch or discard
        after max_failures (processFailedTask :313)."""
        with self._lock:
            t = self._pop_if_current(task_id, epoch)
            if t is not None:
                self._fail(t)

    # ------------------------------------------------------------- internals
    def _fail(self, t: _Task):
        t.failures += 1
        if t.failures > self._max_failures:
            self._failed.append(t)              # discard (go :330)
        else:
            self._todo.append(t)                # re-dispatch (go :336)
        self._snapshot()

    def _requeue_timed_out(self):
        """Lease expiry = dead trainer: re-dispatch its pending tasks
        (go checkTimeoutFunc :341)."""
        now = time.monotonic()
        for tid in [tid for tid, t in self._pending.items()
                    if t.deadline <= now]:
            self._fail(self._pending.pop(tid))

    # ------------------------------------------------------------- state
    @property
    def counts(self) -> dict:
        with self._lock:
            return {"todo": len(self._todo), "pending": len(self._pending),
                    "done": len(self._done), "failed": len(self._failed)}

    def done_chunks(self) -> List[Any]:
        with self._lock:
            return [t.chunk for t in self._done]

    def _snapshot(self):
        """Persist the queue (etcd-snapshot analogue, go :165-213)."""
        if not self._snapshot_path:
            return
        state = {
            "todo": [[t.task_id, t.chunk, t.failures] for t in self._todo],
            # a snapshot taken mid-lease treats pending as todo on recover
            # (the leasing master died; its trainers must re-pull)
            "pending": [[t.task_id, t.chunk, t.failures]
                        for t in self._pending.values()],
            "done": [[t.task_id, t.chunk, t.failures] for t in self._done],
            "failed": [[t.task_id, t.chunk, t.failures]
                       for t in self._failed],
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._snapshot_path)

    def _recover(self):
        with open(self._snapshot_path) as f:
            state = json.load(f)

        def mk(rows):
            out = []
            for tid, chunk, failures in rows:
                t = _Task(tid, chunk)
                t.failures = failures
                out.append(t)
            return out

        self._todo = mk(state["todo"]) + mk(state["pending"])
        self._pending = {}
        self._done = mk(state["done"])
        self._failed = mk(state["failed"])


# ---------------------------------------------------------------------------
# multi-process transport (JSON lines over TCP, localhost clusters)
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        master: Master = self.server.master      # type: ignore[attr-defined]
        while True:
            try:
                req, _ = _recv_msg(self.rfile)
            except (ConnectionError, ValueError):
                return
            try:
                cmd = req.get("cmd")
                if cmd == "get_task":
                    try:
                        tid, chunk, epoch = master.lease_task()
                        resp = {"task_id": tid, "chunk": chunk,
                                "epoch": epoch}
                    except NoMoreTasks:
                        resp = {"eof": True}
                elif cmd == "task_finished":
                    master.task_finished(int(req["task_id"]),
                                         req.get("epoch"))
                    resp = {"ok": True}
                elif cmd == "task_failed":
                    master.task_failed(int(req["task_id"]),
                                       req.get("epoch"))
                    resp = {"ok": True}
                elif cmd == "counts":
                    resp = master.counts
                else:
                    resp = {"error": f"unknown cmd {cmd!r}"}
            except Exception as e:               # keep serving other clients
                resp = {"error": str(e)}
            _send_msg(self.wfile, resp)


class MasterServer:
    """Serve a Master over localhost TCP (the gRPC master service
    analogue)."""

    def __init__(self, master: Master, host: str = "127.0.0.1",
                 port: int = 0):
        self.master = master
        self._srv, self.address = start_server(_Handler, host, port,
                                               master=master)

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


class MasterClient:
    """Trainer-side client (go/master/client.go GetTask/TaskFinished).

    Iterate it like a data source::

        for chunk in MasterClient(addr):
            train_on(chunk)     # task auto-finishes after the body runs
    """

    def __init__(self, address: Tuple[str, int], retry_s: float = 0.2):
        self._addr = tuple(address)
        self._retry = retry_s
        self._sock = socket.create_connection(self._addr)
        self._f = self._sock.makefile("rwb")
        self._epochs: dict = {}        # task_id -> lease epoch we hold

    def _call(self, **req) -> dict:
        _send_msg(self._f, req)
        resp, _ = _recv_msg(self._f)
        return resp

    def get_task(self):
        """(task_id, chunk); blocks while other workers hold the last
        leases; raises NoMoreTasks at end."""
        while True:
            resp = self._call(cmd="get_task")
            if resp.get("eof"):
                raise NoMoreTasks()
            if "error" in resp:
                raise RuntimeError(resp["error"])
            if resp["task_id"] is None:
                time.sleep(self._retry)
                continue
            self._epochs[resp["task_id"]] = resp.get("epoch")
            return resp["task_id"], resp["chunk"]

    def task_finished(self, task_id: int):
        self._call(cmd="task_finished", task_id=task_id,
                   epoch=self._epochs.pop(task_id, None))

    def task_failed(self, task_id: int):
        self._call(cmd="task_failed", task_id=task_id,
                   epoch=self._epochs.pop(task_id, None))

    def __iter__(self):
        while True:
            try:
                tid, chunk = self.get_task()
            except NoMoreTasks:
                return
            yield chunk
            self.task_finished(tid)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
