"""The elastic-dispatch task queue: a deterministic, clock-injected state
machine reproducing the reference Go master's lease protocol
(go/master/service.go:89 ``GetTask``, :280 ``TaskFinished``, :313
``TaskFailed``, :341 timeout requeue; :165-213 snapshot/recover).

One :class:`Task` is an indivisible unit of epoch work (a recordio chunk,
an index range) that moves through::

    PENDING --get_task--> LEASED --finish--> FINISHED
       ^                    |
       |<---fail/expiry-----+          (failure_count += 1, exponential
       |                               backoff; at max_failures the task
       +--> DEAD (quarantined)         is DEAD — reported, never retried)

Every lease carries a fresh ``lease_id``; ``finish``/``fail``/``renew``
must echo it, so a late ``task_finished`` arriving AFTER the lease
expired and the task was requeued is *stale* — rejected, never
double-counted.  All time flows through an injected ``clock`` callable
(``time.time`` in production, a fake in tests), so expiry sweeps and the
backoff schedule are exactly testable.

Snapshot/recover: :func:`save_snapshot` writes the full queue state
tmp-write→rename and commits it by writing ``manifest.json`` LAST (the
``checkpoint/manifest.py`` discipline) — a directory without a parseable
manifest is a torn snapshot and :func:`load_snapshot` ignores it.

Deliberately stdlib-only (no jax, no numpy): the master process and the
jax-free chaos workers load this file without the framework import.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "PENDING", "LEASED", "FINISHED", "DEAD", "Task", "TaskQueue",
    "DispatchError", "SNAPSHOT_MANIFEST", "save_snapshot", "load_snapshot",
    "make_range_tasks",
]

PENDING = "pending"
LEASED = "leased"
FINISHED = "finished"
DEAD = "dead"

SNAPSHOT_MANIFEST = "manifest.json"
SNAPSHOT_FORMAT = "paddle_tpu-dispatch-v1"


class DispatchError(RuntimeError):
    """A dispatch-protocol failure (unknown task, malformed request)."""


class Task:
    """One unit of epoch work plus its full lease/retry history — every
    field JSON-serializable so the queue snapshots losslessly."""

    __slots__ = ("task_id", "payload", "state", "failure_count", "lease_id",
                 "worker", "deadline", "backoff_until", "leased_at",
                 "finished_at", "error")

    def __init__(self, task_id: int, payload: Dict[str, Any]):
        self.task_id = int(task_id)
        self.payload = payload
        self.state = PENDING
        self.failure_count = 0
        self.lease_id: Optional[int] = None   # the CURRENT (or final) lease
        self.worker: Optional[str] = None
        self.deadline: Optional[float] = None
        self.backoff_until = 0.0
        self.leased_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in Task.__slots__}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Task":
        t = cls(d["task_id"], d.get("payload") or {})
        for s in Task.__slots__:
            if s in d and s not in ("task_id", "payload"):
                setattr(t, s, d[s])
        return t


def make_range_tasks(total: int, per_task: int) -> List[Dict[str, Any]]:
    """Index-range payloads over any indexable dataset: ``total`` samples
    split into ``ceil(total/per_task)`` tasks of
    ``{"kind": "range", "start": i, "count": n}``."""
    if per_task < 1:
        raise ValueError("per_task must be >= 1")
    out = []
    start = 0
    while start < total:
        n = min(per_task, total - start)
        out.append({"kind": "range", "start": start, "count": n})
        start += n
    return out


class TaskQueue:
    """The pure (single-threaded) lease state machine.  The master wraps
    every call in its own lock; tests drive it directly with a fake
    clock."""

    def __init__(self, payloads: Optional[List[Dict[str, Any]]] = None, *,
                 lease_timeout_s: float = 30.0, max_failures: int = 3,
                 backoff_base_s: float = 1.0, backoff_mult: float = 2.0,
                 backoff_cap_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.lease_timeout_s = float(lease_timeout_s)
        self.max_failures = int(max_failures)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_mult = float(backoff_mult)
        self.backoff_cap_s = float(backoff_cap_s)
        self.clock = clock
        self.tasks: Dict[int, Task] = {}
        self.epoch = 0
        self._lease_seq = 0
        # cumulative accounting (exactly-once proof material): survives
        # snapshot/recover with the tasks
        self.counters: Dict[str, int] = {
            "served": 0, "finished": 0, "failed": 0, "requeued": 0,
            "dead": 0, "lease_expiry": 0, "stale_finish": 0,
            "stale_renew": 0, "stale_fail": 0, "worker_reaps": 0,
        }
        for i, p in enumerate(payloads or []):
            self.tasks[i] = Task(i, p)

    # ------------------------------------------------------------- queries
    def counts(self) -> Dict[str, int]:
        c = {PENDING: 0, LEASED: 0, FINISHED: 0, DEAD: 0}
        for t in self.tasks.values():
            c[t.state] += 1
        c["total"] = len(self.tasks)
        return c

    @property
    def done(self) -> bool:
        """Epoch complete: every task retired (finished or quarantined)."""
        return all(t.state in (FINISHED, DEAD) for t in self.tasks.values())

    def dead_tasks(self) -> List[Task]:
        return [t for t in self.tasks.values() if t.state == DEAD]

    # --------------------------------------------------------------- lease
    def get_task(self, worker: str, now: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Lease the lowest-id eligible pending task to ``worker``.
        Returns ``{"task": {...}, "lease_id", "deadline"}`` or — with
        nothing currently eligible — ``{"task": None, "done": bool,
        "retry_after": seconds|None}`` (retry_after: when the next lease
        or backoff can unblock a retry; None once the epoch is done)."""
        now = self.clock() if now is None else now
        best: Optional[Task] = None
        next_wake: Optional[float] = None
        for t in sorted(self.tasks.values(), key=lambda t: t.task_id):
            if t.state == PENDING:
                if t.backoff_until <= now:
                    best = t
                    break
                next_wake = t.backoff_until if next_wake is None \
                    else min(next_wake, t.backoff_until)
            elif t.state == LEASED and t.deadline is not None:
                next_wake = t.deadline if next_wake is None \
                    else min(next_wake, t.deadline)
        if best is None:
            if self.done:
                return {"task": None, "done": True, "retry_after": None}
            retry = max(0.0, (next_wake - now)) if next_wake is not None \
                else self.lease_timeout_s
            return {"task": None, "done": False, "retry_after": retry}
        self._lease_seq += 1
        best.state = LEASED
        best.lease_id = self._lease_seq
        best.worker = worker
        best.leased_at = now
        best.deadline = now + self.lease_timeout_s
        self.counters["served"] += 1
        return {"task": {"task_id": best.task_id, "payload": best.payload,
                         "failure_count": best.failure_count},
                "lease_id": best.lease_id, "deadline": best.deadline,
                "lease_timeout_s": self.lease_timeout_s}

    def _holding(self, task_id: int, lease_id: int, worker: str
                 ) -> Optional[Task]:
        """The task iff (task_id, lease_id, worker) is the LIVE lease."""
        t = self.tasks.get(int(task_id))
        if t is None or t.state != LEASED:
            return None
        if t.lease_id != int(lease_id) or t.worker != worker:
            return None
        return t

    def renew(self, task_id: int, lease_id: int, worker: str,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Extend a live lease (the worker heartbeat while it stages a
        task).  A stale lease (expired+requeued, or re-leased elsewhere)
        is refused: the worker must abandon the task."""
        now = self.clock() if now is None else now
        t = self._holding(task_id, lease_id, worker)
        if t is None:
            self.counters["stale_renew"] += 1
            return {"ok": False, "stale": True}
        t.deadline = now + self.lease_timeout_s
        return {"ok": True, "deadline": t.deadline}

    def finish(self, task_id: int, lease_id: int, worker: str,
               now: Optional[float] = None) -> Dict[str, Any]:
        """Retire a task.  Exactly-once accounting: only the live lease
        may finish — a late finish after expiry/requeue is ``stale`` and
        counts nothing (the re-served lease will deliver the records)."""
        now = self.clock() if now is None else now
        t = self._holding(task_id, lease_id, worker)
        if t is None:
            self.counters["stale_finish"] += 1
            return {"ok": False, "stale": True}
        t.state = FINISHED
        t.deadline = None
        t.finished_at = now
        self.counters["finished"] += 1
        latency = (now - t.leased_at) if t.leased_at is not None else None
        return {"ok": True, "done": self.done, "latency_s": latency}

    def fail(self, task_id: int, lease_id: int, worker: str,
             error: Optional[str] = None, now: Optional[float] = None
             ) -> Dict[str, Any]:
        """Voluntary failure report from the lease holder: requeue with
        exponential backoff, or quarantine at the failure cap."""
        now = self.clock() if now is None else now
        t = self._holding(task_id, lease_id, worker)
        if t is None:
            self.counters["stale_fail"] += 1
            return {"ok": False, "stale": True}
        self.counters["failed"] += 1
        return {"ok": True, **self._requeue(t, now, error=error)}

    # ------------------------------------------------------------- reaping
    def _backoff(self, failures: int) -> float:
        """Deterministic schedule: ``base * mult**(failures-1)``, capped —
        no jitter, so a fixed clock replays bit-identically."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * self.backoff_mult
                   ** max(0, failures - 1))

    def _requeue(self, t: Task, now: float, *, error: Optional[str] = None,
                 backoff: bool = True) -> Dict[str, Any]:
        t.lease_id = None
        t.worker = None
        t.deadline = None
        t.error = error
        t.failure_count += 1
        if t.failure_count >= self.max_failures:
            t.state = DEAD
            self.counters["dead"] += 1
            return {"state": DEAD, "failure_count": t.failure_count}
        t.state = PENDING
        t.backoff_until = now + (self._backoff(t.failure_count)
                                 if backoff else 0.0)
        self.counters["requeued"] += 1
        return {"state": PENDING, "failure_count": t.failure_count,
                "backoff_until": t.backoff_until}

    def reap_expired(self, now: Optional[float] = None) -> List[Dict[str,
                                                                     Any]]:
        """The timeout sweep: every lease past its deadline is treated as
        a failure (the holder is presumed dead) and requeued with backoff
        — or quarantined at the cap."""
        now = self.clock() if now is None else now
        out = []
        for t in self.tasks.values():
            # a lease is valid THROUGH its deadline (inclusive): expiry
            # strictly after, so renew-at-deadline never races the sweep
            if t.state != LEASED or t.deadline is None \
                    or t.deadline >= now:
                continue
            self.counters["lease_expiry"] += 1
            worker = t.worker
            res = self._requeue(t, now, error="lease expired")
            out.append({"task_id": t.task_id, "worker": worker, **res})
        return out

    def reap_worker(self, worker: str, now: Optional[float] = None
                    ) -> List[Dict[str, Any]]:
        """Reap every live lease of ``worker`` NOW (no waiting for the
        deadline) and requeue without backoff — the topology-change path:
        a restarted/re-placed rank declares its old incarnation dead and
        the survivors pick the tasks up immediately.  Still counts toward
        the failure cap so a worker-killing task cannot loop forever."""
        now = self.clock() if now is None else now
        out = []
        for t in self.tasks.values():
            if t.state != LEASED or t.worker != worker:
                continue
            self.counters["worker_reaps"] += 1
            res = self._requeue(t, now, error=f"worker {worker} reaped",
                                backoff=False)
            out.append({"task_id": t.task_id, "worker": worker, **res})
        return out

    # ---------------------------------------------------------- epochs
    def begin_epoch(self, epoch: int, now: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Barrier-free epoch advance: a reader entering epoch ``k``
        declares it before consuming.  Joining the current (or an older)
        epoch is a no-op; the FIRST declaration of ``current+1`` — legal
        only once every task of the current epoch is retired — requeues
        every finished task fresh (failure counts cleared; DEAD tasks stay
        quarantined).  A worker that runs ahead while stragglers still
        hold leases gets ``{"ok": False, "wait": seconds}`` and retries."""
        now = self.clock() if now is None else now
        epoch = int(epoch)
        if epoch <= self.epoch:
            return {"ok": True, "epoch": self.epoch, "reset": False}
        if epoch > self.epoch + 1:
            raise DispatchError(
                f"cannot begin epoch {epoch}: current is {self.epoch}")
        if not self.done:
            return {"ok": False, "epoch": self.epoch,
                    "wait": min(1.0, self.lease_timeout_s / 4.0)}
        self.epoch = epoch
        for t in self.tasks.values():
            if t.state == DEAD:
                continue
            t.state = PENDING
            t.failure_count = 0
            t.lease_id = None
            t.worker = None
            t.deadline = None
            t.backoff_until = 0.0
            t.leased_at = None
            t.finished_at = None
            t.error = None
        return {"ok": True, "epoch": self.epoch, "reset": True}

    # ---------------------------------------------------------- snapshots
    def to_snapshot(self) -> Dict[str, Any]:
        return {
            "format": SNAPSHOT_FORMAT,
            "config": {"lease_timeout_s": self.lease_timeout_s,
                       "max_failures": self.max_failures,
                       "backoff_base_s": self.backoff_base_s,
                       "backoff_mult": self.backoff_mult,
                       "backoff_cap_s": self.backoff_cap_s},
            "epoch": self.epoch,
            "lease_seq": self._lease_seq,
            "counters": dict(self.counters),
            "tasks": [t.to_dict() for t in
                      sorted(self.tasks.values(),
                             key=lambda t: t.task_id)],
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any], *,
                      clock: Callable[[], float] = time.time
                      ) -> "TaskQueue":
        if snap.get("format") != SNAPSHOT_FORMAT:
            raise DispatchError(
                f"unknown dispatch snapshot format {snap.get('format')!r}")
        cfg = snap.get("config") or {}
        q = cls(clock=clock, **cfg)
        q.epoch = int(snap.get("epoch", 0))
        q._lease_seq = int(snap.get("lease_seq", 0))
        q.counters.update(snap.get("counters") or {})
        for d in snap.get("tasks") or []:
            t = Task.from_dict(d)
            q.tasks[t.task_id] = t
        return q


# ----------------------------------------------------------- on-disk store

def save_snapshot(dirname: str, snap: Dict[str, Any], seq: int,
                  keep: int = 2) -> str:
    """Commit one queue snapshot: ``snapshot_<seq>.json`` tmp-write→rename
    first, ``manifest.json`` (tmp-write→rename) LAST — the manifest is the
    commit point, exactly the checkpoint discipline, so a master killed
    mid-write leaves either the previous committed snapshot or a torn
    torso that :func:`load_snapshot` ignores.  Prunes committed snapshots
    older than the newest ``keep``."""
    os.makedirs(dirname, exist_ok=True)
    fname = f"snapshot_{int(seq)}.json"
    path = os.path.join(dirname, fname)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    manifest = {"format": SNAPSHOT_FORMAT, "seq": int(seq), "file": fname,
                "created": time.time()}
    mpath = os.path.join(dirname, SNAPSHOT_MANIFEST)
    mtmp = mpath + f".tmp.{os.getpid()}"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, mpath)
    # prune: only files OLDER than the manifest's current target
    try:
        for name in os.listdir(dirname):
            if not name.startswith("snapshot_") \
                    or not name.endswith(".json"):
                continue
            try:
                s = int(name[len("snapshot_"):-len(".json")])
            except ValueError:
                continue
            if s <= int(seq) - keep:
                os.unlink(os.path.join(dirname, name))
    except OSError:
        pass
    return path


def load_snapshot(dirname: str) -> Optional[Dict[str, Any]]:
    """The committed snapshot under ``dirname``, or None when there is no
    (parseable) manifest — a torn snapshot left by a mid-write death is
    indistinguishable from no snapshot, by construction."""
    mpath = os.path.join(dirname, SNAPSHOT_MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    fname = manifest.get("file")
    if not fname:
        return None
    try:
        with open(os.path.join(dirname, fname)) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return None
    if snap.get("format") != SNAPSHOT_FORMAT:
        return None
    snap["_seq"] = int(manifest.get("seq", 0))
    return snap
