"""Elastic data dispatch — the reference Go master's task queue
(dataset → tasks → ``GetTask``/``TaskFinished`` leases with timeout
retry, failure caps, and snapshot/recover) rebuilt as a jax-free service
over the ``reader``/``recordio`` layer.

* :class:`DispatchMaster` — the lease server (TCP line-JSON), timeout
  sweep, snapshot-on-mutation (tmp-write→rename, manifest-last), and the
  ``"dispatch"`` telemetry scope + ``dispatch_<pid>.jsonl``;
* :class:`TaskQueue` — the deterministic clock-injected state machine
  underneath (directly testable with a fake clock);
* :class:`DispatchClient` / :class:`DispatchReader` — the worker lease
  loop as a paddle-style reader creator (heartbeat renew while staging);
* :class:`DispatchConfig` — ``Trainer(dispatch=...)`` wiring, including
  the warm-restart self-reap that re-serves a dead rank's in-flight
  tasks to survivors;
* :func:`make_recordio_tasks` / :func:`make_range_tasks` + the matching
  ``task_reader`` factories — dataset sharding into task payloads.

Fault injection for all of it lives in :mod:`paddle_tpu_torch.faults`.
"""
from .taskqueue import (DEAD, FINISHED, LEASED, PENDING, DispatchError,
                        Task, TaskQueue, load_snapshot, make_range_tasks,
                        save_snapshot)
from .master import DISPATCH_SCOPE, DispatchMaster, read_addr_file, \
    write_addr_file
from .client import (DispatchClient, DispatchConfig, DispatchReader,
                     DispatchUnavailable, MasterUnreachable,
                     chunk_offsets, make_recordio_tasks,
                     range_task_reader, read_chunk, recordio_task_reader)

__all__ = [
    "PENDING", "LEASED", "FINISHED", "DEAD",
    "Task", "TaskQueue", "DispatchError", "DispatchUnavailable",
    "MasterUnreachable",
    "save_snapshot", "load_snapshot",
    "DISPATCH_SCOPE", "DispatchMaster", "write_addr_file",
    "read_addr_file",
    "DispatchClient", "DispatchReader", "DispatchConfig",
    "make_range_tasks", "range_task_reader",
    "make_recordio_tasks", "recordio_task_reader", "chunk_offsets",
    "read_chunk",
]
