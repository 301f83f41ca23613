"""The multi-process runtime: the trainer env contract, the elastic
master (``master``) and parameter-server training (``pserver``, with the
``DistributeTranspiler`` in ``transpiler`` and the send/recv op types in
``ops/dist_ops.py``).

The env-var contract of the fluid benchmark/cluster harness
(the reference's benchmark/fluid/fluid_benchmark.py:62-101):
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINERS`` and
``PADDLE_TRAINER_ENDPOINTS``, read by :func:`trainer_id`,
:func:`num_trainers` and :func:`trainer_endpoints`; :class:`ParallelEnv`
is their snapshot.  Parameter-server training needs nothing more: each
trainer and pserver is a process of its own talking TCP
(``tools/pserver_runner.py``).

The collective half -- ``init_parallel_env`` (one process group over
every trainer), ``data_mesh``, ``feed_sharding`` and ``barrier`` -- is
ROADMAP item 12b and not ported yet: each raises.
"""
from __future__ import annotations

import os
from typing import List, Optional

__all__ = [
    "init_parallel_env", "is_initialized", "trainer_id", "num_trainers",
    "trainer_endpoints", "local_device_count", "barrier", "ParallelEnv",
    "data_mesh", "feed_sharding",
]

_NOT_PORTED = ("is the collective half of multi-GPU training (a process group "
               "and a mesh), not ported to paddle_tpu_torch yet (ROADMAP §A item 12b); "
               "parameter-server training runs through DistributeTranspiler")


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def trainer_id() -> int:
    """``PADDLE_TRAINER_ID`` (0 when unset)."""
    return int(_env("PADDLE_TRAINER_ID", default="0"))


def num_trainers() -> int:
    """``PADDLE_TRAINERS_NUM`` or ``PADDLE_TRAINERS`` (1 when unset)."""
    return int(_env("PADDLE_TRAINERS_NUM", "PADDLE_TRAINERS", default="1"))


def trainer_endpoints() -> List[str]:
    """``PADDLE_TRAINER_ENDPOINTS``, split at commas (empty when unset)."""
    eps = _env("PADDLE_TRAINER_ENDPOINTS", default="") or ""
    return [e.strip() for e in eps.split(",") if e.strip()]


def is_initialized() -> bool:
    """Always False: no process group is ever joined (item 12b)."""
    return False


def local_device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def init_parallel_env(*args, **kwargs):
    raise NotImplementedError(f"init_parallel_env {_NOT_PORTED}")


def data_mesh(*args, **kwargs):
    raise NotImplementedError(f"data_mesh {_NOT_PORTED}")


def feed_sharding(*args, **kwargs):
    raise NotImplementedError(f"feed_sharding {_NOT_PORTED}")


def barrier(*args, **kwargs):
    raise NotImplementedError(f"barrier {_NOT_PORTED}")


class ParallelEnv:
    """Snapshot of the trainer clique from the env contract (the reference
    exposes the same facts via the PADDLE_* env vars consumed in
    fluid_benchmark.py:62-101)."""

    @property
    def nranks(self) -> int:
        return num_trainers()

    @property
    def rank(self) -> int:
        return trainer_id()

    @property
    def local_devices(self) -> int:
        return local_device_count()

    def __repr__(self):
        return (f"ParallelEnv(rank={self.rank}/{self.nranks}, "
                f"local_devices={self.local_devices})")


from .master import Master, MasterClient, MasterServer, NoMoreTasks  # noqa: E402,F401

__all__ += ["Master", "MasterServer", "MasterClient", "NoMoreTasks"]
