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

The collective half (ROADMAP §A item 12b): :func:`init_parallel_env`
joins one ``torch.distributed`` process group over every trainer -- the
port's counterpart of the JAX coordination service and of the
reference's ``gen_nccl_id`` clique -- with one device a rank.  A
``CUDAPlace`` gets NCCL and a ``CPUPlace`` gets gloo; ``backend="gloo"``
puts gloo on CUDA tensors, whose point-to-point transfers then go through
the host (``parallel.mesh.Mesh.host_staged``).  :func:`data_mesh` and
:func:`feed_sharding` give the mesh and the placement a feed lands on
(``parallel/``), :func:`barrier` waits for every rank.
"""
from __future__ import annotations

import os
import socket
from typing import List, Optional

__all__ = [
    "init_parallel_env", "is_initialized", "trainer_id", "num_trainers",
    "trainer_endpoints", "local_device_count", "barrier", "ParallelEnv",
    "data_mesh", "feed_sharding",
]

# the process group this process joined (``init_parallel_env``)
_state = {"initialized": False, "num_trainers": 1, "trainer_id": 0,
          "device": None, "backend": None}
_data_meshes: dict = {}


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def trainer_endpoints() -> List[str]:
    """``PADDLE_TRAINER_ENDPOINTS``, split at commas (empty when unset)."""
    eps = _env("PADDLE_TRAINER_ENDPOINTS", default="") or ""
    return [e.strip() for e in eps.split(",") if e.strip()]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_parallel_env(trainer_id: Optional[int] = None,
                      num_trainers: Optional[int] = None,
                      coordinator_address: Optional[str] = None,
                      local_device_count: Optional[int] = None,
                      cpu_collectives: str = "gloo", place=None,
                      backend: Optional[str] = None) -> "ParallelEnv":
    """Join the trainer clique: one ``torch.distributed`` process group of
    ``num_trainers`` ranks, this process being ``trainer_id``.  Idempotent;
    a re-init with another clique raises.

    Arguments default to the env contract (``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``: the first
    endpoint is the rendezvous, ``tcp://<endpoint>``).  A clique of one
    needs no endpoint: it meets at a free localhost port, so a
    single-process script gets a group too (a ``DeviceMesh`` needs one).

    ``place`` (default ``CUDAPlace(0)``) is this rank's device: one device
    a rank.  ``backend`` defaults to NCCL on a CUDA place and gloo on the
    CPU; ``backend="gloo"`` on a CUDA place runs gloo on CUDA tensors.  A
    CUDA place without NCCL raises: nothing switches backend or device
    quietly.  ``local_device_count > 1`` raises: torch has no virtual
    devices, so N devices are N processes.  ``cpu_collectives`` is kept for
    the JAX package's signature; only gloo exists."""
    import torch
    import torch.distributed as dist
    from ..core.executor import CUDAPlace, place_device
    if _state["initialized"]:
        if ((num_trainers is not None and num_trainers != _state["num_trainers"])
                or (trainer_id is not None and trainer_id != _state["trainer_id"])):
            raise RuntimeError(
                f"init_parallel_env already ran with "
                f"(num_trainers={_state['num_trainers']}, "
                f"trainer_id={_state['trainer_id']}); conflicting re-init "
                f"with ({num_trainers}, {trainer_id}) — the clique cannot "
                f"be changed after initialization")
        return ParallelEnv()
    if local_device_count is not None and int(local_device_count) > 1:
        raise ValueError(
            f"local_device_count={local_device_count}: paddle_tpu_torch runs one "
            f"device a rank (torch has no virtual devices); start "
            f"{local_device_count} processes instead")
    if cpu_collectives != "gloo":
        raise ValueError(f"cpu_collectives={cpu_collectives!r}: only gloo exists")
    if trainer_id is None:
        trainer_id = int(_env("PADDLE_TRAINER_ID", default="0"))
    if num_trainers is None:
        num_trainers = int(_env("PADDLE_TRAINERS_NUM", "PADDLE_TRAINERS", default="1"))
    device = place_device(place if place is not None else CUDAPlace(0))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: the port runs 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' needs a CUDA place")
        if not dist.is_nccl_available():
            raise RuntimeError(f"{device} asks for NCCL, which this torch build lacks; "
                               f"pass backend='gloo' to run gloo on CUDA tensors")
    if coordinator_address is None:
        eps = trainer_endpoints()
        if eps:
            coordinator_address = eps[0]
        elif num_trainers <= 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise ValueError(
                "multi-trainer init needs a coordinator: pass "
                "coordinator_address or set PADDLE_TRAINER_ENDPOINTS "
                "(first endpoint hosts the rendezvous)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=int(trainer_id), world_size=int(num_trainers), **kw)
    _state.update(initialized=True, num_trainers=int(num_trainers),
                  trainer_id=int(trainer_id), device=device, backend=backend)
    return ParallelEnv()


def _ensure_initialized():
    """The process group, joined as a clique of one when none is yet."""
    if not _state["initialized"]:
        init_parallel_env()


def is_initialized() -> bool:
    """A process group of more than one rank was joined."""
    return _state["initialized"] and _state["num_trainers"] > 1


def trainer_id() -> int:
    """This rank (the env contract's ``PADDLE_TRAINER_ID`` before
    :func:`init_parallel_env`)."""
    if _state["initialized"]:
        return _state["trainer_id"]
    return int(_env("PADDLE_TRAINER_ID", default="0"))


def num_trainers() -> int:
    """The clique's size (``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINERS``
    before :func:`init_parallel_env`)."""
    if _state["initialized"]:
        return _state["num_trainers"]
    return int(_env("PADDLE_TRAINERS_NUM", "PADDLE_TRAINERS", default="1"))


def local_device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def data_mesh(batch_axis: str = "data", axes: Optional[dict] = None):
    """The mesh feeds are staged onto: every rank of the clique on one
    ``batch_axis``, or the multi-axis mesh ``axes`` (name -> size, checked
    by :func:`~paddle_tpu_torch.parallel.mesh.make_mesh`).  Cached per axis
    spec, so one ``Mesh`` serves every stager and executor (its identity
    keys the executor's cache)."""
    from ..parallel.mesh import make_mesh
    key = tuple((str(k), int(v)) for k, v in axes.items()) if axes else batch_axis
    mesh = _data_meshes.get(key)
    if mesh is None:
        mesh = make_mesh(dict(axes) if axes else {batch_axis: -1})
        _data_meshes[key] = mesh
    return mesh


def feed_sharding(spec=None, mesh=None, batch_axis: str = "data"):
    """The ``parallel.layout.Sharding`` a feed's value lands on: its batch
    dim split over every present batch axis (``batch_axis``, ``"fsdp"``),
    the rest replicated; or the explicit ``spec`` (axis names, tuples of
    them or None a dim)."""
    from ..parallel.layout import Sharding
    mesh = mesh if mesh is not None else data_mesh(batch_axis)
    if spec is not None:
        return Sharding(mesh, spec)
    present = [a for a in dict.fromkeys((batch_axis, "fsdp")) if a in mesh.shape]
    if not present:
        return Sharding(mesh, None)
    return Sharding(mesh, [present[0] if len(present) == 1 else tuple(present)])


def barrier(name: str = "paddle_tpu_barrier") -> None:
    """Block until every trainer reaches this point (the reference's
    send_barrier / fetch_barrier BSP sync)."""
    if not is_initialized():
        return
    import torch.distributed as dist
    dev = _state["device"]
    if _state["backend"] == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


class ParallelEnv:
    """Snapshot of the trainer clique (the reference exposes the same facts
    through the PADDLE_* env vars read in fluid_benchmark.py:62-101)."""

    @property
    def nranks(self) -> int:
        return num_trainers()

    @property
    def rank(self) -> int:
        return trainer_id()

    @property
    def local_devices(self) -> int:
        return local_device_count()

    @property
    def global_devices(self) -> int:
        """One device a rank: the clique's size once joined."""
        return num_trainers() if is_initialized() else local_device_count()

    def __repr__(self):
        return (f"ParallelEnv(rank={self.rank}/{self.nranks}, "
                f"local_devices={self.local_devices})")


from .master import Master, MasterClient, MasterServer, NoMoreTasks  # noqa: E402,F401

__all__ += ["Master", "MasterServer", "MasterClient", "NoMoreTasks"]
