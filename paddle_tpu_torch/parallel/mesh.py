"""Device meshes over the process group: the port's counterpart of the
JAX package's ``jax.sharding.Mesh`` (the reference's per-device scopes and
``NCCLContextMap``, parallel_executor.cc:119-208).

A :class:`Mesh` names the axes of a ``torch.distributed`` ``DeviceMesh``
laid over the clique's ranks, one device a rank
(``distributed.init_parallel_env``); shardings are specs over those names
(``parallel/layout.py``) turned into DTensor placements.  The axis
vocabulary is the JAX package's:

* ``data`` — batch (pure data parallelism; grads all-reduce over it)
* ``fsdp`` — batch AND parameter dim 0 (ZeRO-style fully-sharded DP)
* ``tp``   — hidden/heads (tensor parallelism)
* ``model`` — legacy alias axis for hand-annotated tensor parallelism
* ``seq``  — sequence/context parallelism (ring attention)
* ``expert`` — MoE expert parallelism
* ``pipe`` — pipeline stages

The canonical training mesh is ``data × fsdp × tp`` (:func:`layout_mesh`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

#: canonical layout axes, in mesh order (parallel/layout.py)
CANONICAL_AXES: Tuple[str, ...] = ("data", "fsdp", "tp")


class Mesh:
    """Named axes over a ``DeviceMesh`` of the clique's ranks.

    ``shape`` is an ordered ``{axis: size}`` (``dict(mesh.shape)`` is what
    ``layout.py``, ``analysis/`` and ``checkpoint/`` read), ``devices`` the
    ranks as an array of that shape, ``device`` this rank's torch device.
    ``host_staged``: point-to-point transfers (``_collectives.ppermute``)
    and DTensor's all-gathers go through host memory, which gloo on CUDA
    tensors needs; the NCCL path never does."""

    def __init__(self, device_mesh, device, backend: str, host_staged: bool = False):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.devices = device_mesh.mesh.cpu().numpy()
        self.shape = OrderedDict(zip(self.axis_names, (int(d) for d in self.devices.shape)))
        self.device = device
        self.backend = backend
        self.host_staged = bool(host_staged)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def dim(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    @property
    def graph_safe(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: NCCL's
        run on the device; gloo's on the host."""
        return self.backend == "nccl"

    def __repr__(self):
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; {self.backend} on {self.device.type})"


def _mesh_cache():
    from .. import distributed as dist_mod
    return dist_mod._data_meshes


def make_mesh(axis_sizes: Optional[dict] = None, devices=None,
              host_staged: bool = False) -> Mesh:
    """Build a Mesh. Default: all devices on one 'data' axis.

    ``axis_sizes`` maps axis name -> size; sizes must multiply to #devices
    exactly.  At most one axis may be -1 to infer its size from the
    device count; every other size must be a positive divisor-compatible
    int.  Example: ``{"data": -1, "fsdp": 2, "tp": 2}``.

    The devices are the clique's ranks (``devices``: a list of ranks,
    default every rank), one device a rank; the process group is joined
    as a clique of one first if none was.  ``host_staged=True`` routes
    ``ppermute`` and DTensor's all-gathers through host memory
    (``_collectives.stage_all_gather_through_host``), which gloo on CUDA
    tensors needs: it cannot send from device memory, and its functional
    all-gather crashes on it.  A gloo CUDA mesh without it refuses
    ``ppermute``; asking for it under NCCL raises.  Meshes are cached by axes and devices, so every
    caller of one layout shares one ``DeviceMesh`` (and its groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from .. import distributed as dist_mod
    if devices is None:
        dist_mod._ensure_initialized()
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"data": n}
    names, sizes = [], []
    infer_idxs = []
    known = 1
    for i, (k, v) in enumerate(axis_sizes.items()):
        v = int(v)
        names.append(k)
        sizes.append(v)
        if v == -1:
            infer_idxs.append(i)
        elif v <= 0:
            raise ValueError(
                f"mesh axis {k!r} has invalid size {v} — sizes must be "
                f"positive ints, or -1 to infer from the device count")
        else:
            known *= v
    if len(infer_idxs) > 1:
        bad = [names[i] for i in infer_idxs]
        raise ValueError(
            f"mesh axes {bad} all have size -1 — at most one axis can be "
            f"inferred from the device count")
    if infer_idxs:
        if n % known != 0:
            raise ValueError(
                f"cannot infer axis {names[infer_idxs[0]]!r}: {n} devices "
                f"is not divisible by the known sizes' product {known} "
                f"({dict(zip(names, sizes))})")
        sizes[infer_idxs[0]] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh sizes {dict(zip(names, sizes))} != {n} devices")
    dist_mod._ensure_initialized()
    device, backend = dist_mod._state["device"], dist_mod._state["backend"]
    if host_staged:
        if backend == "nccl":
            raise ValueError("host_staged=True on an NCCL mesh: NCCL sends from device memory")
        from ._collectives import stage_all_gather_through_host
        stage_all_gather_through_host(device.type)
    key = ("mesh", tuple(names), tuple(sizes), tuple(devices), bool(host_staged))
    cache = _mesh_cache()
    mesh = cache.get(key)
    if mesh is None:
        dm = DeviceMesh(device.type, np.asarray(devices).reshape(sizes),
                        mesh_dim_names=tuple(names))
        mesh = Mesh(dm, device, backend, host_staged=host_staged)
        cache[key] = mesh
    return mesh


def layout_mesh(fsdp: int = 1, tp: int = 1, data: int = -1,
                devices=None) -> Mesh:
    """The canonical ``data × fsdp × tp`` mesh preset —
    ``make_mesh({"data": -1, "fsdp": fsdp, "tp": tp})``: pick the model
    axes, let data parallelism absorb the rest.  Size-1 axes are kept so a
    :class:`SpecLayout`'s specs stay valid across mesh reshapes (sharding
    over a size-1 axis is a no-op)."""
    return make_mesh({"data": int(data), "fsdp": int(fsdp), "tp": int(tp)},
                     devices=devices)
