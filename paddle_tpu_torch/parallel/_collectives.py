"""The collectives ring attention and the pipeline run on local shards:
the port's counterparts of ``lax.ppermute`` and ``lax.psum`` inside the
JAX package's ``shard_map`` bodies (``parallel/_shard_map.py``).

``ppermute`` is a ``torch.autograd.Function``: forward sends each rank's
tensor along a permutation of one mesh axis (``batch_isend_irecv``; a
rank that receives nothing gets zeros, as ``lax.ppermute`` gives), and
backward sends the cotangent along the inverse permutation.  On a mesh
made with ``host_staged=True`` (gloo on CUDA tensors, whose send and receive
take host memory only) the transfer goes through host buffers; a gloo
CUDA mesh without it refuses, and an NCCL mesh never stages.

``stage_all_gather_through_host`` gives a host-staged mesh (gloo on CUDA
tensors) the one collective DTensor asks for that gloo's functional
path cannot run on CUDA memory (``_c10d_functional.all_gather_into_tensor``
crashed the process on the card, torch 2.11): a CUDA kernel of that op
that gathers host copies with ``dist.all_gather_into_tensor`` and copies
the result back.  ``make_mesh(host_staged=True)`` installs it, once a
process, and says so on stdout; the NCCL path never installs it.

``psum`` sums over an axis (an all-reduce).  Its result is the same on
every rank of the axis and each rank goes on with it as the one value:
the cotangent that comes back is that value's, so backward passes it
through unchanged (the transpose of ``lax.psum`` into a device-invariant
value in ``shard_map``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ppermute", "psum", "axis_index", "axis_size", "stage_all_gather_through_host"]

# the torch.library handles of the staged kernels (kept alive), by device type
_STAGED = {}


def stage_all_gather_through_host(device_type: str = "cuda") -> bool:
    """Register the host-staged ``all_gather_into_tensor`` kernel for
    ``device_type`` tensors (see the module docstring).  Returns False
    when it was registered before."""
    if device_type in _STAGED:
        return False
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        group = _resolve_process_group(group_name)
        host = inp.detach().to("cpu", copy=True).contiguous()
        out = torch.empty((int(group_size) * host.shape[0],) + tuple(host.shape[1:]),
                          dtype=host.dtype)
        dist.all_gather_into_tensor(out, host, group=group)
        return out.to(inp.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, device_type.upper())
    _STAGED[device_type] = lib
    print(f"collectives staged through the host: all_gather_into_tensor on {device_type} "
          f"tensors (dist.all_gather_into_tensor of host copies)", flush=True)
    return True


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.coordinate(axis)


def _send_recv(x: torch.Tensor, mesh, axis: str, perm: Tuple[Tuple[int, int], ...]):
    me = mesh.coordinate(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation of axis {axis!r}")
    if mesh.device.type == "cuda" and mesh.backend == "gloo" and not mesh.host_staged:
        raise RuntimeError(
            f"ppermute over {mesh!r}: gloo sends from host memory only; build the "
            f"mesh with make_mesh(..., host_staged=True) to stage it through the host")
    x = x.contiguous()
    out = torch.zeros_like(x)
    if src and src[0] == me:
        # a rank sending to itself (an axis of one) copies
        return out.copy_(x)
    group = mesh.group(axis)
    ops = []
    recv = out.cpu() if mesh.host_staged else out
    if dst:
        payload = x.cpu() if mesh.host_staged else x
        ops.append(dist.P2POp(dist.isend, payload, dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src[0]), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if mesh.host_staged and src:
        out.copy_(recv)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _send_recv(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _send_recv(g, ctx.mesh, ctx.axis, inverse), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` of each rank of ``axis`` sent along ``perm`` (pairs of axis
    coordinates ``(src, dst)``); zeros where a rank receives nothing."""
    return _PPermute.apply(x, mesh, axis, tuple((int(s), int(d)) for s, d in perm))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = x.clone()
        if axis_size(mesh, axis) > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, on every one of them."""
    return _PSum.apply(x, mesh, axis)
