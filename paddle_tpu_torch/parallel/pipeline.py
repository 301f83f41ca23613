"""Pipeline parallelism: GPipe-style microbatched stage pipelining, the
JAX package's ``parallel/pipeline.py`` on DTensor and
``_collectives.ppermute``.

Stage parameters are stacked with a leading ``S`` (stage) dim and sharded
over a ``pipe`` mesh axis, one stage a rank.  Each rank runs its stage on
its local slice: a schedule of ``n_micro + S - 1`` ticks fills and drains
the pipeline (the GPipe bubble), ``ppermute`` shifts each tick's
activation one stage on, and the last stage's outputs, summed over the
axis (the other stages add nothing), are the result on every stage.
Autograd through the schedule, ``ppermute`` sending cotangents back along
the inverse shift, is the backward pipeline.

Where the JAX package runs every stage on every tick inside one traced
``scan`` and masks the bubble's outputs, each rank here knows its own
stage, so it runs only the ticks that carry a microbatch
(``t - stage`` in ``[0, n_micro)``) and sends zeros on the others: the
same outputs and gradients without the bubble's dead compute.  The
backward schedule is written out (``_GPipe.backward``) rather than left
to autograd: every rank then makes the same exchanges in the same order
(ticks descending), whichever of its ticks carried work, so no rank waits
on a transfer its neighbour's autograd graph would have skipped.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from ._collectives import _send_recv, axis_index

__all__ = ["pipeline_apply"]


class _GPipe(torch.autograd.Function):
    """The schedule on one rank's local tensors: ``x`` [B, ...] (read by
    stage 0) and each stacked parameter's local [1, ...] slice."""

    @staticmethod
    def forward(ctx, stage_fn, names, n_micro, mesh, axis, x, *params):
        s = int(mesh.shape[axis])
        stage = axis_index(mesh, axis)
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"a rank's batch {b} is not divisible by n_micro {n_micro}")
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        shift = tuple((i, i + 1) for i in range(s - 1))
        leaves = [p[0].detach().requires_grad_(p.requires_grad) for p in params]
        views = dict(zip(names, leaves))
        h_prev = torch.zeros_like(micro[0])
        saved, emitted = {}, []
        for t in range(n_micro + s - 1):
            if 0 <= t - stage < n_micro:
                inp = (micro[t] if stage == 0 else h_prev).detach().requires_grad_(True)
                with torch.enable_grad():
                    h_out = stage_fn(views, inp)
                if h_out.shape != inp.shape or h_out.dtype != inp.dtype:
                    raise ValueError(
                        f"pipeline stage must preserve shape/dtype: in "
                        f"{tuple(inp.shape)}/{inp.dtype} -> out "
                        f"{tuple(h_out.shape)}/{h_out.dtype}")
                saved[t] = (inp, h_out)
                h_send = h_out.detach()
                if stage == s - 1:
                    emitted.append(h_send)
            else:
                h_send = torch.zeros_like(h_prev)
            h_prev = _send_recv(h_send, mesh, axis, shift)
        out = torch.stack(emitted) if emitted else torch.zeros_like(micro)
        if s > 1:
            # the last stage's microbatches, on every stage (lax.psum)
            dist.all_reduce(out, group=mesh.group(axis))
        ctx.state = (mesh, axis, stage, s, shift, saved, leaves, micro.shape, n_micro)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, stage, s, shift, saved, leaves, micro_shape, n_micro = ctx.state
        inverse = tuple((d, src) for src, d in shift)
        g_micro = g.reshape(micro_shape)
        dx = torch.zeros(micro_shape, dtype=g.dtype, device=g.device)
        dparams = [torch.zeros_like(p) for p in leaves]
        # the cotangent of the activation this rank received at tick t,
        # sent back to the stage before at step t
        carry = torch.zeros_like(g_micro[0])
        for t in reversed(range(n_micro + s - 1)):
            g_out = _send_recv(carry, mesh, axis, inverse)
            carry = torch.zeros_like(carry)
            if t in saved:
                inp, h_out = saved.pop(t)
                if stage == s - 1:
                    # the sum's cotangent reaches the last stage's outputs
                    g_out = g_out + g_micro[t - (s - 1)]
                want = [inp] + [p for p in leaves if p.requires_grad]
                grads = torch.autograd.grad(h_out, want, g_out, allow_unused=True)
                it = iter(grads[1:])
                for i, p in enumerate(leaves):
                    if p.requires_grad:
                        gp = next(it)
                        if gp is not None:
                            dparams[i] += gp
                if grads[0] is not None:
                    if stage == 0:
                        dx[t] += grads[0]
                    else:
                        carry = grads[0]
        return (None, None, None, None, None, dx.reshape(g.shape),
                *(d.unsqueeze(0) for d in dparams))


def pipeline_apply(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor], x,
                   n_micro: int, mesh, axis: str = "pipe", batch_axis=None):
    """Apply ``S`` sequential stages to ``x`` with GPipe microbatching.

    stage_fn(params_i, h) -> h'   (h and h' must share shape/dtype; the
        params and h are local tensors)
    stacked_params: name -> DTensor whose leading dim is S (stage axis),
        sharded over ``axis``.
    x: [B, ...] global DTensor; B must divide by n_micro (and by the
        ``batch_axis`` size if data parallelism is combined).
    Returns stage_{S-1}(...stage_0(x)) — the sequential composition,
    computed with pipeline parallelism over ``axis``."""
    from torch.distributed.tensor import Partial
    from .layout import as_placements, on_local
    s = int(mesh.shape[axis])
    for name, leaf in stacked_params.items():
        if leaf.shape[0] != s:
            raise ValueError(
                f"stacked_params leading dim {leaf.shape[0]} != pipe axis "
                f"size {s} — one stage per device (stack multiple layers "
                f"into one stage_fn for deeper models)")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro {n_micro}")
    names = sorted(stacked_params)
    p_pl = as_placements([axis], mesh)
    x_pl = as_placements([batch_axis] if batch_axis else None, mesh)
    # only stage 0 reads x: its gradient is a sum over the stages
    x_grad = tuple(Partial() if i == mesh.dim(axis) else p for i, p in enumerate(x_pl))

    def body(xl, *pl):
        return _GPipe.apply(stage_fn, names, n_micro, mesh, axis, xl, *pl)

    return on_local(mesh, body, (x,) + tuple(stacked_params[n] for n in names),
                    (x_pl,) + (p_pl,) * len(names), x_pl,
                    in_grad_placements=(x_grad,) + (p_pl,) * len(names))
