"""`pipeline` op: GPipe-style pipeline parallelism reachable from the
Program IR (the JAX package's ``ops/pipeline_ops.py``).

The op carries ONE sub-block describing a single stage's computation
(homogeneous stages: every rank runs the same stage program on its own
stage's parameters).  Parameters created inside the stage body are
stored STACKED with a leading ``n_stages`` dim (``layers/pipeline.py``
stamps them); under an executor mesh with the pipe axis the lowering maps
the stage body onto ``parallel.pipeline.pipeline_apply`` (activations
shift stage to stage through ``ppermute``), and without one it runs the
stages in sequence — the same function either way.

The stage body runs on local tensors in a context of its own, with no
mesh (the JAX package's ``LowerCtx(sub, ..., mesh=None)``).  Backward:
the generic grad differentiates the op's lowering; under the mesh
``pipeline_apply``'s backward schedule is the backward pipeline.
"""
from __future__ import annotations

from ..core.lower import LowerCtx, lower_block
from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape


@register_lowering("pipeline")
def _pipeline(ctx, op):
    sub = ctx.block.program.blocks[op.block_attr("sub_block")]
    x = ctx.read_slot(op, "X")
    n_stages = int(op.attr("n_stages"))
    n_micro = int(op.attr("n_micro"))
    axis = str(op.attr("pipe_axis", "pipe"))
    stage_in = str(op.attr("stage_in"))
    stage_out = str(op.attr("stage_out"))
    # stored (stacked [S, ...]) param name -> stage-view name used by the
    # sub-block's ops
    param_map = dict(op.attr("stage_params", {}))
    stacked = {view: ctx.read(stored) for stored, view in param_map.items()}

    def stage_fn(views, h):
        env = dict(views)
        env[stage_in] = h
        # stage bodies draw nothing (layers/pipeline.py refuses random ops):
        # no generator
        sctx = LowerCtx(sub, env, None, h.device, amp=ctx.amp)
        lower_block(sctx, sub)
        out = sctx.read(stage_out)
        if out.shape != h.shape or out.dtype != h.dtype:
            raise ValueError(
                f"pipeline stage must preserve shape/dtype: in "
                f"{tuple(h.shape)}/{h.dtype} -> out {tuple(out.shape)}/{out.dtype}")
        return out

    mesh = ctx.mesh
    if mesh is not None and axis in mesh.shape:
        if mesh.shape[axis] != n_stages:
            raise ValueError(
                f"pipeline n_stages={n_stages} != mesh axis {axis!r} size "
                f"{mesh.shape[axis]}")
        from ..parallel.pipeline import pipeline_apply
        batch_axis = str(op.attr("batch_axis", "data"))
        out = pipeline_apply(stage_fn, stacked, x, n_micro, mesh, axis=axis,
                             batch_axis=batch_axis if batch_axis in mesh.shape else None)
    else:
        # no pipe axis: the sequential composition the pipeline computes —
        # same function, no schedule (under another mesh, on the DTensors)
        out = x
        for i in range(n_stages):
            out = stage_fn({k: a[i] for k, a in stacked.items()}, out)
    ctx.write_slot(op, "Out", out)


@register_infer_shape("pipeline")
def _pipeline_shape(block, op):
    set_out_shape(block, op, "Out", in_shape(block, op, "X"), in_dtype(block, op, "X"))
