"""Lowerings of the kernel tier's op types.

The ``pallas-kernels`` pass (ops/cuda/kernel_pass.py) retypes
policy-selected ops onto these.  The op types keep the JAX package's names
(they are part of the ProgramDesc), and each lowering calls the port's
hand-written Hopper kernel on CUDA tensors and its plain version on CPU
tensors:

* ``pallas_int8_matmul`` -- one ``amp-quant-int8`` simulation group
  (quantize x2 -> mul or matmul -> scale -> dequantize) as the int8 GEMM,
  K4 (a batched ``matmul`` contracts the quantized operands without it);
* ``pallas_gather`` / ``pallas_scatter_add`` -- the ``lookup_table``
  forward (K2) and its dense gradient (K3, reading the output gradient
  slot ``__outgrad__Out`` and writing ``W@GRAD_SLOT`` as the generic
  ``lookup_table_grad`` op's slots are named).

``pallas_sgd`` / ``pallas_adam`` (K5 / K6) lower through the ``sgd`` /
``adam`` lowerings of ops/optimizer_ops.py, which launch the same kernels.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register_infer_shape, register_lowering
from .common import in_dtype, in_shape, set_out_shape
from .cuda.embedding import gather_rows, scatter_add_rows
from .cuda.int8_matmul import int8_matmul, int8_matmul_plain
from .math_ops import matmul_out_shape
from .nn_ops import flat_ids, lookup_rows


# ----------------------------------------------------------- int8 matmul

@register_lowering("pallas_int8_matmul", no_gradient=True)
def _pallas_int8_matmul(ctx, op):
    """The int8 product of X and Y.  ``base_op="mul"``: flatten X at
    x_num_col_dims and Y at y_num_col_dims, K4, restore.  ``base_op=
    "matmul"``: each operand transposed where its flag says; a 2-D product
    goes through K4, a batched one is the exact integer contraction of the
    abs-max quantized operands, dequantized by the combined scale (the JAX
    package computes it so without its kernel); then ``alpha``."""
    x = ctx.read_slot(op, "X")
    y = ctx.read_slot(op, "Y")
    bits = int(op.attr("bit_length", 8))
    if op.attr("base_op", "mul") == "matmul":
        if op.attr("transpose_X", False):
            x = x.transpose(-1, -2)
        if op.attr("transpose_Y", False):
            y = y.transpose(-1, -2)
        if x.ndim == 2 and y.ndim == 2:
            out = _int8_rows(ctx, x.contiguous(), y.contiguous(), bits)
        else:
            out = int8_matmul_plain(x, y, bits=bits)
        alpha = op.attr("alpha", 1.0)
        if alpha != 1.0:
            out = out * alpha
        ctx.write_slot(op, "Out", out)
        return
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), math.prod(x.shape[xnc:]))
    y2 = y.reshape(math.prod(y.shape[:ync]), math.prod(y.shape[ync:]))
    out = _int8_rows(ctx, x2, y2, bits)
    ctx.write_slot(op, "Out", out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


def _int8_rows(ctx, x2, y2, bits: int):
    """K4 on [M, K] x [K, N]; under a mesh on each rank's rows of x2 with
    y2 replicated."""
    if ctx.mesh is None:
        return int8_matmul(x2, y2, bits=bits)
    from ..parallel.layout import batch_like, on_local, replicate
    pl = batch_like(x2, ctx.mesh)
    return on_local(ctx.mesh, lambda a, b: int8_matmul(a.contiguous(), b.contiguous(), bits=bits),
                    (x2, y2), (pl, replicate(ctx.mesh)), pl)


@register_infer_shape("pallas_int8_matmul")
def _pallas_int8_matmul_shape(block, op):
    if op.attr("base_op", "mul") == "matmul":
        out = matmul_out_shape(block, op)
    else:
        xs, ys = in_shape(block, op, "X"), in_shape(block, op, "Y")
        out = list(xs[:op.attr("x_num_col_dims", 1)]) + list(ys[op.attr("y_num_col_dims", 1):])
    set_out_shape(block, op, "Out", out, in_dtype(block, op, "X"))


# ------------------------------------------------ embedding gather / grad

@register_lowering("pallas_gather", no_gradient=True, non_diff_inputs=("Ids",))
def _pallas_gather(ctx, op):
    lookup_rows(ctx, op, gather_rows)


@register_infer_shape("pallas_gather")
def _pallas_gather_shape(block, op):
    ws = in_shape(block, op, "W")
    ids = in_shape(block, op, "Ids")
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    set_out_shape(block, op, "Out", tuple(ids) + (ws[-1],), in_dtype(block, op, "W"))


@register_lowering("pallas_scatter_add", no_gradient=True)
def _pallas_scatter_add(ctx, op):
    gnames = op.outputs.get("W@GRAD_SLOT", [])
    if not gnames or not gnames[0]:
        return
    w = ctx.read_slot(op, "W")
    ids = ctx.read_slot(op, "Ids")
    grad = ctx.read(op.input("__outgrad__Out")[0])
    padding_idx = op.attr("padding_idx", -1)

    def dw(w, ids, grad, row_offset=0):
        _, flat = flat_ids(ids)
        rows = grad.reshape((-1,) + tuple(w.shape[1:]))
        if padding_idx is not None and padding_idx >= 0:
            rows = torch.where((flat != padding_idx)[:, None], rows, 0.0)
        if row_offset:
            flat = (flat - row_offset).contiguous()
        return scatter_add_rows(w, flat, rows.to(w.dtype).contiguous())

    if ctx.mesh is None:
        ctx.write(gnames[0], dw(w, ids, grad))
        return
    from ..parallel.layout import (batch_like, on_local, partial_where_sharded, replicate,
                                   row_shard)
    shard = row_shard(w, ctx.mesh)
    if shard is not None:
        # a row-sharded table: the ids and output gradient gathered over the
        # batch axes in the global batch's order, K3 into the rank's own
        # rows at the ids shifted by its offset; W's gradient is Shard(0)
        row_offset = shard[0]
        rep = replicate(ctx.mesh)
        ctx.write(gnames[0], on_local(
            ctx.mesh, lambda w, ids, grad: dw(w, ids, grad, row_offset),
            (w, ids, grad), (tuple(w.placements), rep, rep), tuple(w.placements)))
        return
    # each rank adds its own ids' rows: a partial sum of the table's gradient
    pl = batch_like(ids, ctx.mesh)
    ctx.write(gnames[0], on_local(ctx.mesh, dw, (w, ids, grad), (replicate(ctx.mesh), pl, pl),
                                  partial_where_sharded(pl)))


@register_infer_shape("pallas_scatter_add")
def _pallas_scatter_add_shape(block, op):
    set_out_shape(block, op, "W@GRAD_SLOT", in_shape(block, op, "W"), in_dtype(block, op, "W"))


# ------------------------------------------------ fused optimizers (K5 / K6)

def _pallas_opt_shape(block, op):
    """Structural: every ``<Slot>Out`` mirrors ``<Slot>`` (in-place update)."""
    for out_slot in list(op.outputs):
        if not out_slot.endswith("Out"):
            continue
        in_slot = out_slot[:-3]
        if not op.input(in_slot):
            continue
        set_out_shape(block, op, out_slot, in_shape(block, op, in_slot),
                      in_dtype(block, op, in_slot))


for _t in ("pallas_sgd", "pallas_adam"):
    register_infer_shape(_t)(_pallas_opt_shape)
