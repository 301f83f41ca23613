"""Sparse embedding gradients (SelectedRows) and the sparse updates (the
JAX package's ``ops/sparse_ops.py``).

``lookup_table_grad`` with ``is_sparse`` writes the batch's rows as a
:class:`~paddle_tpu_torch.core.selected_rows.SelectedRows` merged at the
source (one slot a unique id, padded to the batch's id count with the
table's height); without it, the gradient is the generic grad's re-run of
the gather under autograd, whose backward is the scatter-add kernel (K3),
as before this lowering existed.  ``get_tensor_from_selected_rows``,
``extract_rows``, ``merge_selected_rows``, ``sparse_weight_decay`` (the
regularizers' lazy decay of the touched rows) and ``sparse_scale_rows``
(the global-norm clip's rescale) convert and combine them.

The sparse updates (:func:`sparse_sgd`, :func:`sparse_adam`,
:func:`sparse_adagrad`) merge the gradient, gather the touched rows,
update them and write them back in place: the untouched rows keep their
bits.  A merged
gradient's padded slots point at slot 0's row and write what slot 0
writes (``selected_rows.update_slots`` / ``settle``), so every slot's
write stays inside the table and the duplicate writes agree.  No step
reads a device value on the host, so a step with sparse updates records
into one CUDA graph.  The JAX package has no Pallas kernel on this path;
these are PyTorch ops.
"""
from __future__ import annotations

import torch

from ..core.lower import _lower_generic_grad, is_dtensor, local_of
from ..core.registry import mark_no_gradient, register_lowering
from ..core.selected_rows import SelectedRows, concat_rows, row_mask, settle, update_slots
from .nn_ops import flat_ids


@register_lowering("lookup_table_grad")
def _lookup_table_grad(ctx, op):
    """W@GRAD from Out@GRAD: SelectedRows(ids, dout rows).merged() when
    ``is_sparse``, the ``padding_idx`` rows zeroed; else the generic grad."""
    if not op.attr("is_sparse", False):
        _lower_generic_grad(ctx, op, "lookup_table")
        return
    gnames = op.outputs.get("W@GRAD_SLOT", [])
    if not gnames or not gnames[0]:
        return
    w = ctx.read_slot(op, "W")
    ids = ctx.read_slot(op, "Ids")
    dname = (op.input("__outgrad__Out") or [""])[0]
    dout = ctx.read_opt(dname) if dname else None
    if ctx.mesh is not None:
        # every rank's rows of the batch, in the global batch's order: the
        # gradient is the whole batch's on every rank (a replicated table's
        # replicas all apply it; the update of a row-sharded one keeps the
        # rank's own rows, ``optimizer_ops._rank_rows``)
        ids, dout = (_whole(ctx.mesh, t) for t in (ids, dout))
    _, flat = flat_ids(ids)
    row_shape = tuple(w.shape[1:])
    if dout is None:
        rows = torch.zeros((flat.shape[0],) + row_shape, dtype=w.dtype, device=flat.device)
    else:
        rows = dout.reshape((-1,) + row_shape)
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        rows = torch.where(row_mask(flat != padding_idx, rows), rows, 0.0)
    ctx.write(gnames[0], SelectedRows(flat, rows, w.shape[0]).merged())


def _whole(mesh, t):
    """A DTensor's whole value on this rank (gathered over the mesh dims
    that shard it); anything else as it is."""
    from ..parallel.layout import replicate
    if not is_dtensor(t):
        return t
    return t.redistribute(mesh.device_mesh, replicate(mesh)).to_local()


# ------------------------------------------------ conversion / inspection

@register_lowering("get_tensor_from_selected_rows", no_gradient=True)
def _get_tensor_from_selected_rows(ctx, op):
    """The dense [height, D] tensor (a dense input passes through)."""
    x = ctx.read_slot(op, "X")
    ctx.write_slot(op, "Out", x.to_dense() if isinstance(x, SelectedRows) else x)


def _need_sparse(op_type, x):
    if not isinstance(x, SelectedRows):
        raise TypeError(f"{op_type} input must be SelectedRows")
    return x


@register_lowering("extract_rows", no_gradient=True)
def _extract_rows(ctx, op):
    ctx.write_slot(op, "Out", _need_sparse("extract_rows", ctx.read_slot(op, "X")).ids)


@register_lowering("merge_selected_rows", no_gradient=True)
def _merge_selected_rows(ctx, op):
    ctx.write_slot(op, "Out", _need_sparse("merge_selected_rows", ctx.read_slot(op, "X")).merged())


# ------------------------------------------------------- sparse updates

def sparse_sgd(p: torch.Tensor, g: SelectedRows, lr) -> torch.Tensor:
    """p[ids] -= lr * rows in place over the merged gradient (a gradient
    summed from several, or with its decay, holds an id more than once);
    returns p."""
    m = g.merged()
    at, valid, (p_rows,) = update_slots(m, p)
    p.index_put_((at,), settle(p_rows + (-lr * m.rows).to(p.dtype), p_rows, valid))
    return p


def sparse_adagrad(p: torch.Tensor, g: SelectedRows, moment: torch.Tensor, lr, eps):
    """The touched rows' Adagrad update in place; returns (p, moment)."""
    m = g.merged()
    at, valid, (p_rows, mom_rows) = update_slots(m, p, moment)
    mom_new = mom_rows + m.rows * m.rows
    p_new = p_rows - lr * m.rows / (torch.sqrt(mom_new) + eps)
    p.index_put_((at,), settle(p_new.to(p.dtype), p_rows, valid))
    moment.index_put_((at,), settle(mom_new.to(moment.dtype), mom_rows, valid))
    return p, moment


def sparse_adam(p, g: SelectedRows, m1, m2, b1p, b2p, lr, b1, b2, eps):
    """Lazy Adam: moments and parameter updated on the touched rows only,
    in place; returns (p, m1, m2, beta1_pow_out, beta2_pow_out), the powers
    fresh tensors (the JAX package's ``sparse_adam``, its arithmetic in its
    order)."""
    m = g.merged()
    at, valid, (p_rows, m1_rows, m2_rows) = update_slots(m, p, m1, m2)
    m1r = b1 * m1_rows + (1 - b1) * m.rows
    m2r = b2 * m2_rows + (1 - b2) * m.rows * m.rows
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    pr = p_rows - lr_t * m1r / (torch.sqrt(m2r) + eps)
    p.index_put_((at,), settle(pr.to(p.dtype), p_rows, valid))
    m1.index_put_((at,), settle(m1r.to(m1.dtype), m1_rows, valid))
    m2.index_put_((at,), settle(m2r.to(m2.dtype), m2_rows, valid))
    return p, m1, m2, b1p * b1, b2p * b2


def unsupported_sparse(op_type: str):
    raise NotImplementedError(
        f"optimizer op {op_type!r} has no sparse (SelectedRows) update rule "
        f"-- use sgd/adagrad/adam for is_sparse embeddings, or set "
        f"is_sparse=False (reference supports the same three)")


# ------------------------------------- regularization / clipping support

@register_lowering("sparse_weight_decay", no_gradient=True)
def _sparse_weight_decay(ctx, op):
    """Out = Grad ++ SelectedRows(unique touched ids, coeff * f(Param[ids])),
    f the identity (l2) or sign (l1): decay once a unique touched row.
    A row-sharded Param's rows are read on the rank that holds each and
    all-reduced over the dims that split them (one nonzero term a row)."""
    p = ctx.read_slot(op, "Param")
    g = _need_sparse("sparse_weight_decay", ctx.read_slot(op, "Grad"))
    coeff = float(op.attr("coeff"))
    m = g.merged()
    valid = row_mask(m.ids < g.height, g.rows)
    at = torch.clamp(m.ids, max=g.height - 1).long()
    shard = None
    if ctx.mesh is not None:
        from ..parallel.layout import all_reduce_over, row_groups, row_shard
        shard = row_shard(p, ctx.mesh)
    if shard is None:
        rows = local_of(p)[at].to(g.rows.dtype)
    else:
        local = at - shard[0]
        mine = row_mask((local >= 0) & (local < shard[1]), g.rows)
        rows = local_of(p)[torch.clamp(local, 0, shard[1] - 1)].to(g.rows.dtype)
        rows = all_reduce_over(torch.where(mine, rows, 0.0), row_groups(p, ctx.mesh))
    if str(op.attr("mode", "l2")) == "l1":
        rows = torch.sign(rows)
    decay = torch.where(valid, coeff * rows, 0.0)
    ctx.write_slot(op, "Out", concat_rows(g, SelectedRows(m.ids, decay, g.height)))


@register_lowering("sparse_scale_rows", no_gradient=True)
def _sparse_scale_rows(ctx, op):
    """A SelectedRows gradient's rows times the scalar Y (the sparse half
    of ``GradientClipByGlobalNorm``'s rescale)."""
    x = _need_sparse("sparse_scale_rows", ctx.read_slot(op, "X"))
    y = local_of(ctx.read_slot(op, "Y"))
    ctx.write_slot(op, "Out", x._like(x.ids, x.rows * y.to(x.rows.dtype)))


mark_no_gradient("get_tensor_from_selected_rows", "extract_rows", "merge_selected_rows",
                 "sparse_weight_decay", "sparse_scale_rows")
