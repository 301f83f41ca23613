"""Distributed ops: send / recv / send_barrier / fetch_barrier /
listen_and_serv, and the distributed lookup table's
distributed_lookup_table / distributed_table_push.

Reference: Paddle's paddle/fluid/operators/send_op.cc (99),
recv_op.cc (91), listen_and_serv_op.cc (405) + the distributed/ gRPC stack.

These ops talk to the ParameterServer service (distributed/pserver.py) on
the host.  A CUDA graph cannot call the host, so the executor runs them
outside the step's graph (``core/executor.py``, ``plan_host_stages``): a
server op whose inputs are all feeds or state the step does not write runs
before the replay (``recv`` at the head, a ``distributed_lookup_table`` over
fed ids, whose rows are bound as a feed of the graph), and one whose
outputs no other op reads runs after it (``send``, ``send_barrier``,
``distributed_table_push``), reading the gradients the graph keeps as
outputs.  The host functions here (``host_*``) are what those stages call.
A server op that fits neither case stays in the block, makes
``graph_blockers`` name it, and its lowering below makes the same call
eagerly in the op-by-op run.

In sync mode the client/server pair is the BSP barrier: the server applies
a round only after all trainers' grads arrive, and recv blocks for the
round its trainer expects.  listen_and_serv's lowering raises: a pserver
program runs through ``Executor.run_pserver``, which serves and blocks."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.desc import OpDesc, grad_var_name
from ..core.dtypes import coerce_feed_dtype, convert_dtype
from ..core.registry import (mark_no_gradient, register_grad_maker,
                             register_infer_shape, register_lowering)
from .common import in_shape, set_out_shape

# the op types that call a parameter server
SERVER_OPS = ("send", "send_barrier", "recv", "fetch_barrier", "listen_and_serv",
              "distributed_lookup_table", "distributed_table_push")


def _client(endpoint: str):
    from ..distributed.pserver import PServerClient
    return PServerClient.for_endpoint(endpoint)


def host_array(t) -> np.ndarray:
    """A value as a host array (a tensor copied to the host)."""
    return t.to("cpu").numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _padding_idx(op: OpDesc) -> int:
    pad = op.attr("padding_idx", -1)
    return -1 if pad is None else int(pad)


# --------------------------------------------------------------- host calls
def send_slice(op: OpDesc, x: np.ndarray) -> np.ndarray:
    """The part of gradient ``x`` a ``send`` op pushes: with row_begin /
    row_end attrs (the slice_var_up path) only that dim0 range -- the
    trainer-side half of reference slice_variable."""
    r0 = op.attr("row_begin", None)
    return x if r0 is None else x[int(r0):int(op.attr("row_end"))]


def host_send(op: OpDesc, x: np.ndarray) -> None:
    """Push one gradient to its pserver (reference send_op.cc)."""
    _client(str(op.attr("endpoint"))).send_grad(
        str(op.attr("param_name")), int(op.attr("trainer_id", 0)), send_slice(op, x))


def host_send_grouped(ops: List[OpDesc], grads: List[np.ndarray]) -> None:
    """The ``send`` ops of one step, batched: one ``send_grads`` round trip
    to each endpoint, in the ops' order (the server applies a round once
    every gradient of it has arrived, in whatever grouping).  ``grads``:
    what each op pushes (``send_slice`` of its gradient)."""
    by_ep: Dict[tuple, list] = {}
    for op, g in zip(ops, grads):
        key = (str(op.attr("endpoint")), int(op.attr("trainer_id", 0)))
        by_ep.setdefault(key, []).append((str(op.attr("param_name")), g))
    for (ep, tid), named in by_ep.items():
        _client(ep).send_grads(named, tid)


def host_send_barrier(op: OpDesc) -> None:
    """All of this trainer's grads for the step are pushed; advance the
    client's round (reference send_barrier_op / BSP semantics)."""
    for ep in op.attr("endpoints", []):
        _client(str(ep)).end_step()


def host_recv(op: OpDesc) -> np.ndarray:
    """Pull a (round-barriered) fresh parameter (reference recv_op.cc) at
    the client's round."""
    c = _client(str(op.attr("endpoint")))
    return c.get_param(str(op.attr("param_name")), c.step)


def _table_fetch(ids_flat: np.ndarray, endpoints, table_name, dim):
    """Gather rows for global ids from their owning shards (id % n)."""
    n = len(endpoints)
    out = np.zeros((ids_flat.shape[0], dim), np.float32)
    for s, ep in enumerate(endpoints):
        mask = (ids_flat % n) == s
        if not mask.any():
            continue
        out[mask] = _client(ep).prefetch_rows(table_name, ids_flat[mask])
    return out


def lookup_shape(op: OpDesc, ids_shape) -> tuple:
    """Out's shape at run time: the ids' shape (a trailing 1 of 2-D or
    more dropped) + (dim,)."""
    ids_shape = tuple(ids_shape)
    if len(ids_shape) >= 2 and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    return ids_shape + (int(op.attr("dim")),)


def host_lookup(op: OpDesc, ids) -> np.ndarray:
    """The distributed table's rows at ``ids``, fetched from the shards'
    servers; a ``padding_idx`` id gives a zero row (lookup_table's pad
    semantics)."""
    ids = host_array(ids)
    flat = np.asarray(ids, np.int64).reshape(-1)
    rows = _table_fetch(flat, [str(e) for e in op.attr("endpoints")],
                        str(op.attr("table_name")), int(op.attr("dim")))
    pad = _padding_idx(op)
    if pad >= 0:
        rows[flat == pad] = 0.0
    dt = coerce_feed_dtype(convert_dtype(str(op.attr("dtype", "float32"))))
    return rows.reshape(lookup_shape(op, ids.shape)).astype(dt.np_dtype)


def host_table_push(op: OpDesc, ids, dout) -> None:
    """Backward of the distributed lookup: merge duplicate ids locally,
    then push (ids, rows) to each owning server."""
    dim = int(op.attr("dim"))
    flat = np.asarray(host_array(ids), np.int64).reshape(-1)
    rows = np.asarray(host_array(dout), np.float32).reshape(-1, dim)
    pad = _padding_idx(op)
    if pad >= 0:
        keep = flat != pad    # pad rows receive no gradient
        flat, rows = flat[keep], rows[keep]
        if flat.size == 0:
            return
    uniq, inv = np.unique(flat, return_inverse=True)
    merged = np.zeros((uniq.shape[0], dim), np.float32)
    np.add.at(merged, inv, rows)
    endpoints = [str(e) for e in op.attr("endpoints")]
    n = len(endpoints)
    for s, ep in enumerate(endpoints):
        mask = (uniq % n) == s
        if mask.any():
            _client(ep).push_sparse_rows(str(op.attr("table_name")),
                                         int(op.attr("trainer_id", 0)),
                                         uniq[mask], merged[mask])


def run_on_host(op: OpDesc, values: Dict[str, np.ndarray]) -> int:
    """Run a server op of a host stage over ``values`` (name -> host
    array); returns the payload bytes it pushed."""
    if op.type == "send":
        x = send_slice(op, values[op.input("X")[0]])
        host_send(op, x)
        return x.nbytes
    if op.type == "send_barrier":
        host_send_barrier(op)
        return 0
    if op.type == "fetch_barrier":
        return 0
    if op.type == "distributed_table_push":
        ids, dout = values[op.input("Ids")[0]], values[op.input("OutGrad")[0]]
        host_table_push(op, ids, dout)
        return ids.nbytes + dout.nbytes
    raise ValueError(f"{op.type} does not run in a host stage")


# ------------------------------------------------ lowerings (op by op)
@register_lowering("send")
def _send(ctx, op):
    """``host_send`` in an op-by-op run."""
    host_send(op, host_array(ctx.read_slot(op, "X")))
    outs = op.output("Out")
    if outs and outs[0]:
        ctx.write(outs[0], torch.zeros((), dtype=torch.int32, device=ctx.device))


@register_infer_shape("send")
def _send_shape(block, op):
    outs = op.output("Out")
    if outs and outs[0]:
        set_out_shape(block, op, "Out", (), "int32")


@register_lowering("send_barrier")
def _send_barrier(ctx, op):
    host_send_barrier(op)


@register_lowering("recv")
def _recv(ctx, op):
    """``host_recv`` in an op-by-op run: the parameter in its var's
    (feed-coerced) dtype."""
    out_name = op.output("Out")[0]
    vd = ctx.block.find_var(out_name)
    dt = coerce_feed_dtype(vd.dtype)
    ctx.write(out_name, torch.from_numpy(np.ascontiguousarray(host_recv(op))).to(
        ctx.device, dt.torch_dtype))


@register_infer_shape("recv")
def _recv_shape(block, op):
    pass                       # Out is the (declared) parameter itself


@register_lowering("fetch_barrier")
def _fetch_barrier(ctx, op):
    """A no-op: recv itself blocks for the round; kept for program-structure
    parity (reference fetch_barrier_op)."""


mark_no_gradient("send", "recv", "send_barrier", "fetch_barrier")


@register_lowering("listen_and_serv", no_gradient=True)
def _listen_and_serv(ctx, op):
    """The pserver main loop as an op (reference listen_and_serv_op.cc:
    251-300) is not lowered: running the pserver program IS running the
    server, through Executor.run_pserver()."""
    raise RuntimeError(
        "listen_and_serv cannot be lowered; run the pserver program "
        "with Executor.run_pserver(program) (it blocks serving, like the "
        "reference's exe.run(pserver_program))")


# ---------------------------------------------------------------------------
# distributed lookup table (reference distributed_lookup_table_design.md,
# operators/prefetch_op.cc, transpiler/distribute_transpiler.py:808):
# giant embedding tables round-robin row-sharded across pservers; the
# forward gathers only the batch's rows from their owning servers, the
# backward pushes SelectedRows-style (ids, rows) SGD updates back.
# ---------------------------------------------------------------------------
@register_lowering("distributed_lookup_table", non_diff_inputs=("Ids",))
def _distributed_lookup_table(ctx, op):
    rows = host_lookup(op, ctx.read_slot(op, "Ids"))
    ctx.write_slot(op, "Out", torch.from_numpy(rows).to(ctx.device))


@register_infer_shape("distributed_lookup_table")
def _distributed_lookup_table_shape(block, op):
    ids_shape = list(in_shape(block, op, "Ids"))
    if ids_shape and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    set_out_shape(block, op, "Out", tuple(ids_shape) + (int(op.attr("dim")),),
                  str(op.attr("dtype", "float32")))


@register_grad_maker("distributed_lookup_table")
def _distributed_lookup_table_grad_maker(op, block, no_grad_set):
    g = OpDesc(type="distributed_table_push", attrs=dict(op.attrs))
    g.inputs["Ids"] = list(op.input("Ids"))
    g.inputs["OutGrad"] = [grad_var_name(n) for n in op.output("Out")]
    return [g]


@register_lowering("distributed_table_push")
def _distributed_table_push(ctx, op):
    host_table_push(op, ctx.read_slot(op, "Ids"), ctx.read(op.input("OutGrad")[0]))


mark_no_gradient("distributed_table_push")
