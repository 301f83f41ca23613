"""Parameter-server runtime: the listen_and_serv / send / recv stack.

Reference: Paddle's paddle/fluid/operators/distributed/ (4,384 LoC
gRPC stack: rpc_client.h:30-69 AsyncSendVar/AsyncGetVar + barriers;
grpc_serde.cc zero-copy tensor wire format) and listen_and_serv_op.cc —
``RunSyncLoop`` (:102-176): wait for N trainer grads per batch barrier →
run the per-param optimize blocks → notify getters; ``RunAsyncLoop``
(:178-249): apply each grad immediately.

The server holds its parameters, their optimizer accumulators and its
distributed tables' row shards on its place (``CUDAPlace(0)`` unless the
caller asks for the CPU), and applies updates by running each parameter's
optimize program through the port's ``Executor`` on that place — the same
sgd/adam/momentum lowerings (and on the card the same K5/K6 kernels) the
trainer would run, so pserver-mode training matches local training bit for
bit given the same gradients.  A received gradient is copied to the device
once; ``get_param`` copies a parameter to the host once.  The arithmetic
around the updates is the JAX server's: the sync-mode average is a float64
mean over the trainers, cast back, and a table push subtracts ``lr * rows``
at ids the trainer merged.  The wire format is the JAX package's
(``_transport``): a JSON header line + raw C-order tensor bytes over TCP.
Trainers talk to it through the send/recv/*_barrier ops
(ops/dist_ops.py) that the DistributeTranspiler inserts, which the
executor runs on the host around the step's graph.
"""
from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ._transport import (arr_to_msg as _arr_to_bytes,
                         msg_to_arr as _bytes_to_arr,
                         recv_msg as _recv_msg, send_msg as _send_msg,
                         start_server)

__all__ = ["ParameterServer", "PServerClient", "serve_pserver",
           "slice_table_shards", "slice_param_blocks"]


def slice_table_shards(scope, tables_meta: Dict[str, dict]) -> Dict[str, dict]:
    """Build this server's table shards from startup-initialized full
    tables in ``scope``: owner of global row r is server ``r % n`` at
    local index ``r // n`` (the single source of the sharding rule — the
    trainer-side ops in ops/dist_ops.py use the same arithmetic).  Each
    shard is a tensor of its own on the full table's device; the full
    table leaves the scope (it is dead once sliced)."""
    tables = {}
    for name, tm in tables_meta.items():
        full = scope.find_var(name)
        if full is None:
            raise RuntimeError(
                f"distributed table {name!r} not initialized — run the "
                f"pserver startup program into this scope first")
        full = torch.as_tensor(full)
        shard = full[tm["shard_id"]::tm["num_shards"]].clone()
        tables[name] = {"shard": shard, "shard_id": tm["shard_id"],
                        "num_shards": tm["num_shards"], "lr": tm["lr"]}
    for name in tables_meta:
        scope.erase(name)
    return tables


def slice_param_blocks(scope, slices_meta: Dict[str, dict]):
    """Carve this server's param BLOCKS out of the startup-initialized
    full params/accumulators (the slice_var_up path — reference
    slice_variable :70-114 splits on dim0).  For each block unit, every
    renamed var whose dim0 equals the source param's row count gets its
    row range; other state (beta pows etc.) is copied whole per block."""
    sources = set()
    for unit, sm in slices_meta.items():
        r0, rows, full = sm["row0"], sm["rows"], sm["full_rows"]
        for orig, renamed in sm["vars"].items():
            arr = scope.find_var(orig)
            if arr is None:
                raise RuntimeError(
                    f"param block {unit!r}: source var {orig!r} not "
                    f"initialized — run the pserver startup program into "
                    f"this scope first")
            if arr.ndim >= 1 and arr.shape[0] == full:
                scope.set_var(renamed, arr[r0:r0 + rows].clone())
            else:
                scope.set_var(renamed, arr.clone())
            sources.add(orig)
    # the full-size source params/accumulators are dead once sliced —
    # keeping them would hold ~2x the memory the slicing exists to avoid
    # (after ALL blocks copied: one server may own several blocks of one
    # param)
    for orig in sources:
        scope.erase(orig)


# The servers of one process (an in-process cluster's threads) take turns on
# the device: a copy that synchronizes the device on one server's thread
# breaks a CUDA graph that another server's thread is capturing.  Taken
# before a server's own lock.
_DEVICE_TURN = threading.Lock()


class _ParamState:
    def __init__(self, name):
        self.name = name
        self.grads: Dict[int, torch.Tensor] = {}    # trainer_id -> grad


def _mean64(grads: List[torch.Tensor]) -> torch.Tensor:
    """The JAX server's sync-mode average, ``np.mean(np.stack(gs), axis=0,
    dtype=np.float64)`` cast back to the gradients' dtype: a float64 sum in
    trainer order, one division, one rounding.  One gradient is its own
    mean (the float64 round trip is exact)."""
    if len(grads) == 1:
        return grads[0]
    acc = grads[0].to(torch.float64)
    for g in grads[1:]:
        acc = acc + g.to(torch.float64)
    return (acc / len(grads)).to(grads[0].dtype)


class ParameterServer:
    """Holds params; applies optimize programs per sync round.

    ``optimize_programs``: {param_name: (program, grad_feed_name)} — built
    by the transpiler from the captured optimize ops; executed with the
    server's scope (which holds the param + its accumulators).
    ``scope`` must already contain initialized params/accumulators (run
    the pserver startup program into it first, with an executor on
    ``place``).  ``place``: where the updates run, ``CUDAPlace(0)`` unless
    given.

    ``stats()``: the rounds' apply seconds (the lr program and every
    update of a round, to the device's finish) and the payload bytes
    received and sent."""

    def __init__(self, param_names: List[str], optimize_programs: dict,
                 scope, trainers: int, sync_mode: bool = True,
                 lr_program=None, tables: Optional[dict] = None, place=None):
        from ..core.executor import CUDAPlace, Executor
        self.param_names = list(param_names)
        self.optimize_programs = optimize_programs
        self.scope = scope
        self.trainers = trainers
        self.sync_mode = sync_mode
        self.lr_program = lr_program   # lr-schedule ops, run once a round
        self.round = 0                       # completed update rounds
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = {n: _ParamState(n) for n in param_names}
        # distributed lookup tables: this server's row shard of each table
        # (reference distributed_lookup_table_design.md — round-robin row
        # sharding, prefetch reads, SGD-on-touched-rows writes).
        # {name: {"shard": tensor [local_rows, dim], "shard_id": i,
        #         "num_shards": n, "lr": float}}
        self.tables: Dict[str, dict] = dict(tables or {})
        self._exe = Executor(place if place is not None else CUDAPlace(0))
        self.device = self._exe.device
        self.on_round = None     # called with the round's number as it ends
        self.round_s: List[float] = []
        self.bytes_in = 0
        self.bytes_out = 0

    def stats(self) -> dict:
        with self._lock:
            return {"rounds": self.round, "round_s": list(self.round_s),
                    "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                    "device": str(self.device)}

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(arr)).to(self.device)

    # ----------------------------------------------- distributed tables
    def prefetch_rows(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Rows of this shard for GLOBAL row ids (reference prefetch_op:
        the trainer sends only the ids this server owns)."""
        t = self.tables[name]
        with _DEVICE_TURN, self._lock:
            local = self._to_device(np.asarray(ids, np.int64) // t["num_shards"])
            return t["shard"].index_select(0, local).cpu().numpy()

    def push_sparse_rows(self, name: str, trainer_id: int,
                         ids: np.ndarray, rows: np.ndarray):
        """SGD on the touched rows, applied immediately (the reference's
        distributed table path is effectively async per design doc; only
        plain SGD is supported for tables there too).  Duplicate ids are
        pre-merged by the trainer-side push op, so each row takes one
        ``- lr * rows`` (``index_add_`` of the negated product, as the JAX
        server's ``np.subtract.at``)."""
        t = self.tables[name]
        shard = t["shard"]
        with _DEVICE_TURN, self._lock:
            local = self._to_device(np.asarray(ids, np.int64) // t["num_shards"])
            upd = (self._to_device(rows) * t["lr"]).to(shard.dtype)
            shard.index_add_(0, local, -upd)

    # ---------------------------------------------------------------- grads
    def push_grad(self, name: str, trainer_id: int, grad):
        """Take one trainer's gradient (a host array, copied to the device
        here, or a tensor on it)."""
        with _DEVICE_TURN:
            self._push_grad(name, trainer_id, grad)

    def _push_grad(self, name: str, trainer_id: int, grad):
        grad = grad if isinstance(grad, torch.Tensor) else self._to_device(grad)
        if not self.sync_mode:
            with self._lock:
                # async (RunAsyncLoop): apply immediately, no barrier
                t0 = time.perf_counter()
                self._run_lr()
                self._apply(name, grad)
                self._finish_round(t0)
            return
        with self._cv:
            st = self._pending[name]
            st.grads[trainer_id] = grad
            if all(len(self._pending[n].grads) >= self.trainers
                   for n in self.param_names):
                # barrier reached (RunSyncLoop :152): lr schedule once,
                # then average + update every param
                t0 = time.perf_counter()
                self._run_lr()
                for n in self.param_names:
                    gs = [g for _, g in sorted(self._pending[n].grads.items())]
                    self._apply(n, _mean64(gs))
                    self._pending[n].grads.clear()
                self._finish_round(t0)

    def _finish_round(self, t0: float):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.round_s.append(time.perf_counter() - t0)
        self.round += 1
        if self.on_round is not None:
            self.on_round(self.round)
        self._cv.notify_all()

    def _run_lr(self):
        if self.lr_program is not None:
            self._exe.run(self.lr_program, feed={}, fetch_list=[],
                          scope=self.scope)

    def _apply(self, name: str, grad: torch.Tensor):
        prog, grad_feed = self.optimize_programs[name]
        self._exe.run(prog, feed={grad_feed: grad}, fetch_list=[],
                      scope=self.scope)

    # --------------------------------------------------------------- params
    def get_param(self, name: str, min_round: int) -> np.ndarray:
        """The parameter once ``min_round`` rounds are done (sync mode)."""
        with self._cv:
            while self.sync_mode and self.round < min_round:
                self._cv.wait(timeout=120)
        with _DEVICE_TURN, self._lock:
            v = self.scope.find_var(name)
            if isinstance(v, torch.Tensor):
                return v.to("cpu", copy=True).numpy()
            return np.asarray(v)


class _PSHandler(socketserver.StreamRequestHandler):
    disable_nagle_algorithm = True      # a reply's header and payload go at once

    def handle(self):
        ps: ParameterServer = self.server.ps     # type: ignore[attr-defined]
        while True:
            try:
                header, payload = _recv_msg(self.rfile)
            except (ConnectionError, ValueError, OSError):
                return
            cmd = header.get("cmd")
            with ps._lock:
                ps.bytes_in += len(payload)
            try:
                out = b""
                if cmd == "send_grad":
                    grad = _bytes_to_arr(header, payload)
                    ps.push_grad(header["name"], int(header["trainer_id"]),
                                 grad)
                    _send_msg(self.wfile, {"ok": True})
                elif cmd == "send_grads":
                    off = 0
                    for m in header["tensors"]:
                        g = _bytes_to_arr(m, payload, off)
                        off += int(m["nbytes"])
                        ps.push_grad(m["name"], int(header["trainer_id"]), g)
                    _send_msg(self.wfile, {"ok": True})
                elif cmd == "get_param":
                    arr = ps.get_param(header["name"],
                                       int(header.get("min_round", 0)))
                    meta, out = _arr_to_bytes(arr)
                    _send_msg(self.wfile, meta, out)
                elif cmd == "round":
                    _send_msg(self.wfile, {"round": ps.round})
                elif cmd == "prefetch_rows":
                    ids = np.frombuffer(payload, np.int64)
                    rows = ps.prefetch_rows(header["name"], ids)
                    meta, out = _arr_to_bytes(rows)
                    _send_msg(self.wfile, meta, out)
                elif cmd == "push_sparse_rows":
                    nb = int(header["ids_nbytes"])
                    ids = np.frombuffer(payload, np.int64, count=nb // 8)
                    rows = _bytes_to_arr(header, payload, nb)
                    ps.push_sparse_rows(header["name"],
                                        int(header["trainer_id"]), ids,
                                        rows)
                    _send_msg(self.wfile, {"ok": True})
                else:
                    _send_msg(self.wfile, {"error": f"unknown cmd {cmd!r}"})
                with ps._lock:
                    ps.bytes_out += len(out)
            except Exception as e:
                _send_msg(self.wfile, {"error": str(e)})


def serve_pserver(ps: ParameterServer, host: str = "127.0.0.1",
                  port: int = 0):
    """Start serving; returns (server, (host, port)).  The reference
    blocks inside the listen_and_serv op; here ``Executor.run_pserver``
    delegates to this and blocks."""
    return start_server(_PSHandler, host, port, ps=ps)


class PServerClient:
    """Trainer-side connection to one pserver endpoint (reference
    GRPCClient, distributed/grpc_client.h:175).  Thread-safe per-call."""

    _cache: Dict[str, "PServerClient"] = {}
    _cache_lock = threading.Lock()

    @classmethod
    def for_endpoint(cls, endpoint: str) -> "PServerClient":
        with cls._cache_lock:
            if endpoint not in cls._cache:
                cls._cache[endpoint] = cls(endpoint)
            return cls._cache[endpoint]

    @classmethod
    def reset_all(cls):
        with cls._cache_lock:
            for c in cls._cache.values():
                c.close()
            cls._cache.clear()

    def __init__(self, endpoint: str):
        from ..flags import FLAGS
        host, port = endpoint.rsplit(":", 1)
        # FLAGS_rpc_deadline / FLAGS_rpc_retry_times keep the reference's
        # grpc_client deadline+retry contract on the TCP transport
        last_err = None
        for _ in range(max(1, int(FLAGS.rpc_retry_times))):
            try:
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=float(FLAGS.rpc_deadline))
                break
            except OSError as e:
                last_err = e
                time.sleep(0.2)
        else:
            raise ConnectionError(
                f"pserver {endpoint} unreachable after "
                f"{FLAGS.rpc_retry_times} retries "
                f"(FLAGS_rpc_deadline={FLAGS.rpc_deadline}s)") from last_err
        # the deadline bounds CONNECT only: sync-mode get_param legitimately
        # blocks past it while the server barrier-waits for slow trainers
        # (reference: grpc deadline is per-call; barrier RPCs use a long one)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()
        self.endpoint = endpoint
        self.step = 0          # completed rounds from this trainer's view
        self.calls = 0         # round trips made
        self.bytes_sent = 0    # payload bytes
        self.bytes_received = 0

    def _call(self, header: dict, payload=None):
        with self._lock:
            _send_msg(self._f, header, payload)
            resp, data = _recv_msg(self._f)
            self.calls += 1
            self.bytes_sent += len(payload) if payload else 0
            self.bytes_received += len(data)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp, data

    def send_grad(self, name: str, trainer_id: int, grad: np.ndarray):
        meta, data = _arr_to_bytes(grad)
        meta.update({"cmd": "send_grad", "name": name,
                     "trainer_id": trainer_id})
        self._call(meta, data)

    def send_grads(self, named_grads, trainer_id: int):
        """Push several dense grads in ONE round trip — the batched analogue
        of the reference's gRPC async-stream sends (grpc_client.h AsyncSend
        + send_barrier amortizes per-RPC latency the same way): one header
        lists every tensor, one payload carries them back to back."""
        metas, blobs = [], []
        for name, g in named_grads:
            g = np.ascontiguousarray(g)
            metas.append({"name": name, "dtype": g.dtype.name,
                          "shape": list(g.shape), "nbytes": g.nbytes})
            blobs.append(_arr_to_bytes(g)[1])
        self._call({"cmd": "send_grads", "trainer_id": trainer_id,
                    "tensors": metas}, b"".join(blobs))

    def get_param(self, name: str, min_round: int) -> np.ndarray:
        resp, payload = self._call({"cmd": "get_param", "name": name,
                                    "min_round": min_round})
        return _bytes_to_arr(resp, payload)

    def prefetch_rows(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Fetch table rows for GLOBAL ids owned by this server
        (reference prefetch_op.cc / AsyncPrefetchVar)."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        resp, payload = self._call({"cmd": "prefetch_rows", "name": name},
                                   ids.tobytes())
        return _bytes_to_arr(resp, payload)

    def push_sparse_rows(self, name: str, trainer_id: int,
                         ids: np.ndarray, rows: np.ndarray):
        """Push SelectedRows-style (ids, rows) table gradient."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64))
        rows = np.ascontiguousarray(rows)
        hdr = {"cmd": "push_sparse_rows", "name": name,
               "trainer_id": trainer_id, "ids_nbytes": ids.nbytes,
               "dtype": rows.dtype.name, "shape": list(rows.shape)}
        self._call(hdr, ids.tobytes() + rows.tobytes())

    def end_step(self):
        """send_barrier semantics: this trainer finished pushing the
        step's grads; subsequent recvs wait for the new round."""
        self.step += 1

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
