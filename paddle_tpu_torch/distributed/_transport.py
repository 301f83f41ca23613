"""Shared TCP transport for the coordination services (master, pserver),
the JAX package's wire format, so the two packages speak one protocol:
a JSON header line, optionally followed by ``header["nbytes"]`` raw
payload bytes (the grpc_serde analogue; a zero-payload message is plain
JSON-lines) — and one threaded-server bootstrap.

A payload is received into a ``bytearray``, so ``msg_to_arr`` hands back a
writable array over it without a copy (``torch.from_numpy`` takes it as it
is), and ``arr_to_msg`` sends an array's own bytes through a memoryview."""
from __future__ import annotations

import json
import socketserver
import threading
from typing import Tuple

import numpy as np


def send_msg(sock_file, header: dict, payload=None):
    header = dict(header)
    header["nbytes"] = len(payload) if payload else 0
    sock_file.write((json.dumps(header) + "\n").encode())
    if payload:
        sock_file.write(payload)
    sock_file.flush()


def read_exact(sock_file, n: int) -> bytearray:
    """``n`` bytes from ``sock_file`` into a new ``bytearray``."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock_file.readinto(view[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def recv_msg(sock_file) -> Tuple[dict, bytearray]:
    line = sock_file.readline()
    if not line:
        raise ConnectionError("peer closed")
    header = json.loads(line)
    n = int(header.get("nbytes", 0))
    payload = read_exact(sock_file, n) if n else bytearray()
    return header, payload


def arr_to_msg(arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    data = memoryview(arr.reshape(-1)).cast("B") if arr.size else b""
    return {"dtype": arr.dtype.name, "shape": list(arr.shape)}, data


def msg_to_arr(meta: dict, payload: bytearray, offset: int = 0) -> np.ndarray:
    """The array ``meta`` describes, over ``payload`` from ``offset`` (no
    copy: ``payload`` is the message's own buffer)."""
    dtype = np.dtype(meta["dtype"])
    count = int(np.prod(meta["shape"], dtype=np.int64))
    return np.frombuffer(payload, dtype=dtype, count=count,
                         offset=offset).reshape(meta["shape"])


def start_server(handler_cls, host: str, port: int, **attrs):
    """Threaded TCP server with daemon workers; ``attrs`` are attached to
    the server object for the handler to reach.  Returns (server, addr)."""
    srv = socketserver.ThreadingTCPServer((host, port), handler_cls,
                                          bind_and_activate=True)
    srv.daemon_threads = True
    for k, v in attrs.items():
        setattr(srv, k, v)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address
