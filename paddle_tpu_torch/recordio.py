"""RecordIO: chunked, CRC-checked record files, the JAX package's format bit
for bit (Fluid's ``paddle/fluid/recordio/`` and its
``create_recordio_file_reader`` op).  The scan path is C++
(``csrc/host/recordio.cpp``; the parallel scanner and the blocking byte
queue in ``csrc/host/concurrency.cpp``), built with ``g++`` at first use
into ``build/paddle_tpu_torch/`` beside the package and loaded through
``ctypes``; a pure-Python path implements the same on-disk format, so a
machine without a C++ toolchain still reads and writes the files
(``use_native=None``, the default, falls back to it quietly;
``use_native=True`` raises instead).  :func:`scans` counts the records each
scanner yielded, so a caller can require the native one.

Format (little-endian)::

  file  := chunk*
  chunk := magic:u32 crc32:u32 nrecords:u32 datalen:u32 data
  data  := (reclen:u32 bytes)*          crc32 over `data`

Stdlib only (no torch): the dispatch tools load this module without the
framework.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Dict, Iterator, Optional

__all__ = ["Writer", "scan", "reader_creator", "NativeByteQueue", "parallel_scan",
           "parallel_reader_creator", "scans", "reset_scans", "native_library"]

_MAGIC = 0x50545231
_HOST_DIR = Path(__file__).resolve().parent / "csrc" / "host"
_RIO_SRC = _HOST_DIR / "recordio.cpp"
_CONC_SRC = _HOST_DIR / "concurrency.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "paddle_tpu_torch"

_load_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_scans_lock = threading.Lock()
_scans = {"native": 0, "python": 0}


def _count(kind: str, n: int = 1) -> None:
    with _scans_lock:
        _scans[kind] += n


def scans() -> Dict[str, int]:
    """Records yielded so far by the native scanners (``scan`` and
    ``parallel_scan`` through the C++ library) and by the Python one."""
    with _scans_lock:
        return dict(_scans)


def reset_scans() -> None:
    with _scans_lock:
        for k in _scans:
            _scans[k] = 0


def _build(name: str, srcs, extra_flags=()) -> Path:
    """``g++`` the sources into ``BUILD_DIR`` unless the library for their
    bytes and flags exists (its name carries their hash); a file lock
    serializes concurrent builds, and the library lands by rename."""
    flags = ["-O2", "-shared", "-fPIC", *extra_flags]
    h = hashlib.sha1(" ".join(flags).encode())
    for s in srcs:
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"_{name}_{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"_{name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
                subprocess.run(["g++", *flags, "-o", str(tmp), *map(str, srcs)],
                               check=True, capture_output=True)
                os.replace(tmp, lib)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return lib


def _declare_scanner(lib: ctypes.CDLL) -> None:
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.rio_writer_write.restype = ctypes.c_int
    lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.rio_writer_close.restype = ctypes.c_int
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_open.restype = ctypes.c_void_p
    lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.rio_scanner_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.rio_scanner_error.restype = ctypes.c_char_p
    lib.rio_scanner_error.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_close.argtypes = [ctypes.c_void_p]


def _declare_concurrency(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ps_open.restype = ctypes.c_void_p
    lib.ps_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.ps_next.restype = u8p
    lib.ps_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)]
    lib.ps_error.restype = ctypes.c_char_p
    lib.ps_error.argtypes = [ctypes.c_void_p]
    lib.ps_close.argtypes = [ctypes.c_void_p]
    lib.cq_create.restype = ctypes.c_void_p
    lib.cq_create.argtypes = [ctypes.c_uint32]
    lib.cq_push.restype = ctypes.c_int
    lib.cq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int]
    lib.cq_pop.restype = u8p
    lib.cq_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
    lib.cq_close.argtypes = [ctypes.c_void_p]
    lib.cq_size.restype = ctypes.c_uint32
    lib.cq_size.argtypes = [ctypes.c_void_p]
    lib.cq_free.argtypes = [u8p]
    lib.cq_destroy.argtypes = [ctypes.c_void_p]


def native_library(name: str = "recordio") -> Optional[ctypes.CDLL]:
    """The loaded C++ library ``"recordio"`` (writer and scanner) or
    ``"concurrency"`` (parallel scanner and byte queue, with the scanner
    linked in), built at first use; None when it cannot be built (no
    ``g++``), as the JAX package's loader answers."""
    with _load_lock:
        if name not in _libs:
            try:
                if name == "recordio":
                    lib = ctypes.CDLL(str(_build("recordio", [_RIO_SRC])))
                    _declare_scanner(lib)
                else:
                    lib = ctypes.CDLL(str(_build("concurrency", [_CONC_SRC, _RIO_SRC],
                                                 ["-std=c++17", "-pthread"])))
                    _declare_concurrency(lib)
            except (OSError, subprocess.CalledProcessError):
                lib = None
            _libs[name] = lib
        return _libs[name]


def _pick(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    lib = native_library() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError("native recordio unavailable")
    return lib


class Writer:
    def __init__(self, path: str, max_chunk_bytes: int = 1 << 20,
                 use_native: Optional[bool] = None):
        lib = _pick(use_native)
        self._lib = lib
        if lib is not None:
            self._h = lib.rio_writer_open(path.encode(), max_chunk_bytes)
            if not self._h:
                raise IOError(f"cannot open {path!r}")
        else:
            self._f = open(path, "wb")
            self._buf = bytearray()
            self._n = 0
            self._max = max_chunk_bytes

    def write(self, record: bytes):
        if self._lib is not None:
            if self._lib.rio_writer_write(self._h, record, len(record)) != 0:
                raise IOError("recordio write failed")
            return
        self._buf += struct.pack("<I", len(record)) + record
        self._n += 1
        if len(self._buf) >= self._max:
            self._flush()

    def _flush(self):
        if self._n == 0:
            return
        data = bytes(self._buf)
        self._f.write(struct.pack("<IIII", _MAGIC, zlib.crc32(data), self._n, len(data)))
        self._f.write(data)
        self._buf.clear()
        self._n = 0

    def close(self):
        if self._lib is not None:
            if self._lib.rio_writer_close(self._h) != 0:
                raise IOError("recordio close failed")
            self._h = None
        else:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan(path: str, use_native: Optional[bool] = None) -> Iterator[bytes]:
    """Yield records; raises IOError on CRC/framing corruption."""
    lib = _pick(use_native)
    if lib is not None:
        h = lib.rio_scanner_open(path.encode())
        if not h:
            raise IOError(f"cannot open {path!r}")
        try:
            ln = ctypes.c_uint32()
            while True:
                p = lib.rio_scanner_next(h, ctypes.byref(ln))
                if not p:
                    if ln.value == 1:
                        raise IOError(lib.rio_scanner_error(h).decode())
                    return
                _count("native")
                yield ctypes.string_at(p, ln.value)
        finally:
            lib.rio_scanner_close(h)
    else:
        with open(path, "rb") as f:
            while True:
                header = f.read(16)
                if not header:
                    return
                if len(header) != 16:
                    raise IOError("bad chunk header")
                magic, crc, n, datalen = struct.unpack("<IIII", header)
                if magic != _MAGIC:
                    raise IOError("bad chunk magic")
                data = f.read(datalen)
                if len(data) != datalen:
                    raise IOError("truncated chunk")
                if zlib.crc32(data) != crc:
                    raise IOError("crc mismatch")
                pos = 0
                for _ in range(n):
                    (rec_len,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    _count("python")
                    yield data[pos:pos + rec_len]
                    pos += rec_len


def reader_creator(path: str):
    """paddle.reader-style creator over a recordio file."""
    def reader():
        return scan(path)
    return reader


class NativeByteQueue:
    """Bounded MPMC blocking byte queue over the native runtime (the
    LoDTensorBlockingQueue analogue for raw payloads, Fluid's
    operators/reader/blocking_queue.h).  push/pop bytes; pop returns None
    at end-of-stream (closed and drained) and raises on timeout."""

    def __init__(self, capacity: int):
        lib = native_library("concurrency")
        if lib is None:
            raise RuntimeError("native concurrency runtime unavailable")
        self._lib = lib
        self._h = lib.cq_create(int(capacity))

    def push(self, data: bytes, timeout_ms: int = -1) -> bool:
        """False when the queue was closed; raises on timeout."""
        rc = self._lib.cq_push(self._h, data, len(data), timeout_ms)
        if rc == 1:
            raise TimeoutError("queue full")
        return rc == 0

    def pop(self, timeout_ms: int = -1):
        ln = ctypes.c_uint32()
        status = ctypes.c_int()
        p = self._lib.cq_pop(self._h, ctypes.byref(ln), timeout_ms, ctypes.byref(status))
        if not p:
            if status.value == 1:
                raise TimeoutError("queue empty")
            return None
        try:
            return ctypes.string_at(p, ln.value)
        finally:
            self._lib.cq_free(p)

    def close(self):
        self._lib.cq_close(self._h)

    def size(self) -> int:
        return int(self._lib.cq_size(self._h))

    def __del__(self):
        try:
            self._lib.cq_destroy(self._h)
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass


def parallel_scan(paths, num_threads: Optional[int] = None,
                  capacity: int = 256) -> Iterator[bytes]:
    """Scan several recordio files concurrently on native worker threads
    (Fluid's open_files_op.cc over framework/threadpool.h).  Record order
    across files is nondeterministic; within a file it is in order per
    worker, and one thread reads the files in the order given.  Falls back
    to a sequential Python chain without the native runtime.
    ``num_threads`` defaults to ``FLAGS.paddle_num_threads`` (0 = one
    thread a file)."""
    paths = list(paths)
    if num_threads is None:
        from .flags import FLAGS
        num_threads = int(FLAGS.paddle_num_threads)
    if num_threads <= 0:
        # one a file, capped so thousand-shard datasets don't spawn a
        # thousand OS threads
        num_threads = min(len(paths) or 1, 2 * (os.cpu_count() or 8), 64)
    lib = native_library("concurrency")
    if lib is None:
        for p in paths:
            yield from scan(p)
        return
    h = lib.ps_open("\n".join(paths).encode(), num_threads, capacity)
    if not h:
        raise IOError("parallel scanner failed to start")
    try:
        ln = ctypes.c_uint32()
        status = ctypes.c_int()
        while True:
            p = lib.ps_next(h, ctypes.byref(ln), -1, ctypes.byref(status))
            if not p:
                if status.value == 2:
                    raise IOError(lib.ps_error(h).decode())
                return          # EOF (status 0)
            try:
                _count("native")
                yield ctypes.string_at(p, ln.value)
            finally:
                lib.cq_free(p)
    finally:
        lib.ps_close(h)


def parallel_reader_creator(paths, num_threads: Optional[int] = None, capacity: int = 256):
    """paddle.reader-style creator over many recordio files scanned in
    parallel."""
    def reader():
        return parallel_scan(paths, num_threads, capacity)
    return reader
