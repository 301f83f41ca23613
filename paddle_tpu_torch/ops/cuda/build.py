"""Build and load the port's hand-written CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process (all started together) for ``sm_90a`` (the ``*.cuh`` headers they
include are hashed with them) and linked into one shared library with a
plain C interface, which Python loads through ``ctypes``.
The build reads only ``csrc/``, runs once at first use under a thread lock
and a file lock, and writes into ``build/paddle_tpu_torch/`` beside the
package.  The library's file name carries a hash of the sources and flags,
so an edited kernel never loads a stale build.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # slow to import: only to build
    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the paddle_tpu_torch kernels")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's
    output, including ``-Xptxas -v``'s registers and shared memory."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = False
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                _compile(lib, log_path)
                built = True
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    log = log_path.read_text() if log_path.exists() else ""
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "built": built, "log": log}


def _compile(lib: Path, log_path: Path):
    nvcc = _nvcc()
    sources, _ = _sources()
    obj_dir = BUILD_DIR / f"obj_{lib.stem}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== nvcc {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *[str(o) for _, o, _ in procs]]
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {p.returncode})\n{p.stdout}")
        if p.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    log_path.write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"building the CUDA kernels failed at {failed}:\n"
                           + "\n".join(log))


class Entry:
    """One C entry point of the kernel library: ``int name(argtypes...)``
    returning a ``cudaError_t``, its last argument the stream.  Making one
    costs nothing (the wrappers' modules do it at import); its first call
    builds and loads the library, resolves the symbol and declares its types,
    once, and puts the ``ctypes`` function in ``fn``: later calls read that
    attribute and take no lock, look nothing up and assign no ``argtypes``."""

    __slots__ = ("name", "argtypes", "fn")

    def __init__(self, name: str, argtypes):
        self.name = name
        self.argtypes = list(argtypes)
        self.fn = self._first_call

    def _first_call(self, *args):
        with _lock:
            if self.fn == self._first_call:
                fn = getattr(_load(), self.name)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self.fn = fn
        return self.fn(*args)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_raw_stream = None   # device index -> handle of its current stream, no Stream object
_get_device = None   # -> the current device's index


def launch(entry: Entry, what: str, device, *args):
    """Call ``entry(*args, stream)`` with the current stream of ``device``
    (the ``torch.device`` of a CUDA tensor) and raise on a CUDA error.  The
    device is switched to only when it is not the current one."""
    global _raw_stream, _get_device
    if _raw_stream is None:
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _get_device = torch._C._cuda_getDevice
    index = device.index
    if index == _get_device():
        rc = entry.fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = entry.fn(*args, _raw_stream(index))
    if rc:
        msg = _lib.ptt_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launch_counters():
    """Every kernel wrapper's launch counters as (wrapper, attribute)
    pairs: ``<wrapper>.launches``, and ``<wrapper>.bf16_launches`` where the
    wrapper has a bf16 instance.  The executor reads them around a CUDA
    graph's capture, which launches nothing, and adds the captured counts
    at each replay."""
    from . import embedding, flash_attention, fused_optimizer, int8_matmul, linear_ce
    wrappers = (flash_attention.flash_attn_fwd, embedding.gather_rows,
                embedding.scatter_add_rows, int8_matmul.abs_max_pair,
                int8_matmul.quantize_int8, int8_matmul.int8_matmul,
                fused_optimizer.fused_sgd, fused_optimizer.fused_adam,
                linear_ce.linear_ce_fwd, linear_ce.linear_ce_bwd,
                linear_ce.gemm_3xtf32, linear_ce.gemm_bf16)
    return [(w, a) for w in wrappers for a in ("launches", "bf16_launches")
            if hasattr(w, a)]
