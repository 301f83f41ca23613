"""Leveled VLOG-style logging -- the glog analogue, copied from the JAX
package's ``log`` module (stdlib only).

Fluid logs through glog (``VLOG(n)`` across its C++ core), with verbosity
from ``GLOG_v`` and per-module overrides from ``GLOG_vmodule=name=level,...``.
This module keeps that user contract on the Python runtime:

    GLOG_v=2 python train.py                 # global verbosity
    GLOG_vmodule=executor=3,pserver=1 ...    # per-module levels

``VLOG(level, msg)`` is enabled when ``level <= effective_verbosity(module)``
where module is the caller's file stem.  Output goes to stderr with the
glog-ish ``I0730 12:34:56 module.py:42] msg`` prefix.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional

__all__ = ["VLOG", "vlog_enabled", "set_verbosity", "get_verbosity"]

_lock = threading.Lock()


def _parse_vmodule(spec: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, lvl = part.partition("=")
        try:
            out[name.strip()] = int(lvl)
        except ValueError:
            pass
    return out


_global_v = 0
_vmodule: Dict[str, int] = {}


def _init_from_env():
    global _global_v, _vmodule
    try:
        _global_v = int(os.environ.get("GLOG_v", "0") or 0)
    except ValueError:
        _global_v = 0
    _vmodule = _parse_vmodule(os.environ.get("GLOG_vmodule", ""))


_init_from_env()


def set_verbosity(level: int, module: Optional[str] = None):
    global _global_v
    with _lock:
        if module is None:
            _global_v = int(level)
        else:
            _vmodule[module] = int(level)


def get_verbosity(module: Optional[str] = None) -> int:
    if module is not None and module in _vmodule:
        return _vmodule[module]
    return _global_v


def _caller(depth: int = 2):
    frame = sys._getframe(depth)
    fname = frame.f_code.co_filename
    stem = os.path.splitext(os.path.basename(fname))[0]
    return stem, os.path.basename(fname), frame.f_lineno


def vlog_enabled(level: int, module: Optional[str] = None) -> bool:
    if module is None:
        module = _caller()[0]
    return level <= get_verbosity(module)


def VLOG(level: int, msg: str, *args):
    """Log ``msg % args`` when verbosity for the calling module >= level."""
    stem, fname, lineno = _caller()
    if level > get_verbosity(stem):
        return
    if args:
        msg = msg % args
    t = time.localtime()
    prefix = (f"I{t.tm_mon:02d}{t.tm_mday:02d} "
              f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} "
              f"{fname}:{lineno}]")
    print(f"{prefix} {msg}", file=sys.stderr, flush=True)
