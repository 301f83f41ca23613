"""Global flag registry -- the gflags analogue, copied from the JAX
package's ``flags`` module (stdlib only) with the same flag names, kinds,
defaults, ``init_gflags`` grammar and ``FLAGS_*`` environment contract.

Fluid defines its gflags next to their use sites (``FLAGS_check_nan_inf``
operator.cc:643, ``FLAGS_benchmark`` operator.cc:722, ...) and exposes a
curated subset as environment variables (``fluid/__init__.py:121-137``
builds a ``--tryfromenv=`` argv for ``core.init_gflags``).  Here the same
contract holds: ``FLAGS_<name>`` environment variables are read at import,
``init_gflags([...])`` overrides them.  The flags that have nothing to
control on the card are registered as accepted no-ops whose ``obviated``
reason says what stands in their place; reading one set to a value other
than its default warns once.

Live flags: ``check_nan_inf`` and ``benchmark`` (read by
``Executor.run``), ``paddle_num_threads`` (``reader.xmap_readers``' pool),
``v`` (``log``'s verbosity), ``rpc_deadline`` and ``rpc_retry_times``
(kept for the distributed layer, which is not ported yet).

Usage::

    from paddle_tpu_torch import flags
    if flags.FLAGS.check_nan_inf: ...
    flags.init_gflags(["--check_nan_inf=true"])   # explicit override
    FLAGS_check_nan_inf=1 python train.py          # environment contract
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Dict, List, Optional

__all__ = ["FLAGS", "init_gflags", "DEFINE_bool", "DEFINE_int32",
           "DEFINE_double", "DEFINE_string", "get_flag_info"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


class _FlagInfo:
    __slots__ = ("name", "default", "kind", "help", "obviated")

    def __init__(self, name, default, kind, help_, obviated=None):
        self.name = name
        self.default = default
        self.kind = kind
        self.help = help_
        # non-None: accepted for compatibility but without effect on the
        # card; the string says why
        self.obviated = obviated


class _Flags:
    """Attribute-style flag store; thread-safe writes."""

    def __init__(self):
        object.__setattr__(self, "_registry", {})   # name -> _FlagInfo
        object.__setattr__(self, "_values", {})     # name -> value
        object.__setattr__(self, "_lock", threading.Lock())
        object.__setattr__(self, "_warned", set())

    def _define(self, info: _FlagInfo):
        with self._lock:
            if info.name in self._registry:
                raise ValueError(f"flag {info.name!r} already defined")
            self._registry[info.name] = info
            self._values[info.name] = info.default

    def __getattr__(self, name: str):
        try:
            val = self._values[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None
        info = self._registry[name]
        if info.obviated and val != info.default and name not in self._warned:
            self._warned.add(name)
            warnings.warn(
                f"FLAGS_{name} is accepted for reference compatibility but "
                f"has no effect here: {info.obviated}", stacklevel=2)
        return val

    def __setattr__(self, name: str, value):
        self.set(name, value)

    def set(self, name: str, value):
        with self._lock:
            info = self._registry.get(name)
            if info is None:
                raise AttributeError(f"unknown flag {name!r}")
            self._values[name] = _coerce(info, value)
        if name == "v":
            # FLAGS_v and GLOG_v are one knob (as in glog); log.py holds
            # the verbosity
            from . import log as _log
            _log.set_verbosity(self._values["v"])

    def names(self) -> List[str]:
        return sorted(self._registry)


def _coerce(info: _FlagInfo, value: Any):
    if info.kind == "bool":
        if isinstance(value, str):
            v = value.strip().lower()
            if v in _TRUE:
                return True
            if v in _FALSE:
                return False
            raise ValueError(f"bad bool for --{info.name}: {value!r}")
        return bool(value)
    if info.kind == "int32":
        return int(value)
    if info.kind == "double":
        return float(value)
    return str(value)


FLAGS = _Flags()


def DEFINE_bool(name, default, help_="", obviated=None):
    FLAGS._define(_FlagInfo(name, default, "bool", help_, obviated))


def DEFINE_int32(name, default, help_="", obviated=None):
    FLAGS._define(_FlagInfo(name, default, "int32", help_, obviated))


def DEFINE_double(name, default, help_="", obviated=None):
    FLAGS._define(_FlagInfo(name, default, "double", help_, obviated))


def DEFINE_string(name, default, help_="", obviated=None):
    FLAGS._define(_FlagInfo(name, default, "string", help_, obviated))


def get_flag_info(name: str) -> Dict[str, Any]:
    info = FLAGS._registry[name]
    return {"name": info.name, "default": info.default, "kind": info.kind,
            "help": info.help, "obviated": info.obviated,
            "value": FLAGS._values[name]}


def init_gflags(args: Optional[List[str]] = None):
    """Parse ``--name=value`` / ``--name value`` overrides (Fluid's
    ``core.init_gflags``, pybind.cc:516).  Unknown flags raise, as gflags'
    would."""
    args = list(args or [])
    i = 0
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            raise ValueError(f"expected --flag argument, got {a!r}")
        body = a[2:]
        if "=" in body:
            name, val = body.split("=", 1)
        else:
            name = body
            info = FLAGS._registry.get(name)
            nxt = args[i + 1] if i + 1 < len(args) else None
            if (info is not None and info.kind == "bool"
                    and (nxt is None or nxt.startswith("--"))):
                # a bare --bool_flag means true (gflags' behaviour), in any
                # position: a next token that is another flag is not its value
                FLAGS.set(name, True)
                i += 1
                continue
            i += 1
            if i >= len(args):
                raise ValueError(f"flag --{name} missing a value")
            val = args[i]
        FLAGS.set(name, val)
        i += 1


# --------------------------------------------------------------------------
# Flag definitions.  Live flags first, then accepted-but-obviated ones.

DEFINE_bool(
    "check_nan_inf", False,
    "After each Executor.run, scan fetches and updated state for NaN/Inf; "
    "on a hit, re-run the block op by op from a snapshot taken before the "
    "run to name the first op that produced a non-finite output (reference "
    "operator.cc:643-655 scans every op's outputs).")
DEFINE_bool(
    "benchmark", False,
    "Synchronize after every Executor.run and log its wall time and the "
    "live device bytes (torch.cuda.memory_allocated) (reference "
    "operator.cc:722 + executor.cc:335 force per-op waits and memory_usage "
    "logging).")
DEFINE_double(
    "rpc_deadline", 30.0,
    "Seconds before a coordination/pserver RPC times out (reference "
    "FLAGS_rpc_deadline, operators/distributed/grpc_client.cc).")
DEFINE_int32(
    "rpc_retry_times", 3,
    "Connection retries for pserver/master RPCs (reference grpc max-retry).")
DEFINE_int32(
    "paddle_num_threads", 0,
    "Worker threads for host-side pipelines (reader.xmap_readers' pool). "
    "0 = the cpu count (reference FLAGS_paddle_num_threads, "
    "platform/cpu_info).")
DEFINE_int32(
    "v", int(os.environ.get("GLOG_v", "0") or 0),
    "VLOG verbosity level (glog -v; also honors GLOG_v).")

DEFINE_double(
    "fraction_of_gpu_memory_to_use", 0.92,
    "Reference memory/malloc.cc:31 pool sizing.",
    obviated="PyTorch's caching allocator owns the card's memory and grows "
             "on demand; cap it with torch.cuda.set_per_process_memory_"
             "fraction or PYTORCH_CUDA_ALLOC_CONF")
DEFINE_bool(
    "use_pinned_memory", True,
    "Reference memory/detail/system_allocator pinned staging.",
    obviated="feeds and fetches always go through pinned host buffers "
             "(core/staging.py: the FeedStager and prefetch_to_host)")
DEFINE_bool(
    "init_allocated_mem", False,
    "Reference memory/malloc.cc:24 poisons fresh allocations with NaN.",
    obviated="every value a block reads is fed, held by the scope or "
             "written by an earlier op; no lowering reads an allocation "
             "before writing it")
DEFINE_bool(
    "cudnn_deterministic", False,
    "Reference conv_cudnn_op.cu.cc algo pinning.",
    obviated="set torch.backends.cudnn.deterministic; the executable cache "
             "records it in each entry's key and fingerprint "
             "(core/executor.py _matmul_flags)")
DEFINE_bool(
    "use_mkldnn", False, "Reference executor.cc:28.",
    obviated="CPUPlace runs PyTorch's CPU kernels, which pick oneDNN "
             "themselves; there is no per-run switch")
DEFINE_double(
    "eager_delete_tensor_gb", -1.0, "Reference GC threshold.",
    obviated="the executor drops each value after its last reader inside "
             "the block (core/lower.py plan_frees)")

# The curated environment subset, the reference list's shape
# (fluid/__init__.py:121-137 read_env_flags + in-place additions).
_ENV_FLAGS = [
    "check_nan_inf", "benchmark", "rpc_deadline", "rpc_retry_times",
    "paddle_num_threads", "v", "fraction_of_gpu_memory_to_use",
    "use_pinned_memory", "init_allocated_mem", "cudnn_deterministic",
    "use_mkldnn", "eager_delete_tensor_gb",
]


def _try_from_env():
    for name in _ENV_FLAGS:
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            try:
                FLAGS.set(name, env)
            except ValueError as e:
                warnings.warn(f"ignoring FLAGS_{name}={env!r}: {e}")


_try_from_env()
