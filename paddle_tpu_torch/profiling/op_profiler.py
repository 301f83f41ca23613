"""The sampled slice profiler and its per-op cost model.

The port of the JAX package's ``profiling/op_profiler.py``, with its
method and its record schemas.  The profiler replays a step's feed
through the program's live slice (``core/prune.live_op_slice`` to the
fetch targets) op by op, through the executor's own ``lower_op``, and
stops each op's clock when its outputs are ready (on the card
``torch.cuda.synchronize``): op ``i``'s time is what it takes to extend
the finished prefix ``0..i-1`` by one op.  The first replay pass fills the
caches (the kernel library, cuBLAS's handles) and is discarded; the
reported pass is the fastest of ``samples``.

The replay writes nothing.  The port's update ops write the scope's own
tensors in place, so every pass lowers over clones of each state tensor
its slice writes (and of any feed it writes), made before the pass's
clock starts, and draws from a ``torch.Generator`` of its own seeded with
``rng_seed``; no scope tensor is rebound, so the addresses a step's CUDA
graph reads stay where they are.  Each update op is lowered alone (a group
of one), so a training step's one K6 launch over every parameter becomes
one launch an ``adam`` row in the replay.

The times are eager op-by-op times (launch and host work included,
nothing of a CUDA graph's replay), which is what ranks ops by cost; they
are not the times of a replayed step.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ..core.lower import _SKIP_OPS
from ..log import VLOG
from ..telemetry import (REGISTRY, StepTelemetry, TIMELINE, process_rank,
                         telemetry_dir)

__all__ = [
    "PROFILE_SCOPE", "PROFILE_RECORDS", "OVERHEAD_WALL_S",
    "RIDGE_FLOPS_PER_BYTE", "OpProfile", "ProgramProfile",
    "profile_program", "export_costmodel", "peak_flops_of",
]

PROFILE_SCOPE = "profiling"

# one process-wide stream: every profile appends to the same
# profile_<pid>.jsonl
PROFILE_RECORDS = StepTelemetry(capacity=8192, prefix="profile")

# roofline classification knobs, shared with the report tools: an op whose
# measured wall sits under OVERHEAD_WALL_S is bound by its launch and host
# work ("overhead"); otherwise its arithmetic intensity (FLOPs per byte
# moved) against the ridge decides compute- or memory-bound.  The ridge is
# deliberately low: the static byte count undercounts reuse, and a low
# ridge keeps large products classified compute-bound.
OVERHEAD_WALL_S = 2e-4
RIDGE_FLOPS_PER_BYTE = 8.0

# dense bf16 peak TFLOP/s by device-name substring, from the spec sheets
# (first match wins); the CPU gets a nominal figure so MFU stays defined
# (an indicative ratio only)
PEAK_TFLOPS = [
    ("h100 pcie", 756.0), ("h100", 989.0), ("h200", 989.0), ("h800", 989.0),
    ("a100", 312.0), ("cpu", 0.05),
]


def peak_flops_of(device=None) -> float:
    """Peak FLOP/s of ``device`` (a ``torch.device``, a device name, or
    None: the first CUDA device, else the CPU) from the spec-sheet table;
    an unknown card gets a nominal 100 TFLOP/s."""
    import torch
    if isinstance(device, str):
        kind = device
    else:
        if device is None:
            device = torch.device("cuda", 0) if torch.cuda.is_available() \
                else torch.device("cpu")
        device = torch.device(device)
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
            else "cpu"
    kind = kind.lower()
    for key, tf in PEAK_TFLOPS:
        if key in kind:
            return tf * 1e12
    return 100e12


# ------------------------------------------------------ static op costing

def _elems(v) -> int:
    shape = getattr(v, "shape", None)
    if not shape:
        return 1
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _nbytes(v) -> int:
    n = getattr(v, "nbytes", None)
    if n is not None:
        return int(n)
    itemsize = getattr(getattr(v, "dtype", None), "itemsize", 4) or 4
    return _elems(v) * int(itemsize)


def _op_static_cost(op, env: Dict[str, Any]) -> Dict[str, float]:
    """Coarse per-op FLOPs and bytes moved, from the tensors the replay
    made (shapes are exact; the FLOP formulas are per-type approximations
    the calibration factor absorbs).  A grad op counts 2x its forward (the
    input and the weight gradient)."""
    ins = [env[n] for n in op.input_names() if n and n in env]
    outs = [env[n] for n in op.output_names() if n and n in env]
    bytes_moved = sum(_nbytes(v) for v in ins) \
        + sum(_nbytes(v) for v in outs)
    out_elems = sum(_elems(v) for v in outs)
    in_elems = sum(_elems(v) for v in ins)

    op_type = op.type
    grad = op_type.endswith("_grad")
    base = op_type[:-len("_grad")] if grad else op_type

    flops = float(out_elems)                       # default: 1 FLOP/elem
    if base in ("mul", "matmul"):
        # out[M, N] = x[M, K] @ y[K, N] -> 2*M*K*N; K from the weight-like
        # second input (last-but-one dim), robust to batched x
        if len(ins) >= 2 and getattr(ins[1], "shape", None):
            k = int(ins[1].shape[0]) if len(ins[1].shape) >= 1 else 1
            flops = 2.0 * out_elems * max(1, k)
        else:
            flops = 2.0 * out_elems
    elif base in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
        # out elems x (Cin * kh * kw) MACs
        filt = ins[1] if len(ins) >= 2 else None
        fshape = getattr(filt, "shape", None)
        if fshape and len(fshape) == 4:
            flops = 2.0 * out_elems * int(fshape[1]) * int(fshape[2]) \
                * int(fshape[3])
        else:
            flops = 2.0 * out_elems
    elif base in ("softmax", "softmax_with_cross_entropy", "exp", "tanh",
                  "sigmoid", "gelu", "erf", "log", "layer_norm",
                  "batch_norm"):
        flops = 5.0 * max(out_elems, in_elems)     # transcendental-ish
    elif base in ("reduce_sum", "reduce_mean", "reduce_max", "mean",
                  "sum", "cross_entropy"):
        flops = float(max(in_elems, out_elems))
    elif base in ("adam", "momentum", "sgd", "adagrad"):
        flops = 10.0 * float(in_elems)             # few fma per param
    if grad:
        flops *= 2.0
    return {"flops": flops, "bytes": float(bytes_moved)}


# --------------------------------------------------------------- records

class OpProfile:
    """One op's measured and modeled cost inside a :class:`ProgramProfile`."""

    __slots__ = ("op_index", "op_type", "callsite", "wall_s", "share",
                 "flops", "bytes", "mfu", "roofline")

    def __init__(self, op_index: int, op_type: str, callsite: Optional[str],
                 wall_s: float, share: float, flops: float, bytes_: float,
                 mfu: float, roofline: str):
        self.op_index = op_index
        self.op_type = op_type
        self.callsite = callsite
        self.wall_s = wall_s
        self.share = share
        self.flops = flops
        self.bytes = bytes_
        self.mfu = mfu
        self.roofline = roofline

    def to_dict(self) -> dict:
        return {"op_index": self.op_index, "op_type": self.op_type,
                "callsite": self.callsite,
                "wall_s": round(self.wall_s, 9),
                "share": round(self.share, 6),
                "flops": self.flops, "bytes": self.bytes,
                "mfu": round(self.mfu, 8), "roofline": self.roofline}


class ProgramProfile:
    """One :func:`profile_program` run: per-op attribution (``ops``, by
    wall time descending), the measured replay wall and coverage
    (attributed / measured), and the per-op-type calibration table
    (``by_type``) the cost-model export writes."""

    def __init__(self, ops: List[OpProfile], measured_wall_s: float,
                 attributed_s: float, samples: int, ops_replayed: int,
                 peak_flops: float, program_fp: Optional[str] = None,
                 compiled_step_s: Optional[float] = None,
                 xla_cost: Optional[dict] = None,
                 flops_scale: float = 1.0):
        self.ops = ops
        self.measured_wall_s = measured_wall_s
        self.attributed_s = attributed_s
        self.coverage = (attributed_s / measured_wall_s
                         if measured_wall_s > 0 else 0.0)
        self.samples = samples
        self.ops_replayed = ops_replayed
        self.peak_flops = peak_flops
        self.program_fp = program_fp
        self.compiled_step_s = compiled_step_s
        self.xla_cost = xla_cost
        self.flops_scale = flops_scale
        self.by_type = self._calibrate()

    def _calibrate(self) -> Dict[str, dict]:
        by_type: Dict[str, dict] = {}
        for op in self.ops:
            t = by_type.setdefault(op.op_type, {
                "count": 0, "wall_s": 0.0, "flops": 0.0, "bytes": 0.0})
            t["count"] += 1
            t["wall_s"] += op.wall_s
            t["flops"] += op.flops
            t["bytes"] += op.bytes
        for t in by_type.values():
            # compute-optimal seconds for the type's FLOPs; the
            # calibration factor is how much slower the replay ran
            predicted = t["flops"] / self.peak_flops \
                if self.peak_flops > 0 else 0.0
            t["predicted_s"] = predicted
            t["calibration"] = (t["wall_s"] / predicted
                                if predicted > 0 else None)
            t["wall_s"] = round(t["wall_s"], 9)
            t["predicted_s"] = round(t["predicted_s"], 12)
            if t["calibration"] is not None:
                t["calibration"] = round(t["calibration"], 3)
        return by_type

    def top(self, k: int = 10) -> List[OpProfile]:
        return self.ops[:k]

    def to_dict(self) -> dict:
        out = {
            "measured_wall_s": round(self.measured_wall_s, 9),
            "attributed_s": round(self.attributed_s, 9),
            "coverage": round(self.coverage, 6),
            "samples": self.samples,
            "ops_replayed": self.ops_replayed,
            "peak_flops": self.peak_flops,
            "flops_scale": round(self.flops_scale, 6),
            "by_type": self.by_type,
            "ops": [op.to_dict() for op in self.ops],
        }
        if self.program_fp:
            out["program_fp"] = self.program_fp
        if self.compiled_step_s is not None:
            out["compiled_step_s"] = round(self.compiled_step_s, 9)
        if self.xla_cost:
            out["xla_cost"] = self.xla_cost
        return out

    def format(self, k: int = 10) -> str:
        lines = [f"op profile: {self.ops_replayed} ops, "
                 f"{self.measured_wall_s * 1e3:.2f} ms replay wall, "
                 f"{self.coverage * 100:.1f}% attributed "
                 f"({self.samples} sample(s))"]
        cum = 0.0
        for op in self.top(k):
            cum += op.share
            lines.append(
                f"  op#{op.op_index:<4} {op.op_type:<24} "
                f"{op.wall_s * 1e3:8.3f} ms {op.share * 100:5.1f}% "
                f"(cum {cum * 100:5.1f}%) {op.roofline:<9} "
                f"{op.callsite or '?'}")
        return "\n".join(lines)


# ----------------------------------------------------------------- replay

class _Replay:
    """Block 0's ops ``idx`` run op by op over the scope's state and a
    feed, writing nothing: the environment every pass starts from (scope
    values of the ops' inputs, the feeds as the executor coerces them),
    the names a pass writes that the environment holds (cloned before each
    pass), and the device the ops run on."""

    def __init__(self, program, feed: Dict[str, Any], scope, executor,
                 idx: Sequence[int], rng_seed: Optional[int] = None):
        import torch

        from ..core.executor import Executor
        from ..core.scope import global_scope
        self.program = program
        self.block = program.desc.block(0)
        self.idx = list(idx)
        scope = scope or global_scope()
        base: Dict[str, Any] = {}
        for op in self.block.ops:
            for n in op.input_names():
                if not n or n in feed or n in base:
                    continue
                v = scope.find_var(n)
                if isinstance(v, torch.Tensor):
                    base[n] = v
        if executor is not None:
            self.device = executor.device
            executor._wait_staged(feed)
        else:
            self.device = next((v.device for v in base.values()),
                               torch.device("cpu"))
        for k, v in feed.items():
            t, dtype = Executor._feed_host(self.block, k, v)
            base[k] = t.to(device=self.device, dtype=dtype)
        self.base = base
        written = {n for i in self.idx for n in self.block.ops[i].output_names() if n}
        self.written = sorted(written & set(base))
        self.rng_seed = (program.random_seed or 0) if rng_seed is None else rng_seed

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, span_prefix: Optional[str] = None):
        """One pass: ``(times, wall, env)``, each op's seconds from its
        lowering's start to its outputs being ready, the pass's seconds,
        and the environment it ended with.  ``span_prefix`` records each
        op as a ``<prefix><type>`` timeline span."""
        import torch

        from ..core.lower import LowerCtx, lower_op
        env = dict(self.base)
        for n in self.written:
            env[n] = self.base[n].clone()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.rng_seed)
        ctx = LowerCtx(self.block, env, gen, self.device)
        self._sync()
        times: List[float] = []
        with torch.no_grad():
            t_pass0 = time.perf_counter()
            for i in self.idx:
                op = self.block.ops[i]
                ts = TIMELINE.now_us() if span_prefix else 0.0
                t0 = time.perf_counter()
                lower_op(ctx, op, index=i)
                self._sync()
                times.append(time.perf_counter() - t0)
                if span_prefix:
                    TIMELINE.record_complete(span_prefix + op.type, ts,
                                             TIMELINE.now_us() - ts)
            wall = time.perf_counter() - t_pass0
        return times, wall, env


# -------------------------------------------------------------- profiling

def profile_program(program, feed: Dict[str, Any], scope=None,
                    fetch_list: Optional[Sequence] = None,
                    samples: int = 3, rng_seed: Optional[int] = None,
                    executor=None, peak_flops: Optional[float] = None,
                    compiled_step_s: Optional[float] = None,
                    record: bool = True,
                    export: bool = True) -> ProgramProfile:
    """Profile block 0 of ``program`` against ``feed``: replay the live
    slice to the fetch targets op by op (every op output when
    ``fetch_list`` is empty), timing each op's lowering to its outputs
    being ready.  ``samples`` passes are reported on (a first, discarded
    pass fills the caches when ``samples > 1``); the fastest is kept.
    State comes from ``scope`` and is never written (module docstring);
    random ops draw from a generator seeded with ``rng_seed`` (default the
    program's ``random_seed``).  ``executor`` coerces the feeds and names
    the device (default: the state's device).

    ``record=True`` writes ``kind: op`` and ``kind: summary`` rows to the
    ``profile_<pid>.jsonl`` stream and bumps the ``"profiling"`` scope's
    counters; ``export=True`` also writes the per-op-type calibration
    table as ``costmodel_<pid>.json`` beside it."""
    from ..core.prune import live_op_slice

    block = program.desc.block(0)
    fetch_names = [f if isinstance(f, str) else f.name
                   for f in fetch_list or []]
    if fetch_names:
        targets = fetch_names
    else:
        targets = [n for op in block.ops if op.type not in _SKIP_OPS
                   for n in op.output_names() if n]
    keep_idx, _ = live_op_slice(block, targets)
    keep_idx = [i for i in keep_idx
                if block.ops[i].type not in _SKIP_OPS]
    if not keep_idx:
        raise ValueError("nothing to profile: the live slice to the "
                         "fetch targets is empty")
    replay = _Replay(program, feed, scope, executor, keep_idx, rng_seed)

    samples = max(1, int(samples))
    n_passes = samples + 1 if samples > 1 else 1

    best_wall = None
    best_times: List[float] = []
    statics: Optional[List[dict]] = None
    for p in range(n_passes):
        times, wall, env = replay.run()
        if p == 0 and n_passes > 1:
            continue                    # warm-up pass: caches fill here
        if statics is None:
            # shapes are the same in every pass
            statics = [_op_static_cost(block.ops[i], env) for i in keep_idx]
        del env
        if best_wall is None or wall < best_wall:
            best_wall = wall
            best_times = times

    attributed = sum(best_times)
    pf = peak_flops if peak_flops is not None else peak_flops_of(replay.device)
    # a CUDA graph has no counted-FLOPs analysis to scale the static
    # estimate to (the JAX package's XLA cost join): the scale stays 1
    xla_cost = None
    flops_scale = 1.0

    ops: List[OpProfile] = []
    for pos, i in enumerate(keep_idx):
        op = block.ops[i]
        wall_s = best_times[pos]
        flops = statics[pos]["flops"] * flops_scale
        bytes_ = statics[pos]["bytes"]
        mfu = flops / wall_s / pf if wall_s > 0 and pf > 0 else 0.0
        if wall_s < OVERHEAD_WALL_S:
            roofline = "overhead"
        elif flops / max(1.0, bytes_) >= RIDGE_FLOPS_PER_BYTE:
            roofline = "compute"
        else:
            roofline = "memory"
        ops.append(OpProfile(
            op_index=i, op_type=op.type,
            callsite=getattr(op, "callsite", None),
            wall_s=wall_s,
            share=wall_s / attributed if attributed > 0 else 0.0,
            flops=flops, bytes_=bytes_, mfu=mfu, roofline=roofline))
    ops.sort(key=lambda o: -o.wall_s)

    prof = ProgramProfile(
        ops=ops, measured_wall_s=best_wall or 0.0, attributed_s=attributed,
        samples=max(1, n_passes - 1), ops_replayed=len(keep_idx),
        peak_flops=pf, program_fp=program.desc.fingerprint()[:12],
        compiled_step_s=compiled_step_s, xla_cost=xla_cost,
        flops_scale=flops_scale)

    if record:
        _record_profile(prof)
    if export:
        export_costmodel(prof)
    return prof


def _record_profile(prof: ProgramProfile):
    """One ``kind: summary`` row and one ``kind: op`` row per attributed
    op into ``profile_<pid>.jsonl``, and the ``"profiling"`` scope's
    counters and gauge; telemetry never raises into the run."""
    try:
        REGISTRY.counter("profiles", scope=PROFILE_SCOPE).inc()
        REGISTRY.counter("ops_profiled", scope=PROFILE_SCOPE).inc(
            len(prof.ops))
        REGISTRY.gauge("coverage", scope=PROFILE_SCOPE).set(
            round(prof.coverage, 6))
        summary = prof.to_dict()
        op_rows = summary.pop("ops")
        summary.pop("by_type", None)    # rides in costmodel_<pid>.json
        PROFILE_RECORDS.record(kind="summary", **summary)
        for row in op_rows:
            PROFILE_RECORDS.record(kind="op", program_fp=prof.program_fp,
                                   **row)
    except Exception as e:  # noqa: BLE001
        VLOG(1, "profile record failed: %s: %s", type(e).__name__, e)


def export_costmodel(prof: ProgramProfile,
                     out_dir: Optional[str] = None) -> Optional[str]:
    """Write the per-op-type calibration table as ``costmodel_<pid>.json``
    under ``out_dir`` (default the telemetry dir), which
    ``tools/profile_report.py`` reads.  A later profile in the process
    overwrites the file.  Returns the path, or None when export is off."""
    d = out_dir or telemetry_dir()
    if not d:
        return None
    path = os.path.join(d, f"costmodel_{os.getpid()}.json")
    doc = {
        "ts": time.time(), "pid": os.getpid(), "rank": process_rank(),
        "peak_flops": prof.peak_flops,
        "flops_scale": round(prof.flops_scale, 6),
        "coverage": round(prof.coverage, 6),
        "measured_wall_s": round(prof.measured_wall_s, 9),
        "program_fp": prof.program_fp,
        "types": prof.by_type,
    }
    if prof.xla_cost:
        doc["xla_cost"] = prof.xla_cost
    try:
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError as e:
        VLOG(1, "costmodel export failed: %s", e)
        return None
