"""Static memory planner: liveness-based per-device memory estimation over
``ProgramDesc x layout``, a copy of the JAX package's
``analysis/memory.py`` (stdlib only).

Walk block 0 with the same liveness machinery inference pruning uses,
size every ``VarDesc`` from shape x dtype, divide each tensor's bytes by
its sharding factor under a mesh, and sweep the per-op live set:

* **persistent** state (params, optimizer slots) is live for the whole
  step and counted once (in-place updates alias);
* **feeds** are held for the whole step unless donated (``donate_feeds``
  or a feed's ``donate`` stamp), which frees each after its last use;
* **activations** live from their producing op to their last use; fetch
  targets are outputs, held to the end;
* **workspace**: control-flow body locals fold into their parent op.

This is the model of XLA's buffer liveness, and the port's executor
follows it: ``core/lower.py`` ``plan_frees`` drops each value after its
last reader, and keeps fetches and written state.  What the plan never
sees on the card: the generic grad's re-run of a forward op (its
intermediates under autograd), cuBLAS's and cuDNN's workspaces, the
caching allocator's rounding, and a CUDA graph's private pool.

Entry point: :func:`plan_memory` -> :class:`MemoryPlan`.  On top of the
plan, :func:`memory_diagnostics` emits the **M5xx** family (see
diagnostics.CATALOG) and ``Executor(memory_budget=...)`` raises
:class:`PredictedOOMError` before a program's first run (or capture) at a
feed signature.  Plans go to ``memplan_<pid>.jsonl`` (:func:`export_plan`)
in the JAX package's schema, which ``tools/memory_report.py`` and
``tools/stats.py`` read.

``DEVICE_PROFILES`` keeps the JAX package's TPU names, so plans and tests
agree across the two packages, and adds the H100 the port runs on.
"""
from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core import prune as _prune
from ..core.desc import (BlockDesc, ProgramDesc, VarType, is_grad_var_name,
                         strip_grad_suffix)
from ..core.registry import OPS
from .diagnostics import Diagnostic
from .verifier import (_CSP_OPS, _DECL_OPS, _EFFECT_OPS, _NON_TENSOR,
                       _BlockFacts, _MeshShim, _mesh_shape,
                       _seq_side_channel)

__all__ = [
    "MemoryPlan", "TensorPlan", "PredictedOOMError", "plan_memory",
    "plan_state_memory", "memory_diagnostics", "parse_memory_budget",
    "export_plan", "fmt_bytes", "DEVICE_PROFILES", "DONATE_ATTR",
    "MEM_HINT_ATTR",
]

#: var attr: explicit byte-size hint for tensors the planner cannot size
#: (dynamic dims with no shape-infer coverage).  Non-semantic — scrubbed
#: from ``ProgramDesc.fingerprint`` (desc.NONSEMANTIC_VAR_ATTRS).
MEM_HINT_ATTR = "mem_bytes_hint"

#: var attr: per-feed donation stamp, written by the donation-insertion
#: pass (passes/donation.py) acting on M503 findings.  A stamped feed's
#: live range ends at its last use here, and the Executor treats the
#: program as ``run(donate_feeds=True)``.  SEMANTIC: the stamp moves the
#: program fingerprint, so a stamped program is a cache entry of its own.
DONATE_ATTR = "donate"

#: ``torch.cuda.get_device_properties(0).total_memory`` read on an NVIDIA
#: H100 80GB HBM3 at a 700 W power limit
H100_TOTAL_MEMORY = 85_017_493_504

#: named per-device memory budgets (GiB per device) accepted by
#: ``Executor(memory_budget="h100-80gb-hbm3")``.  The TPU names are the JAX
#: package's.
DEVICE_PROFILES: Dict[str, float] = {
    "tpu-v2": 8, "tpu-v3": 16, "tpu-v4": 32,
    "tpu-v5e": 16, "tpu-v5p": 95, "tpu-v6e": 32,
    "h100-80gb-hbm3": H100_TOTAL_MEMORY / 2 ** 30,
}

_UNIT = {"b": 1, "kb": 10 ** 3, "mb": 10 ** 6, "gb": 10 ** 9,
         "tb": 10 ** 12, "kib": 2 ** 10, "mib": 2 ** 20, "gib": 2 ** 30,
         "tib": 2 ** 40}

#: dtype value -> bytes per element.  int64/float64 narrow to 4, as the
#: executor's feed coercion (``coerce_feed_dtype``) narrows them.
_DTYPE_BYTES = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
                "int64": 8, "float16": 2, "bfloat16": 2, "float32": 4,
                "float64": 8}


def parse_memory_budget(budget) -> int:
    """A budget knob value as bytes: an int/float byte count, a size
    string (``"16GiB"``, ``"512MB"``), or a named device profile
    (``"h100-80gb-hbm3"``, ``"tpu-v4"`` / ``"v4"``)."""
    if isinstance(budget, (int, float)) and not isinstance(budget, bool):
        return int(budget)
    s = str(budget).strip().lower()
    name = s if s in DEVICE_PROFILES or s.startswith("tpu-") else f"tpu-{s}"
    if name in DEVICE_PROFILES:
        return int(DEVICE_PROFILES[name] * 2 ** 30)
    m = re.fullmatch(r"([\d.]+)\s*([kmgt]i?b|b)?", s)
    if not m:
        raise ValueError(
            f"cannot parse memory budget {budget!r}: pass bytes, a size "
            f"string like '16GiB', or a device profile "
            f"{sorted(DEVICE_PROFILES)}")
    return int(float(m.group(1)) * _UNIT[m.group(2) or "b"])


def fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{int(n)}B" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _itemsize(dtype, x64: bool = False) -> int:
    v = getattr(dtype, "value", str(dtype))
    n = _DTYPE_BYTES.get(v, 4)
    if not x64 and n == 8:
        return 4
    return n


def _prod(xs: Iterable[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclass
class TensorPlan:
    """One tensor's contribution to the plan."""

    name: str
    kind: str                     # persistent | feed | activation | output
    shape: Tuple[int, ...]
    dtype: str
    total_bytes: int              # unsharded (all devices)
    device_bytes: int             # per device under the sharding
    pad_bytes: int = 0            # per-device padding waste (ceil-division)
    spec: Optional[list] = None   # resolved PartitionSpec-style entries
    start: int = 0                # first op index live (non-persistent)
    end: int = 0                  # last op index live (inclusive)
    last_use: Optional[int] = None   # last op that computes with it
    dynamic: bool = False         # unknown dims were assumed (batch=1 etc.)

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "shape": list(self.shape), "dtype": self.dtype,
                "bytes": self.device_bytes, "total_bytes": self.total_bytes,
                "pad_bytes": self.pad_bytes, "spec": self.spec,
                "live": [self.start, self.end], "dynamic": self.dynamic}


@dataclass
class MemoryPlan:
    """Per-op live-set byte profile of one program block, per device."""

    peak_bytes: int = 0                    # per-device live-set peak
    peak_op_index: Optional[int] = None
    peak_op_type: Optional[str] = None
    peak_callsite: Optional[str] = None
    timeline: List[int] = field(default_factory=list)   # per-op live bytes
    top: List[dict] = field(default_factory=list)       # top-K at the peak
    breakdown: Dict[str, int] = field(default_factory=dict)
    persistent_bytes: int = 0              # always-live state, per device
    feed_bytes: int = 0                    # argument buffers, per device
    output_bytes: int = 0                  # fetch targets, per device
    num_devices: int = 1
    mesh: Optional[Dict[str, int]] = None
    layout_fp: Optional[str] = None
    donate_feeds: bool = False
    pad_bytes: int = 0                     # per-device padding waste total
    unsized: List[dict] = field(default_factory=list)   # M504 coverage gaps
    dynamic: List[str] = field(default_factory=list)    # assumed-dim vars
    dead_ops: List[int] = field(default_factory=list)   # D204-dead op idx
    dead_outputs: List[str] = field(default_factory=list)  # their tensors
    donated_feeds: List[str] = field(default_factory=list)  # DONATE_ATTR
    program_fp: str = ""
    num_ops: int = 0
    wall_s: float = 0.0
    tensors: Dict[str, TensorPlan] = field(default_factory=dict)

    def live_at(self, i: int) -> List[TensorPlan]:
        out = [t for t in self.tensors.values()
               if t.kind == "persistent" or t.start <= i <= t.end]
        return sorted(out, key=lambda t: -t.device_bytes)

    def to_dict(self) -> dict:
        return {
            "peak_bytes": self.peak_bytes,
            "peak_op": {"index": self.peak_op_index,
                        "type": self.peak_op_type,
                        "callsite": self.peak_callsite},
            "breakdown": dict(self.breakdown),
            "persistent_bytes": self.persistent_bytes,
            "feed_bytes": self.feed_bytes,
            "output_bytes": self.output_bytes,
            "num_devices": self.num_devices, "mesh": self.mesh,
            "layout": self.layout_fp, "donate_feeds": self.donate_feeds,
            "pad_bytes": self.pad_bytes,
            "top": list(self.top),
            "unsized": list(self.unsized), "dynamic": list(self.dynamic),
            "dead_ops": len(self.dead_ops),
            "donated_feeds": list(self.donated_feeds),
            "program_fp": self.program_fp, "ops": self.num_ops,
            "wall_s": round(self.wall_s, 6),
        }

    def format(self) -> str:
        where = ""
        if self.peak_op_index is not None:
            where = f" at op#{self.peak_op_index} {self.peak_op_type}"
            if self.peak_callsite:
                where += f" ({self.peak_callsite})"
        lines = [
            f"memory plan: peak {fmt_bytes(self.peak_bytes)}/device"
            f"{where} over {self.num_devices} device(s)",
            "  breakdown: " + "  ".join(
                f"{k} {fmt_bytes(v)}" for k, v in self.breakdown.items()),
        ]
        for t in self.top[:8]:
            lines.append(f"  live: {t['name']:<28} "
                         f"{fmt_bytes(t['bytes']):>10}  {t['kind']}")
        if self.unsized:
            lines.append(f"  unsized ({len(self.unsized)}): "
                         + ", ".join(u["name"] for u in self.unsized[:6]))
        return "\n".join(lines)


class PredictedOOMError(RuntimeError):
    """Raised by ``Executor(memory_budget=...)`` before a program's first
    run (or capture) when the static plan's per-device peak exceeds the
    budget.  Carries
    the M501 :class:`Diagnostic` and the full :class:`MemoryPlan`."""

    def __init__(self, plan: MemoryPlan, budget: int,
                 diagnostic: Optional[Diagnostic] = None):
        self.plan = plan
        self.budget = budget
        self.diagnostic = diagnostic or _oom_diagnostic(plan, budget)
        super().__init__(self.diagnostic.format())


def _oom_diagnostic(plan: MemoryPlan, budget: int) -> Diagnostic:
    top3 = ", ".join(f"{t['name']} ({fmt_bytes(t['bytes'])}, {t['kind']})"
                     for t in plan.top[:3])
    return Diagnostic(
        code="M501",
        message=(f"predicted per-device peak {fmt_bytes(plan.peak_bytes)} "
                 f"exceeds the memory budget {fmt_bytes(budget)} "
                 f"({plan.num_devices} device(s)) — top live tensors: "
                 f"{top3}"),
        op_index=plan.peak_op_index, op_type=plan.peak_op_type,
        var=plan.top[0]["name"] if plan.top else None,
        callsite=plan.peak_callsite)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_memory(program, *, fetch_list: Optional[Sequence] = None,
                feed_names: Optional[Iterable[str]] = None,
                feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                mesh=None, layout=None, donate_feeds: bool = False,
                batch: Optional[int] = None, top_k: int = 8,
                x64: bool = False) -> MemoryPlan:
    """Statically estimate the per-device live-set byte profile of
    ``program`` (a framework Program or raw ProgramDesc).

    ``feed_shapes`` maps feed name -> concrete shape (the executor passes
    the batch's shapes; offline callers can take them from a program
    dump).  Unknown feed batch dims fall back to ``batch`` (or 1, recorded
    in ``plan.dynamic``).  ``mesh`` is a plain ``{axis: size}`` dict;
    ``layout`` an object with the JAX package's ``SpecLayout``
    interface.
    """
    t0 = time.perf_counter()
    desc: ProgramDesc = getattr(program, "desc", program)
    fetch_names = [getattr(f, "name", f) for f in (fetch_list or [])]

    plan = MemoryPlan(donate_feeds=donate_feeds,
                      program_fp=desc.fingerprint()[:12])
    if any(op.type in _CSP_OPS for b in desc.blocks for op in b.ops):
        # CSP programs run host-interpreted op by op — no whole-block
        # residency to plan
        plan.wall_s = time.perf_counter() - t0
        return plan

    # mesh / layout resolution (only the axis-size dict is used)
    mesh_shape = _mesh_shape(mesh)
    if mesh_shape is None and layout is not None:
        mesh_shape = {str(k): int(v)
                      for k, v in (layout.mesh_axes or {}).items()
                      if int(v) > 0}
    shim = _MeshShim(mesh_shape) if mesh_shape else None
    if layout is not None and shim is not None:
        batch_axes = tuple(layout.batch_axes(shim))
        plan.layout_fp = layout.fingerprint()[:12]
    elif mesh_shape:
        batch_axes = tuple(a for a in ("data", "fsdp") if a in mesh_shape)
    else:
        batch_axes = ()
    plan.mesh = mesh_shape
    plan.num_devices = max(1, _prod(mesh_shape.values()) if mesh_shape
                           else 1)

    # scratch clone: feed-shape resolution + InferShape propagation must
    # not mutate the caller's descs
    scratch = desc.clone()
    block = scratch.block(0)
    facts = _BlockFacts(block)
    n_ops = len(block.ops)
    plan.num_ops = n_ops

    feeds: Set[str] = set(feed_names) if feed_names is not None \
        else facts.feed_like()
    for i, op in enumerate(block.ops):
        if op.type == "read":      # py_reader outputs are executor-bound
            feeds.update(facts.writes[i])

    batch_hint = int(batch) if batch else 0
    for n, sh in (feed_shapes or {}).items():
        vd = block.find_var(n)
        if vd is not None:
            vd.shape = tuple(int(d) for d in sh)
        if not batch_hint and len(sh) and int(sh[0]) > 0:
            batch_hint = int(sh[0])
    for n in sorted(feeds):
        vd = block.find_var(n)
        if vd is not None and vd.shape and int(vd.shape[0]) < 0:
            plan.dynamic.append(n)
            vd.shape = (batch_hint or 1,) + tuple(vd.shape[1:])

    # re-propagate shapes so derived activations pick the resolved feed
    # dims (ops without a registered rule keep their declared shapes; a
    # rule failure falls back to the declaration too)
    for b in scratch.blocks:
        for op in b.ops:
            fn = OPS.infer_shape_fn(op.type)
            if fn is None:
                continue
            try:
                fn(b, op)
            except Exception:  # noqa: BLE001 — declared shapes remain
                pass

    # dead-op ledger (the D204 slice — core/prune.live_op_slice with
    # fetches + persisted writes as roots): a dead op's output held live
    # at the peak is the M502 class the dead-op-elimination pass fixes
    if fetch_names:
        roots: Set[str] = set(fetch_names)
        for i in range(n_ops):
            for n in facts.writes[i]:
                vd = block.find_var(n)
                if vd is not None and vd.persistable:
                    roots.add(n)
        keep_idx, _live = _prune.live_op_slice(block, roots)
        kept = set(keep_idx)
        for i, op in enumerate(block.ops):
            if i in kept or op.type in _EFFECT_OPS:
                continue
            plan.dead_ops.append(i)
            plan.dead_outputs.extend(n for n in facts.writes[i] if n)

    # per-feed donation stamps (DONATE_ATTR, written by the
    # donation-insertion pass): a stamped feed is planned as donated
    # even when the run-wide donate_feeds flag is off
    for n in sorted(feeds):
        vd = block.find_var(n)
        if vd is not None and vd.attrs.get(DONATE_ATTR):
            plan.donated_feeds.append(n)

    # ------------------------------------------------------------- sizing
    producer: Dict[str, int] = facts.producer

    def resolve_spec(name: str, vd) -> Optional[list]:
        spec = vd.attrs.get("sharding")
        if spec is not None:
            return list(spec)
        if layout is not None and shim is not None:
            if vd.persistable:
                try:
                    return layout.spec_for(
                        name, vd.shape, shim,
                        slot_of=vd.attrs.get("slot_of"),
                        param_lookup=block.find_var,
                        role=vd.attrs.get("layout_role"))
                except Exception:  # noqa: BLE001 — replicate on failure
                    return None
            if is_grad_var_name(name):
                # a parameter gradient lands on its parameter's spec
                # (fsdp reduce-scatter / ZeRO); activation grads fall
                # through to the batch rule below
                base = block.find_var(strip_grad_suffix(name))
                if base is not None and base.persistable:
                    try:
                        return layout.spec_for(
                            strip_grad_suffix(name), base.shape, shim,
                            param_lookup=block.find_var,
                            role=base.attrs.get("layout_role"))
                    except Exception:  # noqa: BLE001
                        return None
        if not vd.persistable and batch_axes and len(vd.shape) >= 1:
            d0 = int(vd.shape[0]) if vd.shape else 0
            if name in feeds or (batch_hint and d0 == batch_hint):
                # feeds and batch-carried activations shard dim 0 over
                # the (data, fsdp) axes — the executor's feed sharding
                # and GSPMD's batch propagation
                return [tuple(batch_axes)]
        return None

    def device_bytes_of(shape, spec, itemsize: int) -> Tuple[int, int]:
        """(bytes per device, per-device padding waste) under ``spec``
        with ceil-division per sharded dim (every shard is padded)."""
        per = 1
        exact = 1.0
        for ax, d in enumerate(shape):
            d = int(d)
            div = 1
            if spec is not None and ax < len(spec) and spec[ax] is not None:
                entry = spec[ax]
                axes = entry if isinstance(entry, (list, tuple)) \
                    else (entry,)
                div = _prod(mesh_shape.get(str(a), 1) for a in axes) \
                    if mesh_shape else 1
            per *= -(-d // div) if div > 1 else d
            exact *= d / div if div > 1 else d
        per_b = per * itemsize
        return per_b, max(0, per_b - int(exact * itemsize))

    referenced: Set[str] = set(fetch_names) | feeds
    for i in range(n_ops):
        referenced.update(facts.reads[i])
        referenced.update(facts.writes[i])

    for name, vd in block.vars.items():
        if vd.type in _NON_TENSOR or vd.type == VarType.TENSOR_ARRAY:
            continue
        if name not in referenced:
            continue  # dead declaration — contributes nothing (D205)
        shape = tuple(int(d) for d in vd.shape)
        if any(d == 0 for d in shape):
            continue  # XShape-style compile-time artifacts, never buffers
        kind = ("persistent" if vd.persistable
                else "feed" if name in feeds
                else "output" if name in fetch_names else "activation")
        dynamic = any(d < 0 for d in shape)
        spec = resolve_spec(name, vd)
        hint = vd.attrs.get(MEM_HINT_ATTR)
        if dynamic and hint is None:
            p = producer.get(name)
            p_op = block.ops[p] if p is not None else None
            # feeds (incl. read-op outputs) are runtime-bound: their
            # dynamism is the R401 bucketing story, not a sizing gap
            if p_op is not None and name not in feeds \
                    and p_op.type not in _DECL_OPS \
                    and not _seq_side_channel(name) \
                    and OPS.infer_shape_fn(p_op.type) is None:
                # the producing op has no shape rule: a coverage gap the
                # estimator cannot see through (M504) — dynamism
                # inherited from feeds through covered rules is just
                # under-resolved
                plan.unsized.append({
                    "name": name, "shape": list(shape), "op": p_op.type,
                    "op_index": p, "callsite": p_op.callsite})
            plan.dynamic.append(name)
        if dynamic and hint is not None:
            total = int(hint)
            dev_b = -(-total // _shard_div(spec, mesh_shape))
            pad_b = 0
        else:
            resolved = tuple(d if d > 0
                             else (batch_hint or 1) if ax == 0 else 1
                             for ax, d in enumerate(shape))
            itemsize = _itemsize(vd.dtype, x64=x64)
            dev_b, pad_b = device_bytes_of(resolved, spec, itemsize)
            total = _prod(resolved) * itemsize
        plan.tensors[name] = TensorPlan(
            name=name, kind=kind, shape=shape,
            dtype=getattr(vd.dtype, "value", str(vd.dtype)),
            total_bytes=total, device_bytes=dev_b, pad_bytes=pad_b,
            spec=spec, dynamic=dynamic)
        plan.pad_bytes += pad_b

    # ----------------------------------------------------------- liveness
    last_use: Dict[str, int] = {}
    for i in range(n_ops):
        for n in facts.reads[i]:
            last_use[n] = i
        for n in facts.writes[i]:
            last_use[n] = i
    end_idx = max(0, n_ops - 1)

    persistent_total = 0
    delta = [0] * (n_ops + 2)
    for t in plan.tensors.values():
        t.last_use = last_use.get(t.name)
        if t.kind == "persistent":
            persistent_total += t.device_bytes
            t.start, t.end = 0, end_idx
            continue
        if t.kind == "feed":
            t.start = 0
            donated = donate_feeds or t.name in plan.donated_feeds
            t.end = (t.last_use if donated and t.last_use is not None
                     else end_idx)
            plan.feed_bytes += t.device_bytes
        elif t.kind == "output":
            t.start = producer.get(t.name, 0)
            t.end = end_idx
            plan.output_bytes += t.device_bytes
        else:
            p = producer.get(t.name)
            if p is None:
                # read but never produced (scope-resolved): held like an
                # argument for the whole execution
                t.start, t.end = 0, end_idx
            else:
                t.start = p
                t.end = t.last_use if t.last_use is not None else p
        if n_ops:
            delta[t.start] += t.device_bytes
            delta[t.end + 1] -= t.device_bytes
    plan.persistent_bytes = persistent_total

    # control-flow body locals fold into the parent op as workspace
    workspace = [0] * max(1, n_ops)
    for i, op in enumerate(block.ops):
        for aname in op.attrs:
            bidx = op.block_attr(aname)
            if bidx is not None:
                workspace[i] += _sub_block_peak(
                    scratch.blocks[bidx], mesh_shape, batch_axes,
                    batch_hint, x64)

    live = persistent_total
    peak = persistent_total
    peak_idx: Optional[int] = None
    timeline: List[int] = []
    for i in range(n_ops):
        live += delta[i]
        cur = live + workspace[i]
        timeline.append(cur)
        if cur > peak:
            peak, peak_idx = cur, i
    plan.timeline = timeline
    plan.peak_bytes = peak
    if peak_idx is None and n_ops:
        # all-persistent profile (startup programs): no op raises the
        # live set above the always-live state, but the diagnostic still
        # wants a callsite — attribute the peak to the op materializing
        # the largest persistent buffer
        biggest = max((t for t in plan.tensors.values()
                       if t.kind == "persistent"
                       and producer.get(t.name) is not None),
                      key=lambda t: t.device_bytes, default=None)
        if biggest is not None:
            peak_idx = producer[biggest.name]
    if peak_idx is not None:
        op = block.ops[peak_idx]
        plan.peak_op_index = peak_idx
        plan.peak_op_type = op.type
        plan.peak_callsite = op.callsite
        live_tensors = plan.live_at(peak_idx)
        plan.top = [{"name": t.name, "bytes": t.device_bytes,
                     "kind": t.kind, "shape": list(t.shape)}
                    for t in live_tensors[:top_k]]
        act = sum(t.device_bytes for t in live_tensors
                  if t.kind == "activation")
        fd = sum(t.device_bytes for t in live_tensors if t.kind == "feed")
        out = sum(t.device_bytes for t in live_tensors
                  if t.kind == "output")
        plan.breakdown = {"persistent": persistent_total, "feeds": fd,
                          "activations": act, "outputs": out,
                          "workspace": workspace[peak_idx]}
    else:
        plan.top = [{"name": t.name, "bytes": t.device_bytes,
                     "kind": t.kind, "shape": list(t.shape)}
                    for t in sorted(plan.tensors.values(),
                                    key=lambda t: -t.device_bytes)[:top_k]]
        plan.breakdown = {"persistent": persistent_total, "feeds": 0,
                          "activations": 0, "outputs": 0, "workspace": 0}
    plan.wall_s = time.perf_counter() - t0
    return plan


def plan_state_memory(var_table: Dict[str, dict], *, mesh=None,
                      layout=None, top_k: int = 8) -> MemoryPlan:
    """Persistent-state-only plan from a var TABLE instead of a program:
    ``{name: {"shape": [...], "dtype": "float32", "slot_of": ...,
    "spec": ...}}`` — the shape of a checkpoint manifest's ``vars``.

    This is the restore-fit estimate when no program is available (a
    checkpoint manager's restore fit): each var's global shape divided
    by the spec the TARGET layout assigns it (explicit ``spec`` entries
    recorded in the table describe the SOURCE topology and are ignored;
    ``slot_of`` slot inheritance applies as in :func:`plan_memory`).
    The returned plan has no activation/feed story — ``peak_bytes`` IS
    the persistent footprint, a lower bound on the true restore peak."""
    t0 = time.perf_counter()
    from ..checkpoint.manifest import _MetaVarDesc, device_bytes

    mesh_shape = _mesh_shape(mesh)
    if mesh_shape is None and layout is not None:
        mesh_shape = {str(k): int(v)
                      for k, v in (layout.mesh_axes or {}).items()
                      if int(v) > 0}
    shim = _MeshShim(mesh_shape) if mesh_shape else None

    def find_row(name):
        m = var_table.get(name)
        return _MetaVarDesc(m) if m is not None else None

    plan = MemoryPlan(mesh=mesh_shape)
    plan.num_devices = max(1, _prod(mesh_shape.values()) if mesh_shape
                           else 1)
    if layout is not None:
        plan.layout_fp = layout.fingerprint()[:12]
    for name, meta in var_table.items():
        shape = tuple(int(d) for d in meta.get("shape") or ())
        spec = None
        if layout is not None and shim is not None:
            try:
                spec = layout.spec_for(name, shape, shim,
                                       slot_of=meta.get("slot_of"),
                                       param_lookup=find_row,
                                       role=meta.get("role"))
            except Exception:  # noqa: BLE001 — replicate on failure
                spec = None
        b = device_bytes(shape, meta.get("dtype", "float32"), spec,
                         mesh_shape)
        total = _prod(shape) * _itemsize(meta.get("dtype", "float32"))
        plan.tensors[name] = TensorPlan(
            name=name, kind="persistent", shape=shape,
            dtype=str(meta.get("dtype", "float32")), total_bytes=total,
            device_bytes=b, spec=spec)
        plan.persistent_bytes += b
    plan.peak_bytes = plan.persistent_bytes
    plan.breakdown = {"persistent": plan.persistent_bytes}
    plan.top = [t.to_dict() for t in sorted(
        plan.tensors.values(), key=lambda t: -t.device_bytes)[:top_k]]
    plan.wall_s = time.perf_counter() - t0
    return plan


def _shard_div(spec, mesh_shape) -> int:
    if spec is None or not mesh_shape:
        return 1
    div = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, (list, tuple)) else (entry,)
        div *= _prod(mesh_shape.get(str(a), 1) for a in axes)
    return max(1, div)


def _sub_block_peak(block: BlockDesc, mesh_shape, batch_axes,
                    batch_hint: int, x64: bool) -> int:
    """Per-device peak of the vars *local* to a control-flow body (loop
    carries / branch temps) — outer reads are already live in the parent
    sweep.  Nested bodies fold recursively."""
    n_ops = len(block.ops)
    if n_ops == 0:
        return 0
    local = set(block.vars)
    first: Dict[str, int] = {}
    last: Dict[str, int] = {}
    nested = [0] * n_ops
    for i, op in enumerate(block.ops):
        for n in op.input_names() + op.output_names():
            if n in local:
                last[n] = i
        for n in op.output_names():
            if n in local:
                first.setdefault(n, i)
        for aname in op.attrs:
            bidx = op.block_attr(aname)
            if bidx is not None:
                nested[i] += _sub_block_peak(
                    block.program.blocks[bidx], mesh_shape, batch_axes,
                    batch_hint, x64)
    delta = [0] * (n_ops + 1)
    for n, s in first.items():
        vd = block.vars.get(n)
        if vd is None or vd.type in _NON_TENSOR \
                or vd.type == VarType.TENSOR_ARRAY:
            continue
        shape = tuple(int(d) for d in vd.shape)
        if any(d == 0 for d in shape):
            continue
        resolved = tuple(d if d > 0 else (batch_hint or 1) if ax == 0
                         else 1 for ax, d in enumerate(shape))
        b = _prod(resolved) * _itemsize(vd.dtype, x64=x64)
        if batch_axes and mesh_shape and resolved \
                and batch_hint and resolved[0] == batch_hint:
            b = -(-b // _prod(mesh_shape.get(a, 1) for a in batch_axes))
        delta[s] += b
        delta[last.get(n, s) + 1] -= b
    live = peak = 0
    for i in range(n_ops):
        live += delta[i]
        peak = max(peak, live + nested[i])
    return peak


# ---------------------------------------------------------------------------
# M5xx diagnostics
# ---------------------------------------------------------------------------

#: a held-past-last-use buffer must dominate at least this share of the
#: peak's FREEABLE portion (everything but the always-live persistent
#: state), with an absolute floor — tiny buffers are never worth a
#: diagnostic, but a big persistent footprint must not mask a freeable one
_HELD_SHARE = 0.05
_HELD_FLOOR = 64 * 1024
#: per-device padding waste share of the peak that trips M505
_PAD_SHARE = 0.10


def memory_diagnostics(plan: MemoryPlan, *, budget=None,
                       donate_feeds: bool = False) -> List[Diagnostic]:
    """The M5xx family over one plan: M501 predicted-OOM (only when a
    ``budget`` is given), M502 peak-dominating held-past-last-use var,
    M503 donation opportunity, M504 unsized-var coverage gaps, M505
    per-device layout imbalance."""
    diags: List[Diagnostic] = []
    if budget is not None:
        budget_b = parse_memory_budget(budget)
        if plan.peak_bytes > budget_b:
            diags.append(_oom_diagnostic(plan, budget_b))

    floor = max(_HELD_FLOOR,
                int((plan.peak_bytes - plan.persistent_bytes)
                    * _HELD_SHARE))
    if plan.peak_op_index is not None:
        dead_outputs = set(plan.dead_outputs)
        for t in plan.live_at(plan.peak_op_index):
            if t.kind == "persistent" or t.device_bytes < floor:
                continue
            if t.kind == "activation" and t.name in dead_outputs:
                # produced by a D204-dead op and holding bytes at the
                # peak: the dead-op-elimination pass frees it outright
                diags.append(Diagnostic(
                    code="M502",
                    message=(
                        f"op output {t.name!r} "
                        f"({fmt_bytes(t.device_bytes)}/device) is "
                        f"produced by a dead op (contributes to no fetch "
                        f"target or persisted state) yet holds bytes at "
                        f"the peak at op#{plan.peak_op_index} — dead-op "
                        f"elimination (pass 'dead-op-elim') would free "
                        f"it"),
                    var=t.name, op_index=plan.peak_op_index,
                    op_type=plan.peak_op_type,
                    callsite=plan.peak_callsite))
                continue
            # held to the end by the runtime, but statically dead before
            # the peak: freeing it (donation / fetch-list hygiene) cuts
            # the peak by its full size
            if t.last_use is None or t.last_use >= plan.peak_op_index:
                continue
            if t.kind == "feed" and not donate_feeds \
                    and t.name not in plan.donated_feeds:
                diags.append(Diagnostic(
                    code="M503",
                    message=(
                        f"feed buffer {t.name!r} "
                        f"({fmt_bytes(t.device_bytes)}/device) is dead "
                        f"after op#{t.last_use} but held through the "
                        f"peak at op#{plan.peak_op_index} — donating it "
                        f"(run(donate_feeds=True)) would cut the "
                        f"predicted peak to "
                        f"{fmt_bytes(plan.peak_bytes - t.device_bytes)}"),
                    var=t.name, op_index=plan.peak_op_index,
                    op_type=plan.peak_op_type,
                    callsite=plan.peak_callsite))
            elif t.kind == "output":
                diags.append(Diagnostic(
                    code="M502",
                    message=(
                        f"fetch target {t.name!r} "
                        f"({fmt_bytes(t.device_bytes)}/device) is last "
                        f"used at op#{t.last_use} but held live through "
                        f"the peak at op#{plan.peak_op_index} — "
                        f"dropping it from the fetch list would free it "
                        f"before the peak"),
                    var=t.name, op_index=plan.peak_op_index,
                    op_type=plan.peak_op_type,
                    callsite=plan.peak_callsite))

    for u in plan.unsized[:8]:
        diags.append(Diagnostic(
            code="M504",
            message=(f"cannot size var {u['name']!r} (shape "
                     f"{tuple(u['shape'])}): producing op {u['op']!r} has "
                     f"no registered infer_shape rule — extend "
                     f"ops/shape_infer.py or set the "
                     f"'{MEM_HINT_ATTR}' var attr"),
            op_index=u.get("op_index"), op_type=u.get("op"),
            var=u["name"], callsite=u.get("callsite")))

    if plan.num_devices > 1 and plan.peak_bytes > 0 \
            and plan.pad_bytes > max(1024, plan.peak_bytes * _PAD_SHARE):
        worst = sorted((t for t in plan.tensors.values() if t.pad_bytes),
                       key=lambda t: -t.pad_bytes)[:3]
        names = ", ".join(f"{t.name} (+{fmt_bytes(t.pad_bytes)})"
                          for t in worst)
        diags.append(Diagnostic(
            code="M505",
            message=(f"per-device shard padding wastes "
                     f"{fmt_bytes(plan.pad_bytes)} "
                     f"({plan.pad_bytes * 100 // max(1, plan.peak_bytes)}"
                     f"% of the predicted peak) under this layout — "
                     f"worst: {names}"),
            var=worst[0].name if worst else None))
    return diags


# ---------------------------------------------------------------------------
# export (memplan_<pid>.jsonl — read by tools/stats.py,
# tools/compile_report.py and tools/memory_report.py)
# ---------------------------------------------------------------------------

def export_plan(plan: MemoryPlan, out_dir: Optional[str] = None,
                **extra) -> Optional[str]:
    """Append one JSONL record to ``memplan_<pid>.jsonl`` under the
    telemetry dir — the plan-side input of the plan-vs-actual rendering
    in the reader tools."""
    out_dir = out_dir or os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    if not out_dir:
        return None
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"memplan_{os.getpid()}.jsonl")
        rec = dict(plan.to_dict(), ts=time.time(), pid=os.getpid(), **extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path
    except OSError:
        return None  # telemetry must never fail a plan
