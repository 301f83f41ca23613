"""Whole-program static verifier over the ProgramDesc IR: a copy of the
JAX package's ``analysis/verifier.py`` (pure desc walks, stdlib only).

Four checker families, the JAX package's codes (diagnostics.CATALOG):

* **shapes** (S1xx) -- re-propagates shapes and dtypes through every
  block with the registry's infer-shape rules on a scratch clone and flags
  disagreements with the declared descs;
* **dataflow** (D2xx) -- use-before-def (across control-flow block
  boundaries too), undefined vars, fetch reachability, dead ops and vars
  (``core.prune.live_op_slice``, the slice inference pruning uses) and
  trainable parameters written outside the optimizer;
* **donation** (A3xx) -- a fed var written in the program, and a read of
  a parameter after its in-place update;
* **hazards** (R4xx) -- feeds with dynamic non-batch dims and no
  bucketing, and sharding annotations against a mesh.  ``mesh=`` is a
  ``parallel.mesh.Mesh`` (or the plain ``{axis: size}`` dict a mesh
  reduces to), and ``layout=`` a ``parallel.SpecLayout`` (or any object
  with its ``mesh_axes``, ``spec_for`` and ``fingerprint``);

plus the memory planner's M5xx family (analysis/memory.py).

Entry point: :func:`verify`.  Each pass counts into the port's telemetry
registry (``"analysis"`` scope: ``programs_verified``,
``diagnostics_<severity>``, the ``verify_s`` histogram, and
``validate_findings`` through :func:`record_findings`) and, with
``PADDLE_TPU_TELEMETRY_DIR`` set, appends to ``analysis_<pid>.jsonl``.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core import prune as _prune
from ..core.desc import (BlockDesc, OpDesc, ProgramDesc, VarType,
                         block_outer_reads, block_written_names)
from ..core.registry import OPS
from .diagnostics import Diagnostic, VerifyResult, export_result

ALL_CHECKS = ("shapes", "dataflow", "donation", "hazards", "memory")

#: declaration ops whose bindings the executor provides
_DECL_OPS = frozenset({"feed", "fetch", "read"})

#: CSP/concurrency coordination ops -- host constructs over RAW channel
#: vars, whose channel dataflow is not tensor dataflow
_CSP_OPS = frozenset({"channel_create", "channel_send", "channel_recv",
                      "channel_close", "go", "select"})

#: op types with side effects beyond their declared tensor outputs —
#: never reported dead even when no fetch depends on them
_EFFECT_OPS = frozenset({"save", "save_combine", "load", "load_combine",
                         "print", "while", "conditional_block",
                         "listen_and_serv", "send_barrier", "fetch_barrier",
                         "distributed_table_push"}) | _CSP_OPS | _DECL_OPS

#: var types that hold host objects, not tensors — excluded from tensor
#: dataflow (the executor binds them through the Scope directly)
_NON_TENSOR = frozenset({VarType.READER, VarType.RAW, VarType.STEP_SCOPES})

#: op roles whose parameter writes/reads are framework-managed data flow
#: (optimizer pipeline, and the distribute transpiler's param-slice
#: reassembly ops, which legitimately concat received slices into params)
_OPTIMIZER_ROLES = ("optimize", "backward", "lr_sched", "dist")

#: the most recent non-info findings of this process, for error messages
LAST_FINDINGS: List[Diagnostic] = []
_LAST_FINDINGS_CAP = 64


def _telemetry():
    from ..telemetry import REGISTRY
    return REGISTRY


def _seq_side_channel(name: str) -> bool:
    return "@SEQ_LEN" in name


class _BlockFacts:
    """Per-block effective reads/writes with sub-block effects folded into
    the parent op (while/cond declare X/Out, but this recomputation also
    covers desc-level rewrites that under-declare)."""

    def __init__(self, block: BlockDesc):
        self.block = block
        self.reads: List[List[str]] = []
        self.writes: List[List[str]] = []
        for op in block.ops:
            r = [n for n in op.input_names() if n]
            w = [n for n in op.output_names() if n]
            for aname in op.attrs:
                bidx = op.block_attr(aname)
                if bidx is not None:
                    sub = block.program.blocks[bidx]
                    r += [n for n in block_outer_reads(sub)
                          if n not in sub.vars]
                    w += [n for n in block_written_names(sub)
                          if n not in sub.vars]
            self.reads.append(list(dict.fromkeys(r)))
            self.writes.append(list(dict.fromkeys(w)))
        # first producing op index per name
        self.producer: Dict[str, int] = {}
        for i, ws in enumerate(self.writes):
            for n in ws:
                self.producer.setdefault(n, i)

    def feed_like(self) -> Set[str]:
        """Vars this block reads that nothing produces and the scope does
        not persist — exactly what the executor resolves from the feed
        dict (or the scope) at run time."""
        out: Set[str] = set()
        for rs in self.reads:
            for n in rs:
                if n in self.producer or _seq_side_channel(n):
                    continue
                vd = self.block.find_var(n)
                if vd is not None and not vd.persistable \
                        and vd.type not in _NON_TENSOR:
                    out.add(n)
        return out


def verify(program, *, fetch_list: Optional[Sequence] = None,
           feed_names: Optional[Iterable[str]] = None,
           mesh=None, layout=None, donate_feeds: bool = False,
           memory_budget=None,
           feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
           checks: Sequence[str] = ALL_CHECKS) -> VerifyResult:
    """Statically verify ``program`` (a framework Program or a raw
    ProgramDesc).  Returns a :class:`VerifyResult`; raises nothing.

    ``fetch_list`` (names or Variables) enables fetch-reachability and
    dead-op/dead-var analysis; ``feed_names`` overrides feed inference;
    ``mesh`` (a ``parallel.mesh.Mesh`` or a plain ``{axis: size}`` dict)
    plus optional ``layout`` enable the sharding lint and the memory
    planner's per-device division.  ``memory_budget`` (bytes /
    size string / device profile, see analysis.memory) arms the M501
    predicted-OOM check; ``feed_shapes`` gives the planner concrete feed
    dims.
    """
    t0 = time.perf_counter()
    desc: ProgramDesc = getattr(program, "desc", program)
    fetch_names = [getattr(f, "name", f) for f in (fetch_list or [])]
    diags: List[Diagnostic] = []

    block0 = desc.block(0)
    facts = _BlockFacts(block0)
    feeds = set(feed_names) if feed_names is not None else facts.feed_like()

    if "dataflow" in checks:
        _check_dataflow(desc, facts, feeds, fetch_names, diags)
    if "shapes" in checks:
        _check_shapes(desc, diags)
    if "donation" in checks:
        _check_donation(facts, feeds, diags, donate_feeds=donate_feeds)
    if "hazards" in checks:
        _check_hazards(desc, facts, feeds, mesh, layout, diags)
    if "memory" in checks:
        _check_memory(desc, feeds, fetch_names, mesh, layout,
                      donate_feeds, memory_budget, feed_shapes, diags)

    res = VerifyResult(
        diagnostics=diags, program_fp=desc.fingerprint()[:12],
        num_blocks=desc.num_blocks(),
        num_ops=sum(len(b.ops) for b in desc.blocks),
        wall_s=time.perf_counter() - t0, checks=tuple(checks))

    reg = _telemetry()
    reg.counter("programs_verified", scope="analysis").inc()
    for sev, n in res.counts().items():
        if n:
            reg.counter(f"diagnostics_{sev}", scope="analysis").inc(n)
    reg.histogram("verify_s", scope="analysis").observe(res.wall_s)
    export_result(res)
    return res


# ---------------------------------------------------------------------------
# checker helpers
# ---------------------------------------------------------------------------

def _diag(diags: List[Diagnostic], code: str, message: str,
          block: Optional[BlockDesc] = None, op_index: Optional[int] = None,
          op: Optional[OpDesc] = None, var: Optional[str] = None):
    diags.append(Diagnostic(
        code=code, message=message,
        block_idx=block.idx if block is not None else 0,
        op_index=op_index,
        op_type=op.type if op is not None else None,
        var=var,
        callsite=op.callsite if op is not None else None))


# ------------------------------------------------------------------ dataflow

def _check_dataflow(desc: ProgramDesc, facts: _BlockFacts, feeds: Set[str],
                    fetch_names: List[str], diags: List[Diagnostic]):
    block = facts.block
    if any(op.type in _CSP_OPS for b in desc.blocks for op in b.ops):
        # CSP programs run interpreted with host channel rendezvous;
        # tensor dataflow order does not apply
        return

    defined: Set[str] = set()
    for i, op in enumerate(block.ops):
        if op.type in _DECL_OPS:
            defined.update(facts.writes[i])
            continue
        for n in facts.reads[i]:
            _check_read(block, op, i, n, defined, facts.producer, feeds,
                        diags)
        # recurse into sub-blocks with the outer names available *at this
        # position* — a sub-block read of an outer var defined only later
        # is a use-before-def across the block boundary
        for aname in op.attrs:
            bidx = op.block_attr(aname)
            if bidx is not None:
                _check_sub_block(desc.blocks[bidx], set(defined),
                                 facts.producer, i, feeds, diags)
        defined.update(facts.writes[i])

    # fetch-list reachability: every fetch target must be persistable,
    # produced by some (possibly sub-block) op, or an actual feed
    for n in fetch_names:
        if _seq_side_channel(n):
            continue  # lengths side channel, bound by the fetch path
        vd = block.find_var(n)
        if vd is None:
            _diag(diags, "D203", f"fetch target {n!r} is not a variable of "
                                 f"this program", block=block, var=n)
        elif not (vd.persistable or n in facts.producer or n in feeds):
            _diag(diags, "D203", f"fetch target {n!r} is declared but no op "
                                 f"produces it and it is not fed",
                  block=block, var=n)

    _check_liveness(block, facts, feeds, fetch_names, diags)
    _check_param_clobber(block, facts, diags)


def _check_read(block: BlockDesc, op: OpDesc, i: int, n: str,
                defined: Set[str], producer: Dict[str, int],
                feeds: Set[str], diags: List[Diagnostic]):
    if _seq_side_channel(n):
        return  # lengths side channel, bound by the feed path
    vd = block.find_var(n)
    if vd is None:
        _diag(diags, "D202", f"op reads {n!r} which is not declared in "
                             f"this block or any ancestor",
              block=block, op_index=i, op=op, var=n)
        return
    if vd.persistable or vd.type in _NON_TENSOR or n in defined \
            or n in feeds:
        return
    p = producer.get(n)
    if p is not None and p >= i:
        _diag(diags, "D201",
              f"op reads {n!r} before it is produced (first producer is "
              f"op#{p} {block.ops[p].type})",
              block=block, op_index=i, op=op, var=n)
    elif p is None:
        # no producer, not persistable, not inferred as a feed: only
        # possible when feed names were given explicitly and exclude it
        _diag(diags, "D201",
              f"op reads {n!r} which is never produced, not persistable "
              f"and not fed", block=block, op_index=i, op=op, var=n)


def _check_sub_block(sub: BlockDesc, outer_avail: Set[str],
                     outer_producer: Dict[str, int], parent_idx: int,
                     feeds: Set[str], diags: List[Diagnostic]):
    """Use-before-def inside a control-flow body.  Vars *declared in* the
    sub-block are bound by the control-flow lowering (loop carries /
    branch-local temps) and exempt; outer reads must be available before
    the parent op."""
    local: Set[str] = set(sub.vars.keys())
    for j, op in enumerate(sub.ops):
        for n in [x for x in op.input_names() if x]:
            if _seq_side_channel(n) or n in local or n in outer_avail \
                    or n in feeds:
                continue
            vd = sub.find_var(n)
            if vd is None:
                _diag(diags, "D202",
                      f"op reads {n!r} which is not declared in this "
                      f"block or any ancestor", block=sub, op_index=j,
                      op=op, var=n)
                continue
            if vd.persistable or vd.type in _NON_TENSOR:
                continue
            p = outer_producer.get(n)
            if p is None or p >= parent_idx:
                where = (f"first produced by outer op#{p}"
                         if p is not None else "never produced outside")
                _diag(diags, "D201",
                      f"control-flow body reads outer var {n!r} before "
                      f"the enclosing op at block 0 op#{parent_idx} "
                      f"({where}) — use-before-def across the block "
                      f"boundary", block=sub, op_index=j, op=op, var=n)
        for aname in op.attrs:
            bidx = op.block_attr(aname)
            if bidx is not None:
                _check_sub_block(sub.program.blocks[bidx],
                                 outer_avail | local, outer_producer,
                                 parent_idx, feeds, diags)
        local.update(n for n in op.output_names() if n)


def _check_liveness(block: BlockDesc, facts: _BlockFacts, feeds: Set[str],
                    fetch_names: List[str], diags: List[Diagnostic]):
    """Dead ops/vars via the SAME backward slice inference pruning uses
    (core.prune.live_op_slice) — info severity: dead code is legal, but
    the executor runs it every step."""
    if not fetch_names:
        return
    # anything that updates persisted state is a root, like a fetch
    roots = set(fetch_names)
    for i, op in enumerate(block.ops):
        for n in facts.writes[i]:
            vd = block.find_var(n)
            if vd is not None and vd.persistable:
                roots.add(n)
    keep_idx, live = _prune.live_op_slice(block, roots)
    kept = set(keep_idx)
    for i, op in enumerate(block.ops):
        if i in kept or op.type in _EFFECT_OPS:
            continue
        outs = facts.writes[i][:1]
        _diag(diags, "D204",
              f"op contributes to no fetch target or persisted state "
              f"(inference pruning would drop it)", block=block,
              op_index=i, op=op, var=outs[0] if outs else None)
    referenced = live | feeds | set(fetch_names)
    for i in range(len(block.ops)):
        referenced.update(facts.reads[i])
        referenced.update(facts.writes[i])
    for n, vd in block.vars.items():
        if n in referenced or vd.persistable or vd.type in _NON_TENSOR \
                or _seq_side_channel(n):
            continue
        _diag(diags, "D205", f"var {n!r} is declared but no op or fetch "
                             f"references it", block=block, var=n)


def _check_param_clobber(block: BlockDesc, facts: _BlockFacts,
                         diags: List[Diagnostic]):
    """A trainable parameter written outside the optimizer pipeline
    (forward-role op with real inputs) is silent training corruption —
    the step would persist the clobber every iteration."""
    for i, op in enumerate(block.ops):
        if op.attrs.get("op_role") in _OPTIMIZER_ROLES \
                or op.type in _EFFECT_OPS:
            continue
        if not [n for n in op.input_names() if n]:
            continue  # initializers (fill/random/load) legitimately write
        for n in [x for x in op.output_names() if x]:
            vd = block.find_var(n)
            # trainable params only: running stats / quantize windows are
            # is_parameter state with stop_gradient=True, and their
            # forward-op in-place update is the designed data flow
            if vd is not None and vd.is_parameter and not vd.stop_gradient:
                _diag(diags, "D206",
                      f"non-optimizer op (role="
                      f"{op.attrs.get('op_role', 'forward')!r}) writes "
                      f"trainable parameter {n!r}", block=block,
                      op_index=i, op=op, var=n)


# -------------------------------------------------------------------- shapes

_WILDCARD = -1


def _dims_conflict(a, b) -> bool:
    if len(a) != len(b):
        return True
    return any(x > 0 and y > 0 and x != y for x, y in zip(a, b))


def _check_shapes(desc: ProgramDesc, diags: List[Diagnostic]):
    """Re-run compile-time InferShape over a scratch clone, block by block
    and op by op in program order, and compare the propagated shapes and
    dtypes with the declared descs.  Dynamic dims (<= 0) are wildcards;
    ops without a registered infer_shape are skipped (propagation trusts
    their declared outputs)."""
    scratch = desc.clone()
    for block in scratch.blocks:
        for i, op in enumerate(block.ops):
            fn = OPS.infer_shape_fn(op.type)
            if fn is None:
                continue
            declared = {}
            for n in op.output_names():
                vd = block.find_var(n) if n else None
                if vd is not None:
                    declared[n] = (tuple(vd.shape), vd.dtype)
            try:
                fn(block, op)
            except KeyError:
                continue  # missing var: the dataflow checker owns that
            except Exception as e:  # noqa: BLE001 — any infer failure
                _diag(diags, "S103",
                      f"InferShape raised {type(e).__name__}: {e}",
                      block=block, op_index=i, op=op,
                      var=next(iter(declared), None))
                continue
            for n, (shape, dtype) in declared.items():
                vd = block.find_var(n)
                if vd is None:
                    continue
                inferred = tuple(vd.shape)
                if shape and inferred and _dims_conflict(shape, inferred):
                    _diag(diags, "S101",
                          f"declared shape {tuple(shape)} of {n!r} "
                          f"disagrees with inferred {inferred}",
                          block=block, op_index=i, op=op, var=n)
                if dtype != vd.dtype:
                    _diag(diags, "S102",
                          f"declared dtype {dtype.value} of {n!r} "
                          f"disagrees with inferred {vd.dtype.value}",
                          block=block, op_index=i, op=op, var=n)


# ------------------------------------------------------------------ donation

def _check_donation(facts: _BlockFacts, feeds: Set[str],
                    diags: List[Diagnostic], donate_feeds: bool = False):
    """Aliasing safety for the executor's two donation classes:

    * feeds (``donate_feeds=True``, or a ``donate`` stamp): the staged
      buffer is given up to the step, so an in-program write to a fed var
      aliases the (possibly pooled) staging buffer — and any read after
      the write sees the clobber, not the batch.
    * in-place state: every var both read and written is updated in
      place; an optimizer update followed by a non-optimizer read
      silently observes the *updated* value.
    """
    block = facts.block
    for i, op in enumerate(block.ops):
        for n in facts.writes[i]:
            if n not in feeds:
                continue
            later_reads = any(n in facts.reads[j]
                              for j in range(i + 1, len(block.ops)))
            qual = ("the donated staged buffer" if donate_feeds
                    else "the feed buffer")
            tail = ("; a later op reads the clobbered value"
                    if later_reads else "")
            _diag(diags, "A301",
                  f"op writes fed var {n!r}, aliasing {qual}{tail}",
                  block=block, op_index=i, op=op, var=n)
    # donated in-place updates: optimizer writes param; later non-optimizer
    # op reads it → reads the post-update buffer
    for i, op in enumerate(block.ops):
        if op.attrs.get("op_role") not in ("optimize",):
            continue
        for n in facts.writes[i]:
            vd = block.find_var(n)
            if vd is None or not vd.persistable:
                continue
            for j in range(i + 1, len(block.ops)):
                reader = block.ops[j]
                if reader.attrs.get("op_role") in _OPTIMIZER_ROLES:
                    continue
                if n in facts.reads[j]:
                    _diag(diags, "A302",
                          f"op reads {n!r} after its donated in-place "
                          f"update by op#{i} ({op.type}) — it observes "
                          f"the post-update buffer", block=block,
                          op_index=j, op=reader, var=n)
                    break


# ------------------------------------------------------------------- hazards

def _mesh_shape(mesh) -> Optional[Dict[str, int]]:
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    shape = getattr(mesh, "shape", None)
    if shape is None:
        return None
    return {str(k): int(v) for k, v in dict(shape).items()}


class _MeshShim:
    """Duck-typed mesh for a layout's ``spec_for`` (only ``.shape`` is
    consulted), so the lint runs off a plain dict."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


def _check_hazards(desc: ProgramDesc, facts: _BlockFacts, feeds: Set[str],
                   mesh, layout, diags: List[Diagnostic]):
    block = facts.block

    # R401 — cache churn: a feed with a dynamic non-batch dim (ragged
    # time axis) builds one cache entry (a CUDA graph) per distinct length
    # unless bucketed; DataFeeder's bucketing stamp ('seq_len_buckets' var
    # attr) discharges the hazard, and so does a decode engine's
    # 'kv_cache_slots' stamp.  The feed-shape-change:<var> class
    # compile_log.diff_signatures reports after the fact.
    feed_vars = set(feeds)
    for i, op in enumerate(block.ops):
        if op.type == "read":
            feed_vars.update(facts.writes[i])
    for n in sorted(feed_vars):
        vd = block.find_var(n)
        if vd is None or _seq_side_channel(n):
            continue
        dyn = [ax for ax, d in enumerate(vd.shape) if ax > 0 and d < 0]
        if dyn and not vd.attrs.get("seq_len_buckets") \
                and not vd.attrs.get("kv_cache_slots"):
            _diag(diags, "R401",
                  f"feed {n!r} has dynamic non-batch dim(s) {dyn} of shape "
                  f"{tuple(vd.shape)} and no length bucketing — each "
                  f"distinct length compiles a fresh executable (pass "
                  f"seq_len_buckets='pow2' to DataFeeder/py_reader)",
                  block=block, var=n)

    # R402/R403/R404 — explicit sharding annotations vs the mesh
    shape_by_axis = _mesh_shape(mesh)
    if shape_by_axis is None and layout is not None:
        shape_by_axis = {str(k): int(v)
                         for k, v in (layout.mesh_axes or {}).items()
                         if int(v) > 0}
    if shape_by_axis:
        for b in desc.blocks:
            for n, vd in b.vars.items():
                spec = vd.attrs.get("sharding")
                if spec is None:
                    continue
                _lint_spec(b, n, tuple(vd.shape), spec, shape_by_axis,
                           diags)
        if layout is not None:
            _lint_layout(desc, layout, shape_by_axis, diags)


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (list, tuple)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def _lint_spec(block: BlockDesc, name: str, shape, spec,
               mesh_shape: Dict[str, int], diags: List[Diagnostic]):
    entries = list(spec) if spec is not None else []
    if len(entries) > len(shape):
        _diag(diags, "R403",
              f"sharding spec {spec!r} of {name!r} has rank "
              f"{len(entries)} but the var has rank {len(shape)}",
              block=block, var=name)
        return
    for ax, entry in enumerate(entries):
        axes = _spec_axes(entry)
        unknown = [a for a in axes if a not in mesh_shape]
        if unknown:
            _diag(diags, "R402",
                  f"sharding spec of {name!r} names mesh ax"
                  f"{'es' if len(unknown) > 1 else 'is'} {unknown} not "
                  f"present in the mesh {sorted(mesh_shape)}",
                  block=block, var=name)
            continue
        if not axes:
            continue
        prod = 1
        for a in axes:
            prod *= mesh_shape[a]
        dim = shape[ax]
        if dim > 0 and prod > 0 and dim % prod != 0:
            _diag(diags, "R404",
                  f"dim {ax} of {name!r} ({dim}) is not divisible by the "
                  f"{prod}-way sharding over {list(axes)} — every shard "
                  f"is padded (wasted device memory + skewed collectives)",
                  block=block, var=name)


def _lint_layout(desc: ProgramDesc, layout, mesh_shape: Dict[str, int],
                 diags: List[Diagnostic]):
    """SpecLayout self-consistency against the mesh: resolve every
    persistable var's spec as a layout-aware executor would and lint the
    result.  spec_for degrades by divisibility, so
    any surviving inconsistency is an explicit-annotation or rule bug."""
    shim = _MeshShim(mesh_shape)
    block = desc.block(0)
    for n, vd in block.vars.items():
        if not vd.persistable or vd.attrs.get("sharding") is not None:
            continue
        try:
            spec = layout.spec_for(n, vd.shape, shim,
                                   slot_of=vd.attrs.get("slot_of"),
                                   param_lookup=block.find_var,
                                   role=vd.attrs.get("layout_role"))
        except Exception as e:  # noqa: BLE001 — lint must not throw
            _diag(diags, "R403",
                  f"layout.spec_for({n!r}) raised {type(e).__name__}: {e}",
                  block=block, var=n)
            continue
        if spec is not None:
            _lint_spec(block, n, tuple(vd.shape), spec, mesh_shape, diags)


# -------------------------------------------------------------------- memory

def _check_memory(desc: ProgramDesc, feeds: Set[str],
                  fetch_names: List[str], mesh, layout,
                  donate_feeds: bool, memory_budget, feed_shapes,
                  diags: List[Diagnostic]):
    """Static memory planner pass (analysis/memory.py): per-device
    liveness byte profile + the M5xx family.  M501 only fires against an
    explicit ``memory_budget``; the planner itself must never break a
    verification pass."""
    from . import memory as _memory
    try:
        plan = _memory.plan_memory(
            desc, fetch_list=fetch_names, feed_names=feeds,
            feed_shapes=feed_shapes, mesh=mesh, layout=layout,
            donate_feeds=donate_feeds)
        diags.extend(_memory.memory_diagnostics(
            plan, budget=memory_budget, donate_feeds=donate_feeds))
    except Exception:  # noqa: BLE001 — an estimator bug must not turn
        pass           # a runnable program into a verification failure


def record_findings(result: VerifyResult):
    """Remember a validate pass's non-info findings (ring) and bump the
    ``validate_findings`` counter — the executor's warn/error modes call
    this."""
    findings = result.findings
    if not findings:
        return
    LAST_FINDINGS.extend(findings)
    del LAST_FINDINGS[:-_LAST_FINDINGS_CAP]
    _telemetry().counter("validate_findings", scope="analysis").inc(
        len(findings))
