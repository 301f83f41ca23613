"""Program-transformation pass pipeline over the ProgramDesc IR.

The port of the JAX package's ``paddle_tpu/passes/base.py``: ordered,
registered :class:`ProgramPass` rewrites of a ``ProgramDesc``, each
reporting a structured diff (:class:`PassResult`) and stamping the ops it
inserts with ``callsite``/``inserted_by`` provenance attrs (both scrubbed
from ``ProgramDesc.fingerprint()``).  :meth:`PassPipeline.fingerprint`
hashes the ordered pass names and their configs exactly as the JAX package
does, so equal pipelines fingerprint equally in both packages.

Pass names (``amp-quant-int8``, ``pallas-kernels``) and the op types the
passes write are part of the ProgramDesc, and the tests compare the
rewritten ProgramDescs of both packages, so they keep the JAX package's
names.

A pass that rewrites parameter *values* (``bn-fold``) sets
``requires_scope`` and reads and writes ``PassContext.scope``; a pipeline
run without a scope skips it.

Not ported yet:
* the analysis verifier that the JAX pipeline runs before and after every
  pass (``verify="error"``/``"warn"``): here those modes raise
  ``NotImplementedError`` and the pipelines the port builds use
  ``verify="off"`` (ROADMAP.md, queue A item 7);
* three of the four seed passes of ``default_pipeline``
  (``fuse-fc-softmax-ce``, ``dead-op-elim``, ``donation-insert``; the
  fourth, ``bn-fold``, is ported), so ``make_pipeline(True)`` raises.

Each pipeline run counts into the telemetry registry's ``"passes"`` scope
(``pipelines_run``, ``programs_rewritten``, ``ops_removed``,
``ops_added``) and, with ``PADDLE_TPU_TELEMETRY_DIR`` set, appends its
:class:`PipelineResult` to ``passes_<pid>.jsonl`` in the JAX package's
schema (the verifier's counts stay empty).  Telemetry never fails a
rewrite.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set

from ..core.desc import (CALLSITE_ATTR, PASS_PROVENANCE_ATTR, BlockDesc,
                         OpDesc, ProgramDesc)
from ..telemetry import REGISTRY

__all__ = [
    "PASSES", "PassContext", "PassPipeline", "PassResult", "PipelineResult",
    "ProgramPass", "default_pipeline", "export_pipeline_result", "make_pipeline",
    "register_pass",
]

_VERIFIER_MISSING = (
    "the analysis verifier is not ported yet (ROADMAP.md, queue A item 7: "
    "analysis and passes); build the pipeline with verify='off'")

# the seed passes of the JAX package's default pipeline still to port
_UNPORTED_SEED_PASSES = ("fuse-fc-softmax-ce", "dead-op-elim", "donation-insert")


def op_info(op: OpDesc) -> dict:
    """Compact op identity for structured diffs."""
    return {"type": op.type,
            "outputs": [n for n in op.output_names() if n][:4],
            "callsite": op.callsite,
            "pass": op.attrs.get(PASS_PROVENANCE_ATTR)}


@dataclass
class PassContext:
    """What one pipeline run knows about the program being rewritten.
    ``feed_names`` and ``fetch_names`` are vars no pass may remove;
    ``scope`` holds the parameter values (None: passes that need it are
    skipped)."""

    desc: ProgramDesc
    program: Any = None                    # framework Program, if any
    fetch_names: List[str] = field(default_factory=list)
    feed_names: Optional[Set[str]] = None
    scope: Any = None


@dataclass
class PassResult:
    """Structured diff of one pass application."""

    name: str
    changed: bool = False
    skipped: Optional[str] = None          # reason, when not applied
    ops_added: List[dict] = field(default_factory=list)
    ops_removed: List[dict] = field(default_factory=list)
    ops_replaced: int = 0                  # pattern instances rewritten
    vars_added: int = 0
    vars_removed: int = 0
    donate_vars: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    wall_s: float = 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "changed": self.changed,
                "skipped": self.skipped,
                "ops_added": list(self.ops_added),
                "ops_removed": list(self.ops_removed),
                "ops_replaced": self.ops_replaced,
                "vars_added": self.vars_added,
                "vars_removed": self.vars_removed,
                "donate_vars": list(self.donate_vars),
                "notes": list(self.notes),
                "wall_s": round(self.wall_s, 6)}


class ProgramPass:
    """One ProgramDesc rewrite.  Subclasses set ``name`` and implement
    :meth:`apply`, mutating ``ctx.desc`` in place and recording every op
    they add or remove into ``result`` through :meth:`insert_op` and
    :meth:`remove_ops`."""

    name: str = "?"
    # reads or writes parameter values through ``PassContext.scope``
    requires_scope: bool = False

    def config(self) -> dict:
        """Semantic configuration, keyed into the pipeline fingerprint."""
        return {}

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        raise NotImplementedError

    def insert_op(self, block: BlockDesc, index: int, op: OpDesc,
                  result: PassResult,
                  callsite: Optional[str] = None) -> OpDesc:
        """Insert ``op`` with pass provenance: ``inserted_by`` names this
        pass and ``callsite`` the rewritten op's creation site (or
        ``pass:<name>``)."""
        op.attrs.setdefault(PASS_PROVENANCE_ATTR, self.name)
        op.attrs.setdefault(CALLSITE_ATTR, callsite or f"pass:{self.name}")
        block.insert_op(index, op)
        result.ops_added.append(op_info(op))
        result.changed = True
        return op

    def remove_ops(self, block: BlockDesc, indices: Iterable[int],
                   result: PassResult) -> None:
        drop = sorted(set(indices), reverse=True)
        for i in drop:
            result.ops_removed.append(op_info(block.ops[i]))
            del block.ops[i]
        if drop:
            block.program._bump()
            result.changed = True

    def gc_dead_var_decls(self, block: BlockDesc, keep: Set[str],
                          result: PassResult) -> None:
        """Drop non-persistable var declarations that no remaining op (nor
        a feed or fetch in ``keep``) references.  (The port's programs have
        one block: the passes skip multi-block programs.)"""
        referenced: Set[str] = set(keep)
        for op in block.ops:
            referenced.update(n for n in op.input_names() if n)
            referenced.update(n for n in op.output_names() if n)
        dead = [n for n, vd in block.vars.items()
                if n not in referenced and not vd.persistable]
        for n in dead:
            del block.vars[n]
            result.vars_removed += 1
        if dead:
            block.program._bump()
            result.changed = True


#: pass registry: name -> zero-arg constructor
PASSES: Dict[str, Callable[[], ProgramPass]] = {}


def register_pass(cls):
    PASSES[cls.name] = cls
    return cls


def _resolve(p) -> ProgramPass:
    if isinstance(p, ProgramPass):
        return p
    if isinstance(p, type) and issubclass(p, ProgramPass):
        return p()
    if isinstance(p, str):
        if p in _UNPORTED_SEED_PASSES:
            raise NotImplementedError(
                f"pass {p!r} is not ported yet (ROADMAP.md, queue A item 7)")
        if p not in PASSES:
            raise KeyError(f"unknown pass {p!r}; registered: {sorted(PASSES)}")
        return PASSES[p]()
    raise TypeError(f"cannot resolve pass from {p!r}")


@dataclass
class PipelineResult:
    """One pipeline application: per-pass structured diffs and identity
    bookkeeping."""

    fingerprint: str = ""
    passes: List[PassResult] = field(default_factory=list)
    changed: bool = False
    program_fp_before: str = ""
    program_fp_after: str = ""
    version_before: int = 0
    version_after: int = 0
    ops_before: int = 0
    ops_after: int = 0
    donate_vars: List[str] = field(default_factory=list)
    verify_counts_pre: Dict[str, int] = field(default_factory=dict)
    verify_counts_post: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0

    def to_dict(self) -> dict:
        return {"fingerprint": self.fingerprint[:12],
                "changed": self.changed,
                "passes": [r.to_dict() for r in self.passes],
                "program_fp_before": self.program_fp_before[:12],
                "program_fp_after": self.program_fp_after[:12],
                "version_before": self.version_before,
                "version_after": self.version_after,
                "ops_before": self.ops_before, "ops_after": self.ops_after,
                "donate_vars": list(self.donate_vars),
                "verify_pre": dict(self.verify_counts_pre),
                "verify_post": dict(self.verify_counts_post),
                "wall_s": round(self.wall_s, 6)}


class PassPipeline:
    """Ordered, registered, fingerprint-aware pass sequence.

    ``verify`` names the JAX package's pre/post verification mode; only
    ``"off"`` exists in the port until the verifier is ported, and the
    default (``"error"``, as in the JAX package) raises rather than
    skipping verification silently."""

    def __init__(self, passes: Sequence, verify: str = "error"):
        if verify not in ("error", "warn", "off"):
            raise ValueError(f"verify must be 'error', 'warn' or 'off', "
                             f"got {verify!r}")
        if verify != "off":
            raise NotImplementedError(f"PassPipeline(verify={verify!r}): "
                                      f"{_VERIFIER_MISSING}")
        self.passes: List[ProgramPass] = [_resolve(p) for p in passes]
        self.verify = verify

    def fingerprint(self) -> str:
        """Stable content hash of the ordered pass names and their
        semantic configs."""
        payload = json.dumps([[p.name, p.config()] for p in self.passes],
                             sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()

    def __repr__(self):
        return (f"PassPipeline([{', '.join(p.name for p in self.passes)}]"
                f", verify={self.verify!r})")

    def run(self, program, *, fetch_list: Optional[Sequence] = None,
            feed_names: Optional[Iterable[str]] = None, scope=None,
            clone: bool = True):
        """Apply every pass in order.  Returns ``(program, result)``.
        A pass that ``requires_scope`` is skipped when ``scope`` is None.

        With ``clone=True`` (default) the input program is never mutated:
        the rewrite happens on a clone that keeps the input's ``uid`` but
        lands on a version no other pipeline over that uid can reach when
        anything changed.  If no pass changes anything, the ORIGINAL
        program object is returned."""
        t0 = time.perf_counter()
        is_framework = hasattr(program, "desc")
        src_desc: ProgramDesc = program.desc if is_framework else program
        fetch_names = [getattr(f, "name", f) for f in (fetch_list or [])]
        v_before = src_desc.version
        fp_before = src_desc.fingerprint()

        if clone:
            work = program.clone() if is_framework else src_desc.clone()
        else:
            work = program
        desc: ProgramDesc = work.desc if is_framework else work
        if clone:
            desc.uid = src_desc.uid
            desc._version = src_desc.version

        ctx = PassContext(
            desc=desc, program=work if is_framework else None,
            fetch_names=fetch_names,
            feed_names=set(feed_names) if feed_names is not None else None,
            scope=scope)
        result = PipelineResult(
            fingerprint=self.fingerprint(), program_fp_before=fp_before,
            version_before=v_before, ops_before=sum(len(b.ops) for b in desc.blocks))

        for p in self.passes:
            pr = PassResult(name=p.name)
            t_pass = time.perf_counter()
            if p.requires_scope and scope is None:
                pr.skipped = "needs a Scope (parameter values)"
                result.passes.append(pr)
                continue
            v0 = desc.version
            p.apply(ctx, pr)
            if pr.changed and desc.version == v0:
                # a mutation must move the version, or a memo keyed on
                # (uid, version) would serve the pre-rewrite program
                desc._bump()
                pr.notes.append("version bump supplied by the pipeline "
                                "(pass mutated without _bump)")
            if pr.changed and is_framework:
                work.sync_with_desc()
            pr.wall_s = time.perf_counter() - t_pass
            result.passes.append(pr)

        result.changed = any(r.changed for r in result.passes)
        result.version_after = desc.version
        result.ops_after = sum(len(b.ops) for b in desc.blocks)
        if result.changed and clone:
            # offset by this pipeline's fingerprint so two different
            # pipelines rewriting one program never collide on (uid, version)
            desc._version = (v_before + 1
                             + (int(self.fingerprint()[:8], 16) & 0xFFFF))
            result.version_after = desc.version
        result.program_fp_after = desc.fingerprint()
        result.wall_s = time.perf_counter() - t0
        _count_pipeline(result)
        export_pipeline_result(result)
        if not result.changed and clone:
            return program, result
        return work, result


def _count_pipeline(result: PipelineResult) -> None:
    """The ``"passes"`` scope's counters."""
    REGISTRY.counter("pipelines_run", scope="passes").inc()
    if result.changed:
        REGISTRY.counter("programs_rewritten", scope="passes").inc()
    REGISTRY.counter("ops_removed", scope="passes").inc(
        sum(len(r.ops_removed) for r in result.passes))
    REGISTRY.counter("ops_added", scope="passes").inc(
        sum(len(r.ops_added) for r in result.passes))


def export_pipeline_result(result: PipelineResult,
                           out_dir: Optional[str] = None) -> Optional[str]:
    """Append one JSONL record of ``result`` to ``passes_<pid>.jsonl``
    under ``out_dir`` (default the telemetry dir); returns the path, or
    None when export is off or fails."""
    out_dir = out_dir or os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    if not out_dir:
        return None
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"passes_{os.getpid()}.jsonl")
        rec = dict(result.to_dict(), ts=time.time(), pid=os.getpid())
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path
    except OSError:
        return None  # telemetry must never fail a rewrite


def default_pipeline(verify: str = "error") -> PassPipeline:
    """The JAX package's seed pipeline; three of its passes are not ported yet."""
    raise NotImplementedError(
        f"the seed passes {list(_UNPORTED_SEED_PASSES)} are not ported yet "
        f"(ROADMAP.md, queue A item 7); name the passes to run instead")


def make_pipeline(spec) -> Optional[PassPipeline]:
    """Normalize the ``Executor(passes=)`` knob: ``None``/``False`` → no
    pipeline, ``True`` → :func:`default_pipeline` (raises until its passes
    are ported), a :class:`PassPipeline` → itself, else an iterable of
    pass names / classes / instances, run with ``verify="off"``."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return default_pipeline()
    if isinstance(spec, PassPipeline):
        return spec
    return PassPipeline(list(spec), verify="off")
