"""Diagnostic objects for the static program verifier: a copy of the JAX
package's ``analysis/diagnostics.py`` (stdlib only), with the same codes,
severities and record schema, so the findings of both packages compare
field for field and the readers in `tools/` take the port's records.

Each diagnostic carries a stable ``code`` (e.g. ``D201``) from the catalog
below, a severity, the op type / var name it names, and the Python
creation site of the offending op (the ``callsite`` attr framework.py
stamps at append time) — so a verifier finding reads like a compiler
error pointing at the user's model-building line, not at framework
internals.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: code -> (name, severity).  Codes are grouped by checker:
#:   S1xx shape/dtype inference   D2xx well-formedness/dataflow
#:   A3xx donation & aliasing     R4xx recompile-hazard & layout lint
#:   M5xx static memory planner (analysis/memory.py)
#: Severity policy: ``error`` = the program cannot mean what was written
#: (running it misbehaves or crashes); ``warning`` = almost certainly a
#: bug but conceivably intended; ``info`` = legal but a known perf cliff
#: (the classes compile_log.diff_signatures attributes after the fact).
CATALOG: Dict[str, tuple] = {
    "S101": ("shape-mismatch", WARNING),
    "S102": ("dtype-mismatch", WARNING),
    "S103": ("shape-infer-error", WARNING),
    "D201": ("use-before-def", ERROR),
    "D202": ("undefined-var", ERROR),
    "D203": ("fetch-unreachable", ERROR),
    "D204": ("dead-op", INFO),
    "D205": ("dead-var", INFO),
    "D206": ("persistable-clobbered", WARNING),
    "A301": ("feed-clobbered", WARNING),
    "A302": ("donated-read-after-write", WARNING),
    "R401": ("dynamic-dim-unbucketed", INFO),
    "R402": ("unknown-mesh-axis", ERROR),
    "R403": ("sharding-rank-mismatch", ERROR),
    "R404": ("indivisible-sharding", WARNING),
    # static memory planner: M501 fires only against an explicit budget
    # (a predicted step-time OOM is as fatal as a malformed program);
    # M504 is a sizing coverage gap (the estimate silently undercounts);
    # M502/M503/M505 are memory perf cliffs, never raised.
    "M501": ("predicted-oom", ERROR),
    "M502": ("peak-dominating-dead-var", INFO),
    "M503": ("donation-opportunity", INFO),
    "M504": ("unsized-var", WARNING),
    "M505": ("layout-imbalance", INFO),
}


@dataclass
class Diagnostic:
    code: str
    message: str
    severity: str = ""
    name: str = ""
    block_idx: int = 0
    op_index: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    callsite: Optional[str] = None

    def __post_init__(self):
        if not self.name or not self.severity:
            name, sev = CATALOG[self.code]
            self.name = self.name or name
            self.severity = self.severity or sev

    def format(self) -> str:
        where = f"block {self.block_idx}"
        if self.op_index is not None:
            where += f" op#{self.op_index}"
        if self.op_type:
            where += f" {self.op_type}"
        if self.var:
            where += f"(var {self.var!r})"
        at = f" at {self.callsite}" if self.callsite else ""
        return (f"{self.severity}[{self.code} {self.name}] {where}{at}: "
                f"{self.message}")

    def to_dict(self) -> dict:
        return {"code": self.code, "name": self.name,
                "severity": self.severity, "block": self.block_idx,
                "op_index": self.op_index, "op_type": self.op_type,
                "var": self.var, "callsite": self.callsite,
                "message": self.message}

    __str__ = format


class ProgramVerificationError(RuntimeError):
    """Raised by ``Executor(validate="error")`` when the verifier finds
    error-severity diagnostics before a program's first run."""

    def __init__(self, result: "VerifyResult"):
        self.result = result
        errs = result.errors
        lines = [d.format() for d in errs[:10]]
        if len(errs) > 10:
            lines.append(f"... and {len(errs) - 10} more")
        super().__init__(
            f"program verification failed with {len(errs)} error(s):\n  "
            + "\n  ".join(lines))


@dataclass
class VerifyResult:
    """All diagnostics of one ``analysis.verify`` pass plus run metadata."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    program_fp: str = ""
    num_blocks: int = 0
    num_ops: int = 0
    wall_s: float = 0.0
    checks: tuple = ()

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == INFO]

    @property
    def findings(self) -> List[Diagnostic]:
        """Non-info diagnostics — what warn/error validate modes report."""
        return [d for d in self.diagnostics if d.severity != INFO]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def counts(self) -> Dict[str, int]:
        out = {ERROR: 0, WARNING: 0, INFO: 0}
        for d in self.diagnostics:
            out[d.severity] += 1
        return out

    def format(self) -> str:
        c = self.counts()
        head = (f"verify: {self.num_ops} ops / {self.num_blocks} block(s) "
                f"in {self.wall_s * 1e3:.1f} ms — {c[ERROR]} error(s), "
                f"{c[WARNING]} warning(s), {c[INFO]} info")
        return "\n".join([head] + ["  " + d.format()
                                   for d in self.diagnostics])

    def to_dict(self) -> dict:
        return {"program_fp": self.program_fp, "blocks": self.num_blocks,
                "ops": self.num_ops, "wall_s": round(self.wall_s, 6),
                "checks": list(self.checks), "counts": self.counts(),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}


def export_result(result: VerifyResult, out_dir: Optional[str] = None):
    """Append one JSONL record to ``analysis_<pid>.jsonl`` under the
    telemetry dir (PADDLE_TPU_TELEMETRY_DIR), read by tools/stats.py and
    tools/compile_report.py."""
    out_dir = out_dir or os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    if not out_dir:
        return
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"analysis_{os.getpid()}.jsonl")
        rec = dict(result.to_dict(), ts=time.time())
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    except OSError:
        pass  # telemetry must never fail a verify pass
