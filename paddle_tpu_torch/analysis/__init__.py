"""paddle_tpu_torch.analysis — the static program verifier and memory
planner, ported from the JAX package's ``paddle_tpu.analysis``.

A model is a :class:`~paddle_tpu_torch.core.desc.ProgramDesc`, so whole-
program verification is a walk of the data structure.  Surfaces:

* ``analysis.verify(program, fetch_list=..., mesh=..., layout=...)`` —
  a :class:`VerifyResult` of :class:`Diagnostic`\\ s;
* ``Executor(validate="error"|"warn"|"off")`` — runs the verifier once per
  (program, version, fetch names) before the program first runs;
  ``error`` raises :class:`ProgramVerificationError`;
* ``analysis.plan_memory`` and ``Executor(memory_budget=...)`` — the
  static per-device peak, and :class:`PredictedOOMError` before anything
  is allocated;
* ``tools/program_lint.py`` and ``tools/memory_report.py`` read the
  port's program dumps and records.

Diagnostics point at the Python creation site of the offending op (the
``callsite`` attr ``Block.append_op`` stamps).  diagnostics.CATALOG lists
the codes.
"""
from .diagnostics import (CATALOG, ERROR, INFO, WARNING, Diagnostic,
                          ProgramVerificationError, VerifyResult,
                          export_result)
from .memory import (DEVICE_PROFILES, MemoryPlan, PredictedOOMError,
                     export_plan, memory_diagnostics, parse_memory_budget,
                     plan_memory, plan_state_memory)
from .verifier import ALL_CHECKS, LAST_FINDINGS, record_findings, verify

__all__ = [
    "ALL_CHECKS", "CATALOG", "DEVICE_PROFILES", "Diagnostic", "ERROR",
    "INFO", "LAST_FINDINGS", "MemoryPlan", "PredictedOOMError",
    "ProgramVerificationError", "VerifyResult", "WARNING", "export_plan",
    "export_result", "memory_diagnostics", "parse_memory_budget",
    "plan_memory", "plan_state_memory", "record_findings", "verify",
]
