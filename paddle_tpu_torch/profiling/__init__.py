"""Op-level execution profiler: per-op wall-time attribution, a per-op
cost model, and the records its report tools read.

The port of the JAX package's ``profiling`` package:

1. **Sampled slice profiler** (:func:`profile_program`,
   ``Executor.profile_ops()``, ``Trainer(profile_steps=N)``): replays a
   step's feed through the live slice of the program
   (``core/prune.live_op_slice``) op by op, through the executor's
   ``lower_op``, timing each op to its outputs being ready on the device,
   over clones of the state it writes (``op_profiler``'s docstring).
2. **OpProfile records** joining each op's measured time with a static
   FLOPs and bytes estimate, giving per-op MFU, a roofline class
   (compute / memory / overhead-bound) and per-op-type calibration
   factors (measured seconds over compute-optimal seconds), exported as
   ``costmodel_<pid>.json``.
3. **Surfacing**: a ``"profiling"`` telemetry scope and one
   ``profile_<pid>.jsonl`` stream (``kind: op`` per attributed op,
   ``kind: summary`` per profile), rendered by ``tools/profile_report.py``
   and the profile section of ``tools/stats.py``.
"""
from __future__ import annotations

from .op_profiler import (
    OVERHEAD_WALL_S, PROFILE_RECORDS, PROFILE_SCOPE, RIDGE_FLOPS_PER_BYTE,
    OpProfile, ProgramProfile, export_costmodel, peak_flops_of,
    profile_program,
)

__all__ = [
    "PROFILE_SCOPE", "PROFILE_RECORDS", "OVERHEAD_WALL_S",
    "RIDGE_FLOPS_PER_BYTE", "OpProfile", "ProgramProfile",
    "profile_program", "export_costmodel", "peak_flops_of",
]
